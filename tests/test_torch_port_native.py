"""igmc_torch's C++ extraction engine against the JAX package's: identical
subgraphs (the same xoshiro streams) whether `max_nodes_per_hop` or
`sample_ratio` binds or not, with global stream ids and side features;
equal to the port's NumPy engine when nothing is subsampled; the engine
choice of `backend`; the build keyed on the source."""

import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sp

from igmc_tpu.graphs import BipartiteCSR as JaxBipartiteCSR
from igmc_tpu.graphs import extract_many as jax_extract_many
from igmc_tpu.graphs import native as jax_native

from igmc_torch.graphs import BipartiteCSR, extract_many
from igmc_torch.graphs import native
from igmc_torch.native import build

FIELDS = ("src", "dst", "etype", "node_label", "num_u", "num_v", "y",
          "u_feat", "v_feat")


def graph_fixture(nu=120, nv=150, density=0.08, seed=2):
    rng = np.random.default_rng(seed)
    M = (rng.random((nu, nv)) < density).astype(np.float32) * rng.integers(
        1, 6, (nu, nv)).astype(np.float32)
    us, vs = np.nonzero(M)
    labels = (M[us, vs] - 1).astype(np.int64)
    uf = rng.normal(size=(nu, 3)).astype(np.float32)
    vf = rng.normal(size=(nv, 2)).astype(np.float32)
    return sp.csr_matrix(M), us, vs, labels, np.arange(1.0, 6.0), uf, vf


def jax_native_ready() -> bool:
    """The JAX package's C++ engine is loaded. Its build writes the library
    in place, so a process that met it half-written while several test
    processes built it at once gave up; the build is done by now: retry."""
    if not jax_native.available():
        jax_native._TRIED, jax_native._LIB = False, None
    return jax_native.available()


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in FIELDS:
            gv, wv = getattr(g, f), getattr(w, f)
            if isinstance(wv, np.ndarray):
                assert gv.dtype == wv.dtype, f
            np.testing.assert_array_equal(gv, wv, err_msg=f)


@pytest.mark.parametrize("h,sample_ratio,mnph,density", [
    (1, 1.0, None, 0.08),      # nothing subsampled
    (1, 1.0, 4, 0.3),          # the per-hop cap binds
    (2, 1.0, 6, 0.05),
    (1, 0.5, None, 0.2),       # sample_ratio binds
    (2, 0.7, 5, 0.1),
])
def test_native_engine_matches_jax_native_engine(h, sample_ratio, mnph, density):
    assert jax_native_ready(), "the JAX package's C++ engine did not build"
    M, us, vs, labels, cv, uf, vf = graph_fixture(density=density)
    n = min(80, len(us))
    links, ids = (us[:n], vs[:n]), np.arange(n, dtype=np.int64) * 7 + 3
    for kw in ({}, {"indices": ids}):
        want = jax_extract_many(links, labels[:n], JaxBipartiteCSR(M), h,
                                sample_ratio, mnph, uf, vf, cv, seed=9,
                                backend="native", **kw)
        got = extract_many(links, labels[:n], BipartiteCSR(M), h, sample_ratio,
                           mnph, uf, vf, cv, seed=9, backend="native", **kw)
        assert_same(got, want)
    if mnph == 4:   # the cap bound: some fringe was cut
        assert any(g.num_u == 5 or g.num_v == 5 for g in got)


def test_native_equals_numpy_engine_when_nothing_is_subsampled():
    M, us, vs, labels, cv, uf, vf = graph_fixture()
    A = BipartiteCSR(M)
    a = extract_many((us, vs), labels, A, 1, 1.0, None, uf, vf, cv, backend="numpy")
    b = extract_many((us, vs), labels, A, 1, 1.0, None, uf, vf, cv, backend="native")
    assert_same(b, a)


def test_backend_choice(monkeypatch, capsys):
    assert native.resolve_backend("numpy") == "numpy"
    assert native.resolve_backend("native") == "native"
    monkeypatch.setattr(native, "_ANNOUNCED", None)
    assert native.resolve_backend("auto") == "native"
    assert "extraction engine: native (backend auto)" in capsys.readouterr().err
    with pytest.raises(ValueError, match="backend"):
        native.resolve_backend("fast")
    # an engine that cannot be loaded: "native" raises, "auto" falls back
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", "RuntimeError: no compiler")
    with pytest.raises(RuntimeError, match="unavailable.*no compiler"):
        native.resolve_backend("native")
    assert native.resolve_backend("auto") == "numpy"
    assert "numpy (backend auto; C++ engine unavailable" in capsys.readouterr().err


def test_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    path = build.library_path()
    assert path.startswith(build.BUILD_DIR) and path == build.library_path()
    assert os.path.isfile(build.build())
    src = tmp_path / "extract.cpp"
    shutil.copy(build.SOURCE, src)
    monkeypatch.setattr(build, "SOURCE", str(src))
    assert build.library_path() == path
    with open(src, "a") as f:
        f.write("// edited\n")
    assert build.library_path() != path
    with open(build.SOURCE) as f:
        text = f.read()
    assert f"igmc_extract_abi_version() {{ return {native.ABI_VERSION}; }}" in text
