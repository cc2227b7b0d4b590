"""igmc_torch's Monti datasets without h5py, against the JAX package on the
CPU:

  * data/hdf5.py through matio.load_matlab_file equals h5py's reading
    through the JAX package's load_matlab_file, bit for bit, on files that
    h5py writes in MATLAB's form (with and without the 512-byte user
    block) in every layout and filter set: compact, contiguous, chunked
    (edge chunks included) plain, deflate and shuffle + deflate; dense and
    sparse (uint64 ir / jc) fields;
  * what the reader does not read raises naming it (a libver='latest'
    file, a version 2 object header, an unknown filter, a big-endian or a
    string dataset, a file that is not HDF5);
  * the committed fixtures (tests/torch_fixtures/monti, written by
    tests/torch_make_monti_fixtures.py) hold what the generator draws from
    its seed, and their .npz twins the same;
  * the port's load_data_monti equals the JAX package's on each fixture,
    array for array, in testing and validation mode and with the CLI's
    rating maps (--standard-rating, --transfer's bucketing);
  * the port CLI end to end on the flixster (IGMC, --ensemble) and
    yahoo_music (R = 71) fixtures with --debug, its set-up lines equal to
    the JAX CLI's.

IGMC_RAW_DATA points at the fixtures through monkeypatch only; nothing is
written under ./raw_data, so the JAX tests' MONTI_AVAILABLE stays false.
"""

import os
import re
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from igmc_tpu.cli.main import main as jax_main
from igmc_tpu.data.matio import load_matlab_file as jax_load_matlab_file
from igmc_tpu.data.splits import load_data_monti as jax_load_data_monti

from igmc_torch.cli.main import main as port_main, rating_maps
from igmc_torch.data import MONTI_DATASETS, load_data_monti, load_matlab_file
from igmc_torch.data.hdf5 import HDF5File

import torch_make_monti_fixtures as gen

torch.set_num_threads(1)

FIXTURES = gen.FIXTURE_ROOT
GRAPHS = {"flixster": ("W_users", "W_movies"), "douban": ("W_users",),
          "yahoo_music": ("W_tracks",)}


def assert_same(got, want, what):
    """Bit for bit: type, shape, dtype and values (a sparse matrix's CSC
    arrays too)."""
    assert type(got) is type(want), what
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if sp.issparse(want):
        for a in ("data", "indices", "indptr"):
            assert np.array_equal(getattr(got, a), getattr(want, a)), (what, a)
    else:
        assert np.array_equal(got, want), what


# -- the reader -----------------------------------------------------------------

STORAGE = {
    "compact": None,
    "contiguous": {},
    "chunked": {"chunks": True},
    "deflate": {"chunks": True, "compression": "gzip", "compression_opts": 4},
    "shuffle+deflate": {"chunks": True, "compression": "gzip", "shuffle": True},
}


def write_field(f, name, arr, storage):
    """One dataset in `storage` form; chunks that do not divide the shape."""
    kw = dict(STORAGE[storage] or {})
    if kw.get("chunks"):
        kw["chunks"] = tuple(max(1, (s * 2) // 5) for s in arr.shape)
    if storage == "compact":
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        tid = h5py.h5t.py_create(arr.dtype)
        d = h5py.h5d.create(f.id, name.encode(), tid,
                            h5py.h5s.create_simple(arr.shape), dcpl)
        ds = h5py.Dataset(d)
        ds[...] = arr
    else:
        ds = f.create_dataset(name, data=arr, **kw)
    ds.attrs["MATLAB_class"] = np.bytes_("double")
    return ds


@pytest.mark.parametrize("userblock", [0, 512])
@pytest.mark.parametrize("storage", list(STORAGE))
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_reader_equals_h5py(kind, storage, userblock, tmp_path):
    rng = np.random.default_rng(len(storage) + userblock)
    path = str(tmp_path / "f.mat")
    a = sp.random(37, 23, density=0.2, format="csc", random_state=7,
                  data_rvs=lambda n: rng.integers(1, 11, n) / 2.0)
    dense = a.toarray()
    with h5py.File(path, "w", userblock_size=userblock or None) as f:
        if kind == "dense":
            write_field(f, "M", dense.T, storage)          # MATLAB's column-major
        else:
            g = f.create_group("W")
            g.attrs["MATLAB_class"] = np.bytes_("double")
            g.attrs["MATLAB_sparse"] = np.uint64(a.shape[0])
            write_field(g, "data", a.data.astype(np.float64), storage)
            write_field(g, "ir", a.indices.astype(np.uint64), storage)
            write_field(g, "jc", a.indptr.astype(np.uint64), storage)
        f.create_dataset("Otest", data=(dense.T != 0).astype(np.float64))
    field = "M" if kind == "dense" else "W"
    got = load_matlab_file(path, field)
    assert_same(got, jax_load_matlab_file(path, field), field)
    assert (got.toarray() if kind == "sparse" else got).tolist() == \
        dense.astype(np.float32).tolist()
    with HDF5File(path) as h:
        assert h.keys() == sorted(["Otest", field])
        with h5py.File(path, "r") as f:
            assert np.array_equal(h["Otest"], f["Otest"][...])


def test_reader_reads_unwritten_chunks_as_the_fill_value(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        d = f.create_dataset("a", shape=(20, 30), chunks=(7, 8), dtype="f4",
                             fillvalue=2.5, compression="gzip")
        d[0:9, 3:11] = np.arange(72, dtype=np.float32).reshape(9, 8)
        many = f.create_group("many")                      # a multi-node B-tree
        for i in range(120):
            many.create_dataset(f"x{i:03d}", data=np.full(2, i, np.int16))
        want = d[...]
    with HDF5File(path) as h:
        assert np.array_equal(h["a"], want) and h["a"].dtype == np.float32
        parts = h.group("many")
        assert len(parts) == 120 and int(parts["x077"][1]) == 77


def _latest(f):
    f.create_dataset("a", data=np.arange(3.0))


@pytest.mark.parametrize("make,opts,message", [
    (_latest, {"libver": "latest"}, "superblock version 3"),
    (_latest, {"track_order": True}, "version 2 object header"),
    (lambda f: f.create_dataset("a", data=np.arange(300.0), compression="lzf"),
     {}, "filter id 32000"),
    (lambda f: f.create_dataset("a", data=np.arange(300.0), chunks=(30,),
                                fletcher32=True), {}, "filter id 3 "),
    (lambda f: f.create_dataset("a", data=np.arange(3, dtype=">i4")), {},
     "big-endian fixed-point"),
    (lambda f: f.create_dataset("a", data=np.bytes_("double")), {}, "string datatype"),
])
def test_reader_names_what_it_does_not_read(make, opts, message, tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", **opts) as f:
        make(f)
    with pytest.raises(ValueError, match=re.escape(message)):
        with HDF5File(path) as h:
            h["a"]
    not_hdf5 = tmp_path / "g.mat"
    not_hdf5.write_bytes(b"MATLAB 5.0 MAT-file" + bytes(2000))
    with pytest.raises(ValueError, match="no HDF5 signature"):
        load_matlab_file(str(not_hdf5), "M")


# -- the fixtures ---------------------------------------------------------------

@pytest.mark.parametrize("name", MONTI_DATASETS)
def test_fixtures_hold_what_the_generator_draws(name):
    """The committed .mat (read by the port) and its .npz twin equal the
    generator's draw from its seed, in the published shapes."""
    fields = gen.draw(name)
    assert set(fields) == {"M", "Otraining", "Otest", *GRAPHS[name]}
    path = os.path.join(FIXTURES, name, gen.FILE + ".mat")
    with open(path, "rb") as fh:
        assert fh.read(19) == b"MATLAB 7.3 MAT-file"
    with np.load(os.path.join(FIXTURES, name, gen.FILE + ".npz")) as npz:
        twin = gen.from_twin(npz)
    for field, want in fields.items():
        got = load_matlab_file(path, field)
        if sp.issparse(want):
            assert got.shape == (gen.N, gen.N)
            assert np.array_equal(got.toarray(), want.toarray().astype(np.float32))
            assert (twin[field] != want).nnz == 0
        else:
            assert np.array_equal(got, want.astype(np.float32))
            assert np.array_equal(twin[field], want)
    M = fields["M"]
    levels = np.unique(M[M != 0])
    n, n_levels = {"flixster": (26_173, 10), "douban": (136_891, 5),
                   "yahoo_music": (5_335, 71)}[name]
    assert M.shape == (3000, 3000) and (M != 0).sum() == n and levels.size == n_levels
    assert fields["Otest"].sum() == n // 10
    assert fields["Otest"].sum() + fields["Otraining"].sum() == n


def monti_cases():
    for name in MONTI_DATASETS:
        for testing, standard, transfer in ((True, False, False), (False, False, False),
                                            (True, True, True)):
            yield pytest.param(name, testing, standard, transfer,
                               id=f"{name}-{'test' if testing else 'val'}"
                                  f"{'-maps' if standard else ''}")


@pytest.mark.parametrize("name,testing,standard,transfer", monti_cases())
def test_load_data_monti_matches_jax(name, testing, standard, transfer, monkeypatch):
    monkeypatch.setenv("IGMC_RAW_DATA", FIXTURES)
    args = SimpleNamespace(standard_rating=standard, transfer="x" if transfer else "",
                           data_name=name, num_relations=5)
    rating_map, post_rating_map = rating_maps(args)
    want = jax_load_data_monti(name, testing, rating_map, post_rating_map)
    got = load_data_monti(name, testing, rating_map, post_rating_map)
    for field in want.__dataclass_fields__:
        assert_same(getattr(got, field), getattr(want, field), field)
    if standard and name != "douban":
        assert len(got.class_values) == 5
    if not testing:
        assert len(got.val_labels) > 0


# -- the CLI --------------------------------------------------------------------

SETUP = re.compile(r"^(#train|Used #train|All ratings|\[|Total number of parameters|"
                   r"batch mode|dense layout)")


def cli(which, argv, cwd, monkeypatch, capsys):
    monkeypatch.setenv("IGMC_RAW_DATA", FIXTURES)
    os.makedirs(cwd, exist_ok=True)
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    if which == "jax":
        jax_main(argv)
    else:
        port_main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name,extra", [
    ("flixster", ["--ensemble", "--epochs", "2", "--save-interval", "1"]),
    ("yahoo_music", ["--epochs", "1"]),
])
def test_cli_trains_on_a_monti_fixture(name, extra, tmp_path, monkeypatch, capsys):
    """The port CLI trains IGMC on the fixture with --debug: the JAX CLI's
    set-up lines (links, ratings, parameters: R = 10 or 71, layout), and a
    log.txt whose RMSEs are finite."""
    argv = ["--data-name", name, "--testing", "--debug", "--max-train-num", "200",
            "--max-test-num", "100"]
    want = [l for l in cli("jax", argv + ["--no-train"], str(tmp_path / "jax"),
                           monkeypatch, capsys) if SETUP.match(l)]
    got = cli("port", argv + extra, str(tmp_path / "port"), monkeypatch, capsys)
    assert [l for l in got if SETUP.match(l)] == want
    assert "dense layout: unified (auto)" in want
    log = (tmp_path / "port" / "results" / f"{name}_testmode" / "log.txt"
           ).read_text().splitlines()
    assert len(log) == (3 if "--ensemble" in extra else 1)
    assert all(np.isfinite(float(l.split()[-1])) for l in log)
    if "--ensemble" in extra:
        assert log[-1].startswith("Epoch ensemble of range(-28, 2, 10)")
        assert any(l.startswith("Ensemble test rmse is: ") for l in got)
