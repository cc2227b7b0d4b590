"""igmc_torch's Predictor and serving CLI against the JAX package's on the
CPU: the same parameters (carried by state_dict_from_params, or `.pth`
checkpoints both packages read) give the same scores to atol 1e-5 for a
single model, a two-checkpoint ensemble, side features, a pinned
slot_ladder and cold-start pairs; the out-of-range and "too small" errors
read the same; read_pairs parses as JAX's does; and the predict CLI runs
end to end on an ml_100k fixture, plain and with --transfer, printing
JAX's scores."""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

from igmc_tpu.cli.predict import main as jax_predict_main
from igmc_tpu.cli.predict import read_pairs as jax_read_pairs
from igmc_tpu.data.synthetic import write_ml100k_format
from igmc_tpu.graphs import native as jax_native
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import igmc_init
from igmc_tpu.serve import Predictor as JaxPredictor
from igmc_tpu.train.torch_interop import state_dict_from_params

from igmc_torch.cli.predict import main as port_predict_main
from igmc_torch.cli.predict import read_pairs
from igmc_torch.data import load_official_trainvaltest_split
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.parallel import Mesh
from igmc_torch.serve import Predictor
from igmc_torch.train import checkpoint_path, save_pth

torch.set_num_threads(1)

ATOL = 1e-5
CLASS_VALUES = np.arange(1.0, 6.0)


def rating_matrix(nu=60, nv=70, density=0.12, seed=0, cold=()):
    """A users x items adjacency of labels + 1 (5 relations); `cold` user
    and item ids get no ratings."""
    rng = np.random.default_rng(seed)
    M = sp.random(nu, nv, density=density, format="lil",
                  random_state=np.random.RandomState(seed))
    for u, v in cold:
        M[u, :] = 0
        M[:, v] = 0
    M = M.tocsr()
    M.eliminate_zeros()
    M.data = rng.integers(1, 6, M.nnz).astype(np.float64)
    return M


def configs(n_side=0, **kw):
    side = dict(side_features=n_side > 0, n_side_features=n_side)
    return (JaxIGMCConfig(num_relations=5, num_bases=4, **side, **kw),
            IGMCConfig(num_relations=5, num_bases=4, **side, **kw))


def pairs_of(M, n=40, seed=1):
    """Observed pairs and random ones (some unobserved)."""
    rng = np.random.default_rng(seed)
    us, vs = M.nonzero()
    k = min(n // 2, len(us))
    ru = rng.integers(0, M.shape[0], n - k)
    rv = rng.integers(0, M.shape[1], n - k)
    return np.concatenate([us[:k], ru]), np.concatenate([vs[:k], rv])


@pytest.mark.parametrize("case", ["single", "features", "numpy_engine_capped",
                                  "slot_ladder", "cold_start"])
def test_predictor_matches_jax(case):
    cold = ((7, 9),) if case == "cold_start" else ()
    M = rating_matrix(cold=cold)
    us, vs = pairs_of(M)
    kw = dict(batch_size=8, backend="native")
    n_side = 0
    if case == "features":
        rng = np.random.default_rng(3)
        kw["u_features"] = rng.random((M.shape[0], 3)).astype(np.float32)
        kw["v_features"] = (rng.random((M.shape[1], 4)) < 0.5).astype(np.float32)
        n_side = 7
    if case == "numpy_engine_capped":
        kw.update(backend="numpy", max_nodes_per_hop=3)
    if case == "slot_ladder":
        kw["slot_ladder"] = [(24, 64), (64, 400)]
    if case == "cold_start":
        us = np.concatenate([[7, 7, us[0]], us])
        vs = np.concatenate([[9, vs[0], 9], vs])
    jcfg, pcfg = configs(n_side)
    params = igmc_init(jax.random.PRNGKey(2), jcfg)
    if not jax_native.available():   # see test_torch_port_native.jax_native_ready
        jax_native._TRIED, jax_native._LIB = False, None
    want = JaxPredictor(M, CLASS_VALUES, jcfg, params=params, **kw).predict(us, vs)
    pred = Predictor(M, CLASS_VALUES, pcfg, params=state_dict_from_params(params),
                     device="cpu", **kw)
    got = pred.predict(us, vs)
    assert got.dtype == np.float32 and got.shape == (len(us),)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert pred.engine == kw["backend"]
    # the host and device halves of predict
    ds = pred.subgraphs(us, vs)
    np.testing.assert_array_equal(pred.score(ds), got)


def test_pth_ensemble_and_results_dir_match_jax(tmp_path):
    """Two `.pth` checkpoints (written by the port) average on both sides;
    from_results_dir finds them by the CLI's range convention."""
    M = rating_matrix(seed=4)
    us, vs = pairs_of(M, seed=5)
    jcfg, pcfg = configs()
    for e, key in ((1, 10), (2, 11)):
        save_pth(checkpoint_path(str(tmp_path), "model", e),
                 state_dict_from_params(igmc_init(jax.random.PRNGKey(key), jcfg)))
    cks = [checkpoint_path(str(tmp_path), "model", e) for e in (1, 2)]
    want = JaxPredictor(M, CLASS_VALUES, jcfg, checkpoints=cks,
                        batch_size=8).predict(us, vs)
    got = Predictor(M, CLASS_VALUES, pcfg, checkpoints=cks, batch_size=8,
                    device="cpu").predict(us, vs)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    single = [Predictor(M, CLASS_VALUES, pcfg, checkpoints=[c], batch_size=8,
                        device="cpu").predict(us, vs) for c in cks]
    np.testing.assert_allclose(got, (single[0] + single[1]) / 2, rtol=0, atol=1e-6)
    from_dir = Predictor.from_results_dir(str(tmp_path), M, CLASS_VALUES, pcfg,
                                          epochs=2, interval=1, span=1,
                                          batch_size=8, device="cpu")
    assert len(from_dir.params_list) == 2
    np.testing.assert_array_equal(from_dir.predict(us, vs), got)
    with pytest.raises(FileNotFoundError, match="no model checkpoints"):
        Predictor.from_results_dir(str(tmp_path / "none"), M, CLASS_VALUES, pcfg,
                                   epochs=2, device="cpu")


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_errors_match_jax():
    M = rating_matrix(20, 30, density=0.2, seed=2)
    jcfg, pcfg = configs()
    params = igmc_init(jax.random.PRNGKey(0), jcfg)
    both = [JaxPredictor(M, CLASS_VALUES, jcfg, params=params),
            Predictor(M, CLASS_VALUES, pcfg, params=state_dict_from_params(params),
                      device="cpu")]
    for us, vs in (([0, 20], [0, 0]), ([0], [30]), ([-1], [0]), ([3, 2, 25], [1, 31, 2])):
        msgs = [_error(lambda p=p: p.predict(us, vs)) for p in both]
        assert msgs[0] == msgs[1] and "out of range" in msgs[1]
    msgs = [_error(lambda p=p: p.predict([1, 2], [3])) for p in both]
    assert msgs[0] == msgs[1]
    assert both[1].predict([], []).shape == (0,)
    us, vs = M.nonzero()
    small = [JaxPredictor(M, CLASS_VALUES, jcfg, params=params, slot_ladder=[(8, 8)]),
             Predictor(M, CLASS_VALUES, pcfg, params=state_dict_from_params(params),
                       slot_ladder=[(8, 8)], device="cpu")]
    msgs = [_error(lambda p=p: p.predict(us[:6], vs[:6])) for p in small]
    assert msgs[0] == msgs[1] and "slot_ladder too small" in msgs[1]
    with pytest.raises(ValueError, match="exactly one"):
        Predictor(M, CLASS_VALUES, pcfg, device="cpu")


def test_predictor_arguments_and_device(monkeypatch):
    M = rating_matrix(20, 30, density=0.2, seed=2)
    _, pcfg = configs()
    sd = IGMC(pcfg, torch.Generator().manual_seed(0)).state_dict()
    # a mesh (ported: data-parallel serving, test_torch_port_parallel.py)
    # refuses a batch that does not split over it, in the JAX words
    with pytest.raises(ValueError, match=r"batch_size \(50\) must divide by the mesh "
                                         r"size \(3\)"):
        Predictor(M, CLASS_VALUES, pcfg, params=sd, device="cpu",
                  mesh=Mesh(rank=0, size=3, device=torch.device("cpu"), backend="gloo"))
    pred = Predictor(M, CLASS_VALUES, pcfg, params=sd, device="cpu",
                     compilation_cache_dir="/nonexistent")
    assert np.isfinite(pred.predict([0, 1], [2, 3])).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(M, CLASS_VALUES, pcfg, params=sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_predict_main(["--data-name", "ml_100k", "--results-dir", "none",
                           "--epochs", "1"])


def test_read_pairs_matches_jax(tmp_path):
    """The formats of tests/test_serve.py's read_pairs test: separators,
    blanks, comments, one header row, and the errors naming the line."""
    f = tmp_path / "pairs.csv"
    f.write_text("user,item\n# comment\n1,2\n3\t4\n5 6\n\n7, 8\n")
    for a, b in zip(read_pairs(str(f)), jax_read_pairs(str(f))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int64
    for name, text in (("bad.csv", "1,2\nnot-a-pair\n"), ("short.csv", "1,2\n3\n"),
                       ("empty.csv", "# nothing\n"), ("head2.csv", "u,i\nx,y\n1,2\n")):
        p = tmp_path / name
        p.write_text(text)
        msgs = []
        for fn in (read_pairs, jax_read_pairs):
            with pytest.raises(SystemExit) as e:
                fn(str(p))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.fixture(scope="module")
def ml100k(tmp_path_factory):
    """An ml_100k fixture (synthetic generator, every file present) with a
    results directory for each serving mode: plain (side features,
    checkpoints of epochs 1 and 2) and transfer (2 relations)."""
    root = tmp_path_factory.mktemp("raw")
    write_ml100k_format(str(root), n_users=120, n_movies=100, n_ratings=2500,
                        seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        split = load_official_trainvaltest_split("ml_100k", testing=True)
    n_side = split.u_features.shape[1] + split.v_features.shape[1]
    results = tmp_path_factory.mktemp("results")
    for name, cfg in (("plain", IGMCConfig(num_relations=5, side_features=True,
                                           n_side_features=n_side)),
                      ("transfer", IGMCConfig(num_relations=2))):
        for e in (1, 2):
            model = IGMC(cfg, torch.Generator().manual_seed(10 * e))
            save_pth(checkpoint_path(str(results / name), "model", e),
                     model.state_dict())
    pairs = results / "pairs.csv"
    pairs.write_text("user,item\n" + "".join(
        f"{u},{v}\n" for u, v in zip(split.test_u_indices[:30],
                                     split.test_v_indices[:30])))
    return str(root), str(results), str(pairs)


@pytest.mark.parametrize("mode", ["plain", "transfer"])
def test_predict_cli_matches_jax(ml100k, tmp_path, monkeypatch, capsys, mode):
    root, results, pairs = ml100k
    monkeypatch.setenv("IGMC_RAW_DATA", root)
    monkeypatch.chdir(tmp_path)
    argv = ["--data-name", "ml_100k", "--testing", "--epochs", "2",
            "--results-dir", os.path.join(results, mode), "--pairs", pairs,
            "--batch-size", "16"]
    if mode == "plain":
        argv += ["--ensemble", "--use-features"]
        # ml_100k's ensemble range is range(-28, 3, 10): epoch 2 only
    else:
        argv += ["--transfer", "--num-relations", "2"]
    outs = {}
    for which, main in (("jax", jax_predict_main), ("port", port_predict_main)):
        out = tmp_path / f"{which}.csv"
        extra = ["--device", "cpu"] if which == "port" else []
        main(argv + ["--out", str(out)] + extra)
        outs[which] = [line.split(",") for line in out.read_text().splitlines()]
    assert len(outs["port"]) == len(outs["jax"]) == 30
    for g, w in zip(outs["port"], outs["jax"]):
        assert g[:2] == w[:2]
        assert abs(float(g[2]) - float(w[2])) <= 1e-6 + ATOL
    assert "ensemble of 1 checkpoint(s)" in capsys.readouterr().err
    if mode == "transfer":
        with pytest.raises(SystemExit, match="--transfer needs --num-relations"):
            port_predict_main(argv[:-2] + ["--device", "cpu"])
