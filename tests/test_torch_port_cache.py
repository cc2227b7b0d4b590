"""igmc_torch's caches against the JAX package's, on the CPU: the `.npz`
subgraph cache (same file name, equal arrays, written by either package
and loaded by the other without extracting), the split pickle (either
way), the synthetic MovieLens files (byte for byte), and the CLI: a second
run on the same data root, and a run after the JAX CLI's, load the caches
and the split pickle instead of extracting and parsing, with the same
RMSE; --reprocess extracts again."""

import os
import re

import numpy as np
import pytest
import torch

import igmc_tpu.batching.dataset as jax_dataset_mod
from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStaticGraphDataset
from igmc_tpu.cli.main import main as jax_main
from igmc_tpu.data import synthetic as jax_synthetic
from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
from igmc_tpu.graphs.csr import BipartiteCSR as JaxBipartiteCSR

import igmc_torch.batching.dataset as port_dataset_mod
import igmc_torch.data.splits as port_splits_mod
from igmc_torch.batching import StaticGraphDataset
from igmc_torch.cli.main import main as port_main
from igmc_torch.data import create_trainvaltest_split, synthetic as port_synthetic
from igmc_torch.graphs import BipartiteCSR

torch.set_num_threads(1)

ARRAYS = ("node_offsets", "edge_offsets", "node_label", "src", "dst", "etype",
          "num_u", "y", "u_feat", "v_feat")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    jax_synthetic.write_ml1m_format(str(root), n_users=150, n_movies=120,
                                    n_ratings=10000, seed=0)
    return str(root)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The JAX package's testing split of a 60 x 50, 1,200-rating ml_1m
    fixture with side features."""
    root = tmp_path_factory.mktemp("raw_small")
    jax_synthetic.write_ml1m_format(str(root), n_users=60, n_movies=50,
                                    n_ratings=1200, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        return jax_split("ml_1m", seed=1234, testing=True, verbose=False)


def no_extraction(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("extracted although a cache was there")
    monkeypatch.setattr(port_dataset_mod, "extract_many", refuse)
    monkeypatch.setattr(jax_dataset_mod, "extract_many", refuse)


def packed_equal(got, want):
    for k in ARRAYS:
        g, w = getattr(got, k), getattr(want, k)
        if w is None:
            assert g is None, k
        else:
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


CASES = {
    "plain": dict(max_nodes_per_hop=200),
    "max_num": dict(max_nodes_per_hop=200, max_num=70),
    "features": dict(max_nodes_per_hop=200, features=True),
    "subsampled": dict(max_nodes_per_hop=5, sample_ratio=0.8, seed=3, max_num=90),
    "scipy_adjacency": dict(max_nodes_per_hop=200, csr=False),
}


def build(which, split, root, kw):
    kw = dict(kw)
    links = (split.train_u_indices, split.train_v_indices)
    csr = kw.pop("csr", True)
    if kw.pop("features", False):
        kw.update(u_features=split.u_features, v_features=split.v_features)
    common = dict(h=1, class_values=split.class_values, backend="numpy", **kw)
    if which == "jax":
        A = JaxBipartiteCSR(split.adj_train) if csr else split.adj_train
        return JaxStaticGraphDataset(root, A, links, split.train_labels,
                                     progress=False, **common)
    A = BipartiteCSR(split.adj_train) if csr else split.adj_train
    return StaticGraphDataset(A, links, split.train_labels, root=root, **common)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_subgraph_cache_is_shared_across_packages(split, tmp_path, monkeypatch,
                                                  writer, case):
    """One package writes <root>/processed/data_<key>.npz; the other,
    given the same inputs, finds the same file name and loads it without
    extracting, with every array equal (dtypes included)."""
    reader = "port" if writer == "jax" else "jax"
    root = str(tmp_path / "train")
    written = build(writer, split, root, CASES[case])
    files = os.listdir(os.path.join(root, "processed"))
    assert len(files) == 1 and files[0].startswith("data_h1_sr")
    if "seed" in CASES[case]:
        assert "_s3_bnumpy_m90.npz" in files[0]
    no_extraction(monkeypatch)
    read = build(reader, split, root, CASES[case])
    assert os.listdir(os.path.join(root, "processed")) == files
    packed_equal(read.packed, written.packed)
    if reader == "port":
        assert read.cache_path == os.path.join(root, "processed", files[0])


def test_cache_key_follows_the_inputs(split, tmp_path):
    """Another rating graph value, another per-hop cap or another max_num
    write another file; the same inputs load the file (the port)."""
    root = str(tmp_path / "train")
    a = build("port", split, root, dict(max_nodes_per_hop=200))
    b = build("port", split, root, dict(max_nodes_per_hop=200, max_num=50))
    c = build("port", split, root, dict(max_nodes_per_hop=7))
    split2 = type(split)(**{**vars(split), "adj_train": split.adj_train * 2})
    d = build("port", split2, root, dict(max_nodes_per_hop=200))
    assert len({a.cache_path, b.cache_path, c.cache_path, d.cache_path}) == 4
    assert len(os.listdir(os.path.join(root, "processed"))) == 4
    again = build("port", split, root, dict(max_nodes_per_hop=200))
    assert again.cache_path == a.cache_path
    packed_equal(again.packed, a.packed)


def split_equal(got, want):
    for k, w in vars(want).items():
        g = getattr(got, k)
        if hasattr(w, "toarray"):
            np.testing.assert_array_equal(g.toarray(), w.toarray(), err_msg=k)
        elif w is None:
            assert g is None, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_split_pickle_is_shared_across_packages(raw, tmp_path, monkeypatch, capsys,
                                                writer):
    """One package writes the split pickle; the other reads it instead of
    the raw files (its loader refuses to run), printing the JAX package's
    lines, and builds the same split (the valmode split here)."""
    monkeypatch.setenv("IGMC_RAW_DATA", raw)
    path = str(tmp_path / "raw_data" / "ml_1m" / "split_seed1234.pickle")
    make = {"jax": jax_split, "port": create_trainvaltest_split}
    reader = "port" if writer == "jax" else "jax"
    want = make[writer]("ml_1m", 1234, False, path, True, False)
    assert os.path.isfile(path)

    def refuse(*a, **k):
        raise AssertionError("read the raw files although the pickle was there")
    monkeypatch.setattr(port_splits_mod, "load_data", refuse)
    monkeypatch.setattr("igmc_tpu.data.splits.load_data", refuse)
    lines = {}
    for w in (reader, writer):
        capsys.readouterr()
        got = make[w]("ml_1m", 1234, False, path, True, True)
        lines[w] = capsys.readouterr().out
        split_equal(got, want)
    assert lines["jax"] == lines["port"]
    assert lines["port"].startswith("Reading processed dataset from file...\n"
                                    "Number of users = ")


@pytest.mark.parametrize("writer,kw", [
    ("write_ml1m_format", dict(n_users=60, n_movies=50, n_ratings=900, seed=2)),
    ("write_ml100k_format", dict(n_users=40, n_movies=30, n_ratings=500, seed=1)),
    ("write_ml25m_format", dict(n_users=50, n_movies=80, n_ratings=1200, seed=3)),
])
def test_synthetic_files_equal_jax_byte_for_byte(tmp_path, writer, kw):
    out = {}
    for name, mod in (("jax", jax_synthetic), ("port", port_synthetic)):
        d = getattr(mod, writer)(str(tmp_path / name), **kw)
        out[name] = {f: open(os.path.join(d, f), "rb").read()
                     for f in sorted(os.listdir(d))}
    assert out["port"].keys() == out["jax"].keys() and len(out["port"]) >= 1
    for f, data in out["jax"].items():
        assert out["port"][f] == data, f
    u, m, r = port_synthetic.synthesize_ratings(20, 15, 100, seed=5)
    for a, b in zip((u, m, r), jax_synthetic.synthesize_ratings(20, 15, 100, seed=5)):
        np.testing.assert_array_equal(a, b)


ARGV = ["--data-name", "ml_1m", "--testing", "--max-nodes-per-hop", "20",
        "--max-train-num", "150", "--max-test-num", "60", "--batch-size", "25",
        "--epochs", "2"]
LOG_RMSE = re.compile(r"test rmse (\d+\.\d{6})$")


def run(which, argv, raw, cwd, monkeypatch):
    monkeypatch.setenv("IGMC_RAW_DATA", raw)
    os.makedirs(cwd, exist_ok=True)
    monkeypatch.chdir(cwd)
    if which == "jax":
        jax_main(argv)
        return None
    port_main(argv + ["--device", "cpu"])
    log = os.path.join(cwd, "results", "ml_1m_testmode", "log.txt")
    return [float(LOG_RMSE.search(l).group(1)) for l in open(log).read().splitlines()]


def test_second_cli_run_loads_the_caches_and_the_split_pickle(raw, tmp_path,
                                                               monkeypatch):
    """Run 1 writes data/ml_1m/testmode/{train,test}/processed/*.npz and
    raw_data/ml_1m/split_seed1234.pickle; run 2 in the same directory
    extracts nothing and reads no raw file, and logs the same RMSEs (the
    same graphs, init and noise: CPU training is deterministic); with
    --reprocess it extracts again."""
    cwd = str(tmp_path / "run")
    first = run("port", ARGV, raw, cwd, monkeypatch)
    caches = sorted(os.path.relpath(os.path.join(d, f), cwd)
                    for d, _, fs in os.walk(os.path.join(cwd, "data")) for f in fs)
    assert [c.split(os.sep)[:4] for c in caches] == [
        ["data", "ml_1m", "testmode", "test"], ["data", "ml_1m", "testmode", "train"]]
    assert os.path.isfile(os.path.join(cwd, "raw_data", "ml_1m",
                                       "split_seed1234.pickle"))
    os.remove(os.path.join(cwd, "results", "ml_1m_testmode", "log.txt"))
    with monkeypatch.context() as mp:
        no_extraction(mp)
        mp.setattr(port_splits_mod, "load_data", lambda *a, **k: 1 / 0)
        second = run("port", ARGV, raw, cwd, monkeypatch)
    assert second == first and len(first) == 2 and np.isfinite(first).all()
    calls = []
    real = port_dataset_mod.extract_many
    monkeypatch.setattr(port_dataset_mod, "extract_many",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    os.remove(os.path.join(cwd, "results", "ml_1m_testmode", "log.txt"))
    assert run("port", ARGV + ["--reprocess"], raw, cwd, monkeypatch) == first
    assert len(calls) == 2                       # train and test extracted again


def test_port_cli_runs_on_the_jax_clis_caches(raw, tmp_path, monkeypatch):
    """The JAX CLI (--no-train, with --use-features) writes the subgraph
    caches and the withfeatures_ split pickle; the port CLI in the same
    directory trains on them without extracting or parsing."""
    cwd = str(tmp_path / "run")
    argv = ARGV + ["--use-features", "--data-appendix", "_x"]
    run("jax", argv + ["--no-train"], raw, cwd, monkeypatch)
    assert os.path.isfile(os.path.join(cwd, "raw_data", "ml_1m",
                                       "withfeatures_split_seed1234.pickle"))
    assert os.path.isdir(os.path.join(cwd, "data", "ml_1m_x", "testmode", "train",
                                      "processed"))
    no_extraction(monkeypatch)
    monkeypatch.setattr(port_splits_mod, "load_data", lambda *a, **k: 1 / 0)
    rmses = run("port", argv, raw, cwd, monkeypatch)
    assert len(rmses) == 2 and np.isfinite(rmses).all()
