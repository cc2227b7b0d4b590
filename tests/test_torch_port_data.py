"""igmc_torch data path against the JAX package on a small ML-1M-format
fixture: the split, every extracted subgraph (NumPy engine on both sides,
with and without a binding per-hop cap), and the collated flat batches with
their aligned edge plans. All comparisons are exact."""

import dataclasses

import numpy as np
import pytest
import torch

from igmc_tpu.batching.dataset import BatchLoader as JaxBatchLoader
from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStaticGraphDataset
from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
from igmc_tpu.data.synthetic import write_ml1m_format
from igmc_tpu.graphs.csr import BipartiteCSR as JaxBipartiteCSR
from igmc_tpu.graphs.extract import extract_many as jax_extract_many

from igmc_torch.batching import BatchLoader, StaticGraphDataset
from igmc_torch.batching import dataset as port_dataset
from igmc_torch.data import create_trainvaltest_split, load_data
from igmc_torch.data.loaders import _cf_nade_shuffle, map_data
from igmc_torch.graphs import BipartiteCSR, extract_many

torch.set_num_threads(1)

SPLIT_FIELDS = ("train_labels", "train_u_indices", "train_v_indices",
                "val_labels", "val_u_indices", "val_v_indices",
                "test_labels", "test_u_indices", "test_v_indices",
                "class_values")


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """(JAX split, port split) of a 300 x 400, 8,000-rating ml_1m fixture."""
    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=300, n_movies=400, n_ratings=8000,
                      seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        want = jax_split("ml_1m", seed=1234, testing=True, verbose=False)
        got = create_trainvaltest_split("ml_1m", seed=1234, testing=True,
                                        verbose=False)
    return want, got


def test_split_matches_jax(splits):
    want, got = splits
    for f in SPLIT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    a, b = got.adj_train.tocsr(), want.adj_train.tocsr()
    assert a.shape == b.shape and a.dtype == b.dtype
    for part in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, part), getattr(b, part))
    assert got.u_features is None and got.v_features is None


def test_non_testing_split_matches_jax(tmp_path, monkeypatch):
    """testing=False keeps validation apart; rating_map rebuckets labels,
    post_rating_map only the adjacency values; ratio thins the train set."""
    write_ml1m_format(str(tmp_path), n_users=80, n_movies=60, n_ratings=900,
                      seed=4)
    monkeypatch.setenv("IGMC_RAW_DATA", str(tmp_path))
    rmap = {1.0: 1.0, 2.0: 1.0, 3.0: 3.0, 4.0: 5.0, 5.0: 5.0}
    for kw in ({"testing": False}, {"testing": True, "rating_map": rmap},
               {"testing": True, "post_rating_map": rmap, "ratio": 0.5}):
        want = jax_split("ml_1m", seed=7, verbose=False, **kw)
        got = create_trainvaltest_split("ml_1m", seed=7, verbose=False, **kw)
        for f in SPLIT_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{kw} {f}")
        assert (got.adj_train != want.adj_train).nnz == 0


def test_cf_nade_shuffle_matches_list_shuffle():
    """Shuffling row indices with random.Random(seed) gives the reference's
    random.seed(seed); random.shuffle(list of rows) order."""
    import random

    rows = np.arange(1000 * 4).reshape(1000, 4)
    ref = rows.tolist()
    random.seed(1234)
    random.shuffle(ref)
    np.testing.assert_array_equal(_cf_nade_shuffle(rows, 1234), np.array(ref))


def test_map_data_and_missing_dataset(tmp_path, monkeypatch):
    mapped, ids, n = map_data(np.array([30, 10, 20, 10]))
    np.testing.assert_array_equal(mapped, [2, 0, 1, 0])
    assert ids == {10: 0, 20: 1, 30: 2} and n == 3
    monkeypatch.setenv("IGMC_RAW_DATA", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="ml_1m"):
        load_data("ml_1m")
    with pytest.raises(NotImplementedError):
        load_data("ml_100k")


SUBGRAPH_FIELDS = ("src", "dst", "etype", "node_label", "num_u", "num_v", "y")


@pytest.mark.parametrize("h,mnph", [(1, None), (1, 100), (1, 3), (2, 4)])
def test_extraction_matches_jax_numpy_engine(splits, h, mnph):
    want_split, got_split = splits
    links = (want_split.test_u_indices[:150], want_split.test_v_indices[:150])
    labels = want_split.test_labels[:150]
    want = jax_extract_many(links, labels, JaxBipartiteCSR(want_split.adj_train),
                            h, 1.0, mnph, None, None, want_split.class_values,
                            seed=5, backend="numpy")
    got = extract_many(links, labels, BipartiteCSR(got_split.adj_train), h, 1.0,
                       mnph, got_split.class_values, seed=5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in SUBGRAPH_FIELDS:
            gv, wv = getattr(g, f), getattr(w, f)
            np.testing.assert_array_equal(gv, wv, err_msg=f)
            if isinstance(wv, np.ndarray):
                assert gv.dtype == wv.dtype, f
    if mnph == 3:   # the cap binds: some fringe was cut to 3 nodes
        full = extract_many(links, labels, BipartiteCSR(got_split.adj_train),
                            h, 1.0, None, got_split.class_values, seed=5)
        assert any(f.num_u > g.num_u for f, g in zip(full, got))


BATCH_FIELDS = ("node_label", "edge_src", "edge_dst", "edge_type", "edge_canon",
                "node2graph", "node_mask", "edge_mask", "y", "graph_mask",
                "target_u", "target_v")


@pytest.mark.parametrize("mnph,rows,eblk", [(100, 256, 1024), (3, 32, 128)])
def test_batches_match_jax_pallas_loader(splits, monkeypatch, mnph, rows, eblk):
    want_split, got_split = splits
    # the port's plan geometry is a pair of module constants; JAX's loader
    # takes it as arguments
    monkeypatch.setattr(port_dataset, "PLAN_ROWS", rows)
    monkeypatch.setattr(port_dataset, "PLAN_EBLK", eblk)
    n = 120
    links = (want_split.test_u_indices, want_split.test_v_indices)
    want_ds = JaxStaticGraphDataset(
        None, want_split.adj_train, links, want_split.test_labels, h=1,
        max_nodes_per_hop=mnph, class_values=want_split.class_values,
        max_num=n, backend="numpy", progress=False)
    got_ds = StaticGraphDataset(
        got_split.adj_train, links, got_split.test_labels, h=1,
        max_nodes_per_hop=mnph, class_values=got_split.class_values, max_num=n)
    np.testing.assert_array_equal(got_ds.node_counts(), want_ds.node_counts())
    np.testing.assert_array_equal(got_ds.edge_counts(), want_ds.edge_counts())

    want_loader = JaxBatchLoader(want_ds, 50, device_put=False, prefetch=0,
                                 flat_aggregate="pallas", plan_rows=rows,
                                 plan_eblk=eblk)
    got_loader = BatchLoader(got_ds, 50)
    assert got_loader.node_ladder == want_loader.node_ladder
    assert got_loader.edge_ladder == want_loader.edge_ladder
    want_batches, got_batches = list(want_loader), list(got_loader)
    assert len(got_batches) == len(want_batches) == len(got_loader) == 3
    for g, w in zip(got_batches, want_batches):
        for f in BATCH_FIELDS:
            gv, wv = getattr(g, f), np.asarray(getattr(w, f))
            assert isinstance(gv, torch.Tensor), f
            np.testing.assert_array_equal(gv.numpy(), wv, err_msg=f)
            assert gv.numpy().dtype == wv.dtype, f
        assert len(g.aligned) == 6
        for ga, wa in zip(g.aligned, w.aligned[:6]):
            np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
            assert ga.numpy().dtype == np.asarray(wa).dtype
        assert g.num_nodes % rows == 0


def test_graph_batch_to_moves_every_tensor(splits):
    _, got_split = splits
    ds = StaticGraphDataset(
        got_split.adj_train, (got_split.test_u_indices, got_split.test_v_indices),
        got_split.test_labels, h=1, class_values=got_split.class_values,
        max_num=10)
    batch = next(iter(BatchLoader(ds, 10)))
    moved = batch.to("meta")
    for f in dataclasses.fields(moved):
        if f.name != "aligned":
            assert getattr(moved, f.name).device.type == "meta", f.name
    assert all(a.device.type == "meta" for a in moved.aligned)
    assert batch.edge_src.device.type == "cpu"   # the original stays put
