"""igmc_torch's dense data path against the JAX package on the CPU:
slot_perm, collate_dense (unified and bipartite), both bucket planners and
plan_dense_epoch equal JAX's exactly, and assemble_dense equals JAX's array
by array for the same gid blocks, -1 padding included. Also: the packed
tables' compaction, live_rows, and the hash dropout of assembled batches
keyed on packed edge ids (the same edges drop in any batch)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStaticGraphDataset
from igmc_tpu.batching.dense import collate_dense as jax_collate_dense
from igmc_tpu.batching.dense import plan_bipartite_buckets as jax_plan_bipartite
from igmc_tpu.batching.dense import plan_dense_buckets as jax_plan_dense
from igmc_tpu.batching.dense import slot_perm as jax_slot_perm
from igmc_tpu.batching.device_data import DeviceDataset as JaxDeviceDataset
from igmc_tpu.batching.device_data import _compact_int as jax_compact_int
from igmc_tpu.batching.device_data import assemble_dense as jax_assemble_dense
from igmc_tpu.batching.device_data import live_rows as jax_live_rows
from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
from igmc_tpu.data.synthetic import write_ml1m_format
from igmc_tpu.train.loop import plan_dense_epoch as jax_plan_dense_epoch

from igmc_torch.batching import (DenseBatch, DeviceDataset, StaticGraphDataset,
                                 assemble_dense, collate_dense, live_rows,
                                 plan_bipartite_buckets, plan_dense_buckets,
                                 slot_perm)
from igmc_torch.batching.device_data import _compact_int
from igmc_torch.data import create_trainvaltest_split
from igmc_torch.ops import edge_dropout_dense
from igmc_torch.train import DensePass, plan_buckets, plan_dense_epoch

torch.set_num_threads(1)

N_PAIRS = 120
BATCH = 8
FIELDS = ("node_label", "edge_src", "edge_dst", "edge_type", "node_mask",
          "edge_mask", "y", "graph_mask")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(JAX, port) static datasets of 120 training pairs of a 150 x 120,
    10,000-rating ml_1m fixture (h 1, at most 100 nodes per hop)."""
    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=150, n_movies=120, n_ratings=10000, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        ws = jax_split("ml_1m", seed=1234, testing=True, verbose=False)
        gs = create_trainvaltest_split("ml_1m", seed=1234, testing=True,
                                       verbose=False)
    links = (ws.train_u_indices, ws.train_v_indices)
    return (JaxStaticGraphDataset(None, ws.adj_train, links, ws.train_labels, h=1,
                                  max_nodes_per_hop=100,
                                  class_values=ws.class_values, max_num=N_PAIRS,
                                  backend="numpy", progress=False),
            StaticGraphDataset(gs.adj_train, links, gs.train_labels, h=1,
                               max_nodes_per_hop=100, class_values=gs.class_values,
                               max_num=N_PAIRS, backend="numpy"))


def assert_batch_equal(got: DenseBatch, want, what):
    assert got.num_u == want.num_u, what
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what}: {f}")


def test_slot_perm_matches_jax():
    for num_u, num_nodes in ((1, 2), (1, 5), (3, 4), (4, 9), (7, 20)):
        np.testing.assert_array_equal(slot_perm(num_u, num_nodes),
                                      jax_slot_perm(num_u, num_nodes))


def _buckets(ds, bipartite, planners, max_buckets=3):
    nu = ds.packed.num_u
    if bipartite:
        return planners[1](nu, ds.node_counts() - nu, ds.edge_counts() // 2,
                           max_buckets=max_buckets)
    return planners[0](ds.node_counts(), ds.edge_counts() // 2,
                       max_buckets=max_buckets)


def assert_buckets_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.node_slot, g.edge_slot, g.num_u_slot) == (
            w.node_slot, w.edge_slot, w.num_u_slot)
        np.testing.assert_array_equal(g.indices, w.indices)


@pytest.mark.parametrize("bipartite", [False, True])
@pytest.mark.parametrize("max_buckets", [1, 3, 5])
def test_bucket_planners_match_jax(datasets, bipartite, max_buckets):
    jds, pds = datasets
    got = _buckets(pds, bipartite, (plan_dense_buckets, plan_bipartite_buckets),
                   max_buckets)
    want = _buckets(jds, bipartite, (jax_plan_dense, jax_plan_bipartite),
                    max_buckets)
    assert_buckets_equal(got, want)
    assert len(got) <= max_buckets
    assert sorted(np.concatenate([b.indices for b in got])) == list(range(N_PAIRS))
    # plan_buckets, the loop's helper, is the same planner
    assert_buckets_equal(plan_buckets(pds, "bipartite" if bipartite else "unified",
                                      max_buckets), want)
    # power-law counts, a fine grid and an empty input
    rng = np.random.default_rng(max_buckets)
    u = rng.zipf(1.6, 500).clip(1, 300)
    v = rng.zipf(1.6, 500).clip(1, 300)
    e = (u * v * rng.uniform(0.2, 1.0, 500)).astype(np.int64)
    assert_buckets_equal(plan_bipartite_buckets(u, v, e, max_buckets, grid=64),
                         jax_plan_bipartite(u, v, e, max_buckets, grid=64))
    assert_buckets_equal(plan_dense_buckets(u + v, e, max_buckets),
                         jax_plan_dense(u + v, e, max_buckets))
    assert plan_dense_buckets([], [], max_buckets) == []


@pytest.mark.parametrize("bipartite", [False, True])
def test_collate_dense_matches_jax(datasets, bipartite):
    jds, pds = datasets
    for b in _buckets(pds, bipartite, (plan_dense_buckets, plan_bipartite_buckets)):
        idx = b.indices[:BATCH]
        got = collate_dense([pds.get(int(i)) for i in idx], BATCH + 2, b.node_slot,
                            b.edge_slot, b.num_u_slot)
        want = jax_collate_dense([jds.get(int(i)) for i in idx], BATCH + 2,
                                 b.node_slot, b.edge_slot, b.num_u_slot)
        assert_batch_equal(got, want, f"bucket {b.node_slot} x {b.edge_slot}")
        assert got.edge_id is None
        assert (got.num_graphs, got.node_slot, got.edge_slot) == (
            BATCH + 2, b.node_slot, b.edge_slot)
    g = pds.get(0)
    with pytest.raises(ValueError, match="exceeds"):
        collate_dense([g], 1, g.num_nodes - 1, len(g.src))
    with pytest.raises(ValueError, match="bipartite slot"):
        collate_dense([g], 1, g.num_nodes, len(g.src), g.num_u - 1)


@pytest.mark.parametrize("superbatch", [1, 8])
def test_plan_dense_epoch_matches_jax(datasets, superbatch):
    _, pds = datasets
    buckets = _buckets(pds, True, (plan_dense_buckets, plan_bipartite_buckets))
    for seed in (None, 1, 2):
        rng = lambda: None if seed is None else np.random.default_rng(
            np.random.SeedSequence([seed, 3]))
        got = plan_dense_epoch(buckets, BATCH, superbatch, rng())
        want = jax_plan_dense_epoch(buckets, BATCH, superbatch, rng())
        assert [bi for bi, _ in got] == [bi for bi, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g.shape == (max(superbatch, 1), BATCH)
            np.testing.assert_array_equal(g, w)
            assert live_rows(g) == jax_live_rows(w)
        # every graph once; padding rows trail their unit
        flat = np.concatenate([u.reshape(-1) for _, u in got])
        assert sorted(flat[flat >= 0]) == list(range(N_PAIRS))
        for _, u in got:
            assert not (u[live_rows(u):] >= 0).any()


def test_compaction_matches_jax():
    for a in (np.array([0, 5, 127]), np.array([-3, 200]), np.array([40000]),
              np.zeros(0, np.int64)):
        assert _compact_int(a).dtype == jax_compact_int(a).dtype
        np.testing.assert_array_equal(_compact_int(a), jax_compact_int(a))


@pytest.mark.parametrize("bipartite", [False, True])
def test_assemble_dense_matches_jax(datasets, bipartite):
    """The same gid blocks (real graphs of every bucket, -1 padding graphs
    in the middle and at the end, and an all-padding row) assemble to the
    same arrays on both sides; the port's tables keep JAX's compaction."""
    jds, pds = datasets
    dd = DeviceDataset(pds.packed, "cpu")
    jdd = JaxDeviceDataset(jds.packed, 8, 16, BATCH)
    for name in ("node_label", "src", "dst", "etype"):
        assert str(getattr(dd, name).dtype).split(".")[-1] == str(
            getattr(jdd, name).dtype)
    assert len(dd) == N_PAIRS and dd.device == torch.device("cpu")
    for b in _buckets(pds, bipartite, (plan_dense_buckets, plan_bipartite_buckets)):
        idx = b.indices.astype(np.int64)
        rows = [idx[:BATCH], np.concatenate([idx[:3], [-1], idx[3:5], [-1, -1]]),
                np.full(BATCH, -1)]
        for gids in rows:
            got = assemble_dense(dd, torch.from_numpy(gids.astype(np.int64)),
                                 b.node_slot, b.edge_slot, b.num_u_slot)
            want = jax_assemble_dense(jdd, jnp.asarray(gids, jnp.int32), b.node_slot,
                                      b.edge_slot, b.num_u_slot)
            assert_batch_equal(got, want, f"gids {gids}")
            # the same batch as collating the real graphs in their slots
            real = [pds.get(int(i)) for i in gids if i >= 0]
            if len(real) == BATCH:
                assert_batch_equal(got, collate_dense(real, BATCH, b.node_slot,
                                                      b.edge_slot, b.num_u_slot),
                                   "collate")
            # packed edge ids of the real edges
            for row, gi in enumerate(gids):
                if gi >= 0:
                    lo, hi = pds.packed.edge_offsets[gi:gi + 2]
                    np.testing.assert_array_equal(
                        got.edge_id[row, : hi - lo].numpy(), np.arange(lo, hi))


def test_dense_pass_and_dropout_follow_the_graph(datasets):
    """A DensePass holds the plan's live rows in order; a graph's edges drop
    alike in any batch it lands in (keys are packed edge ids)."""
    _, pds = datasets
    dd = DeviceDataset(pds.packed, "cpu")
    buckets = _buckets(pds, False, (plan_dense_buckets, plan_bipartite_buckets))
    rng = np.random.default_rng(np.random.SeedSequence([1, 1]))
    units = plan_dense_epoch(buckets, BATCH, 8,
                             np.random.default_rng(np.random.SeedSequence([1, 1])))
    dp = DensePass.plan(buckets, BATCH, 8, "cpu", rng)
    want = [row for _, u in units for row in u if (row >= 0).any()]
    assert dp.gids.shape == (len(want), BATCH) and dp.gids.dtype == torch.int64
    np.testing.assert_array_equal(dp.gids.numpy(), np.stack(want))
    assert len(dp.bucket_of) == len(want)

    b = buckets[0]
    g = int(b.indices[0])
    masks = []
    for gids in ([g] + [-1] * (BATCH - 1), list(b.indices[1:BATCH][::-1]) + [g]):
        batch = assemble_dense(dd, torch.tensor(gids), b.node_slot, b.edge_slot)
        row = gids.index(g)
        mf, mr = edge_dropout_dense(batch.edge_mask, batch.edge_id, 99, 0.5, False)
        masks.append((mf[row], mr[row]))
    assert torch.equal(masks[0][0], masks[1][0])
    assert torch.equal(masks[0][1], masks[1][1])
    assert not torch.equal(masks[0][0], masks[0][1])
