"""Flat collation from both engines: the C++ engine (native/extract.cpp
igmc_collate_flat) and the NumPy form it falls back to give, array for
array and dtype for dtype, the batch of a plain per-graph loop written
here (collate as it was before it read packed tables), through `collate`
(Subgraph lists) and `collate_packed` (rows of packed tables), on
batch-shaped graphs, an edgeless graph, a single graph, pads filled
exactly, with and without side features and with every keying of the
edge ids; both raise the same errors; BatchLoader yields the same
batches and plans on either engine and counts one collation a batch;
threads collating at once from the same tables each get the loop's
batch."""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from igmc_torch.batching import BatchLoader, DynamicGraphDataset, StaticGraphDataset
from igmc_torch.batching.batch import DYNAMIC_EDGE_STRIDE, collate, collate_packed
from igmc_torch.batching.dataset import _PackedGraphs
from igmc_torch.graphs import native
from igmc_torch.graphs.extract import Subgraph
from igmc_torch.utils import spans


def reference_collate(graphs, num_graphs, node_pad, edge_pad, gids=None,
                      edge_offsets=None):
    """The per-graph loop: every array of the batch, by GraphBatch's
    field names (side features None when the graphs carry none)."""
    B = num_graphs
    if len(graphs) > B:
        raise ValueError(f"{len(graphs)} graphs > batch size {B}")
    total_nodes = sum(g.num_nodes for g in graphs)
    total_edges = sum(g.num_edges for g in graphs)
    if total_nodes > node_pad or total_edges > edge_pad:
        raise ValueError(f"batch needs ({total_nodes} nodes, {total_edges} edges) "
                         f"> pad ({node_pad}, {edge_pad})")
    a = dict(node_label=np.zeros(node_pad, np.int32),
             edge_src=np.zeros(edge_pad, np.int32),
             edge_dst=np.zeros(edge_pad, np.int32),
             edge_type=np.zeros(edge_pad, np.int32),
             edge_canon=np.arange(edge_pad, dtype=np.int32),
             node2graph=np.zeros(node_pad, np.int32),
             node_mask=np.zeros(node_pad, bool),
             edge_mask=np.zeros(edge_pad, bool),
             y=np.zeros(B, np.float32), graph_mask=np.zeros(B, bool),
             target_u=np.zeros(B, np.int32), target_v=np.zeros(B, np.int32),
             u_feat=None, v_feat=None, edge_id=np.zeros(edge_pad, np.int64))
    if graphs and graphs[0].u_feat is not None:
        a["u_feat"] = np.zeros((B, len(graphs[0].u_feat)), np.float32)
        a["v_feat"] = np.zeros((B, len(graphs[0].v_feat)), np.float32)
    base = None
    if gids is not None:
        gids = np.asarray(gids, dtype=np.int64)
        base = (gids * DYNAMIC_EDGE_STRIDE if edge_offsets is None
                else np.asarray(edge_offsets, dtype=np.int64)[gids])
    n_off = e_off = 0
    for gi, g in enumerate(graphs):
        n, ne = g.num_nodes, len(g.src)
        a["node_label"][n_off:n_off + n] = g.node_label
        a["node2graph"][n_off:n_off + n] = gi
        a["node_mask"][n_off:n_off + n] = True
        f, r = slice(e_off, e_off + ne), slice(e_off + ne, e_off + 2 * ne)
        a["edge_src"][f], a["edge_dst"][f] = g.src + n_off, g.dst + n_off
        a["edge_src"][r], a["edge_dst"][r] = g.dst + n_off, g.src + n_off
        a["edge_type"][f] = a["edge_type"][r] = g.etype
        a["edge_canon"][r] = np.arange(e_off, e_off + ne)
        a["edge_mask"][e_off:e_off + 2 * ne] = True
        ids = np.arange(e_off, e_off + ne) if base is None else base[gi] + np.arange(ne)
        a["edge_id"][f] = a["edge_id"][r] = ids
        a["y"][gi], a["graph_mask"][gi] = g.y, True
        a["target_u"][gi], a["target_v"][gi] = n_off, n_off + g.num_u
        if a["u_feat"] is not None:
            a["u_feat"][gi], a["v_feat"][gi] = g.u_feat, g.v_feat
        n_off += n
        e_off += 2 * ne
    return a


def make_graphs(count, nodes, edges, R=5, features=False, seed=0, spread=0.1):
    """`count` random subgraphs of about `nodes` nodes (a third users) and
    about `edges` forward edges each, in the extraction's layout."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = max(2, int(nodes * rng.uniform(1 - spread, 1)))
        ne = int(edges * rng.uniform(1 - spread, 1))
        nu = max(1, n // 3)
        label = np.concatenate([2 * rng.integers(0, 2, nu),
                                2 * rng.integers(0, 2, n - nu) + 1]).astype(np.int32)
        label[0], label[nu] = 0, 1
        out.append(Subgraph(
            src=rng.integers(0, nu, ne).astype(np.int32),
            dst=rng.integers(nu, n, ne).astype(np.int32),
            etype=rng.integers(0, R, ne).astype(np.int32),
            node_label=label, num_u=nu, num_v=n - nu,
            y=float(rng.integers(1, 6)) + 0.1,
            u_feat=rng.random(7).astype(np.float32) if features else None,
            v_feat=rng.random(5).astype(np.float32) if features else None))
    return out


def edgeless(n=6):
    return Subgraph(src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
                    etype=np.zeros(0, np.int32),
                    node_label=np.array([0, 2, 1, 3, 3, 1][:n], np.int32),
                    num_u=2, num_v=n - 2, y=3.5,
                    u_feat=np.ones(7, np.float32), v_feat=np.ones(5, np.float32))


def exact_pads(graphs):
    return (sum(g.num_nodes for g in graphs), sum(g.num_edges for g in graphs))


# name: (graphs, num_graphs, node_pad, edge_pad); pads None: filled exactly
CASES = {
    "batch": (lambda f: make_graphs(50, 256, 2230, features=f), 50, 12800, 286152),
    "edgeless_among": (lambda f: [edgeless() if f else
                                  dataclasses.replace(edgeless(), u_feat=None, v_feat=None)]
                       + make_graphs(4, 30, 40, features=f, seed=1), 8, 256, 512),
    "single": (lambda f: make_graphs(1, 40, 90, features=f, seed=2), 1, 64, 256),
    "exact": (lambda f: make_graphs(12, 50, 120, features=f, seed=3), 12, None, None),
    "exact_short": (lambda f: make_graphs(9, 50, 120, features=f, seed=4), 16, None, None),
    "none": (lambda f: [], 4, 64, 128),
}
IDS = ("none", "offsets", "dynamic")


def use_engine(monkeypatch, engine):
    """Collate on `engine`: skip without the C++ engine, or hide it."""
    if engine == "native":
        if not native.available():
            pytest.skip("the C++ engine is not built (no g++?)")
    else:
        monkeypatch.setattr(native, "available", lambda: False)


def assert_batch_equals(batch, want):
    for f in dataclasses.fields(batch):
        if f.name not in want:
            assert getattr(batch, f.name) is None, f.name
            continue
        got, ref = getattr(batch, f.name), want[f.name]
        if ref is None:
            assert got is None, f.name
            continue
        assert isinstance(got, torch.Tensor), f.name
        got = got.numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, f.name
        np.testing.assert_array_equal(got, ref, err_msg=f.name)


def case_data(case, features):
    make, B, node_pad, edge_pad = CASES[case]
    graphs = make(features)
    if node_pad is None:
        node_pad, edge_pad = exact_pads(graphs)
    return graphs, B, node_pad, edge_pad


def id_keys(ids, n, rng):
    """(gids, edge_offsets) for the graphs of a collate call."""
    if ids == "none":
        return None, None
    gids = rng.choice(10 * n + 10, n, replace=False)
    offsets = np.cumsum(rng.integers(0, 5000, 10 * n + 11)) if ids == "offsets" else None
    return gids, offsets


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("ids", IDS)
@pytest.mark.parametrize("features", [False, True], ids=["plain", "features"])
@pytest.mark.parametrize("case", list(CASES))
def test_collate_equals_the_loop(case, features, ids, engine, monkeypatch):
    graphs, B, node_pad, edge_pad = case_data(case, features)
    gids, offsets = id_keys(ids, len(graphs), np.random.default_rng(5))
    use_engine(monkeypatch, engine)
    want = reference_collate(graphs, B, node_pad, edge_pad, gids, offsets)
    got = collate(graphs, B, node_pad, edge_pad, gids=gids, edge_offsets=offsets)
    assert_batch_equals(got, want)
    if case == "exact":
        assert want["node_mask"].all() and want["edge_mask"].all()


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("ids", IDS)
@pytest.mark.parametrize("features", [False, True], ids=["plain", "features"])
@pytest.mark.parametrize("case", ["batch", "edgeless_among", "single", "exact"])
def test_collate_packed_equals_the_loop_over_its_rows(case, features, ids, engine,
                                                      monkeypatch):
    """Rows of a dataset's tables (graphs of other batches around them, in
    another order); gids None collates every row in order."""
    graphs, B, node_pad, edge_pad = case_data(case, features)
    others = make_graphs(7, 60, 100, features=features, seed=9)
    packed = _PackedGraphs(others[:3] + graphs + others[3:])
    rows = 3 + np.random.default_rng(6).permutation(len(graphs))
    offsets = packed.edge_offsets if ids == "offsets" else None
    use_engine(monkeypatch, engine)
    if ids == "none":      # no ids: every row of a table of just these graphs
        packed, rows = _PackedGraphs([graphs[i - 3] for i in rows]), None
        got = collate_packed(packed, None, B, node_pad, edge_pad)
        want = reference_collate([packed.get(i) for i in range(len(packed))], B,
                                 node_pad, edge_pad)
    else:
        got = collate_packed(packed, rows, B, node_pad, edge_pad, edge_offsets=offsets)
        want = reference_collate([packed.get(int(i)) for i in rows], B, node_pad,
                                 edge_pad, rows, offsets)
    assert_batch_equals(got, want)


def reference_error(*args):
    with pytest.raises(ValueError) as e:
        reference_collate(*args)
    return str(e.value)


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("fault", ["nodes", "edges", "graphs"])
def test_both_engines_raise_the_loops_errors(fault, engine, monkeypatch):
    graphs = make_graphs(6, 40, 80, seed=7)
    n, e = exact_pads(graphs)
    B, node_pad, edge_pad = {"nodes": (6, n - 1, e), "edges": (6, n, e - 1),
                             "graphs": (5, n, e)}[fault]
    message = reference_error(graphs, B, node_pad, edge_pad)
    use_engine(monkeypatch, engine)
    with pytest.raises(ValueError) as got:
        collate(graphs, B, node_pad, edge_pad)
    assert str(got.value) == message
    packed = _PackedGraphs(graphs[::-1] + graphs)
    rows = np.arange(6, 12)
    with pytest.raises(ValueError) as got:
        collate_packed(packed, rows, B, node_pad, edge_pad, packed.edge_offsets)
    assert str(got.value) == message
    # the pads exactly filled are no fault
    collate_packed(packed, rows, 6, n, e, packed.edge_offsets)


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_both_engines_refuse_rows_outside_the_tables(engine, monkeypatch):
    packed = _PackedGraphs(make_graphs(4, 30, 40, seed=8))
    use_engine(monkeypatch, engine)
    for rows in ([0, 4], [-1, 2]):
        with pytest.raises(IndexError, match=r"^graph rows outside \[0, 4\)$"):
            collate_packed(packed, rows, 4, 512, 1024)


def rating_dataset(cls=StaticGraphDataset, n=140, seed=0):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    M = sp.random(60, 70, density=0.12, format="csr",
                  random_state=np.random.RandomState(seed))
    M.data = rng.integers(1, 6, M.nnz).astype(np.float64)
    u, v = M.nonzero()
    labels = (M[u[:n], v[:n]].A1 - 1).astype(np.int64)
    kw = dict(progress=False) if cls is StaticGraphDataset else {}
    return cls(M, (u[:n], v[:n]), labels, h=1, class_values=np.arange(1.0, 6.0),
               backend="numpy", **kw)


def loader_pass(dataset, engine, monkeypatch, **kw):
    """Every batch of one pass of a BatchLoader on `engine`, and the
    counters and span calls of the pass."""
    with monkeypatch.context() as m:
        use_engine(m, engine)
        spans.reset()
        spans.enable()
        try:
            batches = list(BatchLoader(dataset, 50, seed=5, prefetch=2, **kw))
            snap = spans.snapshot()
        finally:
            spans.disable()
            spans.reset()
    return batches, snap


def tensors_of(batch):
    """Every tensor of a batch, its plans' included, by name."""
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, tuple):
            out.update({f"{f.name}[{i}]": a for i, a in enumerate(v)})
        elif isinstance(v, torch.Tensor):
            out[f.name] = v
    return out


def test_loader_batches_and_plans_are_the_same_on_both_engines_and_counted(
        monkeypatch):
    use_engine(monkeypatch, "native")
    dataset = rating_dataset()
    kw = dict(shuffle=True, flat_aggregate="pallas")
    got, snap = loader_pass(dataset, "native", monkeypatch, **kw)
    want, snap_numpy = loader_pass(dataset, "numpy", monkeypatch, **kw)
    batches = -(-len(dataset) // 50)
    assert snap["counters"]["batch.collate_native"] == batches
    assert "batch.collate_numpy" not in snap["counters"]
    assert snap_numpy["counters"]["batch.collate_numpy"] == batches
    assert "batch.collate_native" not in snap_numpy["counters"]
    # a packed dataset's flat batches fetch no Subgraph
    assert "loader.fetch" not in snap["spans"]
    assert snap["spans"]["loader.collate"]["calls"] == batches
    order = np.random.default_rng(np.random.SeedSequence([5, 0])).permutation(len(dataset))
    assert len(got) == len(want) == batches
    for k, (a, b) in enumerate(zip(got, want)):
        ta, tb = tensors_of(a), tensors_of(b)
        assert ta.keys() == tb.keys() and "aligned_t[0]" in ta
        for name in ta:
            assert ta[name].dtype == tb[name].dtype and torch.equal(ta[name], tb[name]), name
        assert a.plan_rows == b.plan_rows
        idxs = order[50 * k: 50 * (k + 1)]
        ref = reference_collate([dataset.get(int(i)) for i in idxs], 50,
                                a.num_nodes, a.num_edges, idxs, dataset.packed.edge_offsets)
        assert_batch_equals(dataclasses.replace(a, aligned=None, aligned_t=None,
                                                plan_rows=None), ref)


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_dynamic_loader_collates_fetched_graphs_with_dynamic_ids(engine, monkeypatch):
    use_engine(monkeypatch, engine)
    dataset = rating_dataset(DynamicGraphDataset, n=60)
    batches, snap = loader_pass(dataset, engine, monkeypatch)
    assert snap["counters"][f"batch.collate_{engine}"] == len(batches) == 2
    assert snap["spans"]["loader.fetch"]["calls"] == 2
    for k, b in enumerate(batches):
        idxs = np.arange(50 * k, min(50 * (k + 1), len(dataset)))
        ref = reference_collate(dataset.get_many(idxs), 50, b.num_nodes, b.num_edges, idxs)
        assert_batch_equals(b, ref)


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_threads_collating_at_once_from_shared_tables_get_the_loops_batches(
        engine, monkeypatch):
    use_engine(monkeypatch, engine)
    graphs = make_graphs(120, 60, 150, features=True, seed=11)
    packed = _PackedGraphs(graphs)
    threads = len(os.sched_getaffinity(0)) + 3
    rounds = 6
    rng = np.random.default_rng(12)
    jobs = [[rng.choice(len(graphs), 20, replace=False) for _ in range(rounds)]
            for _ in range(threads)]
    want = {(t, r): reference_collate([graphs[i] for i in rows], 24, 1600, 7200, rows,
                                      packed.edge_offsets)
            for t, rs in enumerate(jobs) for r, rows in enumerate(rs)}
    got, errors = {}, []
    start = threading.Barrier(threads)

    def work(t):
        try:
            start.wait(timeout=30)
            for r, rows in enumerate(jobs[t]):
                got[(t, r)] = collate_packed(packed, rows, 24, 1600, 7200,
                                             packed.edge_offsets)
        except Exception as e:         # reported below, with the thread
            errors.append((t, e))

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(was)
    assert errors == []
    assert got.keys() == want.keys()
    for key, batch in got.items():
        assert_batch_equals(batch, want[key])
