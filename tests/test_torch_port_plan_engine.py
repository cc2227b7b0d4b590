"""The fused aggregate's block plans from both engines: the C++ engine
(native/extract.cpp igmc_plan_blocks) and the NumPy form it falls back to
give, array for array, the plan of a plain reference written here (Python's
stable sort by (scatter row, etype), placed block by block), for the
forward plan and its twin, with and without pair ids, on batch-shaped
edge lists; both raise the same errors; BatchLoader attaches the same
plans on either engine and counts them."""

import functools

import numpy as np
import pytest
import torch

from igmc_torch.batching import BatchLoader, StaticGraphDataset
from igmc_torch.graphs import native
from igmc_torch.kernels.rgcn_aggregate import (block_align_edges,
                                               block_align_edges_transposed,
                                               plan_capacity_blocks)
from igmc_torch.utils import spans

def batch_edges(graphs, nodes, edges, R, node_pad, edge_pad, holes=0.0,
                hot=0.0, seed=0):
    """The edge arrays of a collated batch: `graphs` graphs of `nodes` nodes
    side by side (users in the first third), each with `edges` rating
    edges stored in both directions as collate stores them (edge_canon of
    both copies the forward copy's slot), padding after; `holes` masks a
    share of the real slots out, `hot` sends a share of each graph's edges
    to its first item (a row whose chunk needs several blocks)."""
    rng = np.random.default_rng(seed)
    src, dst, etype, canon = [], [], [], []
    off = 0
    nu = max(1, nodes // 3)
    for g in range(graphs):
        u = rng.integers(0, nu, edges) + g * nodes
        v = rng.integers(nu, nodes, edges) + g * nodes
        v[rng.random(edges) < hot] = nu + g * nodes
        r = rng.integers(0, R, edges)
        fwd = np.arange(off, off + edges)
        src += [u, v]
        dst += [v, u]
        etype += [r, r]
        canon += [fwd, fwd]
        off += 2 * edges
    pad = edge_pad - off
    cat = lambda parts, fill: np.concatenate(parts + [fill]).astype(np.int32)
    src = cat(src, np.zeros(pad))
    dst = cat(dst, np.zeros(pad))
    etype = cat(etype, np.zeros(pad))
    canon = cat(canon, np.arange(off, edge_pad))
    mask = np.arange(edge_pad) < off
    mask &= rng.random(edge_pad) >= holes
    return src, dst, etype, mask, canon, node_pad


CASES = {
    # name: (batch_edges arguments, rows, eblk, num_blocks)
    "cell": (dict(graphs=50, nodes=256, edges=2230, R=5, node_pad=12800,
                  edge_pad=286152), 256, 1024, "capacity"),
    "r71": (dict(graphs=50, nodes=36, edges=150, R=71, node_pad=2048,
                 edge_pad=16384, holes=0.05), 256, 1024, "capacity"),
    "rows128": (dict(graphs=20, nodes=100, edges=600, R=5, node_pad=2048,
                     edge_pad=30000), 128, 512, "capacity"),
    "rows512": (dict(graphs=20, nodes=200, edges=1500, R=5, node_pad=4096,
                     edge_pad=65536), 512, 2048, "capacity"),
    "empty_chunks": (dict(graphs=4, nodes=64, edges=300, R=5, node_pad=2048,
                          edge_pad=4096), 256, 1024, None),
    "several_blocks": (dict(graphs=2, nodes=256, edges=3000, R=5, node_pad=512,
                            edge_pad=12800, hot=0.5), 256, 256, None),
    "padding_blocks": (dict(graphs=6, nodes=40, edges=80, R=5, node_pad=256,
                            edge_pad=1024, holes=0.1), 64, 128, "+7"),
    "no_edges": (dict(graphs=3, nodes=40, edges=0, R=5, node_pad=512,
                      edge_pad=512), 128, 256, None),
}


def reference_plan(scatter, gather, etype, mask, keys, num_nodes, rows, eblk,
                   num_blocks):
    """(gather, scatter_local, etype, mask, chunk_of_block, first_of_chunk,
    n_blocks, ukey): Python's stable sort of the real edges by (scatter
    row, etype), each chunk's edges in consecutive blocks from its first,
    extra blocks on chunk 0."""
    scatter, gather, etype = scatter.tolist(), gather.tolist(), etype.tolist()
    real = [e for e in range(len(mask)) if mask[e]]
    order = sorted(real, key=lambda e: (scatter[e], etype[e]))
    per_chunk = [[] for _ in range(num_nodes // rows)]
    for e in order:
        per_chunk[scatter[e] // rows].append(e)
    blocks = [max(1, -(-len(edges) // eblk)) for edges in per_chunk]
    if num_blocks is None:
        num_blocks = sum(blocks)
    blocks[0] += num_blocks - sum(blocks)
    slots = num_blocks * eblk
    out = [np.zeros(slots, np.int32) for _ in range(3)] + [np.zeros(slots, np.float32)]
    ukey = None if keys is None else np.zeros(slots, np.int32)
    chunk_of_block = np.zeros(num_blocks, np.int32)
    first_of_chunk = np.zeros(num_blocks, np.int32)
    b = 0
    for c, edges in enumerate(per_chunk):
        for k in range(blocks[c]):
            chunk_of_block[b], first_of_chunk[b] = c, k == 0
            for j, e in enumerate(edges[k * eblk:(k + 1) * eblk]):
                s = b * eblk + j
                out[0][s], out[1][s] = gather[e], scatter[e] - c * rows
                out[2][s], out[3][s] = etype[e], 1.0
                if ukey is not None:
                    ukey[s] = keys[e]
            b += 1
    return (*out, chunk_of_block, first_of_chunk, num_blocks, ukey)


@functools.lru_cache(maxsize=None)
def case_data(name, twin, with_canon):
    """The case's edges, plan arguments and reference plan."""
    kw, rows, eblk, num_blocks = CASES[name]
    src, dst, etype, mask, canon, N = batch_edges(**kw)
    keys = canon * 2 + (src < dst) if with_canon else None
    scatter, gather = (src, dst) if twin else (dst, src)
    if num_blocks == "capacity":
        num_blocks = plan_capacity_blocks(N, len(src), rows, eblk)
    elif num_blocks == "+7":
        need = reference_plan(scatter, gather, etype, mask, None, N, rows, eblk,
                              None)[6]
        num_blocks = need + 7
    want = reference_plan(scatter, gather, etype, mask, keys, N, rows, eblk,
                          num_blocks)
    args = (src, dst, etype, mask, N)
    plan_kw = dict(eblk=eblk, rows=rows, num_blocks=num_blocks,
                   edge_canon=canon if with_canon else None)
    return args, plan_kw, want


def use_engine(monkeypatch, engine):
    """Plan on `engine`: skip without the C++ engine, or hide it."""
    if engine == "native":
        if not native.available():
            pytest.skip("the C++ engine is not built (no g++?)")
    else:
        monkeypatch.setattr(native, "available", lambda: False)


def assert_plans_equal(got, want):
    assert len(got) == len(want) == 8
    assert got[6] == want[6]
    assert (got[7] is None) == (want[7] is None)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, i
            np.testing.assert_array_equal(g, w, err_msg=f"array {i}")


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("with_canon", [True, False], ids=["canon", "no_canon"])
@pytest.mark.parametrize("twin", [False, True], ids=["forward", "twin"])
@pytest.mark.parametrize("case", list(CASES))
def test_plan_equals_the_plain_reference(case, twin, with_canon, engine,
                                         monkeypatch):
    args, plan_kw, want = case_data(case, twin, with_canon)
    use_engine(monkeypatch, engine)
    align = block_align_edges_transposed if twin else block_align_edges
    assert_plans_equal(align(*args, **plan_kw), want)
    if case == "several_blocks":
        assert (np.bincount(want[4]) > 2).any()
    if case == "empty_chunks":
        assert (want[3].reshape(want[6], -1).sum(1) == 0).sum() >= 4


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("fault", ["endpoint", "blocks", "rows"])
def test_both_engines_raise_the_same_errors(fault, engine, monkeypatch):
    src, dst, etype, mask, canon, N = batch_edges(
        graphs=4, nodes=64, edges=300, R=5, node_pad=256, edge_pad=4096)
    use_engine(monkeypatch, engine)
    kw = dict(eblk=128, rows=64, edge_canon=canon)
    for twin, align in ((False, block_align_edges),
                        (True, block_align_edges_transposed)):
        scatter, gather = (src, dst) if twin else (dst, src)
        need = reference_plan(scatter, gather, etype, mask, None, N, 64, 128,
                              None)[6]
        if fault == "endpoint":
            for arr, value in ((src, N), (dst, -1)):
                bad = arr.copy()
                bad[5] = value
                edges = (bad, dst) if arr is src else (src, bad)
                with pytest.raises(ValueError, match=rf"^edge endpoints outside \[0, {N}\)$"):
                    align(*edges, etype, mask, N, **kw)
            # an endpoint out of range on a padding slot is no fault
            bad = src.copy()
            bad[~mask] = N + 3
            align(bad, dst, etype, mask, N, **kw)
        elif fault == "blocks":
            with pytest.raises(ValueError, match=rf"^need {need} blocks > requested {need - 1}$"):
                align(src, dst, etype, mask, N, num_blocks=need - 1, **kw)
            assert align(src, dst, etype, mask, N, num_blocks=need, **kw)[6] == need
        else:
            with pytest.raises(ValueError, match=rf"^num_nodes {N - 32} is not a multiple of rows 64$"):
                align(src, dst, etype, mask, N - 32, **kw)


def rating_dataset(n=140, seed=0):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    M = sp.random(60, 70, density=0.12, format="csr",
                  random_state=np.random.RandomState(seed))
    M.data = rng.integers(1, 6, M.nnz).astype(np.float64)
    u, v = M.nonzero()
    labels = (M[u[:n], v[:n]].A1 - 1).astype(np.int64)
    return StaticGraphDataset(M, (u[:n], v[:n]), labels, h=1,
                              class_values=np.arange(1.0, 6.0), backend="numpy",
                              progress=False)


def loader_plans(dataset, shuffle, engine, monkeypatch):
    """Every batch's (aligned, aligned_t) from a pallas BatchLoader on
    `engine`, and the plan counters of the pass."""
    with monkeypatch.context() as m:
        use_engine(m, engine)
        spans.reset()
        spans.enable()
        try:
            loader = BatchLoader(dataset, 50, shuffle=shuffle, seed=5, prefetch=2,
                                 flat_aggregate="pallas")
            plans = [(b.aligned, b.aligned_t) for b in loader]
            counters = spans.snapshot()["counters"]
        finally:
            spans.disable()
            spans.reset()
    return plans, counters


@pytest.mark.parametrize("shuffle", [True, False], ids=["train", "eval"])
def test_loader_plans_are_the_same_on_both_engines_and_counted(shuffle,
                                                               monkeypatch):
    use_engine(monkeypatch, "native")
    dataset = rating_dataset()
    batches = -(-len(dataset) // 50)
    got, counted = loader_plans(dataset, shuffle, "native", monkeypatch)
    want, counted_numpy = loader_plans(dataset, shuffle, "numpy", monkeypatch)
    per_batch = 2 if shuffle else 1
    assert counted["loader.plans_native"] == per_batch * batches
    assert "loader.plans_numpy" not in counted
    assert counted_numpy["loader.plans_numpy"] == per_batch * batches
    assert "loader.plans_native" not in counted_numpy
    assert len(got) == len(want) == batches
    for (a, a_t), (b, b_t) in zip(got, want):
        assert len(a) == len(b) == 7
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
        if shuffle:
            for x, y in zip(a_t, b_t):
                assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert a_t is None and b_t is None


def test_engine_refuses_edge_arrays_of_different_lengths(monkeypatch):
    use_engine(monkeypatch, "native")
    src, dst, etype, mask, canon, N = batch_edges(
        graphs=2, nodes=64, edges=50, R=5, node_pad=128, edge_pad=256)
    with pytest.raises(ValueError, match="differ in length"):
        block_align_edges(src, dst[:-1], etype, mask, N, eblk=128, rows=64)
    with pytest.raises(ValueError, match="differ in length"):
        block_align_edges(src, dst, etype, mask, N, eblk=128, rows=64,
                          edge_canon=canon[:-1])
