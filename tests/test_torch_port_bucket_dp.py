"""The dense bucket planners' DP, taken over all cut points at once as array
operations, against its plain form: the triple loop over (i, j, b) below,
kept here as the reference. Both planners must return the same buckets,
shapes and index arrays in the same order, on random inputs, on zero-edge
graphs, on ties in every cost, on one graph and on none; a few cases are
also held against the JAX package's planners. A tie between two earlier
cut points goes to the smaller one, as the loop's strict `<` does. Also
a speed guard: planning one 100-pair serving call stays well under 5 ms."""

import statistics
import time
from typing import List

import numpy as np
import pytest
import torch

from igmc_tpu.batching.dense import plan_bipartite_buckets as jax_plan_bipartite
from igmc_tpu.batching.dense import plan_dense_buckets as jax_plan_dense

from igmc_torch.batching import DenseBucket, plan_bipartite_buckets, plan_dense_buckets

torch.set_num_threads(1)

N_RANDOM = 200


def _loop_round8(v) -> int:
    return int(-(-max(int(v), 8) // 8) * 8)


def _loop_core(dims, width_of, make_bucket, max_buckets, grid) -> List[DenseBucket]:
    """The planners' DP as nested Python loops over (i, j, dim, b)."""
    dims = [np.asarray(d, dtype=np.int64) for d in dims]
    n = len(dims[0])
    if n == 0:
        return []
    cost = sum(dims[:-1]) * np.maximum(dims[-1], 1)
    order = np.argsort(cost, kind="stable")
    sorted_dims = [d[order] for d in dims]
    cuts = np.unique(np.linspace(0, n, min(grid, n) + 1).astype(np.int64))
    C = len(cuts)
    seg_max = [np.array([d[cuts[i]:cuts[i + 1]].max(initial=0)
                         for i in range(C - 1)]) for d in sorted_dims]

    k = max(1, int(max_buckets))
    dp = np.full((C, k + 1), float("inf"))
    dp[0, 0] = 0.0
    parent = np.zeros((C, k + 1), np.int64)
    for i in range(C - 1):
        run = [0] * len(dims)
        for j in range(i + 1, C):
            for d in range(len(dims)):
                run[d] = max(run[d], int(seg_max[d][j - 1]))
            w = (cuts[j] - cuts[i]) * width_of(run[:-1]) * _loop_round8(run[-1])
            for b in range(1, k + 1):
                v = dp[i, b - 1] + w
                if v < dp[j, b]:
                    dp[j, b] = v
                    parent[j, b] = i

    segs = []
    j, b = C - 1, int(np.argmin(dp[C - 1, 1:]) + 1)
    while b > 0 and j > 0:
        i = parent[j, b]
        segs.append((int(cuts[i]), int(cuts[j])))
        j, b = int(i), b - 1
    segs.reverse()

    buckets: List[DenseBucket] = []
    for i, j in segs:
        nb = make_bucket([_loop_round8(d[i:j].max()) for d in sorted_dims], order[i:j])
        last = buckets[-1] if buckets else None
        if last is not None and (nb.node_slot, nb.edge_slot, nb.num_u_slot) == (
                last.node_slot, last.edge_slot, last.num_u_slot):
            buckets[-1] = DenseBucket(nb.node_slot, nb.edge_slot,
                                      np.concatenate([last.indices, nb.indices]),
                                      nb.num_u_slot)
        else:
            buckets.append(nb)
    return buckets


def loop_plan_dense(node_counts, fwd_edge_counts, max_buckets=3, grid=256):
    return _loop_core([node_counts, fwd_edge_counts],
                      lambda nodes: _loop_round8(nodes[0]),
                      lambda m, idx: DenseBucket(m[0], m[1], idx),
                      max_buckets, grid)


def loop_plan_bipartite(u_counts, v_counts, fwd_edge_counts, max_buckets=3, grid=256):
    return _loop_core([u_counts, v_counts, fwd_edge_counts],
                      lambda sides: _loop_round8(sides[0]) + _loop_round8(sides[1]),
                      lambda m, idx: DenseBucket(m[0] + m[1], m[2], idx, m[0]),
                      max_buckets, grid)


def assert_same_buckets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.node_slot, g.edge_slot, g.num_u_slot) == (
            w.node_slot, w.edge_slot, w.num_u_slot)
        assert all(type(s) is int for s in (g.node_slot, g.edge_slot))
        assert g.num_u_slot is None or type(g.num_u_slot) is int
        assert g.indices.dtype == w.indices.dtype
        assert np.array_equal(g.indices, w.indices)


def _random_case(seed):
    """(u, v, e, max_buckets, grid) of 1-500 graphs, grid 1-300 (often
    above the count), counts from one of four shapes: power-law, narrow
    (many ties), with many zero-edge graphs, and all equal."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 501))
    grid = int(rng.integers(1, 301))
    max_buckets = int(rng.integers(1, 6))
    kind = seed % 4
    if kind == 0:
        u = rng.zipf(1.6, n).clip(1, 300)
        v = rng.zipf(1.6, n).clip(1, 300)
        e = (u * v * rng.uniform(0.2, 1.0, n)).astype(np.int64)
    elif kind == 1:
        u = rng.integers(1, 12, n)
        v = rng.integers(1, 12, n)
        e = rng.integers(0, 40, n)
    elif kind == 2:
        u = rng.integers(1, 120, n)
        v = rng.integers(1, 120, n)
        e = np.where(rng.random(n) < 0.4, 0, rng.integers(1, 3000, n))
    else:
        u = np.full(n, int(rng.integers(1, 50)))
        v = np.full(n, int(rng.integers(1, 50)))
        e = np.full(n, int(rng.integers(0, 500)))
    return u, v, e, max_buckets, grid


def _check_both(u, v, e, max_buckets, grid):
    got_b = plan_bipartite_buckets(u, v, e, max_buckets, grid=grid)
    assert_same_buckets(got_b, loop_plan_bipartite(u, v, e, max_buckets, grid))
    got_d = plan_dense_buckets(u + v, e, max_buckets, grid=grid)
    assert_same_buckets(got_d, loop_plan_dense(u + v, e, max_buckets, grid))
    return got_d, got_b


@pytest.mark.parametrize("seed", range(N_RANDOM))
def test_bucket_dp_matches_loop_form(seed):
    u, v, e, max_buckets, grid = _random_case(seed)
    got_d, got_b = _check_both(u, v, e, max_buckets, grid)
    for got in (got_d, got_b):
        assert 0 < len(got) <= max_buckets
        assert sorted(np.concatenate([b.indices for b in got])) == list(range(len(u)))
    if seed % 25 == 0:
        assert_same_buckets(got_b, jax_plan_bipartite(u, v, e, max_buckets, grid=grid))
        assert_same_buckets(got_d, jax_plan_dense(u + v, e, max_buckets, grid=grid))


_EDGE_CASES = {
    "empty": (np.zeros(0, np.int64),) * 3,
    "one_graph": (np.array([7]), np.array([40]), np.array([300])),
    "one_graph_no_edges": (np.array([1]), np.array([1]), np.array([0])),
    "all_zero_edges": (np.arange(1, 61) % 13 + 1, np.arange(1, 61) % 7 + 1,
                       np.zeros(60, np.int64)),
    "all_equal": (np.full(150, 9), np.full(150, 30), np.full(150, 211)),
    "two_graphs": (np.array([90, 3]), np.array([2, 80]), np.array([500, 60])),
}


@pytest.mark.parametrize("max_buckets", [1, 2, 5])
@pytest.mark.parametrize("grid", [1, 3, 256])
@pytest.mark.parametrize("case", sorted(_EDGE_CASES))
def test_bucket_dp_edge_cases(case, grid, max_buckets):
    u, v, e = _EDGE_CASES[case]
    got_d, got_b = _check_both(u, v, e, max_buckets, grid)
    assert_same_buckets(got_b, jax_plan_bipartite(u, v, e, max_buckets, grid=grid))
    assert_same_buckets(got_d, jax_plan_dense(u + v, e, max_buckets, grid=grid))
    if case == "empty":
        assert got_d == got_b == []
    if case == "all_equal":
        assert len(got_d) == len(got_b) == 1


# Three graphs of 8, 16 and 24 edge slots, one node-width each: with two
# buckets, cutting after the first graph costs 8 + 2 * 24 and cutting after
# the second 2 * 16 + 24, both 56 units. The DP keeps the first cut point,
# so the buckets are {g8} and {g16, g24} and not {g8, g16} and {g24}.
@pytest.mark.parametrize("edges, small, large", [
    ([8, 16, 24], [0], [1, 2]),
    ([24, 8, 16], [1], [2, 0]),
])
def test_bucket_dp_tie_goes_to_the_smaller_cut(edges, small, large):
    e = np.array(edges)
    u, v = np.full(3, 2), np.full(3, 3)
    for got, width in ((plan_dense_buckets(u + v, e, 2, grid=3), 8),
                       (plan_bipartite_buckets(u, v, e, 2, grid=3), 16)):
        assert [(b.node_slot, b.edge_slot) for b in got] == [(width, 8), (width, 24)]
        assert [b.indices.tolist() for b in got] == [small, large]
    _check_both(u, v, e, 2, 3)


def test_bucket_dp_serving_call_is_fast():
    """One rerank call's plan: 100 graphs (101 cut points), 3 buckets."""
    rng = np.random.default_rng(7)
    nc = rng.integers(20, 202, 100)
    ec = (nc * rng.uniform(2.0, 12.0, 100)).astype(np.int64)
    plan_dense_buckets(nc, ec)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        plan_dense_buckets(nc, ec)
        times.append(time.perf_counter() - t0)
    assert statistics.median(times) < 5e-3, times
