"""The harness's operation and byte counts against brute-force counts."""

import numpy as np
import pytest

from portbench.lib import counts

MODEL = {"num_features": 4, "latent_dim": [32, 32, 32, 32], "num_bases": 4, "hidden": 128}


def _graphs(rng, n_graphs, R):
    """Packed arrays of small random bipartite graphs."""
    node_off, edge_off, src, dst, et = [0], [0], [], [], []
    for _ in range(n_graphs):
        nu, nv = rng.integers(1, 6), rng.integers(1, 6)
        pairs = [(u, nu + v) for u in range(nu) for v in range(nv) if rng.random() < 0.6]
        for u, v in pairs:
            src.append(u)
            dst.append(v)
            et.append(rng.integers(R))
        node_off.append(node_off[-1] + nu + nv)
        edge_off.append(edge_off[-1] + len(pairs))
    return (np.array(node_off), np.array(edge_off), np.array(src, np.int64),
            np.array(dst, np.int64), np.array(et, np.int64))


@pytest.mark.parametrize("R", [1, 5, 71])
def test_graph_sizes_match_a_brute_force_count(R):
    rng = np.random.default_rng(R)
    no, eo, src, dst, et = _graphs(rng, 40, R)
    nodes, msgs, pairs = counts.graph_sizes(no, eo, src, dst, et, R)
    for g in range(40):
        es = range(eo[g], eo[g + 1])
        want = {(src[e], et[e]) for e in es} | {(dst[e], et[e]) for e in es}
        assert nodes[g] == no[g + 1] - no[g]
        assert msgs[g] == 2 * len(es)
        assert pairs[g] == len(want)


def test_model_flops_match_the_terms_written_out():
    nodes, msgs, pairs, graphs, R = 900.0, 8000.0, 1500.0, 5, 5
    want, cin = 0.0, 4
    for cout in (32, 32, 32, 32):
        want += 2 * R * 4 * cin * cout                                  # W_r fold
        want += min(2 * msgs * cin * cout, 2 * pairs * cin * cout + msgs * cout)
        want += 2 * nodes * cin * cout                                  # root
        cin = cout
    want += graphs * (2 * 256 * 128 + 2 * 128)                          # lin1, lin2
    got = counts.model_flops(nodes, msgs, pairs, graphs, MODEL, R)
    assert got == pytest.approx(want, rel=1e-12)
    assert counts.train_step_flops(nodes, msgs, pairs, graphs, MODEL, R) == pytest.approx(3 * want)
    many = counts.model_flops([nodes, 2 * nodes], [msgs, msgs], [pairs, pairs], [graphs, graphs],
                              MODEL, R)
    assert many[0] == pytest.approx(want)


def _plan(rng, n_nodes, R, blocks, eblk, rows):
    size = blocks * eblk
    mask = (rng.random(size) < 0.7).astype(np.float32)
    src = rng.integers(0, n_nodes, size).astype(np.int32)
    local = rng.integers(0, rows, size).astype(np.int32)
    et = rng.integers(0, R, size).astype(np.int32)
    chunk = np.sort(rng.integers(0, n_nodes // rows, blocks)).astype(np.int32)
    return (src, local, et, mask, chunk)


def test_aggregate_bounds_match_a_brute_force_count():
    rng = np.random.default_rng(0)
    n, R, rows, nb, cin, cout = 1024, 5, 256, 4, 32, 32
    plan = _plan(rng, n, R, 12, 128, rows)
    live = plan[3] != 0
    e = int(live.sum())
    p_src = len(set(zip(plan[0][live].tolist(), plan[2][live].tolist())))
    scatter = plan[1].astype(np.int64) + np.repeat(plan[4], 128).astype(np.int64) * rows
    p_dst = len(set(zip(scatter[live].tolist(), plan[2][live].tolist())))
    b1 = counts.aggregate_bound(n, cin, cout, nb, R, plan, rows)
    assert b1["pairs"] == p_src and b1["e_real"] == e
    flops = min(2 * e * cin * cout, 2 * p_src * cin * cout + e * cout) + 2 * R * nb * cin * cout
    nbytes = 4 * (plan[3].size + 3 * e + plan[4].size + n * cin + R * nb + nb * cin * cout
                  + n * cout)
    assert b1["flops"] == flops and b1["nbytes"] == nbytes
    assert b1["bound_s"] == pytest.approx(max(flops / 67e12, nbytes / 3.35e12))
    # the twin plan: (dst, src-local, etype, mask, chunk); dx on
    b2 = counts.aggregate_bwd_bound(n, cin, cout, nb, R, plan, True, rows)
    assert b2["pairs"] == (p_dst, p_src)
    pe = 2 * e * cin * cout
    f = (min(pe, 2 * p_src * cin * cout + e * cin)
         + min(pe, 2 * p_dst * cin * cout + e * cout, 2 * p_src * cin * cout + e * cin)
         + 4 * R * nb * cin * cout)
    assert b2["flops"] == f
