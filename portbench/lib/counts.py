"""Operations and bytes of IGMC's work, and the card's published peaks.

The bound arithmetic is a frozen copy of `aggregate_bound`,
`aggregate_bwd_bound`, `_bound`, `_pairs` and `_edges` of chip_smoke.py
at commit ead40f2a1b0deed656f1008c591755b35d83b708, and the peaks are
its PEAK_*: NVIDIA's H100 SXM data sheet, HBM3 at 3.35 TB/s and float32
outside the tensor cores at 67 TFLOP/s (at the full 700 W; the run prints
the card's power limit beside them). `_pairs` counts the distinct
(node, relation) pairs with a flag table in place of np.unique: the same
number, faster.

`model_flops` counts a step's model operations by the same least-work
rule, from the real nodes and edges of its graphs, whatever implements
the layer: per layer the W_r fold (2 R nb Cin Cout), then the cheaper of
one product per directed edge (2 M Cin Cout) or one per distinct
(source node, relation) pair plus a gather-sum (2 P Cin Cout + M Cout),
plus the root transform (2 N Cin Cout); then lin1 and lin2. A training
step counts three times its forward (the backward as twice the forward).
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def _bound(flops: float, nbytes: float) -> dict:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return dict(bound_s=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                flops=flops, nbytes=nbytes)


def _pairs(nodes, etype, live, nrel: int, num_nodes: int) -> int:
    """Distinct (node, relation) pairs among the live slots."""
    flag = np.zeros(int(num_nodes) * nrel, bool)
    flag[nodes[live].astype(np.int64) * nrel + etype[live]] = True
    return int(flag.sum())


def _edges(plan, rows: int):
    """(gather side, scatter side, etype, live) of a plan's real slots, as
    numpy: for the dst-sorted plan (src, dst); for the twin (dst, src)."""
    a0, local, etype, mask, chunk = (np.asarray(t) for t in plan[:5])
    eblk = a0.size // chunk.size
    scatter = local.astype(np.int64) + np.repeat(chunk, eblk).astype(np.int64) * rows
    return a0, scatter, etype.astype(np.int64), mask != 0


def aggregate_bound(n, cin, cout, nb, nrel, aligned, rows) -> dict:
    """Least time of one K1 call on inputs x [n, cin], att [nrel, nb],
    basis [nb, cin, cout] and the dst-sorted plan `aligned` (numpy)."""
    src, _, etype, live = _edges(aligned, rows)
    e = int(live.sum())
    pairs = _pairs(src, etype, live, nrel, n)
    flops = (min(2.0 * e * cin * cout, 2.0 * pairs * cin * cout + e * cout)
             + 2.0 * nrel * nb * cin * cout)
    nbytes = 4.0 * (np.asarray(aligned[3]).size + 3 * e + np.asarray(aligned[4]).size
                    + n * cin + nrel * nb + nb * cin * cout + n * cout)
    return dict(_bound(flops, nbytes), e_real=e, pairs=pairs)


def aggregate_bwd_bound(n, cin, cout, nb, nrel, plan_t, need_dx: bool, rows) -> dict:
    """Least time of one K2 call over the src-sorted twin plan `plan_t`."""
    dst, src, etype, live = _edges(plan_t, rows)
    e = int(live.sum())
    p_src, p_dst = _pairs(src, etype, live, nrel, n), _pairs(dst, etype, live, nrel, n)
    per_edge = 2.0 * e * cin * cout
    f_dx = min(per_edge, 2.0 * p_dst * cin * cout + e * cin) if need_dx else 0.0
    f_dw = min(per_edge, 2.0 * p_src * cin * cout + e * cout,
               2.0 * p_dst * cin * cout + e * cin)
    flops = f_dx + f_dw + 4.0 * nrel * nb * cin * cout
    nbytes = 4.0 * (np.asarray(plan_t[3]).size + 3 * e + np.asarray(plan_t[4]).size
                    + n * cin * (2 if need_dx else 1) + n * cout
                    + 2 * (nrel * nb + nb * cin * cout))
    return dict(_bound(flops, nbytes), e_real=e, pairs=(p_src, p_dst))


def graph_sizes(node_offsets, edge_offsets, src, dst, etype, nrel: int):
    """Per graph of packed arrays: (nodes, directed edges, distinct
    (source node, relation) pairs over both directions)."""
    node_offsets = np.asarray(node_offsets, np.int64)
    edge_offsets = np.asarray(edge_offsets, np.int64)
    nodes = np.diff(node_offsets)
    stored = np.diff(edge_offsets)
    g_of_edge = np.repeat(np.arange(len(stored)), stored)
    base = node_offsets[:-1][g_of_edge]
    et = np.asarray(etype, np.int64)
    flag = np.zeros(int(node_offsets[-1]) * nrel, bool)
    flag[(base + np.asarray(src, np.int64)) * nrel + et] = True
    flag[(base + np.asarray(dst, np.int64)) * nrel + et] = True
    per_node = flag.reshape(-1, nrel).sum(axis=1)
    pairs = np.add.reduceat(per_node, node_offsets[:-1]) if len(nodes) else per_node
    pairs = np.where(nodes > 0, pairs, 0)
    return nodes, 2 * stored, pairs


def model_flops(nodes, messages, pairs, graphs, model: dict, nrel: int):
    """Model operations of one forward per step, from each step's summed
    real nodes, directed edges, (node, relation) pairs and graphs
    (scalars or arrays over steps)."""
    nodes, messages, pairs, graphs = (np.asarray(a, np.float64)
                                      for a in (nodes, messages, pairs, graphs))
    nb, cin, total = model["num_bases"], model["num_features"], 0.0
    for cout in model["latent_dim"]:
        total = total + 2.0 * nrel * nb * cin * cout
        total = total + np.minimum(2.0 * messages * cin * cout,
                                   2.0 * pairs * cin * cout + messages * cout)
        total = total + 2.0 * nodes * cin * cout
        cin = cout
    hidden = model["hidden"]
    return total + graphs * (2.0 * 2 * sum(model["latent_dim"]) * hidden + 2.0 * hidden)


def train_step_flops(nodes, messages, pairs, graphs, model: dict, nrel: int):
    """A training step: the forward and a backward of twice its work."""
    return 3.0 * model_flops(nodes, messages, pairs, graphs, model, nrel)
