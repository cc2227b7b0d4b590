"""Dense slot batching: one fixed node slot per graph, targets at fixed rows.

Port of igmc_tpu/batching/dense.py (DenseBatch, slot_perm, collate_dense,
plan_rel_caps and the bucket planners):

  * every graph occupies a slot of `n` node rows, so node states are
    [B, n, C];
  * edges are stored ONCE, in the forward (user -> item) direction, as
    [B, E] graph-local rows; the layer applies them in both directions;
  * graphs are grouped into a few (n, E) slot shapes (size buckets) that
    minimise the padded n * E work of an epoch.

Two slot layouts share DenseBatch, told apart by `num_u`:

  * UNIFIED (`num_u is None`): target user at row 0, target item at row 1
    (slot_perm), the other users and items after them;
  * BIPARTITE (`num_u = nu`, a per-bucket boundary): users in rows
    [0, nu), items in [nu, n); target user at row 0, target item at row
    nu. Padded edges point at item row nu, with mask 0.

Either layout's edge axis may be RELATION-SLOTTED (`rel_caps`, a tuple of
R per-relation capacities summing to E): each graph's relation-r edges sit
in [off_r, off_r + count_r), off_r = sum(caps[:r]), and every position of
the segment, padding included, carries relation r (models/rgcn.py
relslot_plan reads the relation from the position).

Batches carry `edge_id`, the key of each stored edge's hash edge dropout
in the training forward (ops/dropout.py edge_dropout_dense), so the same
edges drop whatever batch a graph lands in: on the device
(batching/device_data.py assemble_dense) each edge's index in the packed
dataset tables; on the host (collate_dense with the graphs' dataset ids)
the same packed index for a static dataset, and for a dynamic one
gid * DYNAMIC_EDGE_STRIDE + the edge's position in its graph.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..graphs.extract import Subgraph
from .batch import DYNAMIC_EDGE_STRIDE, _feature_tables


@dataclass
class DenseBatch:
    """B graphs in fixed node slots (torch tensors)."""

    node_label: torch.Tensor   # int32 [B, n]  hop/side label per node row
    edge_src: torch.Tensor     # int32 [B, E]  forward-edge user row
    edge_dst: torch.Tensor     # int32 [B, E]  forward-edge item row
    edge_type: torch.Tensor    # int32 [B, E]  rating label per forward edge
    node_mask: torch.Tensor    # bool  [B, n]
    edge_mask: torch.Tensor    # bool  [B, E]
    y: torch.Tensor            # float32 [B] regression target
    graph_mask: torch.Tensor   # bool  [B]
    u_feat: Optional[torch.Tensor] = None  # float32 [B, du] target-user features
    v_feat: Optional[torch.Tensor] = None  # float32 [B, dv] target-item features
    num_u: Optional[int] = None            # bipartite user/item boundary
    edge_id: Optional[torch.Tensor] = None  # int64 [B, E] packed edge index
    rel_caps: Optional[tuple] = None       # relation-slotted edge axis

    @property
    def num_graphs(self) -> int:
        return self.y.shape[0]

    @property
    def node_slot(self) -> int:
        return self.node_label.shape[-1]

    @property
    def edge_slot(self) -> int:
        return self.edge_src.shape[-1]

    def to(self, device, non_blocking: bool = False) -> "DenseBatch":
        """A copy with every tensor on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def graphs(self, start: int, stop: int) -> "DenseBatch":
        """The batch of graphs [start, stop): views of every tensor."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[start:stop]
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def slot_perm(num_u: int, num_nodes: int) -> np.ndarray:
    """Extraction-order -> slot-row permutation of the unified layout.

    Extraction order is [target_user, users..., target_item, items...]
    (graphs/extract.py Subgraph). Slot order moves the target item to row
    1: 0 -> 0, num_u -> 1, other users j -> j+1, other items d -> d."""
    perm = np.empty(num_nodes, dtype=np.int32)
    perm[0] = 0
    perm[1:num_u] = np.arange(1, num_u, dtype=np.int32) + 1
    perm[num_u] = 1
    if num_nodes > num_u + 1:
        perm[num_u + 1:] = np.arange(num_u + 1, num_nodes, dtype=np.int32)
    return perm


def collate_dense(graphs: Sequence[Subgraph], num_graphs: int, node_slot: int,
                  edge_slot: int, num_u_slot: Optional[int] = None,
                  rel_caps: Optional[tuple] = None, gids=None,
                  edge_offsets: Optional[np.ndarray] = None) -> DenseBatch:
    """Pack subgraphs one per slot (CPU tensors); slots must fit every graph.

    With `num_u_slot`, pack the bipartite layout: users keep their
    extraction order in rows [0, num_u_slot), items theirs in rows
    [num_u_slot, node_slot). With `rel_caps` (R capacities summing to
    edge_slot), pack the relation-slotted edge axis: relation r's edges in
    their extraction order from sum(caps[:r]).

    With `gids`, the graphs' dataset indices, attach `edge_id`: edge j of
    graph gid gets edge_offsets[gid] + j (a static dataset's packed
    offsets: the id assemble_dense gives it) or, without `edge_offsets`,
    gid * DYNAMIC_EDGE_STRIDE + j. Padding slots get 0."""
    B, n, E = num_graphs, node_slot, edge_slot
    if len(graphs) > B:
        raise ValueError(f"{len(graphs)} graphs > batch size {B}")
    if rel_caps is not None:
        rel_caps = tuple(int(c) for c in rel_caps)
        if sum(rel_caps) != E:
            raise ValueError(f"rel_caps {rel_caps} must sum to edge_slot {E}")
        rel_off = np.concatenate([[0], np.cumsum(rel_caps)]).astype(np.int64)
    node_label = np.zeros((B, n), dtype=np.int32)
    node_mask = np.zeros((B, n), dtype=bool)
    edge_src = np.zeros((B, E), dtype=np.int32)
    edge_dst = np.zeros((B, E), dtype=np.int32)
    edge_type = np.zeros((B, E), dtype=np.int32)
    edge_mask = np.zeros((B, E), dtype=bool)
    y = np.zeros(B, dtype=np.float32)
    graph_mask = np.zeros(B, dtype=bool)
    u_feat, v_feat = _feature_tables(graphs, B)
    edge_id = None
    if gids is not None:
        gids = np.asarray(gids, dtype=np.int64)
        base = (gids * DYNAMIC_EDGE_STRIDE if edge_offsets is None
                else np.asarray(edge_offsets, dtype=np.int64)[gids])
        edge_id = np.zeros((B, E), dtype=np.int64)

    for gi, g in enumerate(graphs):
        nn, ne = g.num_nodes, len(g.src)
        if ne > E:
            raise ValueError(f"graph ({nn} nodes, {ne} fwd edges) exceeds dense "
                             f"slot ({n}, {E})")
        if num_u_slot is None:
            if nn > n:
                raise ValueError(f"graph ({nn} nodes, {ne} fwd edges) exceeds "
                                 f"dense slot ({n}, {E})")
            perm = slot_perm(g.num_u, nn)
            node_mask[gi, :nn] = True
        else:
            if g.num_u > num_u_slot or g.num_v > n - num_u_slot:
                raise ValueError(
                    f"graph ({g.num_u} users, {g.num_v} items) exceeds "
                    f"bipartite slot ({num_u_slot}, {n - num_u_slot})")
            perm = np.concatenate([np.arange(g.num_u, dtype=np.int32),
                                   num_u_slot + np.arange(g.num_v, dtype=np.int32)])
            node_mask[gi, :g.num_u] = True
            node_mask[gi, num_u_slot:num_u_slot + g.num_v] = True
        node_label[gi, perm] = g.node_label
        if rel_caps is None:
            epos = np.arange(ne)
        else:
            epos = np.empty(ne, dtype=np.int64)
            for r in np.unique(g.etype):
                sel = np.flatnonzero(g.etype == r)
                cap = rel_caps[r] if r < len(rel_caps) else 0
                if len(sel) > cap:
                    raise ValueError(f"graph has {len(sel)} relation-{r} edges > "
                                     f"capacity {cap}")
                epos[sel] = rel_off[r] + np.arange(len(sel))
        edge_src[gi, epos] = perm[g.src]
        edge_dst[gi, epos] = perm[g.dst]
        edge_type[gi, epos] = g.etype
        edge_mask[gi, epos] = True
        if edge_id is not None:
            edge_id[gi, epos] = base[gi] + np.arange(ne)
        y[gi] = g.y
        graph_mask[gi] = True
        if u_feat is not None:
            u_feat[gi] = g.u_feat
            v_feat[gi] = g.v_feat
    if num_u_slot is not None:
        edge_dst[~edge_mask] = num_u_slot   # a valid item row, masked out
    if rel_caps is not None:                # padding carries its segment's relation
        edge_type[:] = np.repeat(np.arange(len(rel_caps), dtype=np.int32), rel_caps)

    t = torch.from_numpy
    return DenseBatch(node_label=t(node_label), edge_src=t(edge_src),
                      edge_dst=t(edge_dst), edge_type=t(edge_type),
                      node_mask=t(node_mask), edge_mask=t(edge_mask), y=t(y),
                      graph_mask=t(graph_mask),
                      u_feat=None if u_feat is None else t(u_feat),
                      v_feat=None if v_feat is None else t(v_feat),
                      num_u=num_u_slot, rel_caps=rel_caps,
                      edge_id=None if edge_id is None else t(edge_id))


def plan_rel_caps(etypes: Sequence[np.ndarray], num_relations: int,
                  base: int = 8) -> tuple:
    """Per-relation edge capacities covering every graph: for each relation
    r the most relation-r edges of any graph, rounded up to a multiple of
    `base`. A relation no graph has gets capacity 0, where the JAX package
    gives it `base` (a known defect of the reference: its segment only
    pads). The sum is the relation-slotted edge_slot."""
    caps = np.zeros(num_relations, dtype=np.int64)
    for et in etypes:
        if len(et):
            caps = np.maximum(caps, np.bincount(et, minlength=num_relations))
    return tuple(int(-(-int(c) // base) * base) for c in caps)


def _round8(v):
    """Round up to a multiple of 8, at least 8; elementwise on arrays."""
    return -(-np.maximum(v, 8) // 8) * 8


@dataclass(frozen=True)
class DenseBucket:
    """One slot shape and the dataset indices assigned to it. `num_u_slot`
    is None for the unified layout, else the bipartite boundary (node_slot
    = user rows + item rows, each side rounded to 8)."""

    node_slot: int
    edge_slot: int
    indices: np.ndarray  # int64 dataset indices whose graphs fit this slot
    num_u_slot: Optional[int] = None


def _plan_buckets_core(dims, width_of, make_bucket, max_buckets: int,
                       grid: int) -> List[DenseBucket]:
    """The contiguous-segment DP behind both planners.

    `dims` = per-graph dimension arrays (the LAST is the edge count, the
    rest node-side widths). Graphs are sorted by real width * edges; the
    DP over `grid` candidate cut points picks <= max_buckets contiguous
    segments minimising sum(count * width(maxima) * round8(edge max));
    `width_of` maps arrays of node-side maxima to arrays of slot widths.
    Each DP step takes the minimum over every earlier cut point at once,
    the first on ties. `make_bucket(maxima, indices)` builds each bucket
    from the rounded member maxima, and shape-identical neighbours merge."""
    dims = [np.asarray(d, dtype=np.int64) for d in dims]
    n = len(dims[0])
    if n == 0:
        return []
    cost = sum(dims[:-1]) * np.maximum(dims[-1], 1)
    order = np.argsort(cost, kind="stable")
    sorted_dims = [d[order] for d in dims]
    cuts = np.unique(np.linspace(0, n, min(grid, n) + 1).astype(np.int64))
    C = len(cuts)
    # run[d][i, j - 1]: the maximum of dim d over the cut segments i..j-1
    upper = np.triu(np.ones((C - 1, C - 1), dtype=bool))
    run = [np.maximum.accumulate(
        np.where(upper, np.maximum.reduceat(d, cuts[:-1])[None, :], 0), axis=1)
        for d in sorted_dims]
    # w[i, j - 1]: the cost of one bucket holding graphs cuts[i]:cuts[j]
    w = ((cuts[None, 1:] - cuts[:-1, None]) * width_of(run[:-1])
         * _round8(run[-1])).astype(np.float64)
    w[~upper] = np.inf

    k = max(1, int(max_buckets))
    dp = np.full((C, k + 1), float("inf"))
    dp[0, 0] = 0.0
    parent = np.zeros((C, k + 1), np.int64)
    for b in range(1, k + 1):
        v = dp[:-1, b - 1, None] + w
        parent[1:, b] = np.argmin(v, axis=0)
        dp[1:, b] = v.min(axis=0)

    segs = []
    j, b = C - 1, int(np.argmin(dp[C - 1, 1:]) + 1)
    while b > 0 and j > 0:
        i = parent[j, b]
        segs.append((int(cuts[i]), int(cuts[j])))
        j, b = int(i), b - 1
    segs.reverse()

    buckets: List[DenseBucket] = []
    for i, j in segs:
        nb = make_bucket([int(_round8(d[i:j].max())) for d in sorted_dims],
                         order[i:j])
        last = buckets[-1] if buckets else None
        if last is not None and (nb.node_slot, nb.edge_slot, nb.num_u_slot) == (
                last.node_slot, last.edge_slot, last.num_u_slot):
            buckets[-1] = DenseBucket(nb.node_slot, nb.edge_slot,
                                      np.concatenate([last.indices, nb.indices]),
                                      nb.num_u_slot)
        else:
            buckets.append(nb)
    return buckets


def plan_dense_buckets(node_counts, fwd_edge_counts, max_buckets: int = 3,
                       grid: int = 256) -> List[DenseBucket]:
    """<= max_buckets unified (node, edge) slot shapes minimising the
    epoch's padded node_slot * edge_slot work."""
    return _plan_buckets_core(
        [node_counts, fwd_edge_counts],
        width_of=lambda nodes: _round8(nodes[0]),
        make_bucket=lambda m, idx: DenseBucket(m[0], m[1], idx),
        max_buckets=max_buckets, grid=grid)


def plan_bipartite_buckets(u_counts, v_counts, fwd_edge_counts,
                           max_buckets: int = 3,
                           grid: int = 256) -> List[DenseBucket]:
    """plan_dense_buckets for the bipartite layout: separate user and item
    slot widths per bucket, a member costing (nu_slot + nv_slot) *
    edge_slot."""
    return _plan_buckets_core(
        [u_counts, v_counts, fwd_edge_counts],
        width_of=lambda sides: _round8(sides[0]) + _round8(sides[1]),
        make_bucket=lambda m, idx: DenseBucket(m[0] + m[1], m[2], idx, m[0]),
        max_buckets=max_buckets, grid=grid)
