"""Dense slot batching: one fixed node slot per graph, targets at fixed rows.

Port of igmc_tpu/batching/dense.py (DenseBatch, slot_perm, collate_dense
and the bucket planners), without the relation-slotted edge axis:

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

Batches built on the device (batching/device_data.py assemble_dense) also
carry `edge_id`, each stored edge's index in the packed dataset tables:
the training forward keys its hash edge dropout on it (ops/dropout.py
edge_dropout_dense), so the same edges drop whatever batch a graph lands
in. collate_dense builds no such ids.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..graphs.extract import Subgraph


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
    num_u: Optional[int] = None            # bipartite user/item boundary
    edge_id: Optional[torch.Tensor] = None  # int64 [B, E] packed edge index

    @property
    def num_graphs(self) -> int:
        return self.y.shape[0]

    @property
    def node_slot(self) -> int:
        return self.node_label.shape[-1]

    @property
    def edge_slot(self) -> int:
        return self.edge_src.shape[-1]

    def to(self, device) -> "DenseBatch":
        """A copy with every tensor on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
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
                  edge_slot: int, num_u_slot: Optional[int] = None) -> DenseBatch:
    """Pack subgraphs one per slot (CPU tensors); slots must fit every graph.

    With `num_u_slot`, pack the bipartite layout: users keep their
    extraction order in rows [0, num_u_slot), items theirs in rows
    [num_u_slot, node_slot)."""
    B, n, E = num_graphs, node_slot, edge_slot
    if len(graphs) > B:
        raise ValueError(f"{len(graphs)} graphs > batch size {B}")
    node_label = np.zeros((B, n), dtype=np.int32)
    node_mask = np.zeros((B, n), dtype=bool)
    edge_src = np.zeros((B, E), dtype=np.int32)
    edge_dst = np.zeros((B, E), dtype=np.int32)
    edge_type = np.zeros((B, E), dtype=np.int32)
    edge_mask = np.zeros((B, E), dtype=bool)
    y = np.zeros(B, dtype=np.float32)
    graph_mask = np.zeros(B, dtype=bool)

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
        edge_src[gi, :ne] = perm[g.src]
        edge_dst[gi, :ne] = perm[g.dst]
        edge_type[gi, :ne] = g.etype
        edge_mask[gi, :ne] = True
        y[gi] = g.y
        graph_mask[gi] = True
    if num_u_slot is not None:
        edge_dst[~edge_mask] = num_u_slot   # a valid item row, masked out

    t = torch.from_numpy
    return DenseBatch(node_label=t(node_label), edge_src=t(edge_src),
                      edge_dst=t(edge_dst), edge_type=t(edge_type),
                      node_mask=t(node_mask), edge_mask=t(edge_mask), y=t(y),
                      graph_mask=t(graph_mask), num_u=num_u_slot)


def _round8(v: int) -> int:
    return int(-(-max(int(v), 8) // 8) * 8)


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
    `make_bucket(maxima, indices)` builds each bucket from the rounded
    member maxima, and shape-identical neighbours merge."""
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
            w = (cuts[j] - cuts[i]) * width_of(run[:-1]) * _round8(run[-1])
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
        nb = make_bucket([_round8(d[i:j].max()) for d in sorted_dims], order[i:j])
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
