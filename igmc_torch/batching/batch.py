"""Fixed-shape batching: variable-size subgraphs -> padded flat batches.

Port of igmc_tpu/batching/batch.py. Batches are padded up a small
geometric ladder of sizes so every tensor downstream has one of a few
shapes, and every op is masked.

Layout invariants:
  * graphs are concatenated; node/edge indices are offset per graph.
  * per graph, edges are stored [forward..., reverse...] — forward edges are
    user->item (src < dst within the graph). `edge_canon` maps every edge to
    the batch index of its forward copy.
  * padded edges point at node 0 with edge_mask 0; padded nodes/graphs are
    masked via node_mask/graph_mask.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graphs.extract import Subgraph


@dataclass
class GraphBatch:
    """A static-shape batch of B disjoint subgraphs (torch tensors)."""

    node_label: torch.Tensor   # int32 [N]   hop/side label per node
    edge_src: torch.Tensor     # int32 [E]   source node (batch-local)
    edge_dst: torch.Tensor     # int32 [E]   destination node (batch-local)
    edge_type: torch.Tensor    # int32 [E]   rating label per edge
    edge_canon: torch.Tensor   # int32 [E]   index of this edge's forward copy
    node2graph: torch.Tensor   # int32 [N]   graph id per node
    node_mask: torch.Tensor    # bool  [N]
    edge_mask: torch.Tensor    # bool  [E]
    y: torch.Tensor            # float32 [B] regression target
    graph_mask: torch.Tensor   # bool  [B]
    target_u: torch.Tensor     # int32 [B]   batch-local node idx of target user
    target_v: torch.Tensor     # int32 [B]   batch-local node idx of target item
    # dst-block-aligned edges for the fused aggregate kernel
    # (kernels/rgcn_aggregate.py block_align_edges): (src, dst_local, etype,
    # mask, chunk_of_block, first_of_chunk), attached by BatchLoader.
    aligned: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def num_graphs(self) -> int:
        return self.y.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_label.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_src.shape[0]

    def to(self, device) -> "GraphBatch":
        """A copy with every tensor (the aligned plan included) on `device`."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self) if f.name != "aligned"}
        if self.aligned is not None:
            moved["aligned"] = tuple(a.to(device) for a in self.aligned)
        return GraphBatch(**moved)


def topk_sum_bound(node_counts, edge_counts, batch_size: int):
    """Worst-case node/edge totals over ANY batch of `batch_size` graphs:
    the sum of the `batch_size` largest per-graph counts."""
    k = min(batch_size, len(node_counts))
    max_n = int(np.sort(node_counts)[-k:].sum())
    max_e = int(np.sort(edge_counts)[-k:].sum())
    return max_n, max_e


def pad_ladder(max_val: int, base: int = 64, ratio: float = 1.5) -> List[int]:
    """Geometric ladder of pad sizes covering [base, >= max_val].

    ratio 1.5 bounds padding waste at ~33% while keeping the number of
    distinct batch shapes small (~log1.5 of the range).
    """
    sizes = [base]
    while sizes[-1] < max_val:
        sizes.append(int(np.ceil(sizes[-1] * ratio / 8.0)) * 8)
    return sizes


def bucket_for(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder size >= n (ladder is ascending)."""
    for s in ladder:
        if s >= n:
            return s
    return ladder[-1] if ladder and ladder[-1] >= n else int(np.ceil(n / 8.0)) * 8


def collate(
    graphs: Sequence[Subgraph],
    num_graphs: int,
    node_pad: int,
    edge_pad: int,
) -> GraphBatch:
    """Merge subgraphs into one padded disjoint batch-graph (CPU tensors).

    `num_graphs`/`node_pad`/`edge_pad` must be >= the actual totals; the
    remainder is masked padding.
    """
    B = num_graphs
    if len(graphs) > B:
        raise ValueError(f"{len(graphs)} graphs > batch size {B}")

    total_nodes = sum(g.num_nodes for g in graphs)
    total_edges = sum(g.num_edges for g in graphs)  # doubled (fwd+rev)
    if total_nodes > node_pad or total_edges > edge_pad:
        raise ValueError(
            f"batch needs ({total_nodes} nodes, {total_edges} edges) "
            f"> pad ({node_pad}, {edge_pad})"
        )

    node_label = np.zeros(node_pad, dtype=np.int32)
    node2graph = np.zeros(node_pad, dtype=np.int32)
    node_mask = np.zeros(node_pad, dtype=bool)
    edge_src = np.zeros(edge_pad, dtype=np.int32)
    edge_dst = np.zeros(edge_pad, dtype=np.int32)
    edge_type = np.zeros(edge_pad, dtype=np.int32)
    edge_canon = np.arange(edge_pad, dtype=np.int32)
    edge_mask = np.zeros(edge_pad, dtype=bool)
    y = np.zeros(B, dtype=np.float32)
    graph_mask = np.zeros(B, dtype=bool)
    target_u = np.zeros(B, dtype=np.int32)
    target_v = np.zeros(B, dtype=np.int32)

    n_off = 0
    e_off = 0
    for gi, g in enumerate(graphs):
        n = g.num_nodes
        ne = len(g.src)  # forward edges
        node_label[n_off : n_off + n] = g.node_label
        node2graph[n_off : n_off + n] = gi
        node_mask[n_off : n_off + n] = True
        # forward block
        edge_src[e_off : e_off + ne] = g.src + n_off
        edge_dst[e_off : e_off + ne] = g.dst + n_off
        edge_type[e_off : e_off + ne] = g.etype
        # reverse block
        edge_src[e_off + ne : e_off + 2 * ne] = g.dst + n_off
        edge_dst[e_off + ne : e_off + 2 * ne] = g.src + n_off
        edge_type[e_off + ne : e_off + 2 * ne] = g.etype
        edge_canon[e_off + ne : e_off + 2 * ne] = np.arange(
            e_off, e_off + ne, dtype=np.int32
        )
        edge_mask[e_off : e_off + 2 * ne] = True
        y[gi] = g.y
        graph_mask[gi] = True
        target_u[gi] = n_off            # target user is first user node
        target_v[gi] = n_off + g.num_u  # target item is first item node
        n_off += n
        e_off += 2 * ne

    t = torch.from_numpy
    return GraphBatch(
        node_label=t(node_label),
        edge_src=t(edge_src),
        edge_dst=t(edge_dst),
        edge_type=t(edge_type),
        edge_canon=t(edge_canon),
        node2graph=t(node2graph),
        node_mask=t(node_mask),
        edge_mask=t(edge_mask),
        y=t(y),
        graph_mask=t(graph_mask),
        target_u=t(target_u),
        target_v=t(target_v),
    )
