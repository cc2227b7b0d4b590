"""Static subgraph dataset and the flat batch loader.

Port of igmc_tpu/batching/dataset.py:

  * StaticGraphDataset — extracts all subgraphs once and stores them in a
    packed structure-of-arrays (concatenated fields + offsets, compact and
    O(1) to slice). The JAX package's .npz cache is not ported yet.
  * BatchLoader — collates fixed-size padded flat batches on a geometric
    bucket ladder, in order, and attaches the dst-block-aligned edge plan
    of the fused aggregate kernel (the JAX package's
    `flat_aggregate="pallas"` mode). No shuffling, threads, superbatches or
    data parallelism yet, and no src-sorted twin plan: only the training
    backward needs it.

`max_num` subsampling draws the reference's permutation of
np.random.seed(123), from a private RandomState(123).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..graphs.csr import BipartiteCSR
from ..graphs.extract import Subgraph, extract_many
from ..kernels.rgcn_aggregate import (PLAN_EBLK, PLAN_ROWS, block_align_edges,
                                      plan_capacity_blocks)
from .batch import GraphBatch, bucket_for, collate, pad_ladder, topk_sum_bound


def _apply_max_num(links, labels, max_num):
    if max_num is None:
        return links, labels
    perm = np.random.RandomState(123).permutation(len(links[0]))[:max_num]
    return (links[0][perm], links[1][perm]), labels[perm]


class _PackedGraphs:
    """Structure-of-arrays storage for a list of Subgraphs."""

    def __init__(self, graphs: Sequence[Subgraph]):
        n = len(graphs)
        self.node_offsets = np.zeros(n + 1, dtype=np.int64)
        self.edge_offsets = np.zeros(n + 1, dtype=np.int64)
        for i, g in enumerate(graphs):
            self.node_offsets[i + 1] = self.node_offsets[i] + g.num_nodes
            self.edge_offsets[i + 1] = self.edge_offsets[i] + len(g.src)

        def cat(field):
            return (np.concatenate([getattr(g, field) for g in graphs])
                    if n else np.zeros(0, np.int32))

        self.node_label = cat("node_label")
        self.src = cat("src")
        self.dst = cat("dst")
        self.etype = cat("etype")
        self.num_u = np.array([g.num_u for g in graphs], dtype=np.int32)
        self.y = np.array([g.y for g in graphs], dtype=np.float32)

    def __len__(self):
        return len(self.y)

    def get(self, i: int) -> Subgraph:
        ns, ne = self.node_offsets[i], self.node_offsets[i + 1]
        es, ee = self.edge_offsets[i], self.edge_offsets[i + 1]
        return Subgraph(
            src=self.src[es:ee],
            dst=self.dst[es:ee],
            etype=self.etype[es:ee],
            node_label=self.node_label[ns:ne],
            num_u=int(self.num_u[i]),
            num_v=int(ne - ns - self.num_u[i]),
            y=float(self.y[i]),
        )

    def node_counts(self) -> np.ndarray:
        return np.diff(self.node_offsets)

    def edge_counts(self) -> np.ndarray:
        """Directed (doubled) edge counts."""
        return 2 * np.diff(self.edge_offsets)


class StaticGraphDataset:
    """Precomputed enclosing-subgraph dataset over a training adjacency
    (scipy sparse, values = rating label + 1) and (u, v) links."""

    def __init__(
        self,
        A,
        links,
        labels,
        h: int = 1,
        sample_ratio: float = 1.0,
        max_nodes_per_hop: Optional[int] = None,
        class_values=None,
        max_num: Optional[int] = None,
        seed: int = 0,
    ):
        links, labels = _apply_max_num(links, labels, max_num)
        if not isinstance(A, BipartiteCSR):
            A = BipartiteCSR(A)
        self.packed = _PackedGraphs(extract_many(
            links, labels, A, h, sample_ratio, max_nodes_per_hop,
            class_values, seed=seed))

    def __len__(self):
        return len(self.packed)

    def get(self, i: int) -> Subgraph:
        return self.packed.get(i)

    def node_counts(self):
        return self.packed.node_counts()

    def edge_counts(self):
        return self.packed.edge_counts()


class BatchLoader:
    """In-order flat batches with the aggregate kernel's aligned edge plan.

    Yields CPU GraphBatches whose (node_pad, edge_pad) come from geometric
    ladders up to the dataset's worst-case batch; node_pad is rounded up to
    a multiple of PLAN_ROWS (the kernel's output chunk), and the plan is
    sized by plan_capacity_blocks so every batch of one bucket has the same
    plan shape.
    """

    def __init__(self, dataset: StaticGraphDataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size
        # ladders up to the worst-case batch of the dataset: no batch
        # overflows them
        max_n, max_e = topk_sum_bound(dataset.node_counts(),
                                      dataset.edge_counts(), batch_size)
        self.node_ladder = pad_ladder(max(max_n, 64))
        self.edge_ladder = pad_ladder(max(max_e, 128), base=128)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def make_batch(self, idxs: np.ndarray) -> GraphBatch:
        graphs = [self.dataset.get(int(i)) for i in idxs]
        node_pad = bucket_for(sum(g.num_nodes for g in graphs), self.node_ladder)
        edge_pad = bucket_for(sum(g.num_edges for g in graphs), self.edge_ladder)
        # the kernel's output chunking needs num_nodes % rows == 0
        node_pad = -(-node_pad // PLAN_ROWS) * PLAN_ROWS
        batch = collate(graphs, self.batch_size, node_pad, edge_pad)
        nb = plan_capacity_blocks(node_pad, edge_pad, PLAN_ROWS, PLAN_EBLK)
        plan = block_align_edges(
            batch.edge_src.numpy(), batch.edge_dst.numpy(),
            batch.edge_type.numpy(), batch.edge_mask.numpy(), node_pad,
            eblk=PLAN_EBLK, rows=PLAN_ROWS, num_blocks=nb)
        batch.aligned = tuple(torch.from_numpy(a) for a in plan[:6])
        return batch

    def __iter__(self) -> Iterator[GraphBatch]:
        order = np.arange(len(self.dataset), dtype=np.int64)
        for s in range(0, len(order), self.batch_size):
            yield self.make_batch(order[s : s + self.batch_size])
