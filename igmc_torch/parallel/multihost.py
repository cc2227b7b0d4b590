"""Multi-host data feeding: per-rank dataset shards and shared pad ladders.

Port of igmc_tpu/parallel/multihost.py as NumPy, keyed on (rank, size) of
the process group. The recipe, each rank on its own host or card:

    mesh = spawn(...)'s mesh, or make_mesh() under torchrun
    idx = process_shard_indices(len(train_graphs), mesh.rank, mesh.size)
    nl, el = capacity_ladders(train_graphs, B // mesh.size)  # FULL dataset
    loader = BatchLoader(Subset(train_graphs, idx), batch_size=B // mesh.size,
                         node_ladder=nl, edge_ladder=el)
    step = make_dp_train_step(model, optimizer, mesh, ARR)
    for local in loader:
        step(local.to(mesh.device), noise)   # the count n is all-reduced

Every rank feeds only its shard; the gradient all-reduce spans the group,
so the math is single-device training on the global batch. The JAX
package's two alignment rules carry over: process_shard_indices pads by
wrapping, so every rank runs the same number of steps (a short shard would
leave the others waiting in a collective), and the ladders come from the
FULL dataset, so every rank pads alike (torch compiles nothing per shape,
so there it is a matter of equal work, not of one compiled program).

`global_batch_from_local` has no counterpart, by design: there is no
global array to assemble; each rank's local batch IS its shard.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist

from ..batching.device_data import capacity_bound


def _rank_size(rank: Optional[int], size: Optional[int]):
    live = dist.is_available() and dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if live else 0
    if size is None:
        size = dist.get_world_size() if live else 1
    return rank, size


def process_shard_indices(n: int, rank: Optional[int] = None,
                          size: Optional[int] = None, seed: int = 0) -> np.ndarray:
    """Deterministic per-rank partition of range(n): every rank receives
    exactly ceil(n / size) indices (a seeded permutation that wraps around
    to pad, so a few samples repeat rather than any rank running fewer
    steps). Disjoint up to the wrap pad, and covering. rank / size default
    to the initialised group's (else 0 / 1)."""
    rank, size = _rank_size(rank, size)
    per = -(-n // size)
    perm = np.random.default_rng(seed).permutation(n)
    padded = np.concatenate([perm, perm[: per * size - n]])
    return padded[rank * per: (rank + 1) * per]


def capacity_ladders(dataset, batch_graphs: int):
    """Single-entry pad ladders ([node_pad], [edge_pad]) from the FULL
    dataset's worst-case batch of `batch_graphs` graphs (capacity_bound):
    the same on every rank. Needs a dataset with node/edge counts (static);
    for dynamic ones see dynamic_capacity_ladders."""
    n_pad, e_pad = capacity_bound(np.asarray(dataset.node_counts()),
                                  np.asarray(dataset.edge_counts()), batch_graphs)
    return [n_pad], [e_pad]


def dynamic_capacity_ladders(dataset, batch_graphs: int, sample: int = 64,
                             margin: float = 1.0):
    """Single-entry pad ladders every rank computes alike for a DYNAMIC
    dataset: extract a deterministic sample (linspace over the FULL dataset;
    extraction is deterministic in the dataset index) and take the largest
    per-graph counts x batch_graphs x margin, rounded up to 8. Only a graph
    larger than every sampled one can beat it; margin > 1 buys headroom."""
    n = len(dataset)
    idx = np.linspace(0, n - 1, num=min(sample, n), dtype=np.int64)
    graphs = (dataset.get_many(idx) if hasattr(dataset, "get_many")
              else [dataset.get(int(i)) for i in idx])
    max_n = max(g.num_nodes for g in graphs)
    max_e = max(g.num_edges for g in graphs)
    pad = lambda v: int(-(-v * margin // 8) * 8)
    return [pad(max_n * batch_graphs)], [pad(max_e * batch_graphs)]


class Subset:
    """Index-remapped view of a dataset (static or dynamic).
    node_counts / edge_counts exist only when the wrapped dataset has them,
    so BatchLoader's ladder estimate keeps working for dynamic datasets."""

    def __init__(self, dataset, indices: np.ndarray):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def get(self, i: int):
        return self.dataset.get(int(self.indices[i]))

    def get_many(self, idxs):
        remapped = self.indices[np.asarray(idxs)]
        if hasattr(self.dataset, "get_many"):
            return self.dataset.get_many(remapped)
        return [self.dataset.get(int(i)) for i in remapped]

    def __getattr__(self, name):
        # present iff the wrapped dataset has it
        if name in ("node_counts", "edge_counts"):
            inner = getattr(self.dataset, name)  # AttributeError if absent
            idx = self.indices
            return lambda: np.asarray(inner())[idx]
        raise AttributeError(name)
