"""SortPooling (the DGCNN readout) over flat and dense slot batches.

Port of igmc_tpu/ops/sort_pool.py: per graph, nodes sorted descending by
the last feature channel, the top k kept, graphs of fewer than k nodes
zero-padded (PyG's global_sort_pool). global_sort_pool takes the flat
layout's disjoint node rows: one stable sort by (graph id, -last channel)
with padded nodes last, then a gather of each graph's first k rows from
its start (cumulative counts). dense_sort_pool takes [B, n, D] slots.
"""

from __future__ import annotations

import torch


def global_sort_pool(x: torch.Tensor, node2graph: torch.Tensor,
                     node_mask: torch.Tensor, num_graphs: int, k: int) -> torch.Tensor:
    """x [N, D] node rows of a flat batch -> [num_graphs, k * D]: graph b's
    rows in descending order of x[:, -1] (stable: ties keep row order), the
    first k kept, missing rows zero. The JAX package's lexsort by
    (graph id, -key) is the stable sort by -key followed by the stable sort
    by graph id."""
    N, D = x.shape
    B = num_graphs
    gid = torch.where(node_mask, node2graph.long(), B)
    by_key = torch.argsort(-x[:, -1], stable=True)
    order = by_key[torch.argsort(gid[by_key], stable=True)]
    x_sorted, gid_sorted = x[order], gid[order]
    counts = torch.bincount(gid, minlength=B + 1)[:B]
    starts = torch.cumsum(counts, 0) - counts                      # [B]
    j = torch.arange(k, device=x.device)[None, :]
    idx = (starts[:, None] + j).clamp(0, N - 1)                    # [B, k]
    keep = (j < counts[:, None]) & (gid_sorted[idx] == torch.arange(
        B, device=x.device)[:, None])
    pooled = torch.where(keep[..., None], x_sorted[idx], torch.zeros((), dtype=x.dtype,
                                                                     device=x.device))
    return pooled.reshape(B, k * D)


def dense_sort_pool(x: torch.Tensor, node_mask: torch.Tensor, k: int) -> torch.Tensor:
    """x [B, n, D] node slots, node_mask [B, n] -> [B, k * D]: each graph's
    rows in descending order of x[..., -1] (stable: ties keep slot order;
    masked slots last), the first k kept, masked and missing rows zero."""
    B, n, D = x.shape
    keys = torch.where(node_mask, x[..., -1], torch.full_like(x[..., -1], -torch.inf))
    kk = min(k, n)
    idx = torch.argsort(-keys, dim=1, stable=True)[:, :kk]          # [B, kk]
    pooled = torch.gather(x, 1, idx[..., None].expand(B, kk, D))     # [B, kk, D]
    valid = torch.gather(node_mask, 1, idx)
    pooled = torch.where(valid[..., None], pooled, torch.zeros_like(pooled))
    if kk < k:
        pooled = torch.cat([pooled, pooled.new_zeros(B, k - kk, D)], dim=1)
    return pooled.reshape(B, k * D)
