"""SortPooling (the DGCNN readout) over dense slot batches.

Port of igmc_tpu/ops/sort_pool.py's dense_sort_pool: per graph, nodes
sorted descending by the last feature channel, the top k kept, graphs of
fewer than k nodes zero-padded (PyG's global_sort_pool). The flat
global_sort_pool waits for the flat segment engine.
"""

from __future__ import annotations

import torch


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
