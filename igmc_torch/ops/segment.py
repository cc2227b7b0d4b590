"""Masked segment reductions, the aggregation of the flat segment engine.

Port of igmc_tpu/ops/segment.py: segment_sum, masked_segment_sum and
masked_segment_mean as index_add over the segment ids (the JAX package's
jax.ops.segment_sum is an XLA scatter-add). Contributions are gated by a
mask, so padded edges and nodes never reach a real row, and a segment with
no unmasked entry gets 0.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[e] over the e with segment_ids[e] = s:
    [num_segments, *data.shape[1:]] in data's dtype (differentiable)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def _column(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return mask.to(data.dtype).reshape((-1,) + (1,) * (data.dim() - 1))


def masked_segment_sum(data, segment_ids, mask, num_segments: int) -> torch.Tensor:
    """Sum of data[e] into row segment_ids[e] where mask[e]; zeros elsewhere."""
    return segment_sum(data * _column(mask, data), segment_ids, num_segments)


def masked_segment_mean(data, segment_ids, mask, num_segments: int) -> torch.Tensor:
    """Mean of data per segment over its unmasked entries; a segment with
    none gets 0 (scatter-mean, the reference R-GCN's aggr='mean')."""
    s = masked_segment_sum(data, segment_ids, mask, num_segments)
    cnt = segment_sum(mask.to(data.dtype), segment_ids, num_segments)
    return s / _column(cnt.clamp_min(1.0), data)
