"""Dropout ops: the stateless hash edge dropout and feature dropout.

Port of igmc_tpu/parallel/ep.py:hash_edge_keep and
igmc_tpu/ops/dropout.py (edge_dropout_dense, feature_dropout). Edge
dropout keeps an edge when a murmur-style hash of (seed, edge key) clears
the drop probability, so the keep decision is recomputed on the device per
step: from the plans' ukey streams on the fused aggregate path, from the
packed edge ids on the dense path. Both directed copies of an undirected
pair can share one key (force_undirected). The hash equals the JAX
package's bit for bit; the JAX package's dense dropout draws jax.random
masks instead, which torch cannot reproduce.

torch has no usable uint32 arithmetic: the hash runs in int64, masked to
its low 32 bits after every multiply and add and before every right
shift. A product of two 32-bit values can overflow int64, but its low 32
bits are still right once masked.
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF


def hash_edge_keep(seed: int, key_ids: torch.Tensor, p: float) -> torch.Tensor:
    """Bernoulli(1-p) keep decision per key, as a hash of (seed, key):
    bool tensor of key_ids' shape and device. `seed` is an int in
    [0, 2**32); key_ids are non-negative integers."""
    h = (key_ids.long() * 0x9E3779B9) & _LOW32
    h = (h + (int(seed) & _LOW32)) & _LOW32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _LOW32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _LOW32
    h = h ^ (h >> 16)
    return h.float() * (1.0 / 4294967296.0) >= p


def edge_dropout_dense(edge_mask: torch.Tensor, edge_id: torch.Tensor, seed: int,
                       p: float, force_undirected: bool):
    """(mask_fwd, mask_rev) of a dense batch, whose edges are stored once
    and applied in both directions: edge i of the packed tables (`edge_id`)
    is keyed 2i forward and 2i+1 reverse, so the two directions keep
    independently; with force_undirected both use key i and one mask."""
    if p == 0.0:
        return edge_mask, edge_mask
    if force_undirected:
        m = edge_mask & hash_edge_keep(seed, edge_id, p)
        return m, m
    return (edge_mask & hash_edge_keep(seed, 2 * edge_id, p),
            edge_mask & hash_edge_keep(seed, 2 * edge_id + 1, p))


def feature_dropout(h: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Inverted dropout with a given keep mask: h / (1 - p) where kept,
    0 elsewhere (F.dropout's scaling)."""
    return torch.where(keep, h / (1.0 - p), torch.zeros_like(h))
