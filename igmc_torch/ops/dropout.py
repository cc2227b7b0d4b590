"""Dropout ops: the stateless hash edge dropout and feature dropout.

Port of igmc_tpu/parallel/ep.py:hash_edge_keep and
igmc_tpu/ops/dropout.py (edge_dropout, edge_dropout_dense,
feature_dropout). Edge dropout keeps an edge when a murmur-style hash of
(seed, edge key) clears the drop probability, so the keep decision is
recomputed on the device per step: from the plans' ukey streams on the
fused aggregate path, from the plans' pair and ukey streams on the blocked
engine (both as the JAX package keys them), from the packed edge ids on
the dense path and on the flat segment engine. Both directed copies of an
undirected pair can share one key (force_undirected). The hash equals the
JAX package's bit for bit; the JAX package's segment and dense dropout
draw jax.random masks instead, which torch cannot reproduce.

The packed edge id is the key of the segment and dense engines: edge i of
a static dataset's packed tables (or, for a dynamic dataset, graph g's
edge j as g * DYNAMIC_EDGE_STRIDE + j) is keyed 2i forward (user to item)
and 2i + 1 reverse, or i in both directions with force_undirected. A
batch assembled on the device and the same graphs collated on the host
carry the same ids, so they drop the same edges for one seed, on the card
and on the CPU alike, and so do a flat and a dense batch of those graphs.

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
    [0, 2**32); key_ids are non-negative integers. A key of 2**32 or more
    (a dynamic dataset's host-collated dense edge keys) adds its high word,
    times an odd constant, to the seed; for other keys that term is 0, and
    the hash is the JAX package's."""
    k = key_ids.long()
    h = ((k & _LOW32) * 0x9E3779B9) & _LOW32
    h = (h + (int(seed) & _LOW32) + (k >> 32).clamp_min(0) * 0x27D4EB2F) & _LOW32
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


def flat_edge_keep(seed: int, edge_id: torch.Tensor, edge_src: torch.Tensor,
                   edge_dst: torch.Tensor, p: float,
                   force_undirected: bool) -> torch.Tensor:
    """Keep decision [E] of each directed edge of a flat batch, keyed on its
    packed edge id (GraphBatch.edge_id): 2 * id for a forward copy
    (src < dst: user to item), 2 * id + 1 for a reverse one, as the dense
    layout keys its two directions; id alone with force_undirected."""
    keys = edge_id.long()
    if not force_undirected:
        keys = 2 * keys + (edge_src > edge_dst).long()
    return hash_edge_keep(seed, keys, p)


def edge_dropout(edge_mask: torch.Tensor, edge_canon: torch.Tensor,
                 keep: torch.Tensor, force_undirected: bool) -> torch.Tensor:
    """edge_mask AND the [E] keep decisions; with force_undirected each
    edge takes its forward copy's decision (keep[edge_canon]), so both
    copies of a pair drop together (dropout_adj(force_undirected=True)).
    `keep` comes from flat_edge_keep or is injected (the JAX package's
    jax.random.bernoulli mask)."""
    if force_undirected:
        keep = keep[edge_canon.long()]
    return edge_mask & keep


def feature_dropout(h: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Inverted dropout with a given keep mask: h / (1 - p) where kept,
    0 elsewhere (F.dropout's scaling)."""
    return torch.where(keep, h / (1.0 - p), torch.zeros_like(h))
