"""The basis-decomposed relational graph convolution's parameters.

Port of igmc_tpu/models/rgcn.py (rgcn_init, rgcn_relation_weights) as an
nn.Module. The layer computes, as PyG 1.4.2's RGCNConv does,

    W_r  = sum_b att[r, b] * basis[b]                 (basis decomposition)
    out_i = aggr_{e: dst_e = i} x[src_e] @ W_{type_e} + x_i @ root + bias

with the aggregate done by kernels/rgcn_aggregate.py on the flat layout
(models/igmc.py wires it), or by rgcn_dense_apply on the dense slot layout
(batching/dense.py). Parameter names and layouts equal the JAX package's
and the PyTorch reference's state_dict (`convs.{i}.{basis,att,root,bias}`).

The dense layer computes the function of the JAX package's
rgcn_dense_apply / rgcn_dense_bipartite_apply, not their TPU form (one-hot
matmuls that fill the MXU): per node, H = x @ W for every relation at once;
per stored edge, the message H[src, type] flows to dst and H[dst, type] to
src, each times its direction's mask (and 1/c_{i,r} for relmean); the
messages are summed into their rows with one index_add over the flattened
b * n + row. That is sum_e mask_e * x[src_e] @ W_{type_e}, the one-hot
form's sum, with O(E) gathers in place of O(E * n) products.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    """Fill `t` in place with U(-bound, bound) from `generator`."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class RGCNConv(nn.Module):
    """basis [B, Cin, Cout], att [R, B], root [Cin, Cout], bias [Cout]; every
    tensor ~ U(±1/sqrt(B * Cin)) (the PyG 1.4.2 init)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_relations: int, num_bases: int,
                 generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(num_bases * in_channels)
        shapes = {
            "basis": (num_bases, in_channels, out_channels),
            "att": (num_relations, num_bases),
            "root": (in_channels, out_channels),
            "bias": (out_channels,),
        }
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                uniform_(torch.empty(shape), bound, generator)))

    def relation_weights(self) -> torch.Tensor:
        """W_r = att @ basis, shape [R, Cin, Cout]."""
        R, B = self.att.shape
        _, i, o = self.basis.shape
        return (self.att @ self.basis.reshape(B, i * o)).reshape(R, i, o)


AGGRS = ("mean", "sum", "relmean")


@dataclass
class DensePlan:
    """A dense batch's edges as flat gather / scatter indices, shared by
    every layer of one forward. Messages of both directions are stacked,
    forward (src -> dst) first: message m reads row gather[m] of H (the
    [(B * n) * R, Cout] per-(node, relation) transforms), is scaled by
    coef[m] and lands in output row scatter[m] (b * n + row)."""

    gather: torch.Tensor            # int64 [2 * B * E]
    scatter: torch.Tensor           # int64 [2 * B * E]
    coef: torch.Tensor              # float [2 * B * E] mask (/ c_{i,r})
    inv_deg: Optional[torch.Tensor]   # float [B * n, 1] for mean, else None
    num_rows: int                   # B * n


def dense_plan(edge_src, edge_dst, edge_type, mask_f, mask_r, num_nodes: int,
               num_relations: int, aggr: str = "mean",
               dtype=torch.float32) -> DensePlan:
    """The plan of [B, E] forward edges (slot rows, relation, per-direction
    masks) in slots of `num_nodes` rows. relmean folds the inverse count
    of each (destination row, relation) pair into the coefficients; mean
    keeps the inverse degree, counted over both directions' kept edges."""
    if aggr not in AGGRS:
        raise ValueError(f"unknown aggr {aggr!r} (mean|sum|relmean)")
    B, _ = edge_src.shape
    R = num_relations
    base = torch.arange(B, device=edge_src.device)[:, None] * num_nodes
    rows_s = (base + edge_src.long()).reshape(-1)
    rows_d = (base + edge_dst.long()).reshape(-1)
    etype = edge_type.long().reshape(-1).repeat(2)
    gather = torch.cat([rows_s, rows_d]) * R + etype
    scatter = torch.cat([rows_d, rows_s])
    coef = torch.cat([mask_f.reshape(-1), mask_r.reshape(-1)]).to(dtype)
    N = B * num_nodes
    inv_deg = None
    if aggr == "relmean":
        pair = scatter * R + etype
        cnt = torch.zeros(N * R, dtype=dtype, device=coef.device).index_add_(
            0, pair, coef)
        coef = coef / cnt.clamp_min(1.0)[pair]
    elif aggr == "mean":
        deg = torch.zeros(N, dtype=dtype, device=coef.device).index_add_(
            0, scatter, coef)
        inv_deg = (1.0 / deg.clamp_min(1.0))[:, None]
    return DensePlan(gather, scatter, coef, inv_deg, N)


def rgcn_dense_layer(conv: RGCNConv, x: torch.Tensor, plan: DensePlan) -> torch.Tensor:
    """One R-GCN layer over node states x [B, n, Cin] and a DensePlan:
    [B, n, Cout] = aggregate + x @ root + bias."""
    B, n, Cin = x.shape
    w = conv.relation_weights()                              # [R, Cin, Cout]
    R, _, Cout = w.shape
    h = x.reshape(B * n, Cin) @ w.transpose(0, 1).reshape(Cin, R * Cout)
    msg = h.reshape(B * n * R, Cout).index_select(0, plan.gather)
    msg = msg * plan.coef[:, None]
    agg = torch.zeros(plan.num_rows, Cout, dtype=x.dtype, device=x.device)
    agg = agg.index_add(0, plan.scatter, msg)
    if plan.inv_deg is not None:
        agg = agg * plan.inv_deg
    return agg.reshape(B, n, Cout) + x @ conv.root + conv.bias


def _refuse_p7(compute_dtype, per_basis):
    if compute_dtype is not None:
        raise NotImplementedError("igmc_torch dense layer: compute_dtype "
                                  f"{compute_dtype!r} is not ported (float32 only)")
    if per_basis:
        raise NotImplementedError("igmc_torch dense layer: per_basis "
                                  "(dense_strategy 'edge-k') is not ported")


def rgcn_dense_apply(conv: RGCNConv, x, edge_src, edge_dst, edge_type, mask_f,
                     mask_r, aggr: str = "mean", compute_dtype=None,
                     per_basis: bool = False) -> torch.Tensor:
    """The R-GCN layer over a unified dense batch: x [B, n, Cin], forward
    edges [B, E] (slot rows) applied in both directions, `mask_f` /
    `mask_r` [B, E] the kept edges per direction; aggr mean, sum or
    relmean. The function of the JAX package's rgcn_dense_apply."""
    _refuse_p7(compute_dtype, per_basis)
    plan = dense_plan(edge_src, edge_dst, edge_type, mask_f, mask_r, x.shape[1],
                      conv.att.shape[0], aggr, x.dtype)
    return rgcn_dense_layer(conv, x, plan)


def rgcn_dense_bipartite_apply(conv: RGCNConv, x, num_u: int, edge_src, edge_dst,
                               edge_type, mask_f, mask_r, aggr: str = "mean",
                               compute_dtype=None) -> torch.Tensor:
    """rgcn_dense_apply over a bipartite dense batch: users in rows
    [0, num_u), items in [num_u, n), `edge_dst` the item's slot row. With
    slot rows as indices the gather and scatter are those of the unified
    layout; the JAX package's per-side one-hot widths have no counterpart
    here."""
    if not 0 < int(num_u) < x.shape[1]:
        raise ValueError(f"num_u {num_u} outside the slot of {x.shape[1]} rows")
    return rgcn_dense_apply(conv, x, edge_src, edge_dst, edge_type, mask_f,
                            mask_r, aggr, compute_dtype)
