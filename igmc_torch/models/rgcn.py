"""The basis-decomposed relational graph convolution's parameters.

Port of igmc_tpu/models/rgcn.py (rgcn_init, rgcn_relation_weights,
gcn_init and the dense layers) as nn.Modules and functions. The layer
computes, as PyG 1.4.2's RGCNConv does,

    W_r  = sum_b att[r, b] * basis[b]                 (basis decomposition)
    out_i = aggr_{e: dst_e = i} x[src_e] @ W_{type_e} + x_i @ root + bias

with the aggregate done on the flat layout by the segment engine
(rgcn_apply below: gathers, one matmul per strategy, index_add), the
blocked engine (ops/blocked.py) or the fused kernels
(kernels/rgcn_aggregate.py), as models/igmc.py selects them, or by the
dense layers below on the dense slot layout (batching/dense.py). Parameter names and layouts equal the JAX
package's and the PyTorch reference's state_dict
(`convs.{i}.{basis,att,root,bias}`).

The dense layers compute the functions of the JAX package's
rgcn_dense_apply, rgcn_dense_bipartite_apply, rgcn_dense_relslot_apply and
rgcn_dense_adj_apply, not their TPU form (one-hot matmuls that fill the
MXU). The edge and relation-slotted strategies share one DensePlan per
forward: per node, H = x @ W for every relation at once; per stored edge,
the message H[src, type] flows to dst and H[dst, type] to src, each times
its direction's mask (and 1/c_{i,r} for relmean); the messages are summed
into their rows with one index_add over the flattened b * n + row. That is
sum_e mask_e * x[src_e] @ W_{type_e}, the one-hot form's sum, with O(E)
gathers in place of O(E * n) products. The adjacency strategy builds the
per-relation [B, R, n, n] adjacency once per forward and contracts it with
the per-node transforms in every layer, as the JAX package does.

rgcn_apply and gcn_apply are the JAX package's flat layers over a padded
edge list. rgcn_apply's relation transform has three strategies, chosen
by conv_strategy: "dispatch" (x @ W_r for every node and relation, an
[R, N, Cout] table, one gather per edge at type * N + src), "basis-mix"
(per edge, att[type] outer x[src] times the stacked bases: R-independent,
for many relations) and "per-edge" (per edge, x[src] @ W[type]); "auto"
takes dispatch when E >= N * R // 4, else basis-mix. Under bfloat16 the
transform rounds where the JAX package's does (x, W or att and basis, each
edge's att * x product, the messages) and the aggregation and x @ root +
bias stay float32; the sums run in float32 over bfloat16-rounded values.

GCNConv and the GCN dense layer (gcn_dense_plan, gcn_dense_layer,
gcn_dense_apply) are the trunk of the GNN and DGCNN families
(models/families.py): the JAX package's gcn_init and gcn_dense_apply,
computed with the same gathers and index_add as the R-GCN layers.

compute_dtype bfloat16 rounds where the JAX package rounds and sums in
float32 where it accumulates in float32 (preferred_element_type): a
bfloat16 product in torch returns bfloat16 and a bfloat16 index_add sums
in bfloat16, so every sum the JAX package keeps in float32 runs on float32
tensors that hold bfloat16-rounded values (the cast up is exact), and so
do the gathers, whose backward is such a sum. The edge strategies round x,
att, att[type] * coef and each edge's product att[type] * coef * x[src]
(the basis-mix form: the products are summed per row into a float32
[B * n, nb * Cin] table, which is then projected with basis in float32);
the relation-slotted strategy rounds each x @ W_r (a bfloat16 matmul,
float32 accumulation); the adjacency strategy rounds x @ basis and its
att-weighted mix. Degrees and relation counts are summed per direction,
rounded to bfloat16 and added in bfloat16, as the JAX package's bfloat16
einsums give them (exact below 257).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops.segment import masked_segment_mean, segment_sum


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


def resolve_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """None (float32) or torch.bfloat16, from a config value: None,
    "float32", "bfloat16" or the torch dtype."""
    if compute_dtype in (None, "float32", torch.float32):
        return None
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")


@dataclass
class DensePlan:
    """A dense batch's edges as flat gather / scatter indices, shared by
    every layer of one forward. Messages of both directions are stacked,
    forward (src -> dst) first: message m reads row gather[m] of H (the
    [(B * n) * R, Cout] per-(node, relation) transforms), that is node row
    rows[m] under relation etype[m], is scaled by coef[m] and lands in
    output row scatter[m] (b * n + row). Under bfloat16 `coef` holds
    bfloat16 values, and `edge_form` says whether each edge's product is
    rounded (the edge strategies) or each (node, relation) transform
    (relslot)."""

    gather: torch.Tensor            # int64 [2 * B * E]
    rows: torch.Tensor              # int64 [2 * B * E]
    etype: torch.Tensor             # int64 [2 * B * E]
    scatter: torch.Tensor           # int64 [2 * B * E]
    coef: torch.Tensor              # float32 [2 * B * E] mask (/ c_{i,r})
    inv_deg: Optional[torch.Tensor]   # float32 [B * n, 1] for mean, else None
    num_rows: int                   # B * n
    compute_dtype: Optional[torch.dtype] = None
    edge_form: bool = True


def _round(t: torch.Tensor, cd) -> torch.Tensor:
    """`t` rounded to bfloat16 and held in float32 (as is under float32).
    Its backward rounds the gradient to bfloat16 likewise."""
    return t if cd is None else t.to(cd).float()


def _directed_sum(index, weight, size: int, half: int, cd) -> torch.Tensor:
    """float32 sums of `weight` into `size` bins; under bfloat16 each
    direction's sum (forward = the first `half` entries) is rounded to
    bfloat16 and the two are added in bfloat16, as the JAX package sums
    them."""
    zeros = lambda: torch.zeros(size, dtype=torch.float32, device=weight.device)
    if cd is None:
        return zeros().index_add_(0, index, weight)
    fwd = zeros().index_add_(0, index[:half], weight[:half])
    rev = zeros().index_add_(0, index[half:], weight[half:])
    return (fwd.to(cd) + rev.to(cd)).float()


def dense_plan(edge_src, edge_dst, edge_type, mask_f, mask_r, num_nodes: int,
               num_relations: int, aggr: str = "mean", compute_dtype=None,
               edge_form: bool = True) -> DensePlan:
    """The plan of [B, E] forward edges (slot rows, relation, per-direction
    masks) in slots of `num_nodes` rows. relmean folds the inverse count
    of each (destination row, relation) pair into the coefficients; mean
    keeps the inverse degree, counted over both directions' kept edges."""
    if aggr not in AGGRS:
        raise ValueError(f"unknown aggr {aggr!r} (mean|sum|relmean)")
    cd = resolve_compute_dtype(compute_dtype)
    B, E = edge_src.shape
    R = num_relations
    base = torch.arange(B, device=edge_src.device)[:, None] * num_nodes
    rows_s = (base + edge_src.long()).reshape(-1)
    rows_d = (base + edge_dst.long()).reshape(-1)
    rows = torch.cat([rows_s, rows_d])
    etype = edge_type.long().reshape(-1).repeat(2)
    scatter = torch.cat([rows_d, rows_s])
    mask = torch.cat([mask_f.reshape(-1), mask_r.reshape(-1)]).float()
    N, half = B * num_nodes, B * E
    coef, inv_deg = mask, None
    if aggr == "relmean":
        pair = scatter * R + etype
        inv_cnt = 1.0 / _directed_sum(pair, mask, N * R, half, cd).clamp_min(1.0)
        coef = mask * _round(inv_cnt, cd)[pair]
    elif aggr == "mean":
        deg = _directed_sum(scatter, mask, N, half, cd)
        inv_deg = (1.0 / deg.clamp_min(1.0))[:, None]
    return DensePlan(rows * R + etype, rows, etype, scatter, coef, inv_deg, N, cd,
                     edge_form)


def rgcn_dense_layer(conv: RGCNConv, x: torch.Tensor, plan: DensePlan) -> torch.Tensor:
    """One R-GCN layer over node states x [B, n, Cin] (float32) and a
    DensePlan: [B, n, Cout] float32 = aggregate + x @ root + bias.

    float32, and bfloat16 on the relation-slotted strategy: the dispatch
    form (H = x @ W, one gather per message). bfloat16 on the edge
    strategies: the basis-mix form, which holds each message's
    att[type] * coef * x[src] as a [2 * B * E, nb * Cin] float32 table and
    its bfloat16 rounding (6 bytes per entry: 280 MB per layer at B 50,
    E 3,640, nb 4, Cin 32) before summing it into [B * n, nb * Cin] float32
    rows."""
    B, n, Cin = x.shape
    cd = plan.compute_dtype
    if cd is None or not plan.edge_form:
        w = conv.relation_weights()                          # [R, Cin, Cout]
        R, _, Cout = w.shape
        w = w.transpose(0, 1).reshape(Cin, R * Cout)
        xf = x.reshape(B * n, Cin)
        h = xf @ w if cd is None else (xf.to(cd) @ w.to(cd)).float()
        msg = h.reshape(B * n * R, Cout).index_select(0, plan.gather)
        msg = msg * plan.coef[:, None]
    else:
        nb, _, Cout = conv.basis.shape
        xs = _round(x.reshape(B * n, Cin), cd).index_select(0, plan.rows)
        af = _round(conv.att, cd).index_select(0, plan.etype) * plan.coef[:, None]
        af = _round(af, cd)
        msg = _round(af[:, :, None] * xs[:, None, :], cd).reshape(-1, nb * Cin)
    agg = torch.zeros(plan.num_rows, msg.shape[1], dtype=torch.float32, device=x.device)
    agg = agg.index_add(0, plan.scatter, msg)
    if cd is not None and plan.edge_form:
        agg = agg @ conv.basis.reshape(-1, Cout)
    if plan.inv_deg is not None:
        agg = agg * plan.inv_deg
    return agg.reshape(B, n, Cout) + x @ conv.root + conv.bias


def rgcn_dense_apply(conv: RGCNConv, x, edge_src, edge_dst, edge_type, mask_f,
                     mask_r, aggr: str = "mean", compute_dtype=None,
                     per_basis: bool = False) -> torch.Tensor:
    """The R-GCN layer over a unified dense batch: x [B, n, Cin], forward
    edges [B, E] (slot rows) applied in both directions, `mask_f` /
    `mask_r` [B, E] the kept edges per direction; aggr mean, sum or
    relmean; compute_dtype None (float32) or bfloat16. The function of the
    JAX package's rgcn_dense_apply.

    `per_basis` (dense_strategy 'edge-k') is accepted for parity with the
    JAX package, whose per-basis scatters sum the edge form's products
    split by basis and then add the splits: the same function with the
    same bfloat16 rounding points (its own test holds the two within rtol
    1e-5). Here it is an alias: the edge form's code runs for it."""
    del per_basis
    plan = dense_plan(edge_src, edge_dst, edge_type, mask_f, mask_r, x.shape[1],
                      conv.att.shape[0], aggr, compute_dtype)
    return rgcn_dense_layer(conv, x, plan)


def _check_num_u(num_u: int, node_slot: int):
    if not 0 < int(num_u) < node_slot:
        raise ValueError(f"num_u {num_u} outside the slot of {node_slot} rows")


def rgcn_dense_bipartite_apply(conv: RGCNConv, x, num_u: int, edge_src, edge_dst,
                               edge_type, mask_f, mask_r, aggr: str = "mean",
                               compute_dtype=None) -> torch.Tensor:
    """rgcn_dense_apply over a bipartite dense batch: users in rows
    [0, num_u), items in [num_u, n), `edge_dst` the item's slot row. With
    slot rows as indices the gather and scatter are those of the unified
    layout; the JAX package's per-side one-hot widths have no counterpart
    here."""
    _check_num_u(num_u, x.shape[1])
    return rgcn_dense_apply(conv, x, edge_src, edge_dst, edge_type, mask_f,
                            mask_r, aggr, compute_dtype)


def relslot_plan(edge_src, edge_dst, rel_caps, mask_f, mask_r, num_nodes: int,
                 num_relations: int, aggr: str = "mean",
                 compute_dtype=None) -> DensePlan:
    """The DensePlan of a relation-slotted edge axis (DenseBatch.rel_caps):
    relation r's edges sit in the static segment [off_r, off_r + caps[r]),
    so each position's relation comes from rel_caps, not from edge_type.
    aggr mean or sum, as in the JAX package."""
    if aggr not in ("mean", "sum"):
        raise ValueError(f"relslot strategy supports mean/sum, not {aggr}")
    caps = [int(c) for c in rel_caps]
    B, E = edge_src.shape
    if sum(caps) != E or len(caps) > num_relations:
        raise ValueError(f"rel_caps {tuple(caps)} must sum to edge_slot {E} over "
                         f"at most {num_relations} relations")
    rel = torch.repeat_interleave(torch.arange(len(caps), device=edge_src.device),
                                  torch.tensor(caps, device=edge_src.device))
    return dense_plan(edge_src, edge_dst, rel.expand(B, E), mask_f, mask_r,
                      num_nodes, num_relations, aggr, compute_dtype, edge_form=False)


def rgcn_dense_relslot_apply(conv: RGCNConv, x, edge_src, edge_dst, rel_caps,
                             mask_f, mask_r, aggr: str = "mean", compute_dtype=None,
                             num_u=None) -> torch.Tensor:
    """The R-GCN layer over a relation-slotted dense batch (unified, or
    bipartite with `num_u`): the function of the JAX package's
    rgcn_dense_relslot_apply, computed as x @ W_r per (node, relation) and
    gathered per message, which is its per-segment xs @ W_r. aggr mean or
    sum; relmean raises ValueError."""
    if num_u is not None:
        _check_num_u(num_u, x.shape[1])
    plan = relslot_plan(edge_src, edge_dst, rel_caps, mask_f, mask_r, x.shape[1],
                        conv.att.shape[0], aggr, compute_dtype)
    return rgcn_dense_layer(conv, x, plan)


def build_dense_adj(edge_src, edge_dst, edge_type, mask, num_relations: int,
                    node_slot: int, compute_dtype=None) -> torch.Tensor:
    """Per-relation dense adjacency A[b, r, i, j] = sum_e mask * 1[type_e = r,
    dst_e = i, src_e = j] of [B, E] forward edges, [B, R, n, n]: float32
    counts from one index_add, cast to the compute dtype (exact: counts of
    parallel edges). It depends on neither the layer nor the width, so one
    build per forward serves every layer (rgcn_dense_adj_apply)."""
    B, _ = edge_src.shape
    R, n = num_relations, node_slot
    b = torch.arange(B, device=edge_src.device)[:, None]
    idx = ((b * R + edge_type.long()) * n + edge_dst.long()) * n + edge_src.long()
    adj = torch.zeros(B * R * n * n, dtype=torch.float32, device=edge_src.device)
    adj = adj.index_add_(0, idx.reshape(-1), mask.reshape(-1).float())
    cd = resolve_compute_dtype(compute_dtype)
    adj = adj.reshape(B, R, n, n)
    return adj if cd is None else adj.to(cd)


def dense_adj_degrees(adj_f, adj_r=None) -> torch.Tensor:
    """1 / max(deg, 1) per node row, [B, n] float32: forward edges land on
    dst i (adj_f[..., i, :]), reverse ones on src i (adj_r[..., :, i];
    adj_r None reuses adj_f). The aggr 'mean' denominator of every layer."""
    ar = adj_f if adj_r is None else adj_r
    fwd, rev = adj_f.float().sum((1, 3)), ar.float().sum((1, 2))
    if adj_f.dtype == torch.bfloat16:
        deg = (fwd.to(adj_f.dtype) + rev.to(adj_f.dtype)).float()
    else:
        deg = fwd + rev
    return 1.0 / deg.clamp_min(1.0)


def rgcn_dense_adj_apply(conv: RGCNConv, x, adj_f, adj_r=None, aggr: str = "mean",
                         compute_dtype=None, inv_deg=None) -> torch.Tensor:
    """The R-GCN layer over a unified dense batch through its precomputed
    adjacencies (build_dense_adj): per node m[b, r, j] = sum_k att[r, k] *
    (x[b, j] @ basis[k]); forward messages sum A_f[b, r, i, j] * m[b, r, j]
    into row i, reverse ones A_r[b, r, j, i] * m[b, r, j] (adj_r None
    reuses adj_f, for masks tied across directions). `inv_deg` [B, n]
    (dense_adj_degrees) is required for aggr 'mean'; aggr mean or sum. The
    function of the JAX package's rgcn_dense_adj_apply."""
    if aggr not in ("mean", "sum"):
        raise ValueError(f"adjacency strategy supports mean/sum, not {aggr}")
    if aggr == "mean" and inv_deg is None:
        raise ValueError("aggr 'mean' needs inv_deg (dense_adj_degrees)")
    cd = resolve_compute_dtype(compute_dtype)
    B, n, Cin = x.shape
    nb, _, Cout = conv.basis.shape
    basis = conv.basis.transpose(0, 1).reshape(Cin, nb * Cout)
    att, xf = conv.att, x.reshape(B * n, Cin)
    if cd is not None:
        att, xf, basis = att.to(cd), xf.to(cd), basis.to(cd)
    h = (xf @ basis).reshape(B, n, nb, Cout)
    m = torch.einsum("rk,bjko->brjo", att, h).float()        # [B, R, n, Cout]
    af = adj_f.float()
    ar = af if adj_r is None else adj_r.float()
    agg = (torch.einsum("brij,brjo->bio", af, m)
           + torch.einsum("brji,brjo->bio", ar, m))
    if aggr == "mean":
        agg = agg * inv_deg[..., None]
    return agg + x @ conv.root + conv.bias


CONV_STRATEGIES = ("auto", "dispatch", "basis-mix", "per-edge")


def conv_strategy_for(strategy: str, num_edges: int, num_nodes: int,
                      num_relations: int) -> str:
    """The strategy rgcn_apply runs: `strategy`, or for "auto" dispatch when
    E >= N * R // 4 (the [R, N, Cout] table costs N * R transforms, the
    basis mix E * B), else basis-mix."""
    if strategy not in CONV_STRATEGIES:
        raise ValueError(f"unknown conv_strategy {strategy!r} "
                         f"({'|'.join(CONV_STRATEGIES)})")
    if strategy == "auto":
        return ("dispatch" if num_edges >= num_nodes * num_relations // 4
                else "basis-mix")
    return strategy


def rgcn_apply(conv: RGCNConv, x, edge_src, edge_dst, edge_type, edge_mask,
               num_nodes: int, strategy: str = "auto", aggr: str = "mean",
               compute_dtype=None) -> torch.Tensor:
    """The R-GCN layer over a padded flat edge list (the segment engine):
    x [N, Cin] float32, edges [E] (batch rows), edge_mask [E] the kept
    edges; [N, Cout] float32 = aggr over incoming messages + x @ root +
    bias. aggr 'mean' (over all incoming edges), 'sum' or 'relmean' (mean
    within each (dst, relation), summed over relations); `strategy` as in
    conv_strategy_for; compute_dtype None (float32) or bfloat16. The
    function of the JAX package's rgcn_apply."""
    if aggr not in AGGRS:
        raise ValueError(f"unknown aggr {aggr!r} (mean|sum|relmean)")
    cd = resolve_compute_dtype(compute_dtype)
    nb, Cin, Cout = conv.basis.shape
    R = conv.att.shape[0]
    N = num_nodes
    src, dst, typ = edge_src.long(), edge_dst.long(), edge_type.long()
    xc = _round(x, cd)
    strategy = conv_strategy_for(strategy, src.shape[0], N, R)
    if strategy != "basis-mix":
        w = _round(conv.relation_weights(), cd)              # [R, Cin, Cout]
    if strategy == "dispatch":
        h = _round(torch.einsum("ni,rio->rno", xc, w), cd)   # [R, N, Cout]
        msg = h.reshape(R * N, Cout).index_select(0, typ * N + src)
    elif strategy == "basis-mix":
        xs = xc.index_select(0, src)                         # [E, Cin]
        ae = _round(conv.att, cd).index_select(0, typ)       # [E, nb]
        z = _round(ae[:, :, None] * xs[:, None, :], cd).reshape(-1, nb * Cin)
        msg = _round(z @ _round(conv.basis, cd).reshape(nb * Cin, Cout), cd)
    else:                                                    # per-edge
        xs = xc.index_select(0, src)
        msg = _round(torch.bmm(xs[:, None, :], w.index_select(0, typ))[:, 0], cd)
    m = edge_mask.float()
    if aggr == "mean":
        agg = masked_segment_mean(msg, dst, edge_mask, N)
    elif aggr == "sum":
        agg = segment_sum(msg * m[:, None], dst, N)
    else:                                                    # relmean
        seg = dst * R + typ
        per_rel = (segment_sum(msg * m[:, None], seg, N * R)
                   / segment_sum(m, seg, N * R).clamp_min(1.0)[:, None])
        agg = per_rel.reshape(N, R, Cout).sum(1)
    return agg + x @ conv.root + conv.bias


def gcn_apply(conv: "GCNConv", x, edge_src, edge_dst, edge_mask, node_mask,
              num_nodes: int) -> torch.Tensor:
    """The GCN layer over a padded flat edge list: self-loops and the
    symmetric D^-1/2 (A + I) D^-1/2 norm, the degree counting the kept
    edges into a node and its self-loop if the node is real (a padding
    node's 0 gives 0). The function of the JAX package's gcn_apply."""
    h = x @ conv.weight
    src, dst = edge_src.long(), edge_dst.long()
    em, nm = edge_mask.to(h.dtype), node_mask.to(h.dtype)
    deg = segment_sum(em, dst, num_nodes) + nm
    dinv = torch.where(deg > 0, deg.clamp_min(1e-12).rsqrt(), torch.zeros_like(deg))
    coef = dinv[src] * dinv[dst] * em
    agg = segment_sum(h.index_select(0, src) * coef[:, None], dst, num_nodes)
    return agg + h * (dinv * dinv * nm)[:, None] + conv.bias


class GCNConv(nn.Module):
    """weight [Cin, Cout] ~ glorot U(±sqrt(6 / (Cin + Cout))), bias [Cout]
    zero (PyG's GCNConv init, the JAX package's gcn_init); the reference's
    state_dict names `convs.{i}.{weight,bias}`."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: torch.Generator):
        super().__init__()
        bound = math.sqrt(6.0 / (in_channels + out_channels))
        self.weight = nn.Parameter(uniform_(torch.empty(in_channels, out_channels),
                                            bound, generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))


@dataclass
class GCNPlan:
    """A dense batch's GCN propagation, shared by every layer of one
    forward: message m reads row gather[m] of h = x @ weight ([B * n, C]),
    is scaled by coef[m] and lands in row scatter[m]; forward messages
    (src -> dst) first. self_coef [B * n, 1] scales each row's own h."""

    gather: torch.Tensor      # int64 [2 * B * E]
    scatter: torch.Tensor     # int64 [2 * B * E]
    coef: torch.Tensor        # float32 [2 * B * E]
    self_coef: torch.Tensor   # float32 [B * n, 1]


def gcn_dense_plan(edge_src, edge_dst, mask_f, mask_r, node_mask) -> GCNPlan:
    """The symmetric normalisation D^-1/2 (A + I) D^-1/2 of [B, E] forward
    edges applied in both directions: a node's degree counts its kept
    forward edges at dst, its kept reverse edges at src, and its self-loop
    (the node mask); a degree of 0 (a padding row) gives 0."""
    B, n = node_mask.shape
    base = torch.arange(B, device=edge_src.device)[:, None] * n
    rows_s = (base + edge_src.long()).reshape(-1)
    rows_d = (base + edge_dst.long()).reshape(-1)
    mf, mr = mask_f.reshape(-1).float(), mask_r.reshape(-1).float()
    nm = node_mask.reshape(-1).float()
    deg = (torch.zeros_like(nm).index_add_(0, rows_d, mf).index_add_(0, rows_s, mr)
           + nm)
    dinv = torch.where(deg > 0, deg.clamp_min(1e-12).rsqrt(), torch.zeros_like(deg))
    norm = dinv[rows_s] * dinv[rows_d]
    return GCNPlan(torch.cat([rows_s, rows_d]), torch.cat([rows_d, rows_s]),
                   torch.cat([norm * mf, norm * mr]), (dinv * dinv * nm)[:, None])


def gcn_dense_layer(conv: GCNConv, x: torch.Tensor, plan: GCNPlan) -> torch.Tensor:
    """One GCN layer over node states x [B, n, Cin]: [B, n, Cout] =
    the normalised neighbour sum of h = x @ weight + the self-loop + bias."""
    B, n, _ = x.shape
    h = (x @ conv.weight).reshape(B * n, -1)
    msg = h.index_select(0, plan.gather) * plan.coef[:, None]
    agg = torch.zeros_like(h).index_add(0, plan.scatter, msg)
    return (agg + h * plan.self_coef + conv.bias).reshape(B, n, -1)


def gcn_dense_apply(conv: GCNConv, x, edge_src, edge_dst, mask_f, mask_r,
                    node_mask) -> torch.Tensor:
    """The GCN layer over a dense batch (self-loops, symmetric
    normalisation, forward-only [B, E] edges applied in both directions,
    `mask_f` / `mask_r` the kept edges per direction): the function of the
    JAX package's gcn_dense_apply."""
    plan = gcn_dense_plan(edge_src, edge_dst, mask_f, mask_r, node_mask)
    return gcn_dense_layer(conv, x, plan)
