"""An ensemble of IGMC members scored by one forward, members as channels.

Serving averages the ratings of M members (serve.py). Run one after
another, each member would repeat work that is the same for all of them
(the batch's DensePlan, every layer's launches over rows of Cout floats).
StackedIGMC folds the members' parameters once into member-as-channel
weights, so that one forward over a DenseBatch computes every member at
the launch count of one:

  * layer l's relation weights W_r = att @ basis of every member as one
    [M * Cin, R * M * Cout] matrix, block-diagonal in the member, its
    columns in (relation, member, channel) order: x @ W reshapes without
    a permute to the [(B * n) * R, M * Cout] table that the plan's gather
    indexes, so each message is one row of M * Cout floats. The first
    layer's input is the one-hot hop label, which every member shares:
    its transforms are rows of an [F, R * M * Cout] table, gathered by
    label, as the one-hot product gives them exactly;
  * root block-diagonal [M * Cin, M * Cout] (the first layer's: rows
    gathered by label), bias [M * Cout];
  * the head as one batched product over the members: lin1 [M, K, HIDDEN]
    over each member's K = 2 * sum(latent) (+ side features) target
    states, lin2 [M, HIDDEN, 1]; it gives [M, B], whose mean over M is the
    ensemble's rating.

Every other step is a member's own, in its order of sums: one gather of
the 2 * B * E messages (rows of M * Cout floats), times their
coefficients, one index_add, times the inverse degree, plus x @ root,
plus bias, tanh. The zero blocks add exact zeros, so each member's
function is unchanged; only the order of sums inside a GEMM may differ
from a member's own forward. The head is batched, not block-diagonal: K
is 256 a member at the published widths, and a block-diagonal
[M * K, M * HIDDEN] product sums its rows in another order (an ulp off a
member's lin1 on the CPU's BLAS at M = 4), where the batched one sums as
the member does; lin2's one output column may still be summed otherwise
(nn.Linear as a matrix-vector product), within an ulp of the rating.

The fold covers what `stacks(cfg)` accepts: float32 (compute_dtype None)
and the edge strategies (dense_strategy auto, edge, edge-k), on every
layout (unified, bipartite, relation-slotted), every aggr, side features
and any M >= 1; in eval mode, as serving runs. Under bfloat16 and the
adjacency strategy the members run one after another.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..batching.dense import DenseBatch
from .igmc import IGMC, check_side_features, edge_plan
from .rgcn import resolve_compute_dtype


def stacks(cfg) -> bool:
    """Whether StackedIGMC computes the members of config `cfg`: float32
    and an edge strategy."""
    return (resolve_compute_dtype(cfg.compute_dtype) is None
            and cfg.dense_strategy in ("auto", "edge", "edge-k"))


def _relation_blocks(convs, shared: bool) -> torch.Tensor:
    """The members' layer relation weights as one matrix, columns (relation,
    member, channel): [Cin, R * M * Cout] when the input is `shared`, else
    [M * Cin, R * M * Cout], block-diagonal in the member."""
    ws = [c.relation_weights().transpose(0, 1) for c in convs]   # [Cin, R, Cout]
    M = len(ws)
    Cin, R, Cout = ws[0].shape
    if shared:
        return torch.stack(ws, dim=2).reshape(Cin, R * M * Cout)
    out = ws[0].new_zeros(M, Cin, R, M, Cout)
    for m, w in enumerate(ws):
        out[m, :, :, m] = w
    return out.reshape(M * Cin, R * M * Cout)


class StackedIGMC(nn.Module):
    """M IGMC members with one config (`stacks` true), folded at
    construction; `forward(batch)` is the members' mean rating [B] of a
    DenseBatch in eval mode. The members' parameters are read once: a
    member changed later is not seen."""

    def __init__(self, members: Sequence[IGMC]):
        super().__init__()
        if not members:
            raise ValueError("StackedIGMC needs at least one member")
        cfg = members[0].cfg
        if not stacks(cfg):
            raise ValueError(f"StackedIGMC runs float32 edge strategies, not "
                             f"compute_dtype {cfg.compute_dtype!r} / dense_strategy "
                             f"{cfg.dense_strategy!r}")
        self.cfg = cfg
        self.num_members = len(members)
        with torch.no_grad():
            layers = list(zip(*(m.convs for m in members)))
            w0 = _relation_blocks(layers[0], shared=True)
            root0 = torch.cat([c.root for c in layers[0]], 1)
            # one spare row of zeros: a padding node's one-hot row is 0
            self.register_buffer("w0", torch.cat([w0, w0.new_zeros(1, w0.shape[1])]))
            self.register_buffer("root0", torch.cat(
                [root0, root0.new_zeros(1, root0.shape[1])]))
            self.register_buffer("bias0", torch.cat([c.bias for c in layers[0]]))
            for l, convs in enumerate(layers[1:], 1):
                self.register_buffer(f"w{l}", _relation_blocks(convs, shared=False))
                self.register_buffer(f"root{l}",
                                     torch.block_diag(*[c.root for c in convs]))
                self.register_buffer(f"bias{l}", torch.cat([c.bias for c in convs]))
            # [M, out, in], nn.Linear's layout: the products read its transpose
            for name in ("lin1", "lin2"):
                lins = [getattr(m, name) for m in members]
                self.register_buffer(f"{name}_w", torch.stack([f.weight for f in lins]))
                self.register_buffer(f"{name}_b",
                                     torch.stack([f.bias for f in lins])[:, None])
        self.num_layers = len(layers)

    def forward(self, batch: DenseBatch) -> torch.Tensor:
        cfg, M = self.cfg, self.num_members
        if cfg.side_features:
            check_side_features(batch)
        B, n, R = batch.num_graphs, batch.node_slot, cfg.num_relations
        N = B * n
        plan = edge_plan(batch, cfg, batch.edge_mask, batch.edge_mask)
        label = torch.where(batch.node_mask, batch.node_label.long(),
                            cfg.num_features).reshape(-1)
        item_row = 1 if batch.num_u is None else batch.num_u
        users, items = [], []
        for l in range(self.num_layers):
            w, root = getattr(self, f"w{l}"), getattr(self, f"root{l}")
            if l == 0:   # x is the one-hot label: its products are table rows
                h, out = w.index_select(0, label), root.index_select(0, label)
            else:
                h, out = x @ w, x @ root
            MC = out.shape[1]
            msg = h.view(N * R, MC).index_select(0, plan.gather).mul_(plan.coef[:, None])
            agg = msg.new_zeros(N, MC).index_add_(0, plan.scatter, msg)
            if plan.inv_deg is not None:
                agg.mul_(plan.inv_deg)
            # aggregate + x @ root + bias, in a member's order of sums
            x = out.add_(agg).add_(getattr(self, f"bias{l}")).tanh_()
            rows = x.view(B, n, M, MC // M)
            users.append(rows[:, 0])
            items.append(rows[:, item_row])
        states = users + items
        if cfg.side_features:
            states += [batch.u_feat[:, None].expand(B, M, -1),
                       batch.v_feat[:, None].expand(B, M, -1)]
        s = torch.cat(states, dim=2).transpose(0, 1)             # [M, B, K]
        hidden = torch.baddbmm(self.lin1_b, s, self.lin1_w.transpose(1, 2)).relu_()
        out = torch.baddbmm(self.lin2_b, hidden, self.lin2_w.transpose(1, 2))  # [M, B, 1]
        return (out[..., 0] * cfg.multiply_by).mean(0)
