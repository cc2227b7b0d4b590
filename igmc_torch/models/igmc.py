"""The IGMC model over flat padded graph batches and dense slot batches.

Port of igmc_tpu/models/igmc.py (IGMCConfig, igmc_init, igmc_forward's
flat branch with use_pallas and its dense branch _igmc_forward_dense,
arr_regularizer): one-hot hop labels, 4 R-GCN layers with tanh, the states
of the target user and target item from every layer, then relu(lin1),
feature dropout 0.5 in training, and lin2, times `multiply_by`.

  * Flat GraphBatch: every layer's aggregate runs through the fused
    kernels (kernels/rgcn_aggregate.py); aggr mean or sum.
  * DenseBatch (batching/dense.py): every layer is rgcn_dense_layer over
    one DensePlan per forward (models/rgcn.py); the targets are slot rows
    0 and 1 (unified) or 0 and num_u (bipartite); aggr mean, sum or
    relmean.

In training mode the forward takes its noise from the caller,
(edge_noise, feature_keep) from `draw_noise`: edge_noise is a seed for
the hash edge dropout (flat: keyed on the plans' ukey stream, folded into
both plans' masks; dense: keyed on the batch's packed edge ids), and
feature_keep is lin1's dropout mask. A dense forward also takes
edge_noise as a pair of [B, E] keep masks (forward, reverse), so that
tests can feed it the JAX package's masks. Side features belong to a
later slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..batching.batch import GraphBatch
from ..batching.dense import DenseBatch
from ..kernels.rgcn_aggregate import PLAN_ROWS, _dst_global, rgcn_aggregate
from ..ops.dropout import edge_dropout_dense, feature_dropout, hash_edge_keep
from .rgcn import RGCNConv, dense_plan, rgcn_dense_layer, uniform_

HIDDEN = 128           # lin1's width
FEATURE_DROPOUT = 0.5  # dropout after relu(lin1) in training


@dataclass(frozen=True)
class IGMCConfig:
    num_features: int = 4                  # 2h + 2 one-hot node-label dim
    latent_dim: Tuple[int, ...] = (32, 32, 32, 32)
    num_relations: int = 5
    num_bases: int = 4
    adj_dropout: float = 0.2
    force_undirected: bool = False
    multiply_by: float = 1.0
    aggr: str = "mean"                     # mean/sum (flat), mean/sum/relmean (dense)


def _linear(in_features: int, out_features: int,
            generator: torch.Generator) -> nn.Linear:
    """nn.Linear with torch's default init, U(±1/sqrt(fan_in)) for weight
    and bias, drawn from `generator`."""
    lin = nn.Linear(in_features, out_features)
    bound = 1.0 / math.sqrt(in_features)
    uniform_(lin.weight, bound, generator)
    uniform_(lin.bias, bound, generator)
    return lin


class IGMC(nn.Module):
    """IGMC with parameters `convs.{i}.{basis,att,root,bias}`, `lin1` and
    `lin2` (the reference's state_dict layout; Linear weights [out, in]),
    initialised from `generator`."""

    def __init__(self, cfg: IGMCConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        convs = []
        in_dim = cfg.num_features
        for out_dim in cfg.latent_dim:
            convs.append(RGCNConv(in_dim, out_dim, cfg.num_relations,
                                  cfg.num_bases, generator))
            in_dim = out_dim
        self.convs = nn.ModuleList(convs)
        self.lin1 = _linear(2 * sum(cfg.latent_dim), HIDDEN, generator)
        self.lin2 = _linear(HIDDEN, 1, generator)

    def forward(self, batch, noise=None) -> torch.Tensor:
        """Predicted rating per graph, [B] float32, of a GraphBatch or a
        DenseBatch. In training mode `noise` = (edge_noise, feature_keep)
        is required (draw_noise)."""
        if self.training and noise is None:
            raise ValueError("IGMC in training mode needs noise = "
                             "(edge_seed, feature_keep) from draw_noise; "
                             "call .eval() to evaluate")
        edge_noise, feature_keep = noise if self.training else (None, None)
        if isinstance(batch, DenseBatch):
            states = self._dense_states(batch, edge_noise)
        else:
            states = self._flat_states(batch, edge_noise)
        h = F.relu(self.lin1(states))
        if self.training:
            h = feature_dropout(h, feature_keep, FEATURE_DROPOUT)
        return self.lin2(h)[:, 0] * self.cfg.multiply_by

    def _flat_states(self, batch: GraphBatch, edge_seed) -> torch.Tensor:
        """[B, 2 * sum(latent)]: the target user's and target item's states
        of every layer, through the fused aggregate."""
        cfg = self.cfg
        if cfg.aggr not in ("mean", "sum"):
            raise NotImplementedError(f"aggregate kernel + aggr={cfg.aggr}")
        aligned, aligned_t = batch.aligned, batch.aligned_t
        if aligned is None:
            raise ValueError("the IGMC forward needs the batch's aligned edge "
                             "plan (BatchLoader attaches it)")
        if self.training and cfg.adj_dropout > 0:
            aligned = _drop_edges(aligned, edge_seed, cfg)
            if aligned_t is not None:
                aligned_t = _drop_edges(aligned_t, edge_seed, cfg)
        N = batch.node_label.shape[0]
        x = F.one_hot(batch.node_label.long(), cfg.num_features).float()
        x = x * batch.node_mask[:, None].float()

        if cfg.aggr == "mean":
            amask = aligned[3]       # the degree counts the kept edges only
            deg = torch.zeros(N, dtype=amask.dtype, device=amask.device)
            deg.index_add_(0, _dst_global(aligned, PLAN_ROWS), amask)
            inv_deg = (1.0 / deg.clamp_min(1.0))[:, None]

        states = []
        for conv in self.convs:
            agg = rgcn_aggregate(x, conv.att, conv.basis, aligned,
                                 PLAN_ROWS, N, aligned_t)
            if cfg.aggr == "mean":
                agg = agg * inv_deg
            x = torch.tanh(agg + x @ conv.root + conv.bias)
            states.append(x)
        concat_states = torch.cat(states, dim=1)        # [N, sum(latent)]
        return torch.cat([concat_states[batch.target_u.long()],
                          concat_states[batch.target_v.long()]], dim=1)

    def _dense_states(self, batch: DenseBatch, edge_noise) -> torch.Tensor:
        """[B, 2 * sum(latent)]: the target rows' states of every layer of
        the dense trunk (one DensePlan for all layers)."""
        cfg = self.cfg
        mask_f = mask_r = batch.edge_mask
        if self.training and cfg.adj_dropout > 0:
            if isinstance(edge_noise, tuple):          # injected keep masks
                mask_f = batch.edge_mask & edge_noise[0]
                mask_r = batch.edge_mask & edge_noise[1]
            elif batch.edge_id is None:
                raise ValueError("dense edge dropout needs the batch's packed "
                                 "edge ids (assemble_dense attaches them)")
            else:
                mask_f, mask_r = edge_dropout_dense(
                    batch.edge_mask, batch.edge_id, edge_noise, cfg.adj_dropout,
                    cfg.force_undirected)
        x = F.one_hot(batch.node_label.long(), cfg.num_features).float()
        x = x * batch.node_mask[..., None].float()
        plan = dense_plan(batch.edge_src, batch.edge_dst, batch.edge_type,
                          mask_f, mask_r, batch.node_slot, cfg.num_relations,
                          cfg.aggr)
        item_row = 1 if batch.num_u is None else batch.num_u
        users, items = [], []
        for conv in self.convs:
            x = torch.tanh(rgcn_dense_layer(conv, x, plan))
            users.append(x[:, 0])
            items.append(x[:, item_row])
        return torch.cat(users + items, dim=1)


def _drop_edges(plan, edge_seed: int, cfg: IGMCConfig):
    """`plan` with the hash edge dropout folded into its mask. The ukey
    stream keys the original orientation in both plans, so the dst- and
    src-sorted plans drop the same edges."""
    if len(plan) < 7 or plan[6] is None:
        raise ValueError("edge dropout needs the plan's ukey stream "
                         "(BatchLoader attaches it)")
    ukey = plan[6]
    keep = hash_edge_keep(edge_seed, ukey // 2 if cfg.force_undirected else ukey,
                          cfg.adj_dropout)
    return plan[:3] + (plan[3] * keep.to(plan[3].dtype),) + plan[4:]


def draw_noise(generator: torch.Generator, batch_size: int):
    """One training step's noise from a CPU generator: (edge_seed, an int
    in [0, 2**31 - 1), and feature_keep, a [batch_size, HIDDEN] bool mask
    of Bernoulli(1 - FEATURE_DROPOUT)). Drawn on the CPU so the card and
    the CPU see the same noise; move feature_keep to the batch's device."""
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    keep = torch.rand(batch_size, HIDDEN, generator=generator) >= FEATURE_DROPOUT
    return seed, keep


def arr_regularizer(model: IGMC) -> torch.Tensor:
    """Adjacent-rating regularizer: the sum over layers of
    ||W[1:] - W[:-1]||^2 with W = att @ basis, [R, Cin, Cout]."""
    reg = 0.0
    for conv in model.convs:
        w = conv.relation_weights()
        reg = reg + ((w[1:] - w[:-1]) ** 2).sum()
    return reg
