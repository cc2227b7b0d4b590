"""The IGMC model over flat padded graph batches (evaluation forward).

Port of igmc_tpu/models/igmc.py (IGMCConfig, igmc_init, and the flat
branch of igmc_forward with use_pallas): one-hot hop labels, 4 R-GCN
layers with tanh whose aggregate runs through the fused kernel
(kernels/rgcn_aggregate.py), the concatenated states of the target user
and target item, then relu(lin1) and lin2, times `multiply_by`.

Only the evaluation forward is ported: training mode (edge and feature
dropout), side features and the other aggregation engines and layouts
belong to later slices and raise here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..batching.batch import GraphBatch
from ..kernels.rgcn_aggregate import PLAN_ROWS, _dst_global, rgcn_aggregate
from .rgcn import RGCNConv, uniform_


@dataclass(frozen=True)
class IGMCConfig:
    num_features: int = 4                  # 2h + 2 one-hot node-label dim
    latent_dim: Tuple[int, ...] = (32, 32, 32, 32)
    num_relations: int = 5
    num_bases: int = 4
    multiply_by: float = 1.0
    aggr: str = "mean"                     # rgcn aggregation (mean/sum)


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
        self.lin1 = _linear(2 * sum(cfg.latent_dim), 128, generator)
        self.lin2 = _linear(128, 1, generator)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        """Predicted rating per graph, [B] float32 (evaluation mode only)."""
        cfg = self.cfg
        if self.training:
            raise NotImplementedError(
                "igmc_torch IGMC runs the evaluation forward only; call "
                ".eval() (training mode is not ported yet)")
        if cfg.aggr not in ("mean", "sum"):
            raise NotImplementedError(f"aggregate kernel + aggr={cfg.aggr}")
        aligned = batch.aligned
        if aligned is None:
            raise ValueError("the IGMC forward needs the batch's aligned edge "
                             "plan (BatchLoader attaches it)")
        N = batch.node_label.shape[0]
        x = F.one_hot(batch.node_label.long(), cfg.num_features).float()
        x = x * batch.node_mask[:, None].float()

        if cfg.aggr == "mean":
            amask = aligned[3]
            deg = torch.zeros(N, dtype=amask.dtype, device=amask.device)
            deg.index_add_(0, _dst_global(aligned, PLAN_ROWS), amask)
            inv_deg = (1.0 / deg.clamp_min(1.0))[:, None]

        states = []
        for conv in self.convs:
            agg = rgcn_aggregate(x, conv.att, conv.basis, aligned,
                                 PLAN_ROWS, N)
            if cfg.aggr == "mean":
                agg = agg * inv_deg
            x = torch.tanh(agg + x @ conv.root + conv.bias)
            states.append(x)
        concat_states = torch.cat(states, dim=1)        # [N, sum(latent)]

        h = torch.cat([concat_states[batch.target_u.long()],
                       concat_states[batch.target_v.long()]], dim=1)
        h = F.relu(self.lin1(h))
        return self.lin2(h)[:, 0] * cfg.multiply_by
