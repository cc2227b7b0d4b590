"""The paper's baseline families on the flat and dense slot layouts: GNN,
DGCNN and DGCNN_RS.

Port of igmc_tpu/models/igmc.py's GNNConfig / gnn_init / gnn_forward and
DGCNNConfig / dgcnn_init / dgcnn_forward and sortpool_k_from_dataset:

  * GNN: a GCN trunk (GCNConv layers of `latent_dim`, tanh), the states of
    every layer concatenated and summed over the graph's node rows, then
    relu(lin1), feature dropout 0.5 in training, and lin2.
  * DGCNN: the same GCN trunk, or with `relational` (DGCNN_RS) a trunk of
    R-GCN layers with aggr "mean"; SortPooling of the concatenated states
    (ops/sort_pool.py) to k rows; Conv1d(1, C1, D, stride D), that is a
    linear map of each pooled row, relu, MaxPool1d(2, 2); Conv1d(C1, C2,
    5), relu, flattened; relu(lin1), dropout, lin2.

A flat GraphBatch runs the segment engine (models/rgcn.py gcn_apply, and
rgcn_apply with conv_strategy "auto" for DGCNN_RS), the sum pool as
masked_segment_sum over node2graph and SortPooling as global_sort_pool; a
DenseBatch runs the dense layers, the sum over node slots and
dense_sort_pool.

Parameter names are the PyTorch reference's (`convs.{i}.{weight,bias}` for
GCN layers, `convs.{i}.{basis,att,root,bias}` for R-GCN layers,
`conv1d_params1` / `conv1d_params2` as torch.nn.Conv1d, `lin1`, `lin2`).
Training noise is IGMC's (draw_noise): hash dropout of the packed edge ids
or injected keep masks ([E] flat; (forward, reverse) [B, E] dense), and
lin1's feature_keep. The families have no compute dtype, side features or
multiply_by, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..batching.dense import DenseBatch
from ..ops.dropout import feature_dropout
from ..ops.segment import masked_segment_sum
from ..ops.sort_pool import dense_sort_pool, global_sort_pool
from .igmc import (FEATURE_DROPOUT, HIDDEN, _linear, dense_edge_masks, flat_edge_mask,
                   node_onehot)
from .rgcn import (GCNConv, RGCNConv, dense_plan, gcn_apply, gcn_dense_layer,
                   gcn_dense_plan, rgcn_apply, rgcn_dense_layer, uniform_)


@dataclass(frozen=True)
class GNNConfig:
    num_features: int = 4
    latent_dim: Tuple[int, ...] = (32, 32, 32, 1)
    adj_dropout: float = 0.2
    force_undirected: bool = False
    regression: bool = True
    num_classes: int = 1


@dataclass(frozen=True)
class DGCNNConfig:
    num_features: int = 4
    latent_dim: Tuple[int, ...] = (32, 32, 32, 1)
    k: int = 30
    adj_dropout: float = 0.2
    force_undirected: bool = False
    regression: bool = True
    num_classes: int = 1
    # the RS variant (relational trunk):
    relational: bool = False
    num_relations: int = 5
    num_bases: int = 2
    conv1d_channels: Tuple[int, int] = (16, 32)
    conv1d_kw2: int = 5

    @property
    def total_latent_dim(self) -> int:
        return sum(self.latent_dim)

    @property
    def dense_dim(self) -> int:
        d = int((self.k - 2) / 2 + 1)
        return (d - self.conv1d_kw2 + 1) * self.conv1d_channels[1]


def sortpool_k_from_dataset(node_counts, k_fraction: float) -> int:
    """The SortPool k of a percentile k_fraction in (0, 1): that fraction's
    node count among the dataset's graphs, at least 10 (the reference's
    rule)."""
    node_nums = sorted(int(n) for n in node_counts)
    k = node_nums[int(math.ceil(k_fraction * len(node_nums))) - 1]
    return max(10, k)


def _conv1d(in_ch: int, out_ch: int, kernel: int, stride: int,
            generator: torch.Generator) -> nn.Conv1d:
    """nn.Conv1d with weight and bias ~ U(±1/sqrt(in_ch * kernel)), torch's
    default bound, drawn from `generator`."""
    conv = nn.Conv1d(in_ch, out_ch, kernel, stride=stride)
    bound = 1.0 / math.sqrt(in_ch * kernel)
    uniform_(conv.weight, bound, generator)
    uniform_(conv.bias, bound, generator)
    return conv


def _check_batch(batch, family: str):
    if isinstance(batch, DenseBatch) and batch.rel_caps is not None:
        raise NotImplementedError(f"{family} on the relation-slotted layout")
    return batch


class _Family(nn.Module):
    """What the families share: the noise contract and the MLP head."""

    def _noise(self, noise):
        if self.training and noise is None:
            raise ValueError(f"{type(self).__name__} in training mode needs noise "
                             f"= (edge_seed, feature_keep) from draw_noise; call "
                             f".eval() to evaluate")
        return noise if self.training else (None, None)

    def trunk(self, batch, edge_noise=None) -> torch.Tensor:
        """The trunk's layer states, concatenated: [N, sum(latent)] of a
        flat batch, [B, n, sum(latent)] of a dense one (`edge_noise` as
        forward's, read in training mode only)."""
        return self._gcn_states(batch, edge_noise)

    def _gcn_states(self, batch, edge_noise) -> torch.Tensor:
        x = node_onehot(batch, self.cfg.num_features)
        if isinstance(batch, DenseBatch):
            mask_f, mask_r = dense_edge_masks(batch, edge_noise, self.cfg,
                                              self.training)
            plan = gcn_dense_plan(batch.edge_src, batch.edge_dst, mask_f, mask_r,
                                  batch.node_mask)
            layer = lambda conv, h: gcn_dense_layer(conv, h, plan)
        else:
            emask = flat_edge_mask(batch, edge_noise, self.cfg, self.training)
            layer = lambda conv, h: gcn_apply(conv, h, batch.edge_src, batch.edge_dst,
                                              emask, batch.node_mask, h.shape[0])
        states = []
        for conv in self.convs:
            x = torch.tanh(layer(conv, x))
            states.append(x)
        return torch.cat(states, dim=-1)

    def _head(self, h: torch.Tensor, feature_keep) -> torch.Tensor:
        h = F.relu(self.lin1(h))
        if self.training:
            h = feature_dropout(h, feature_keep, FEATURE_DROPOUT)
        out = self.lin2(h)
        return out[:, 0] if self.cfg.regression else F.log_softmax(out, dim=-1)


class GNN(_Family):
    """GCN trunk + sum pool + MLP, initialised from `generator`."""

    def __init__(self, cfg: GNNConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dims = (cfg.num_features,) + tuple(cfg.latent_dim)
        self.convs = nn.ModuleList(GCNConv(i, o, generator)
                                   for i, o in zip(dims[:-1], dims[1:]))
        self.lin1 = _linear(sum(cfg.latent_dim), HIDDEN, generator)
        self.lin2 = _linear(HIDDEN, 1 if cfg.regression else cfg.num_classes,
                            generator)

    def forward(self, batch, noise=None) -> torch.Tensor:
        """Predicted rating per graph, [B] (log-probabilities [B, classes]
        when not regression)."""
        batch = _check_batch(batch, "GNN")
        edge_noise, feature_keep = self._noise(noise)
        states = self.trunk(batch, edge_noise)
        if isinstance(batch, DenseBatch):
            pooled = (states * batch.node_mask[..., None].float()).sum(dim=1)
        else:
            pooled = masked_segment_sum(states, batch.node2graph, batch.node_mask,
                                        batch.num_graphs)
        return self._head(pooled, feature_keep)


class DGCNN(_Family):
    """DGCNN (GCN trunk) or, with cfg.relational, DGCNN_RS (R-GCN trunk):
    SortPooling + two Conv1d layers + MLP, initialised from `generator`."""

    def __init__(self, cfg: DGCNNConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dims = (cfg.num_features,) + tuple(cfg.latent_dim)
        if cfg.relational:
            convs = (RGCNConv(i, o, cfg.num_relations, cfg.num_bases, generator)
                     for i, o in zip(dims[:-1], dims[1:]))
        else:
            convs = (GCNConv(i, o, generator) for i, o in zip(dims[:-1], dims[1:]))
        self.convs = nn.ModuleList(convs)
        D = cfg.total_latent_dim
        c1, c2 = cfg.conv1d_channels
        self.conv1d_params1 = _conv1d(1, c1, D, D, generator)
        self.conv1d_params2 = _conv1d(c1, c2, cfg.conv1d_kw2, 1, generator)
        self.lin1 = _linear(cfg.dense_dim, HIDDEN, generator)
        self.lin2 = _linear(HIDDEN, 1 if cfg.regression else cfg.num_classes,
                            generator)

    def trunk(self, batch, edge_noise=None) -> torch.Tensor:
        """The trunk's layer states, concatenated: [N, sum(latent)] of a
        flat batch, [B, n, sum(latent)] of a dense one; SortPool ranks the
        rows by the last channel."""
        if not self.cfg.relational:
            return self._gcn_states(batch, edge_noise)
        cfg = self.cfg
        x = node_onehot(batch, cfg.num_features)
        if isinstance(batch, DenseBatch):
            mask_f, mask_r = dense_edge_masks(batch, edge_noise, cfg, self.training)
            plan = dense_plan(batch.edge_src, batch.edge_dst, batch.edge_type, mask_f,
                              mask_r, batch.node_slot, cfg.num_relations, "mean")
            layer = lambda conv, h: rgcn_dense_layer(conv, h, plan)
        else:
            emask = flat_edge_mask(batch, edge_noise, cfg, self.training)
            layer = lambda conv, h: rgcn_apply(conv, h, batch.edge_src, batch.edge_dst,
                                               batch.edge_type, emask, h.shape[0])
        states = []
        for conv in self.convs:
            x = torch.tanh(layer(conv, x))
            states.append(x)
        return torch.cat(states, dim=-1)

    def forward(self, batch, noise=None) -> torch.Tensor:
        """Predicted rating per graph, [B] (log-probabilities [B, classes]
        when not regression)."""
        cfg = self.cfg
        batch = _check_batch(batch, "DGCNN_RS" if cfg.relational else "DGCNN")
        edge_noise, feature_keep = self._noise(noise)
        states = self.trunk(batch, edge_noise)
        B, D = batch.num_graphs, cfg.total_latent_dim
        if isinstance(batch, DenseBatch):
            pooled = dense_sort_pool(states, batch.node_mask, cfg.k)
        else:
            pooled = global_sort_pool(states, batch.node2graph, batch.node_mask, B,
                                      cfg.k)
        pooled = pooled.reshape(B, cfg.k, D)
        # Conv1d(1, C1, D, stride D): the same linear map of each pooled row
        w1 = self.conv1d_params1.weight[:, 0, :]                    # [C1, D]
        h = (pooled @ w1.t()).transpose(1, 2) + self.conv1d_params1.bias[:, None]
        h = F.max_pool1d(F.relu(h), 2, 2)                           # [B, C1, k // 2]
        h = F.relu(self.conv1d_params2(h)).reshape(B, -1)
        return self._head(h, feature_keep)
