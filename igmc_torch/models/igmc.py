"""The IGMC model over flat padded graph batches and dense slot batches.

Port of igmc_tpu/models/igmc.py (IGMCConfig, igmc_init, igmc_forward's
flat branches: segment, _igmc_forward_blocked and use_pallas, its dense
branch _igmc_forward_dense, chunk_dense_batch, igmc_forward_dense_chunked,
arr_regularizer): one-hot hop labels, 4 R-GCN layers with tanh, the states
of the target user and target item from every layer, then relu(lin1),
feature dropout 0.5 in training, and lin2, times `multiply_by`.

  * Flat GraphBatch: `flat_aggregate` names the engine of every layer's
    aggregate (batching/batch.py flat_engine reads its spellings).
    "segment" (the default, as in the JAX package): rgcn_apply
    (models/rgcn.py) with `conv_strategy`, aggr mean, sum or relmean,
    `compute_dtype` float32 or bfloat16. "blocked": the scatter-free
    blocked engine (ops/blocked.py) over the batch's `blocked` plans
    (BatchLoader(flat_aggregate="blocked")), aggr mean, sum or relmean,
    bfloat16 in its forward messages. "pallas": the fused kernels
    (kernels/rgcn_aggregate.py) over the batch's aligned plans, aggr mean
    or sum, in float32 whatever `compute_dtype` says, as the JAX package's
    fused aggregate.
  * DenseBatch (batching/dense.py): the targets are slot rows 0 and 1
    (unified) or 0 and num_u (bipartite). A relation-slotted batch
    (`rel_caps`) runs the relslot strategy, any other the edge strategy
    (`dense_strategy` auto or edge: one DensePlan per forward; edge-k is
    accepted as an alias of edge, for parity with the JAX package) or,
    on the unified layout only, the adjacency strategy (one [B, R, n, n]
    adjacency per forward); models/rgcn.py has the layers. aggr mean, sum
    or relmean (edge), mean or sum (relslot, adjacency); `compute_dtype`
    float32 or bfloat16.

With `side_features`, the batch's target-user and target-item feature
rows are concatenated after the target states, so lin1 takes
2 * sum(latent) + n_side_features inputs.

In training mode the forward takes its noise from the caller,
(edge_noise, feature_keep) from `draw_noise`: edge_noise is a seed for
the hash edge dropout (segment and dense: keyed on the batch's packed edge
ids; blocked: on the plans' pair and ukey streams; pallas: on the plans'
ukey stream, folded into both plans' masks), and feature_keep is lin1's
dropout mask. A segment forward also takes edge_noise as an [E] keep
mask, and a dense one as a pair of [B, E] keep masks (forward, reverse),
so that tests can feed them the JAX package's masks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..batching.batch import GraphBatch, flat_engine
from ..batching.dense import DenseBatch
from ..kernels.rgcn_aggregate import PLAN_ROWS, _dst_global, rgcn_aggregate
from ..ops.blocked import (blocked_degree, blocked_rel_counts,
                           blocked_rgcn_aggregate, dropout_masks, relmean_weights)
from ..ops.dropout import (edge_dropout, edge_dropout_dense, feature_dropout,
                           flat_edge_keep, hash_edge_keep)
from .rgcn import (AGGRS, RGCNConv, build_dense_adj, dense_adj_degrees, dense_plan,
                   relslot_plan, resolve_compute_dtype, rgcn_apply,
                   rgcn_dense_adj_apply, rgcn_dense_layer, uniform_)

HIDDEN = 128           # lin1's width
FEATURE_DROPOUT = 0.5  # dropout after relu(lin1) in training
# auto = edge; edge-k = edge (the JAX package's per-basis scatters compute
# the edge form's function, so the port runs the edge code for it)
DENSE_STRATEGIES = ("auto", "edge", "edge-k", "adjacency")


@dataclass(frozen=True)
class IGMCConfig:
    num_features: int = 4                  # 2h + 2 one-hot node-label dim
    latent_dim: Tuple[int, ...] = (32, 32, 32, 32)
    num_relations: int = 5
    num_bases: int = 4
    adj_dropout: float = 0.2
    force_undirected: bool = False
    side_features: bool = False
    n_side_features: int = 0               # du + dv when side_features
    multiply_by: float = 1.0
    conv_strategy: str = "auto"            # segment engine: models/rgcn.py CONV_STRATEGIES
    aggr: str = "mean"                     # mean/sum/relmean (pallas: mean/sum)
    dense_strategy: str = "auto"           # DENSE_STRATEGIES
    compute_dtype: Optional[str] = None    # None (float32) or "bfloat16"
    flat_aggregate: str = "segment"        # flat engine: batching flat_engine
    pallas_rows: int = PLAN_ROWS           # output-chunk rows of the aggregate kernels


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
        n_side = cfg.n_side_features if cfg.side_features else 0
        self.lin1 = _linear(2 * sum(cfg.latent_dim) + n_side, HIDDEN, generator)
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
        if self.cfg.side_features:
            check_side_features(batch)
            states = torch.cat([states, batch.u_feat, batch.v_feat], dim=1)
        h = F.relu(self.lin1(states))
        if self.training:
            h = feature_dropout(h, feature_keep, FEATURE_DROPOUT)
        return self.lin2(h)[:, 0] * self.cfg.multiply_by

    def _flat_states(self, batch: GraphBatch, edge_noise) -> torch.Tensor:
        """[B, 2 * sum(latent)]: the target user's and target item's states
        of every layer, through the engine cfg.flat_aggregate names."""
        engine = flat_engine(self.cfg.flat_aggregate)
        states = {"segment": self._segment_states, "blocked": self._blocked_states,
                  "pallas": self._fused_states}[engine](batch, edge_noise)
        concat_states = torch.cat(states, dim=1)        # [N, sum(latent)]
        # a padding graph's targets may lie one past the last row of a full
        # device-assembled batch; the JAX package's gather clamps them
        last = concat_states.shape[0] - 1
        return torch.cat([concat_states[batch.target_u.long().clamp_max(last)],
                          concat_states[batch.target_v.long().clamp_max(last)]], dim=1)

    def _segment_states(self, batch: GraphBatch, edge_noise) -> List[torch.Tensor]:
        """Every layer's node states through the segment engine (rgcn_apply)."""
        cfg = self.cfg
        emask = flat_edge_mask(batch, edge_noise, cfg, self.training)
        N = batch.node_label.shape[0]
        x = node_onehot(batch, cfg.num_features)
        states = []
        for conv in self.convs:
            x = torch.tanh(rgcn_apply(conv, x, batch.edge_src, batch.edge_dst,
                                      batch.edge_type, emask, N, cfg.conv_strategy,
                                      cfg.aggr, cfg.compute_dtype))
            states.append(x)
        return states

    def _blocked_states(self, batch: GraphBatch, edge_seed) -> List[torch.Tensor]:
        """Every layer's node states through the blocked engine, over the
        batch's dst- and src-major plans; dropout is the hash of the plans'
        pair (force_undirected) or ukey streams, as in the JAX package."""
        cfg = self.cfg
        blocked = batch.blocked
        if blocked is None:
            raise ValueError("flat_aggregate='blocked' needs dst/src-blocked plans "
                             "on the batch (BatchLoader(flat_aggregate='blocked') "
                             "or ops.plan_blocked_edges)")
        if cfg.aggr not in AGGRS:
            raise NotImplementedError(f"flat_aggregate='blocked': unknown aggr "
                                      f"{cfg.aggr}")
        N, rows = batch.node_label.shape[0], blocked.rows
        masks, inv_deg = (blocked.fwd.mask, blocked.bwd.mask), None
        if self.training and cfg.adj_dropout > 0:
            masks = dropout_masks(blocked, cfg.adj_dropout, cfg.force_undirected,
                                  edge_seed)
        if cfg.aggr == "mean":
            deg = blocked_degree(blocked.fwd, masks[0], rows, N)
            inv_deg = (1.0 / deg.clamp_min(1.0))[:, None]
        elif cfg.aggr == "relmean":
            # 1/c_{i,r} folded into both plans' per-edge weights, after dropout
            R = cfg.num_relations
            cnt = blocked_rel_counts(blocked.fwd, masks[0], R, rows, N)
            cinv = (1.0 / cnt.clamp_min(1.0)).reshape(-1)
            masks = (relmean_weights(cinv, blocked.fwd, masks[0], R, rows, True),
                     relmean_weights(cinv, blocked.bwd, masks[1], R, rows, False))
        cd = resolve_compute_dtype(cfg.compute_dtype)
        return self._summed_layers(
            batch, lambda conv, x: blocked_rgcn_aggregate(x, conv.att, conv.basis,
                                                          blocked, masks, cd),
            inv_deg)

    def _fused_states(self, batch: GraphBatch, edge_seed) -> List[torch.Tensor]:
        """Every layer's node states through the fused aggregate, in float32
        whatever cfg.compute_dtype says (as the JAX package's fused
        aggregate)."""
        cfg = self.cfg
        if cfg.aggr not in ("mean", "sum"):
            raise NotImplementedError(f"aggregate kernel + aggr={cfg.aggr}")
        aligned, aligned_t = batch.aligned, batch.aligned_t
        if aligned is None:
            raise ValueError("flat_aggregate='pallas' needs the batch's aligned "
                             "edge plan (BatchLoader(flat_aggregate='pallas') "
                             "attaches it)")
        rows = cfg.pallas_rows
        if batch.plan_rows is not None and batch.plan_rows != rows:
            raise ValueError(f"IGMCConfig.pallas_rows {rows} != the batch's plan "
                             f"rows {batch.plan_rows} (BatchLoader(plan_rows=))")
        if self.training and cfg.adj_dropout > 0:
            aligned = _drop_edges(aligned, edge_seed, cfg)
            if aligned_t is not None:
                aligned_t = _drop_edges(aligned_t, edge_seed, cfg)
        N = batch.node_label.shape[0]
        inv_deg = None
        if cfg.aggr == "mean":
            amask = aligned[3]       # the degree counts the kept edges only
            deg = torch.zeros(N, dtype=amask.dtype, device=amask.device)
            deg.index_add_(0, _dst_global(aligned, rows), amask)
            inv_deg = (1.0 / deg.clamp_min(1.0))[:, None]
        return self._summed_layers(
            batch, lambda conv, x: rgcn_aggregate(x, conv.att, conv.basis, aligned,
                                                  rows, N, aligned_t),
            inv_deg)

    def _summed_layers(self, batch: GraphBatch, aggregate, inv_deg) -> List[torch.Tensor]:
        """Every layer's node states when `aggregate(conv, x)` gives the
        summed messages into each row: tanh(agg (* inv_deg for mean) +
        x @ root + bias)."""
        x = node_onehot(batch, self.cfg.num_features)
        states = []
        for conv in self.convs:
            agg = aggregate(conv, x)
            if inv_deg is not None:
                agg = agg * inv_deg
            x = torch.tanh(agg + x @ conv.root + conv.bias)
            states.append(x)
        return states

    def _dense_states(self, batch: DenseBatch, edge_noise) -> torch.Tensor:
        """[B, 2 * sum(latent)]: the target rows' states of every layer of
        the dense trunk, by the strategy the batch and the config select
        (the dispatch of the JAX package's _igmc_forward_dense)."""
        cfg = self.cfg
        if cfg.dense_strategy not in DENSE_STRATEGIES:
            raise ValueError(f"unknown dense_strategy {cfg.dense_strategy!r} "
                             f"({'|'.join(DENSE_STRATEGIES)})")
        cd = resolve_compute_dtype(cfg.compute_dtype)
        use_adj = cfg.dense_strategy == "adjacency"
        if use_adj and (batch.num_u is not None or batch.rel_caps is not None):
            raise NotImplementedError(
                "dense_strategy='adjacency' is unified-layout only; the "
                "bipartite/relslot layouts' cheaper one-hot work supersedes it")
        mask_f, mask_r = dense_edge_masks(batch, edge_noise, cfg, self.training)
        x = node_onehot(batch, cfg.num_features)
        n, R = batch.node_slot, cfg.num_relations
        if use_adj:
            # one build for every layer; masks tied across directions
            # (eval, force_undirected) share one adjacency
            adj_f = build_dense_adj(batch.edge_src, batch.edge_dst, batch.edge_type,
                                    mask_f, R, n, cd)
            adj_r = None if mask_r is mask_f else build_dense_adj(
                batch.edge_src, batch.edge_dst, batch.edge_type, mask_r, R, n, cd)
            inv_deg = dense_adj_degrees(adj_f, adj_r) if cfg.aggr == "mean" else None
            layer = lambda conv, h: rgcn_dense_adj_apply(conv, h, adj_f, adj_r,
                                                         cfg.aggr, cd, inv_deg)
        else:
            plan = edge_plan(batch, cfg, mask_f, mask_r)
            layer = lambda conv, h: rgcn_dense_layer(conv, h, plan)
        item_row = 1 if batch.num_u is None else batch.num_u
        users, items = [], []
        for conv in self.convs:
            x = torch.tanh(layer(conv, x))
            users.append(x[:, 0])
            items.append(x[:, item_row])
        return torch.cat(users + items, dim=1)


def check_side_features(batch) -> None:
    """Raise ValueError unless the batch carries its target rows' side
    features (cfg.side_features)."""
    if batch.u_feat is None or batch.v_feat is None:
        raise ValueError("side_features: the batch carries no u_feat / v_feat "
                         "(build the dataset with u_features and v_features)")


def edge_plan(batch: DenseBatch, cfg, mask_f, mask_r):
    """The DensePlan of a dense batch's edges under the edge strategies:
    relslot_plan on a relation-slotted batch, else dense_plan. `cfg`
    carries num_relations, aggr and compute_dtype."""
    n, R, cd = batch.node_slot, cfg.num_relations, cfg.compute_dtype
    if batch.rel_caps is not None:
        return relslot_plan(batch.edge_src, batch.edge_dst, batch.rel_caps,
                            mask_f, mask_r, n, R, cfg.aggr, cd)
    return dense_plan(batch.edge_src, batch.edge_dst, batch.edge_type,
                      mask_f, mask_r, n, R, cfg.aggr, cd)


def dense_edge_masks(batch: DenseBatch, edge_noise, cfg, training: bool):
    """(mask_f, mask_r) [B, E] of a dense batch's kept edges per direction:
    the edge mask in eval mode or without dropout; in training, the hash
    dropout of its packed edge ids seeded by `edge_noise`, or `edge_noise`
    as a pair of injected keep masks (forward, reverse). `cfg` carries
    adj_dropout and force_undirected."""
    mask_f = mask_r = batch.edge_mask
    if training and cfg.adj_dropout > 0:
        if isinstance(edge_noise, tuple):          # injected keep masks
            mask_f = batch.edge_mask & edge_noise[0]
            mask_r = (mask_f if edge_noise[1] is edge_noise[0]
                      else batch.edge_mask & edge_noise[1])
        elif batch.edge_id is None:
            raise ValueError("dense edge dropout needs the batch's packed "
                             "edge ids (assemble_dense attaches them)")
        else:
            mask_f, mask_r = edge_dropout_dense(
                batch.edge_mask, batch.edge_id, edge_noise, cfg.adj_dropout,
                cfg.force_undirected)
    return mask_f, mask_r


def flat_edge_mask(batch: GraphBatch, edge_noise, cfg, training: bool):
    """[E] kept edges of a flat batch for the segment engine: the edge mask
    in eval mode or without dropout; in training, edge_dropout of the hash
    keep decisions of the batch's packed edge ids seeded by `edge_noise`
    (flat_edge_keep), or of `edge_noise` as an injected [E] keep mask.
    `cfg` carries adj_dropout and force_undirected."""
    if not training or cfg.adj_dropout == 0:
        return batch.edge_mask
    if torch.is_tensor(edge_noise):                 # injected keep mask
        keep = edge_noise
    elif batch.edge_id is None:
        raise ValueError("flat edge dropout needs the batch's packed edge ids "
                         "(BatchLoader and assemble_batch attach them)")
    else:
        keep = flat_edge_keep(edge_noise, batch.edge_id, batch.edge_src,
                              batch.edge_dst, cfg.adj_dropout, cfg.force_undirected)
    return edge_dropout(batch.edge_mask, batch.edge_canon, keep, cfg.force_undirected)


def node_onehot(batch, num_features: int) -> torch.Tensor:
    """The one-hot hop labels of a batch's node rows, zero on padding."""
    x = F.one_hot(batch.node_label.long(), num_features).float()
    return x * batch.node_mask[..., None].float()


def _drop_edges(plan, edge_seed, cfg: IGMCConfig):
    """`plan` with the hash edge dropout of `edge_seed` (an int, or a 0-d
    device tensor: hash_edge_keep) folded into its mask. The ukey
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


def chunk_dense_batch(batch: DenseBatch, chunk: int) -> List[DenseBatch]:
    """A DenseBatch of B graphs as B / chunk batches of `chunk` graphs each
    (views of its tensors), in order. B must be a multiple of `chunk`."""
    if batch.num_graphs % chunk != 0:
        raise ValueError(f"num_graphs {batch.num_graphs} % chunk {chunk}")
    return [batch.graphs(s, s + chunk) for s in range(0, batch.num_graphs, chunk)]


def slice_noise(noise, start: int, stop: int):
    """The training noise of graphs [start, stop) of a batch's: the edge
    seed as it is (dense dropout is keyed on packed edge ids, so a graph's
    edges drop alike in any slice), injected edge masks and feature_keep
    cut to those graphs."""
    if noise is None:
        return None
    edge, keep = noise
    if isinstance(edge, tuple):
        edge = tuple(m[start:stop] for m in edge)
    return edge, keep[start:stop]


def igmc_forward_dense_chunked(model: IGMC, batch: DenseBatch, chunk: int,
                               noise=None) -> torch.Tensor:
    """The model's predictions [B] of a giant DenseBatch, computed `chunk`
    graphs at a time (chunk_dense_batch). The same function as one forward
    over the whole batch, dropout included: its edge masks are keyed on
    packed edge ids and each slice gets its rows of feature_keep
    (slice_noise). The JAX package assigns per-chunk dropout streams.

    This and chunk_dense_batch are the JAX package's API over a batch
    already assembled whole; the giant-batch training step
    (train/loop.py make_chunked_dense_train_step) assembles each slice
    itself, so that a row is never held whole."""
    return torch.cat([model(b, slice_noise(noise, s, s + chunk))
                      for s, b in zip(range(0, batch.num_graphs, chunk),
                                      chunk_dense_batch(batch, chunk))])


def set_flat_engine(model: nn.Module, flat_aggregate) -> nn.Module:
    """`model`, set to run the flat engine `flat_aggregate` names
    (flat_engine): an IGMC's cfg.flat_aggregate is replaced; the other
    families run the segment engine only, and any other engine raises
    ValueError. Returns `model`."""
    engine = flat_engine(flat_aggregate)
    if isinstance(model, IGMC):
        model.cfg = replace(model.cfg, flat_aggregate=engine)
    elif engine != "segment":
        raise ValueError(f"flat_aggregate={engine!r} applies to the R-GCN trunk of "
                         f"IGMC, not to {type(model).__name__}")
    return model


def arr_regularizer(model: nn.Module) -> torch.Tensor:
    """Adjacent-rating regularizer of any model family: the sum over its
    R-GCN layers of ||W[1:] - W[:-1]||^2 with W = att @ basis, [R, Cin,
    Cout]. GCN layers (the GNN and DGCNN trunks) carry no relation weights
    and add nothing, as in the JAX package."""
    reg = 0.0
    for conv in model.convs:
        if isinstance(conv, RGCNConv):
            w = conv.relation_weights()
            reg = reg + ((w[1:] - w[:-1]) ** 2).sum()
    return reg
