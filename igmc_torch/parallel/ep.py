"""Edge-partitioned model parallelism: ONE giant batch-graph split over the
ranks.

Port of igmc_tpu/parallel/ep.py. Where the reference bounds subgraph size,
this path partitions the disjoint batch-graph itself:

  * nodes are block-partitioned: rank d owns the global node range
    [d * Nl, (d + 1) * Nl); every edge lives on the rank that owns its
    DESTINATION, so each aggregation is rank-local;
  * communication is boundary-only: each rank's edges are split into an
    intra group (source owned locally) and a boundary group (source
    remote), and a static halo plan names, for every ordered rank pair
    (s, r), the rows of s that a boundary edge on r reads. Each layer runs
    ONE all_to_all of those rows (P per pair) instead of an all_gather of
    the [N, C] table (comm_stats counts both);
  * the target readout exchanges only the remote target rows of the
    concatenated states through a second, smaller halo plan.

Host half (NumPy, the JAX package's arrays bit for bit): EPBatch, EPCaps,
partition_batch, ep_batch_caps / max_ep_caps / pad_ep_batch,
build_ep_batches (fixed membership, node pad quantum 8 * D), comm_stats,
the blocked plans (EPBlocked, build_ep_blocked, pad_ep_blocked,
ep_blocked_blocks, max_ep_blocked_blocks, over ops/blocked.py) and
dropout_key_ids. Every rank builds the same [D, ...] arrays (each holds
the whole dataset) and takes its row (ep_shard, EPBlocked.shard).

Device half: the halo exchange is an autograd Function around
all_to_all_single whose backward is the transposed exchange (the
gradients of the rows a rank sent come back to it and are summed into
them); at one rank it returns zeros [P, C] with no collective. The
forward is IGMC's: one-hot labels; per layer the halo exchange, the
basis-mix messages and the aggregate (mean, sum or relmean over both
edge groups; or the blocked engine with num_gather = the halo rows for the
boundary group); then the target-halo readout, lin1, ReLU, feature
dropout and lin2. The train step sums the gradients with one all_reduce
(parallel/dp.py summed_gradient_step; the graph count comes from the host
partition, so the step issues no other collective apart from the
exchanges).

Edge dropout is the stateless hash of the step seed and
dropout_key_ids(force_undirected, pair, rank * Nl + local dst), the JAX
package's keys bit for bit, so both directed copies of an edge agree with
no communication. Feature dropout: the JAX package draws it from
fold_in(PRNGKey(seed), axis_index), which torch cannot reproduce; here each
rank draws its mask from a CPU generator keyed on (step seed, rank)
(divergence by design).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..batching.batch import GraphBatch, collate
from ..models.igmc import FEATURE_DROPOUT, HIDDEN
from ..ops.blocked import (BlockedEdges, BlockedPlan, _plan_one, blocked_degree,
                           blocked_rel_counts, blocked_rgcn_aggregate,
                           pad_plan_blocks, relmean_weights)
from ..ops.dropout import feature_dropout, hash_edge_keep
from ..ops.segment import segment_sum
from .dp import summed_gradient_step
from .mesh import Mesh

_LOW32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1


# ---------------------------------------------------------------------------
# Host-side partitioner
# ---------------------------------------------------------------------------

@dataclass
class EPBatch:
    """One collated GraphBatch, edge-partitioned for D ranks: NumPy arrays
    with a leading rank axis [D, ...]. Node and graph axes are
    block-partitioned. Intra edges have rank-local indices; a boundary
    edge's `bnd_src` is its slot s * P + k in the halo receive table (the
    k-th row peer s sends); `*_dst` are local to the owning rank."""

    node_label: np.ndarray   # int32 [D, Nl]
    node_mask: np.ndarray    # bool  [D, Nl]
    intra_src: np.ndarray    # int32 [D, Ei]  local node index
    intra_dst: np.ndarray    # int32 [D, Ei]  local node index
    intra_type: np.ndarray   # int32 [D, Ei]
    intra_pair: np.ndarray   # int32 [D, Ei]  global undirected-pair id
    intra_mask: np.ndarray   # bool  [D, Ei]
    bnd_src: np.ndarray      # int32 [D, Eb]  halo slot (s*P + k)
    bnd_dst: np.ndarray      # int32 [D, Eb]  local node index
    bnd_type: np.ndarray     # int32 [D, Eb]
    bnd_pair: np.ndarray     # int32 [D, Eb]  global undirected-pair id
    bnd_mask: np.ndarray     # bool  [D, Eb]
    send_idx: np.ndarray     # int32 [D, D, P]   local rows sent to each peer
    tgt_send_idx: np.ndarray  # int32 [D, D, Pt] local rows for target readout
    y: np.ndarray            # float32 [D, Bl]
    graph_mask: np.ndarray   # bool  [D, Bl]
    target_u: np.ndarray     # int32 [D, Bl]  EXTENDED index into [Nl + D*Pt]
    target_v: np.ndarray     # int32 [D, Bl]  EXTENDED index into [Nl + D*Pt]
    u_feat: Optional[np.ndarray] = None  # float32 [D, Bl, du]
    v_feat: Optional[np.ndarray] = None  # float32 [D, Bl, dv]

    @property
    def num_devices(self) -> int:
        return self.node_label.shape[0]


def _round8(n: int, lo: int = 8) -> int:
    return max(lo, int(-(-n // 8) * 8))


class EPCaps(NamedTuple):
    """Static per-rank capacities of an EPBatch. Partitioning every batch
    of an epoch under ONE shared EPCaps (max_ep_caps) gives the epoch one
    shape."""

    intra: int   # intra-edge slots per rank
    bnd: int     # boundary-edge slots per rank
    halo: int    # halo rows per ordered rank pair
    tgt: int     # target-readout halo rows per ordered rank pair


def max_ep_caps(caps: Sequence[EPCaps]) -> EPCaps:
    return EPCaps(*(max(c[i] for c in caps) for i in range(4)))


def _halo_demands(needed_global: Sequence[np.ndarray], D: int, Nl: int):
    """Per-receiver remote-row demands grouped by owner: per_r[r] = (g, s,
    k) with g the sorted unique remote rows rank r reads, s = g // Nl their
    owners and k each row's rank within its owner's send list; and the
    largest (sender, receiver) demand."""
    per_r = []
    pair_max = 0
    for r in range(D):
        g = np.unique(np.asarray(needed_global[r], dtype=np.int64))
        s = g // Nl
        if np.any(s == r):
            bad = g[s == r][0]
            raise ValueError(f"row {bad} is local to chip {r}, not remote")
        starts = np.searchsorted(s, np.arange(D))
        counts = np.diff(np.append(starts, len(g)))
        k = np.arange(len(g), dtype=np.int64) - starts[s]
        per_r.append((g, s, k))
        if len(g):
            pair_max = max(pair_max, int(counts.max()))
    return per_r, pair_max


def _halo_plan(per_r, D: int, Nl: int, Pcap: int):
    """(send_idx [D, D, Pcap], ext): ext[r] = (sorted global rows, their
    slots s * Pcap + k in rank r's receive table). Padding slots send row
    0; no edge reads them."""
    send_idx = np.zeros((D, D, Pcap), np.int32)
    ext = []
    for r, (g, s, k) in enumerate(per_r):
        if len(g):
            send_idx[s, r, k] = (g - s * Nl).astype(np.int32)
        ext.append((g, (s * Pcap + k).astype(np.int32)))
    return send_idx, ext


def _ext_lookup(ext_r, q: np.ndarray) -> np.ndarray:
    """Receive-table slots of global rows `q` (all must be present)."""
    g, slot = ext_r
    idx = np.searchsorted(g, q)
    if len(q) and (np.any(idx >= len(g)) or np.any(g[idx] != q)):
        raise KeyError("remote row missing from the halo plan")
    return slot[idx]


def _host(a) -> np.ndarray:
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def partition_batch(batch: GraphBatch, n_devices: int,
                    edge_pad_per_device: Optional[int] = None,
                    caps: Optional[EPCaps] = None) -> EPBatch:
    """Partition a flat collated batch (CPU tensors or arrays): node
    blocks, dst-owned edges. num_nodes and num_graphs must divide by
    n_devices. Edge capacities default to the largest owner load rounded up
    to 8; `edge_pad_per_device` lower-bounds both; `caps` pins all four
    capacities (one shape for an epoch)."""
    D = n_devices
    N, B = batch.num_nodes, batch.num_graphs
    if N % D or B % D:
        raise ValueError(f"node pad {N} and graph pad {B} must divide by {D}")
    Nl, Bl = N // D, B // D

    src = _host(batch.edge_src)
    dst = _host(batch.edge_dst)
    etype = _host(batch.edge_type)
    pair = _host(batch.edge_canon)
    emask = _host(batch.edge_mask)

    owner = np.where(emask, dst // Nl, -1)          # padded edges unassigned
    src_owner = src // Nl
    intra = (owner >= 0) & (src_owner == owner)
    bnd = (owner >= 0) & (src_owner != owner)

    floor = edge_pad_per_device or 8
    counts_i = np.bincount(owner[intra], minlength=D)
    counts_b = np.bincount(owner[bnd], minlength=D)
    Ei = _round8(max(int(counts_i.max(initial=0)), floor))
    Eb = _round8(max(int(counts_b.max(initial=0)), floor))

    # halo plan: rank r needs the remote sources of its boundary edges
    needed = [np.unique(src[bnd & (owner == r)]) for r in range(D)]
    per_r, pair_max = _halo_demands(needed, D, Nl)
    Pcap = _round8(pair_max, lo=1) if pair_max else 1

    # target-readout halo plan: remote rows among each rank's target u/v
    tu = _host(batch.target_u).reshape(D, Bl)
    tv = _host(batch.target_v).reshape(D, Bl)
    gmask = _host(batch.graph_mask).reshape(D, Bl)
    tgt_needed = []
    for r in range(D):
        rows = np.concatenate([tu[r][gmask[r]], tv[r][gmask[r]]])
        tgt_needed.append(rows[rows // Nl != r])
    tgt_per_r, tgt_pair_max = _halo_demands(tgt_needed, D, Nl)
    Pt = _round8(tgt_pair_max, lo=1) if tgt_pair_max else 1

    if caps is not None:
        need = EPCaps(Ei, Eb, Pcap, Pt)
        if any(n > c for n, c in zip(need, caps)):
            raise ValueError(f"EP caps {caps} too small: batch needs {need}")
        Ei, Eb, Pcap, Pt = caps

    send_idx, ext = _halo_plan(per_r, D, Nl, Pcap)
    tgt_send_idx, tgt_ext = _halo_plan(tgt_per_r, D, Nl, Pt)

    def remap_targets(t):
        out = np.zeros((D, Bl), np.int32)
        for r in range(D):
            g = t[r].astype(np.int64)
            local = (g // Nl) == r
            keep = gmask[r]
            out[r] = np.where(local, g - r * Nl, 0)
            rem = keep & ~local
            if rem.any():
                out[r, rem] = Nl + _ext_lookup(tgt_ext[r], g[rem])
            out[r, ~keep] = 0
        return out

    z = np.zeros
    feat = lambda f: None if f is None else _host(f).reshape(D, Bl, -1)
    out = EPBatch(
        node_label=_host(batch.node_label).reshape(D, Nl),
        node_mask=_host(batch.node_mask).reshape(D, Nl),
        intra_src=z((D, Ei), np.int32), intra_dst=z((D, Ei), np.int32),
        intra_type=z((D, Ei), np.int32), intra_pair=z((D, Ei), np.int32),
        intra_mask=z((D, Ei), bool),
        bnd_src=z((D, Eb), np.int32), bnd_dst=z((D, Eb), np.int32),
        bnd_type=z((D, Eb), np.int32), bnd_pair=z((D, Eb), np.int32),
        bnd_mask=z((D, Eb), bool),
        send_idx=send_idx, tgt_send_idx=tgt_send_idx,
        y=_host(batch.y).reshape(D, Bl), graph_mask=gmask,
        target_u=remap_targets(tu), target_v=remap_targets(tv),
        u_feat=feat(batch.u_feat), v_feat=feat(batch.v_feat),
    )

    def fill(group_mask, Ecap, f_src, f_dst, f_type, f_pair, f_mask, map_src):
        # one stable sort by owner; per-rank slot = rank within the owner
        real = np.nonzero(group_mask)[0]
        order = real[np.argsort(owner[real], kind="stable")]
        own = owner[order]
        starts = np.searchsorted(own, np.arange(D))
        slot = np.arange(len(order)) - starts[own]
        if len(order) and slot.max() >= Ecap:
            raise ValueError(f"device edge load {slot.max() + 1} > {Ecap}")
        f_src[own, slot] = map_src(order, own)
        f_dst[own, slot] = dst[order] - own * Nl
        f_type[own, slot] = etype[order]
        f_pair[own, slot] = pair[order]
        f_mask[own, slot] = True

    def bnd_src_slots(order, own):
        # each boundary edge's remote source -> its halo receive slot
        out_slots = np.empty(len(order), np.int32)
        for r in range(D):
            m = own == r
            if m.any():
                out_slots[m] = _ext_lookup(ext[r], src[order[m]].astype(np.int64))
        return out_slots

    fill(intra, Ei, out.intra_src, out.intra_dst, out.intra_type,
         out.intra_pair, out.intra_mask, lambda order, own: src[order] - own * Nl)
    fill(bnd, Eb, out.bnd_src, out.bnd_dst, out.bnd_type,
         out.bnd_pair, out.bnd_mask, bnd_src_slots)
    return out


def ep_batch_caps(ep: EPBatch) -> EPCaps:
    """The static capacities an EPBatch was built with."""
    return EPCaps(ep.intra_src.shape[1], ep.bnd_src.shape[1],
                  ep.send_idx.shape[2], ep.tgt_send_idx.shape[2])


def pad_ep_batch(ep: EPBatch, caps: EPCaps) -> EPBatch:
    """An EPBatch grown to capacities `caps`. Halo slots are numbered
    s * P + k, so growing P renumbers every boundary source and every
    extended target index."""
    cur = ep_batch_caps(ep)
    if cur == caps:
        return ep
    if any(c < n for c, n in zip(caps, cur)):
        raise ValueError(f"cannot shrink EP caps {cur} -> {caps}")
    D = ep.num_devices
    Nl = ep.node_label.shape[1]

    def grow(a, width, fill=0):
        if a.shape[1] == width:
            return a
        out = np.full((D, width), fill, a.dtype)
        out[:, : a.shape[1]] = a
        return out

    def reslot(slots, mask, P_old, P_new):
        s, k = slots // P_old, slots % P_old
        return np.where(mask, s * P_new + k, 0).astype(np.int32)

    bnd_src = reslot(ep.bnd_src, ep.bnd_mask, cur.halo, caps.halo)

    def retgt(t):
        rem = t >= Nl
        s, k = (t - Nl) // cur.tgt, (t - Nl) % cur.tgt
        return np.where(rem, Nl + s * caps.tgt + k, t).astype(np.int32)

    send_idx = np.zeros((D, D, caps.halo), np.int32)
    send_idx[:, :, : cur.halo] = ep.send_idx
    tgt_send_idx = np.zeros((D, D, caps.tgt), np.int32)
    tgt_send_idx[:, :, : cur.tgt] = ep.tgt_send_idx

    return EPBatch(
        node_label=ep.node_label, node_mask=ep.node_mask,
        intra_src=grow(ep.intra_src, caps.intra),
        intra_dst=grow(ep.intra_dst, caps.intra),
        intra_type=grow(ep.intra_type, caps.intra),
        intra_pair=grow(ep.intra_pair, caps.intra),
        intra_mask=grow(ep.intra_mask, caps.intra),
        bnd_src=grow(bnd_src, caps.bnd),
        bnd_dst=grow(ep.bnd_dst, caps.bnd),
        bnd_type=grow(ep.bnd_type, caps.bnd),
        bnd_pair=grow(ep.bnd_pair, caps.bnd),
        bnd_mask=grow(ep.bnd_mask, caps.bnd),
        send_idx=send_idx, tgt_send_idx=tgt_send_idx,
        y=ep.y, graph_mask=ep.graph_mask,
        target_u=retgt(ep.target_u), target_v=retgt(ep.target_v),
        u_feat=ep.u_feat, v_feat=ep.v_feat,
    )


def build_ep_batches(dataset, batch_size: int, n_devices: int):
    """A dataset collated and partitioned into EP giant batches of
    batch_size graphs, all of ONE shape: a common (node_pad, graph_pad) from
    the largest batch (node pad a multiple of 8 * D), then the shared
    max_ep_caps via pad_ep_batch. Batch membership is FIXED across epochs
    (epochs permute the visit order). Returns (ep_batches, gid_chunks):
    gid_chunks[i] = batch i's dataset indices in its [D * Bl] prediction
    order."""
    D, B = n_devices, batch_size
    if B % D:
        raise ValueError(f"batch_size {B} must divide by n_devices {D}")
    n = len(dataset)
    if n == 0:
        return [], []

    def fetch(idxs):
        if hasattr(dataset, "get_many"):
            return dataset.get_many(idxs)
        return [dataset.get(int(i)) for i in idxs]

    chunks = [np.arange(s, min(s + B, n), dtype=np.int64) for s in range(0, n, B)]
    graph_lists = [fetch(c) for c in chunks]
    quantum = 8 * D        # the node pad divides by D and keeps the 8-alignment
    node_pad = max(-(-sum(g.num_nodes for g in gs) // quantum) * quantum
                   for gs in graph_lists)
    edge_pad = max(_round8(sum(g.num_edges for g in gs)) for gs in graph_lists)
    eps = [partition_batch(collate(gs, B, node_pad, edge_pad), D)
           for gs in graph_lists]
    caps = max_ep_caps([ep_batch_caps(e) for e in eps])
    return [pad_ep_batch(e, caps) for e in eps], chunks


def comm_stats(ep: EPBatch, feature_width: int = 32, n_layers: int = 4,
               readout_width: int = 128) -> dict:
    """Bytes this partition's exchanges move between ranks against the
    per-layer all_gather they replace. Self-pair slots stay on their rank
    and are excluded."""
    D, _, Pcap = ep.send_idx.shape
    Nl = ep.node_label.shape[1]
    Pt = ep.tgt_send_idx.shape[2]
    halo_layer = D * (D - 1) * Pcap * feature_width * 4
    gather_layer = D * (D - 1) * Nl * feature_width * 4
    cs_w = feature_width * n_layers if readout_width is None else readout_width
    halo_total = n_layers * halo_layer + D * (D - 1) * Pt * cs_w * 4
    gather_total = n_layers * gather_layer + D * (D - 1) * Nl * cs_w * 4
    return {
        "devices": D, "halo_rows_per_pair": Pcap, "tgt_rows_per_pair": Pt,
        "local_nodes": Nl,
        "halo_bytes_per_layer": halo_layer,
        "allgather_bytes_per_layer": gather_layer,
        "halo_bytes_total": halo_total,
        "allgather_bytes_total": gather_total,
        "reduction_x": (1.0 if halo_total == 0
                        else round(gather_total / halo_total, 2)),
    }


# ---------------------------------------------------------------------------
# Blocked local aggregation plans (ops/blocked.py inside EP)
# ---------------------------------------------------------------------------

@dataclass
class EPBlocked:
    """Per-rank blocked plans of an EPBatch, NumPy BlockedPlans with a
    leading [D] axis: i_fwd / i_bwd for the intra edges (gather and
    aggregate over the Nl local nodes), b_fwd / b_bwd for the boundary
    edges (gather from the [D * P] halo table; the backward aggregates the
    halo rows' gradients, which the exchange's transpose routes home). The
    ukeys are the EP dropout keys (pair and global dst), so blocked and
    segment EP drop the same edges for one seed."""

    i_fwd: BlockedPlan
    i_bwd: BlockedPlan
    b_fwd: BlockedPlan
    b_bwd: BlockedPlan
    rows: int
    group: int
    Nl: int
    halo_rows: int

    def shard(self, rank: int, device):
        """(intra, boundary) BlockedEdges of rank `rank` on `device`."""
        put = lambda stacked: BlockedPlan(*(torch.from_numpy(np.ascontiguousarray(
            a[rank])).to(device) for a in stacked))
        intra = BlockedEdges(put(self.i_fwd), put(self.i_bwd), self.rows,
                             self.Nl, self.group)
        bnd = BlockedEdges(put(self.b_fwd), put(self.b_bwd), self.rows, self.Nl,
                           self.group, num_gather=self.halo_rows)
        return intra, bnd


def _n_chunks(Nl: int, rows: int, halo_rows: int):
    return (-(-Nl // rows), -(-Nl // rows), -(-Nl // rows), -(-halo_rows // rows))


def _stack(plans: Sequence[BlockedPlan]) -> BlockedPlan:
    return BlockedPlan(*(np.stack(xs) for xs in zip(*plans)))


def build_ep_blocked(ep: EPBatch, rows: int = 128, eblk: int = 512,
                     group: int = 8) -> EPBlocked:
    """Blocked plans for every rank of an EPBatch, naturally sized and then
    padded to the largest rank's block counts (pad_ep_blocked aligns them
    across batches)."""
    D = ep.num_devices
    Nl = ep.node_label.shape[1]
    halo_rows = D * ep.send_idx.shape[2]

    def per_device(d):
        gdst_i = (d * Nl + ep.intra_dst[d]).astype(np.int64)
        gdst_b = (d * Nl + ep.bnd_dst[d]).astype(np.int64)
        uk_i = (ep.intra_pair[d].astype(np.uint32) * np.uint32(_GOLDEN)
                + gdst_i.astype(np.uint32)).astype(np.int32)
        uk_b = (ep.bnd_pair[d].astype(np.uint32) * np.uint32(_GOLDEN)
                + gdst_b.astype(np.uint32)).astype(np.int32)
        isrc, idst, ityp, ipair, imask = (ep.intra_src[d], ep.intra_dst[d],
                                          ep.intra_type[d], ep.intra_pair[d],
                                          ep.intra_mask[d])
        bsrc, bdst, btyp, bpair, bmask = (ep.bnd_src[d], ep.bnd_dst[d],
                                          ep.bnd_type[d], ep.bnd_pair[d],
                                          ep.bnd_mask[d])
        return [_plan_one(idst, isrc, ityp, ipair, uk_i, imask, Nl, rows, eblk, group),
                _plan_one(isrc, idst, ityp, ipair, uk_i, imask, Nl, rows, eblk, group),
                _plan_one(bdst, bsrc, btyp, bpair, uk_b, bmask, Nl, rows, eblk, group),
                _plan_one(bsrc, bdst, btyp, bpair, uk_b, bmask, halo_rows, rows,
                          eblk, group)]

    per_d = [per_device(d) for d in range(D)]
    n_chunks = _n_chunks(Nl, rows, halo_rows)
    stacked = []
    for i in range(4):
        nb_max = max(p[i].gather.shape[0] for p in per_d)
        stacked.append(_stack([pad_plan_blocks(p[i], nb_max, n_chunks[i], group)
                               for p in per_d]))
    return EPBlocked(*stacked, rows, group, Nl, halo_rows)


def ep_blocked_blocks(plans: EPBlocked):
    """The four plans' block counts."""
    return tuple(p.gather.shape[1]
                 for p in (plans.i_fwd, plans.i_bwd, plans.b_fwd, plans.b_bwd))


def max_ep_blocked_blocks(all_plans: Sequence[EPBlocked]):
    return tuple(max(ep_blocked_blocks(p)[i] for p in all_plans) for i in range(4))


def pad_ep_blocked(plans: EPBlocked, nb_targets) -> EPBlocked:
    """Every rank's plans padded to shared block counts (masked padding
    blocks), so all batches of an epoch have one plan shape."""
    n_chunks = _n_chunks(plans.Nl, plans.rows, plans.halo_rows)
    out = []
    for i, stacked in enumerate((plans.i_fwd, plans.i_bwd, plans.b_fwd, plans.b_bwd)):
        D = stacked.gather.shape[0]
        per_d = [BlockedPlan(*(np.asarray(a)[d] for a in stacked)) for d in range(D)]
        out.append(_stack([pad_plan_blocks(p, nb_targets[i], n_chunks[i], plans.group)
                           for p in per_d]))
    return EPBlocked(*out, plans.rows, plans.group, plans.Nl, plans.halo_rows)


# ---------------------------------------------------------------------------
# Stateless hash dropout keys
# ---------------------------------------------------------------------------

def dropout_key_ids(force_undirected: bool, epair: torch.Tensor,
                    gdst: torch.Tensor) -> torch.Tensor:
    """The hash-dropout key of each edge: its undirected pair id with
    force_undirected (both directed copies agree, no communication), else
    pair * 0x9E3779B1 + global dst mod 2**32 (each directed copy drops
    independently; a bipartite graph has no self-loops). int64 tensors
    holding the JAX package's uint32 keys."""
    if force_undirected:
        return epair.long()
    return (epair.long() * _GOLDEN + gdst.long()) & _LOW32


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------

@dataclass
class EPShard:
    """One rank's row of an EPBatch as tensors on its device (indices
    int64), with the whole batch's real graph count `n_real`."""

    node_label: torch.Tensor
    node_mask: torch.Tensor
    intra_src: torch.Tensor
    intra_dst: torch.Tensor
    intra_type: torch.Tensor
    intra_pair: torch.Tensor
    intra_mask: torch.Tensor
    bnd_src: torch.Tensor
    bnd_dst: torch.Tensor
    bnd_type: torch.Tensor
    bnd_pair: torch.Tensor
    bnd_mask: torch.Tensor
    send_idx: torch.Tensor
    tgt_send_idx: torch.Tensor
    y: torch.Tensor
    graph_mask: torch.Tensor
    target_u: torch.Tensor
    target_v: torch.Tensor
    u_feat: Optional[torch.Tensor]
    v_feat: Optional[torch.Tensor]
    n_real: int


def ep_shard(ep: EPBatch, rank: int, device) -> EPShard:
    """Rank `rank`'s row of `ep` on `device` (int32 indices widened to
    int64)."""
    def put(a):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a[rank]))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(device)

    kw = {f.name: put(getattr(ep, f.name)) for f in fields(EPBatch)}
    return EPShard(**kw, n_real=int(np.asarray(ep.graph_mask).sum()))


class _HaloExchange(torch.autograd.Function):
    """recv = all_to_all(x[send_idx]): slot s * P + k of the result is the
    k-th row peer s sends. The backward is the transposed exchange: the
    gradients of the received rows go back to their senders and are summed
    into the rows they came from."""

    @staticmethod
    def forward(ctx, x, send_idx, mesh):
        ctx.mesh, ctx.num_rows = mesh, x.shape[0]
        ctx.save_for_backward(send_idx)
        return mesh.all_to_all(x[send_idx.reshape(-1)])

    @staticmethod
    def backward(ctx, g):
        (send_idx,) = ctx.saved_tensors
        back = ctx.mesh.all_to_all(g.contiguous())
        dx = g.new_zeros((ctx.num_rows, g.shape[1]))
        return dx.index_add_(0, send_idx.reshape(-1), back), None, None


def halo_exchange(x: torch.Tensor, send_idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The [D * P, C] receive table of `x`'s rows that send_idx [D, P]
    sends to each peer; zeros [P, C] with no collective at one rank."""
    D, P = send_idx.shape
    if D == 1:
        return x.new_zeros((P, x.shape[1]))
    return _HaloExchange.apply(x, send_idx, mesh)


def _message(conv, xs: torch.Tensor, ae: torch.Tensor) -> torch.Tensor:
    """Basis-mix messages: per edge att[type] outer x[src], times the
    stacked bases."""
    nb, cin, cout = conv.basis.shape
    z = (ae[:, :, None] * xs[:, None, :]).reshape(-1, nb * cin)
    return z @ conv.basis.reshape(nb * cin, cout)


def _aggregate(aggr: str, R: int, Nl: int, msg_i, idst, itype, imf,
               msg_b, bdst, btype, bmf) -> torch.Tensor:
    if aggr == "relmean":
        # mean within each (dst, relation) bucket, summed over relations
        seg_i, seg_b = idst * R + itype, bdst * R + btype
        s = (segment_sum(msg_i * imf[:, None], seg_i, Nl * R)
             + segment_sum(msg_b * bmf[:, None], seg_b, Nl * R))
        cnt = segment_sum(imf, seg_i, Nl * R) + segment_sum(bmf, seg_b, Nl * R)
        return (s / cnt.clamp_min(1.0)[:, None]).reshape(Nl, R, -1).sum(1)
    s = (segment_sum(msg_i * imf[:, None], idst, Nl)
         + segment_sum(msg_b * bmf[:, None], bdst, Nl))
    if aggr == "mean":
        cnt = segment_sum(imf, idst, Nl) + segment_sum(bmf, bdst, Nl)
        s = s / cnt.clamp_min(1.0)[:, None]
    elif aggr != "sum":
        raise NotImplementedError(f"EP path supports aggr mean/sum/relmean, not {aggr}")
    return s


def _blocked_trunk(model, x, shard: EPShard, mesh: Mesh, plans, seed, training):
    """The R-GCN trunk on the blocked engine: intra edges gather from the
    local x, boundary edges from each layer's halo table."""
    cfg = model.cfg
    if cfg.aggr not in ("mean", "sum", "relmean"):
        raise NotImplementedError(f"blocked EP aggregation: unknown aggr {cfg.aggr}")
    intra, bnd = plans
    rows, Nl = intra.rows, intra.num_nodes

    def keep(plan):
        if not (training and cfg.adj_dropout > 0):
            return plan.mask
        ids = plan.pair if cfg.force_undirected else plan.ukey
        return plan.mask * hash_edge_keep(seed, ids, cfg.adj_dropout).to(plan.mask.dtype)

    masks_i = (keep(intra.fwd), keep(intra.bwd))
    masks_b = (keep(bnd.fwd), keep(bnd.bwd))
    inv_deg = None
    if cfg.aggr == "mean":
        deg = (blocked_degree(intra.fwd, masks_i[0], rows, Nl)
               + blocked_degree(bnd.fwd, masks_b[0], rows, Nl))
        inv_deg = (1.0 / deg.clamp_min(1.0))[:, None]
    elif cfg.aggr == "relmean":
        # (local dst, relation) counts over BOTH edge groups
        R = cfg.num_relations
        cnt = (blocked_rel_counts(intra.fwd, masks_i[0], R, rows, Nl)
               + blocked_rel_counts(bnd.fwd, masks_b[0], R, rows, Nl))
        cinv = (1.0 / cnt.clamp_min(1.0)).reshape(-1)
        masks_i = (relmean_weights(cinv, intra.fwd, masks_i[0], R, rows, True),
                   relmean_weights(cinv, intra.bwd, masks_i[1], R, rows, False))
        masks_b = (relmean_weights(cinv, bnd.fwd, masks_b[0], R, rows, True),
                   relmean_weights(cinv, bnd.bwd, masks_b[1], R, rows, False))
    states = []
    for conv in model.convs:
        halo = halo_exchange(x, shard.send_idx, mesh)
        s = (blocked_rgcn_aggregate(x, conv.att, conv.basis, intra, masks_i)
             + blocked_rgcn_aggregate(halo, conv.att, conv.basis, bnd, masks_b))
        if inv_deg is not None:
            s = s * inv_deg
        x = torch.tanh(s + x @ conv.root + conv.bias)
        states.append(x)
    return states


def ep_feature_keep(seed: int, rank: int, n_graphs: int) -> torch.Tensor:
    """A rank's feature-dropout keep mask [n_graphs, HIDDEN] of one EP
    step, from a CPU generator keyed on (step seed, rank)."""
    state = np.random.SeedSequence([int(seed), int(rank), 2]).generate_state(1)[0]
    gen = torch.Generator().manual_seed(int(state))
    return torch.rand(n_graphs, HIDDEN, generator=gen) >= FEATURE_DROPOUT


def ep_forward(model, shard: EPShard, mesh: Mesh, seed: int = 0,
               training: bool = False, plans=None) -> torch.Tensor:
    """IGMC's predictions [Bl] of this rank's graphs of an EP batch.
    `plans` (EPBlocked.shard) runs the blocked local aggregate, else the
    segment one. In training, edge dropout hashes (seed, dropout_key_ids)
    and feature dropout draws ep_feature_keep(seed, rank)."""
    cfg = model.cfg
    Nl = shard.node_label.shape[0]
    x = F.one_hot(shard.node_label, cfg.num_features).float()
    x = x * shard.node_mask[:, None].float()
    if plans is not None:
        states = _blocked_trunk(model, x, shard, mesh, plans, seed, training)
    else:
        im, bm = shard.intra_mask, shard.bnd_mask
        if training and cfg.adj_dropout > 0:
            d0 = mesh.rank * Nl
            ki = dropout_key_ids(cfg.force_undirected, shard.intra_pair,
                                 d0 + shard.intra_dst)
            kb = dropout_key_ids(cfg.force_undirected, shard.bnd_pair,
                                 d0 + shard.bnd_dst)
            im = im & hash_edge_keep(seed, ki, cfg.adj_dropout)
            bm = bm & hash_edge_keep(seed, kb, cfg.adj_dropout)
        imf, bmf = im.float(), bm.float()
        states = []
        for conv in model.convs:
            # the exchange first: the intra messages do not depend on it
            halo = halo_exchange(x, shard.send_idx, mesh)
            msg_i = _message(conv, x[shard.intra_src], conv.att[shard.intra_type])
            msg_b = _message(conv, halo[shard.bnd_src], conv.att[shard.bnd_type])
            s = _aggregate(cfg.aggr, cfg.num_relations, Nl, msg_i, shard.intra_dst,
                           shard.intra_type, imf, msg_b, shard.bnd_dst,
                           shard.bnd_type, bmf)
            x = torch.tanh(s + x @ conv.root + conv.bias)
            states.append(x)
    cs = torch.cat(states, dim=1)                        # [Nl, sum(latent)]
    table = torch.cat([cs, halo_exchange(cs, shard.tgt_send_idx, mesh)])
    h = torch.cat([table[shard.target_u], table[shard.target_v]], dim=1)
    if cfg.side_features:
        h = torch.cat([h, shard.u_feat, shard.v_feat], dim=1)
    h = F.relu(model.lin1(h))
    if training:
        keep = ep_feature_keep(seed, mesh.rank, h.shape[0]).to(h.device)
        h = feature_dropout(h, keep, FEATURE_DROPOUT)
    return model.lin2(h)[:, 0] * cfg.multiply_by


# ---------------------------------------------------------------------------
# Train / eval steps
# ---------------------------------------------------------------------------

def make_ep_train_step(model, optimizer, mesh: Mesh, ARR: float = 0.0):
    """(shard, seed, plans=None) -> (loss, n): one optimizer step on the
    whole EP batch (the global-mean loss over its n_real graphs), the
    gradients summed over the ranks with one all_reduce."""

    def step(shard: EPShard, seed: int, plans=None):
        optimizer.zero_grad(set_to_none=True)
        preds = ep_forward(model, shard, mesh, seed, True, plans)
        n = torch.tensor(float(max(shard.n_real, 1)), device=preds.device)
        sse = (((preds - shard.y) ** 2) * shard.graph_mask.float()).sum()
        return summed_gradient_step(model, optimizer, mesh, sse, n, ARR), n

    return step


@torch.no_grad()
def _local_eval(model, shard: EPShard, mesh: Mesh, plans=None):
    preds = ep_forward(model, shard, mesh, 0, False, plans)
    gmask = shard.graph_mask.float()
    return (((preds - shard.y) ** 2) * gmask).sum(), gmask.sum(), preds


def make_ep_eval_step(model, mesh: Mesh):
    """(shard, plans=None) -> (sse, count, predictions [D * Bl]) of the
    whole EP batch: the sums all-reduced, the predictions all-gathered in
    collate order. `model` must be in eval mode."""

    def step(shard: EPShard, plans=None):
        sse, cnt, preds = _local_eval(model, shard, mesh, plans)
        sums = mesh.all_reduce(torch.stack([sse, cnt]))
        return sums[0], sums[1], mesh.all_gather(preds)

    return step


# ---------------------------------------------------------------------------
# Epochs over EP batches
# ---------------------------------------------------------------------------

def ep_step_seed(seed: int, epoch: int, step: int) -> int:
    """Deterministic per-step dropout seed, the JAX package's: a resumed
    run replays the exact stream."""
    h = np.uint64(seed) * np.uint64(1_000_003) + np.uint64(epoch)
    h = h * np.uint64(1_000_003) + np.uint64(step)
    return int(h & np.uint64(0xFFFFFFFF))


def ep_train_epoch(step_fn, shards: Sequence[EPShard], seed: int, epoch: int,
                   rng: Optional[np.random.Generator] = None, plans=None):
    """One epoch over a rank's EP shards (the same order on every rank:
    `rng` permutes the visit order, membership is fixed); returns the
    device scalar sum(loss * n), or None for no batches."""
    order = rng.permutation(len(shards)) if rng is not None else np.arange(len(shards))
    total = None
    for j, bi in enumerate(order):
        loss, n = step_fn(shards[bi], ep_step_seed(seed, epoch, j),
                          plans[bi] if plans is not None else None)
        total = loss * n if total is None else total + loss * n
    return total


def ep_eval_sums(model, shards: Sequence[EPShard], mesh: Mesh, plans=None):
    """(sse, count) over all EP batches: local sums, one all_reduce at the
    end; None for no batches."""
    if not shards:
        return None
    acc = None
    for i, shard in enumerate(shards):
        sse, cnt, _ = _local_eval(model, shard, mesh,
                                  plans[i] if plans is not None else None)
        part = torch.stack([sse, cnt])
        acc = part if acc is None else acc + part
    acc = mesh.all_reduce(acc)
    return acc[0], acc[1]


def ep_predict_all(model, shards: Sequence[EPShard], mesh: Mesh, gid_chunks,
                   num_graphs: int, plans=None) -> np.ndarray:
    """Raw predictions in DATASET order (for ensembling), the same array on
    every rank: each batch's [D, Bl] predictions flatten back to collate
    order; one all_gather at the end."""
    preds = np.full(num_graphs, np.nan, np.float32)
    if not shards:
        return preds
    local = torch.stack([_local_eval(model, s, mesh,
                                     plans[i] if plans is not None else None)[2]
                         for i, s in enumerate(shards)])          # [nb, Bl]
    every = mesh.all_gather(local[None]).cpu().numpy()            # [D, nb, Bl]
    for i, chunk in enumerate(gid_chunks):
        preds[chunk] = every[:, i].reshape(-1)[: len(chunk)]
    return preds
