"""Device-resident datasets: the packed subgraphs uploaded once, flat and
dense batches assembled on the device from graph-id vectors.

Port of igmc_tpu/batching/device_data.py (_compact_int, DeviceDataset with
rel_sort, _ragged_slots, assemble_batch, assemble_dense with rel_caps,
capacity_bound, plan_gid_epoch, live_rows), in torch ops on an explicit
device. A step uploads nothing but its [B] graph ids (the epoch loops
upload an epoch's ids at once); the row gathers from the packed tables
run on the device, once per batch.

assemble_batch builds the flat GraphBatch of the JAX package's: nodes of
the graphs in order, all forward edges first and then all reverse ones,
`edge_canon` pointing each reverse edge at its forward copy, the targets
at each graph's first user and first item row, the side-feature rows;
and `edge_id`, each edge's packed index, the key of the segment engine's
hash edge dropout, as the host collate of the same graphs gives it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .batch import GraphBatch, topk_sum_bound
from .dense import DenseBatch


def _compact_int(a: np.ndarray) -> np.ndarray:
    """Narrowest of int8/int16/int32 that holds `a` losslessly."""
    if a.size == 0:
        return a.astype(np.int32)
    lo, hi = int(a.min()), int(a.max())
    if -128 <= lo and hi <= 127:
        return a.astype(np.int8)
    if -32768 <= lo and hi <= 32767:
        return a.astype(np.int16)
    return a.astype(np.int32)


class DeviceDataset:
    """The packed subgraph tables (batching/dataset.py _PackedGraphs) on
    `device`: node labels, graph-local src/dst and edge types compacted to
    the narrowest lossless integer type, int64 offsets, num_u and y, and
    the side-feature tables when the graphs carry them (else None).

    `rel_sort` = R stores each graph's edges stably sorted by relation,
    with `rel_start` [G, R + 1], each graph's relation-segment starts
    relative to its first edge, and `edge_id`, each sorted edge's packed
    index before the sort (what dense dropout keys on). The relation-
    slotted assembly needs them; the other assemblies run on either."""

    def __init__(self, packed, device="cuda", rel_sort: Optional[int] = None):
        self.device = resolve_device(device)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        src, dst, etype = packed.src, packed.dst, packed.etype
        self.num_relations = rel_sort
        self.rel_start = self.edge_id = None
        if rel_sort is not None:
            G, R = len(packed), int(rel_sort)
            if len(etype) and int(etype.max()) >= R:
                raise ValueError(f"rel_sort {R}: the graphs carry relation "
                                 f"{int(etype.max())}")
            gid = np.repeat(np.arange(G, dtype=np.int64), np.diff(packed.edge_offsets))
            order = np.lexsort((etype.astype(np.int64), gid))
            src, dst, etype = src[order], dst[order], etype[order]
            cnt = np.bincount(gid * R + etype, minlength=G * R).reshape(G, R)
            rel_start = np.zeros((G, R + 1), np.int64)
            rel_start[:, 1:] = np.cumsum(cnt, axis=1)
            self.rel_start = put(rel_start)
            self.edge_id = put(order.astype(np.int64))
        self._slot_maps = {}
        self.node_label = put(_compact_int(packed.node_label))
        self.src = put(_compact_int(src))
        self.dst = put(_compact_int(dst))             # num_u + item-local
        self.etype = put(_compact_int(etype))
        self.node_off = put(packed.node_offsets.astype(np.int64))
        self.edge_off = put(packed.edge_offsets.astype(np.int64))
        self.num_u = put(packed.num_u.astype(np.int64))
        self.y = put(packed.y.astype(np.float32))
        self.u_feat = (None if packed.u_feat is None
                       else put(packed.u_feat.astype(np.float32)))
        self.v_feat = (None if packed.v_feat is None
                       else put(packed.v_feat.astype(np.float32)))
        self.num_graphs = len(packed)

    def __len__(self):
        return self.num_graphs

    def slot_maps(self, rel_caps: tuple):
        """(relation, offset in its segment) of every position of a
        relation-slotted edge axis, two int64 [E] tensors on the device,
        built once per rel_caps."""
        if rel_caps not in self._slot_maps:
            caps = np.asarray(rel_caps, np.int64)
            rel = np.repeat(np.arange(len(caps)), caps)
            local = np.arange(int(caps.sum())) - np.concatenate([[0], np.cumsum(caps)])[rel]
            self._slot_maps[rel_caps] = tuple(
                torch.from_numpy(a.astype(np.int64)).to(self.device) for a in (rel, local))
        return self._slot_maps[rel_caps]


def _ragged_slots(counts: torch.Tensor, starts: torch.Tensor, pad: int):
    """Each of `pad` slots mapped to (its graph in the batch, its offset in
    that graph, valid): graphs own consecutive runs of counts[b] slots
    from starts[b]; slots past the last run are invalid (graph clamped to
    the last, offset 0)."""
    cum = torch.cumsum(counts, 0)
    i = torch.arange(pad, device=counts.device)
    b = torch.searchsorted(cum, i, right=True)
    valid = b < counts.shape[0]
    b = b.clamp_max(counts.shape[0] - 1)
    local = i - starts[b]
    valid = valid & (local < counts[b])
    return b, torch.where(valid, local, 0), valid


def assemble_batch(dd: DeviceDataset, gids: torch.Tensor, node_pad: int,
                   edge_pad: int) -> GraphBatch:
    """One flat GraphBatch on dd's device from graph ids `gids` [B] (int64
    on that device; -1 = a padding graph) in `node_pad` node rows and
    `edge_pad` directed edge slots (even: forward half, then reverse half),
    as the JAX package assembles it; with `edge_id`, each edge's packed
    index (the forward copy's for a reverse edge; padding edges 0)."""
    if edge_pad % 2:
        raise ValueError("edge_pad must be even (forward + reverse halves)")
    ef_pad = edge_pad // 2
    gmask = gids >= 0
    g = torch.where(gmask, gids, 0)
    counts_n = (dd.node_off[g + 1] - dd.node_off[g]) * gmask
    counts_e = (dd.edge_off[g + 1] - dd.edge_off[g]) * gmask    # forward edges
    starts_n = torch.cumsum(counts_n, 0) - counts_n
    starts_e = torch.cumsum(counts_e, 0) - counts_e

    nb, nlocal, nvalid = _ragged_slots(counts_n, starts_n, node_pad)
    node_label = torch.where(nvalid, dd.node_label[dd.node_off[g[nb]] + nlocal].int(), 0)
    node2graph = torch.where(nvalid, nb, 0).int()

    eb, elocal, evalid = _ragged_slots(counts_e, starts_e, ef_pad)
    epos = dd.edge_off[g[eb]] + elocal
    base = starts_n[eb]
    f_src = torch.where(evalid, base + dd.src[epos].long(), 0).int()
    f_dst = torch.where(evalid, base + dd.dst[epos].long(), 0).int()
    f_type = torch.where(evalid, dd.etype[epos].int(), 0)
    f_id = torch.where(evalid, epos if dd.edge_id is None else dd.edge_id[epos], 0)
    fwd_ids = torch.arange(ef_pad, device=gids.device, dtype=torch.int32)
    feat = lambda table: None if table is None else table[g] * gmask[:, None]
    return GraphBatch(
        node_label=node_label, edge_src=torch.cat([f_src, f_dst]),
        edge_dst=torch.cat([f_dst, f_src]), edge_type=torch.cat([f_type, f_type]),
        edge_canon=torch.cat([fwd_ids, fwd_ids]), node2graph=node2graph,
        node_mask=nvalid, edge_mask=torch.cat([evalid, evalid]),
        y=torch.where(gmask, dd.y[g], 0.0), graph_mask=gmask,
        target_u=starts_n.int(), target_v=(starts_n + dd.num_u[g]).int(),
        u_feat=feat(dd.u_feat), v_feat=feat(dd.v_feat),
        edge_id=torch.cat([f_id, f_id]))


def capacity_bound(node_counts, edge_counts, batch_size: int):
    """(node_pad, edge_pad) that hold ANY batch of `batch_size` graphs: the
    sums of the batch_size largest node and directed edge counts
    (topk_sum_bound), rounded up to multiples of 8 and 16."""
    max_n, max_e = topk_sum_bound(node_counts, edge_counts, batch_size)
    rnd = lambda v, m: int(-(-max(v, m) // m) * m)
    return rnd(max_n, 8), rnd(max_e, 16)


def plan_gid_epoch(order: np.ndarray, batch_graphs: int, superbatch: int):
    """The JAX package's [K, B] graph-id blocks of a pass in `order`
    (K = max(superbatch, 1)): batches of B ids, the last padded with -1,
    stacked K at a time, the last block padded with all-(-1) rows. A list
    of int32 arrays (the JAX package's `supers`; its `rest` is empty)."""
    B = batch_graphs
    blocks = []
    for s in range(0, len(order), B):
        blk = np.asarray(order[s:s + B]).astype(np.int32)
        if len(blk) < B:
            blk = np.concatenate([blk, np.full(B - len(blk), -1, np.int32)])
        blocks.append(blk)
    K = superbatch if superbatch > 1 else 1
    n_super = len(blocks) // K
    supers = [np.stack(blocks[i * K:(i + 1) * K]) for i in range(n_super)]
    rem = blocks[n_super * K:]
    if rem:
        supers.append(np.stack(rem + [np.full(B, -1, np.int32)] * (K - len(rem))))
    return supers


def assemble_dense(dd: DeviceDataset, gids: torch.Tensor, node_slot: int,
                   edge_slot: int, num_u_slot: Optional[int] = None,
                   rel_caps: Optional[tuple] = None) -> DenseBatch:
    """One DenseBatch on dd's device from graph ids `gids` [B] (int64 on
    that device; -1 = a padding graph), with the rows of collate_dense:
    unified (slot_perm's rows) or, with `num_u_slot`, bipartite, and the
    graphs' side-feature rows (zero for padding graphs). With `rel_caps`
    (summing to edge_slot; needs DeviceDataset(rel_sort=R)), the edge axis
    is relation-slotted: a graph's relation-r edges in packed order from
    sum(caps[:r]), edges beyond a capacity left out, as in the JAX
    package. Also sets `edge_id`, the packed index of each stored edge
    (from before the relation sort)."""
    n, E = node_slot, edge_slot
    dev = dd.device
    gmask = gids >= 0
    g = torch.where(gmask, gids, 0)
    nu = dd.num_u[g][:, None]                                   # [B, 1]
    first_n = dd.node_off[g][:, None]
    first_e = dd.edge_off[g][:, None]
    counts_n = (dd.node_off[g + 1][:, None] - first_n) * gmask[:, None]

    r = torch.arange(n, device=dev)[None, :]                    # [1, n]
    if rel_caps is not None:
        if dd.rel_start is None:
            raise ValueError("assemble_dense(rel_caps=...) needs "
                             "DeviceDataset(rel_sort=num_relations)")
        rel_caps = tuple(int(c) for c in rel_caps)
        if sum(rel_caps) != E or len(rel_caps) > dd.num_relations:
            raise ValueError(f"rel_caps {rel_caps} must sum to edge_slot {E} over "
                             f"at most {dd.num_relations} relations")
        rel, local = dd.slot_maps(rel_caps)
        starts = dd.rel_start[g]                                # [B, R + 1]
        seg_start = starts[:, rel]
        evalid = (local < starts[:, rel + 1] - seg_start) & gmask[:, None]
        epos = first_e + torch.where(evalid, seg_start + local, 0)
    else:
        counts_e = (dd.edge_off[g + 1][:, None] - first_e) * gmask[:, None]
        e = torch.arange(E, device=dev)[None, :]
        evalid = (e < counts_e) & gmask[:, None]
        epos = first_e + torch.where(evalid, e, 0)
    src_p = dd.src[epos].long()                                 # user-local
    dst_p = dd.dst[epos].long()                                 # num_u + item-local

    if num_u_slot is not None:
        nus = int(num_u_slot)
        # slot row -> packed-local row: users keep packed order, items offset
        packed_local = torch.where(r < nus, r, nu + (r - nus))
        nvalid = torch.where(r < nus, r < torch.minimum(counts_n, nu),
                             (r - nus) < (counts_n - nu)) & gmask[:, None]
        edge_src = torch.where(evalid, src_p, 0)
        edge_dst = torch.where(evalid, nus + (dst_p - nu), nus)
    else:
        # the inverse of slot_perm
        packed_local = torch.where(r == 0, 0, torch.where(
            r == 1, nu, torch.where(r <= nu, r - 1, r)))
        nvalid = (r < counts_n) & gmask[:, None]
        edge_src = torch.where(evalid, torch.where(src_p == 0, 0, src_p + 1), 0)
        edge_dst = torch.where(evalid, torch.where(dst_p == nu, 1, dst_p), 0)

    nidx = first_n + torch.where(nvalid, packed_local, 0)
    node_label = torch.where(nvalid, dd.node_label[nidx].int(), 0)
    if rel_caps is not None:         # the relation is the position's
        edge_type = rel.int().expand(len(gids), E)
    else:
        edge_type = torch.where(evalid, dd.etype[epos].int(), 0)
    y = torch.where(gmask, dd.y[g], 0.0)
    feat = lambda table: None if table is None else table[g] * gmask[:, None]
    return DenseBatch(node_label=node_label, edge_src=edge_src.int(),
                      edge_dst=edge_dst.int(), edge_type=edge_type,
                      node_mask=nvalid, edge_mask=evalid, y=y, graph_mask=gmask,
                      u_feat=feat(dd.u_feat), v_feat=feat(dd.v_feat),
                      num_u=None if num_u_slot is None else int(num_u_slot),
                      edge_id=epos if dd.edge_id is None else dd.edge_id[epos],
                      rel_caps=rel_caps)


def live_rows(gid_block: np.ndarray) -> int:
    """Rows of a [K, B] gid block holding at least one real graph id."""
    return int((np.asarray(gid_block) >= 0).any(axis=1).sum())
