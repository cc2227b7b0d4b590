"""Device-resident datasets: the packed subgraphs uploaded once, dense
batches assembled on the device from graph-id vectors.

Port of igmc_tpu/batching/device_data.py (_compact_int, DeviceDataset,
assemble_dense without the relation-slotted axis, live_rows), in torch
ops on an explicit device. A step uploads nothing but its [B] graph ids
(the epoch loops upload an epoch's ids at once); the row gathers from the
packed tables run on the device, once per batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
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
    the narrowest lossless integer type, int64 offsets, num_u and y."""

    def __init__(self, packed, device="cuda"):
        self.device = resolve_device(device)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self.node_label = put(_compact_int(packed.node_label))
        self.src = put(_compact_int(packed.src))
        self.dst = put(_compact_int(packed.dst))      # num_u + item-local
        self.etype = put(_compact_int(packed.etype))
        self.node_off = put(packed.node_offsets.astype(np.int64))
        self.edge_off = put(packed.edge_offsets.astype(np.int64))
        self.num_u = put(packed.num_u.astype(np.int64))
        self.y = put(packed.y.astype(np.float32))
        self.num_graphs = len(packed)

    def __len__(self):
        return self.num_graphs


def assemble_dense(dd: DeviceDataset, gids: torch.Tensor, node_slot: int,
                   edge_slot: int, num_u_slot: Optional[int] = None) -> DenseBatch:
    """One DenseBatch on dd's device from graph ids `gids` [B] (int64 on
    that device; -1 = a padding graph), with the rows of collate_dense:
    unified (slot_perm's rows) or, with `num_u_slot`, bipartite. Also sets
    `edge_id`, the packed index of each stored edge."""
    n, E = node_slot, edge_slot
    dev = dd.device
    gmask = gids >= 0
    g = torch.where(gmask, gids, 0)
    nu = dd.num_u[g][:, None]                                   # [B, 1]
    first_n = dd.node_off[g][:, None]
    first_e = dd.edge_off[g][:, None]
    counts_n = (dd.node_off[g + 1][:, None] - first_n) * gmask[:, None]
    counts_e = (dd.edge_off[g + 1][:, None] - first_e) * gmask[:, None]

    r = torch.arange(n, device=dev)[None, :]                    # [1, n]
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
    edge_type = torch.where(evalid, dd.etype[epos].int(), 0)
    y = torch.where(gmask, dd.y[g], 0.0)
    return DenseBatch(node_label=node_label, edge_src=edge_src.int(),
                      edge_dst=edge_dst.int(), edge_type=edge_type,
                      node_mask=nvalid, edge_mask=evalid, y=y, graph_mask=gmask,
                      num_u=None if num_u_slot is None else int(num_u_slot),
                      edge_id=epos)


def live_rows(gid_block: np.ndarray) -> int:
    """Rows of a [K, B] gid block holding at least one real graph id."""
    return int((np.asarray(gid_block) >= 0).any(axis=1).sum())
