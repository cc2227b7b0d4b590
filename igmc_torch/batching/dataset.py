"""Subgraph datasets (static, cached; dynamic, extracted on access) and the
batch loader.

Port of igmc_tpu/batching/dataset.py:

  * StaticGraphDataset — extracts all subgraphs once, with the extraction
    engine `backend` names (graphs/extract.py), and stores them in a
    packed structure-of-arrays (concatenated fields + offsets, compact and
    O(1) to slice; the side-feature rows of each graph's target user and
    item as [G, du] / [G, dv] tables). With a `root` it caches the packed
    arrays as `<root>/processed/data_<key>[_m<max_num>].npz` under the JAX
    package's key and file format, so either package loads the other's.
  * DynamicGraphDataset — extracts at access time, keyed by the global
    dataset index, so it gives the static dataset's subgraphs.
  * BatchLoader — collates fixed-size padded batches on geometric ladders
    (from the dataset's counts, or estimated from 64 sampled graphs and
    extended when a batch overflows them), in order or shuffled per epoch,
    on a small thread pool that extracts, collates and plans ahead of the
    consumer. Flat batches carry the packed edge ids the segment engine's
    edge dropout keys on and, as `flat_aggregate` asks (the JAX package's
    loader argument), no plan (None, "segment", "auto": the segment
    engine), the blocked engine's dst- and src-major plans ("blocked"), or
    the fused aggregate kernel's dst-block-aligned edge plan with its
    dropout key stream and, for a training loader (shuffle=True), the
    src-sorted twin plan the aggregate's gradient walks ("pallas"); dense
    batches (`batch_mode="dense"`) are unified slot batches with per-graph
    slot ladders and edge ids for the dense edge dropout. No superbatches
    (the JAX package pads a training superbatch to the ladder maximum and
    scans it; here each batch is one step, in the same order). Data
    parallelism (`n_devices`, `rank`): each rank's loader yields its
    sub-batch of every global batch (parallel/dp.py).

`max_num` subsampling draws the reference's permutation of
np.random.seed(123), from a private RandomState(123).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import logging
import os
import threading
from collections import deque
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..graphs import native
from ..graphs.csr import BipartiteCSR
from ..graphs.extract import Subgraph, extract_many
from ..kernels.rgcn_aggregate import (PLAN_EBLK, PLAN_ROWS, block_align_plans,
                                      plan_capacity_blocks)
from ..ops.blocked import plan_blocked_edges
from ..utils import spans
from .batch import (GraphBatch, bucket_for, collate, collate_packed, pad_ladder,
                    planned_engine, topk_sum_bound)
from .dense import collate_dense

# Compress .npz caches only up to this many raw bytes (zlib at ~3 MB/s
# makes bigger writes cost more time than the disk they save).
NPZ_COMPRESS_MAX_BYTES = 4 << 30


def _adjacency_digest(A, labels, class_values) -> str:
    """Short content digest of what shapes the extracted subgraphs beyond
    the structural cache key: the adjacency's values (rating maps rewrite
    them without changing its shape), the link labels and the class-value
    table (the targets)."""
    h = hashlib.sha1()
    if isinstance(A, BipartiteCSR):
        parts = (A.u_indptr, A.u_indices, A.u_data)
    else:
        Ac = A.tocsr() if hasattr(A, "tocsr") else A
        parts = (Ac.indptr, Ac.indices, Ac.data)
    for p in parts:
        h.update(np.ascontiguousarray(p).tobytes())
    h.update(np.ascontiguousarray(np.asarray(labels)).tobytes())
    if class_values is not None:
        h.update(np.ascontiguousarray(np.asarray(class_values)).tobytes())
    return h.hexdigest()[:10]


def cache_name(A, n_links: int, labels, h: int, sample_ratio: float,
               max_nodes_per_hop: Optional[int], features: bool,
               class_values, seed: int, backend: str,
               max_num: Optional[int]) -> str:
    """The JAX package's cache file name of a static dataset: every input
    that changes the extracted subgraphs, and the seed and the engine only
    when subsampling binds (only subsampling draws random numbers, and the
    engines draw different streams). A per-hop cap at least the larger
    bipartite side never binds."""
    key = (f"h{h}_sr{sample_ratio:g}_mnph{max_nodes_per_hop}"
           f"_f{int(features)}_n{n_links}"
           f"_d{_adjacency_digest(A, labels, class_values)}")
    side = max(A.shape) if hasattr(A, "shape") else max(A.num_users, A.num_items)
    mnph_binds = max_nodes_per_hop is not None and max_nodes_per_hop < side
    if sample_ratio < 1.0 or mnph_binds:
        eff = ("native" if backend in ("auto", "native") and native.available()
               else "numpy")
        key += f"_s{seed}_b{eff}"
    return f"data_{key}.npz" if max_num is None else f"data_{key}_m{max_num}.npz"


def _apply_max_num(links, labels, max_num):
    if max_num is None:
        return links, labels
    perm = np.random.RandomState(123).permutation(len(links[0]))[:max_num]
    return (links[0][perm], links[1][perm]), labels[perm]


class _PackedGraphs:
    """Structure-of-arrays storage for a list of Subgraphs."""

    _FIELDS = ("node_offsets", "edge_offsets", "node_label", "src", "dst",
               "etype", "num_u", "y")

    def __init__(self, graphs: Sequence[Subgraph]):
        n = len(graphs)
        self.node_offsets = np.zeros(n + 1, dtype=np.int64)
        self.edge_offsets = np.zeros(n + 1, dtype=np.int64)
        for i, g in enumerate(graphs):
            self.node_offsets[i + 1] = self.node_offsets[i] + g.num_nodes
            self.edge_offsets[i + 1] = self.edge_offsets[i] + len(g.src)

        def cat(field):
            return (np.concatenate([getattr(g, field) for g in graphs])
                    if n else np.zeros(0, np.int32))

        self.node_label = cat("node_label")
        self.src = cat("src")
        self.dst = cat("dst")
        self.etype = cat("etype")
        self.num_u = np.array([g.num_u for g in graphs], dtype=np.int32)
        self.y = np.array([g.y for g in graphs], dtype=np.float32)
        self.u_feat = self.v_feat = None
        if n and graphs[0].u_feat is not None:
            self.u_feat = np.stack([g.u_feat for g in graphs]).astype(np.float32)
            self.v_feat = np.stack([g.v_feat for g in graphs]).astype(np.float32)

    @classmethod
    def _from_arrays(cls, d):
        obj = cls.__new__(cls)
        for k in cls._FIELDS:
            setattr(obj, k, d[k])
        obj.u_feat = d.get("u_feat")
        obj.v_feat = d.get("v_feat")
        return obj

    def __len__(self):
        return len(self.y)

    def get(self, i: int) -> Subgraph:
        ns, ne = self.node_offsets[i], self.node_offsets[i + 1]
        es, ee = self.edge_offsets[i], self.edge_offsets[i + 1]
        return Subgraph(
            src=self.src[es:ee],
            dst=self.dst[es:ee],
            etype=self.etype[es:ee],
            node_label=self.node_label[ns:ne],
            num_u=int(self.num_u[i]),
            num_v=int(ne - ns - self.num_u[i]),
            y=float(self.y[i]),
            u_feat=self.u_feat[i] if self.u_feat is not None else None,
            v_feat=self.v_feat[i] if self.v_feat is not None else None,
        )

    def node_counts(self) -> np.ndarray:
        return np.diff(self.node_offsets)

    def edge_counts(self) -> np.ndarray:
        """Directed (doubled) edge counts."""
        return 2 * np.diff(self.edge_offsets)

    def save(self, path: str):
        """Write the arrays as an .npz (compressed up to
        NPZ_COMPRESS_MAX_BYTES of raw arrays), the JAX package's format."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        d = {k: getattr(self, k) for k in self._FIELDS}
        if self.u_feat is not None:
            d["u_feat"] = self.u_feat
            d["v_feat"] = self.v_feat
        raw_bytes = sum(a.nbytes for a in d.values())
        # a temporary file renamed into place: a run killed mid-write
        # leaves no truncated cache under the name
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        if raw_bytes > NPZ_COMPRESS_MAX_BYTES:
            np.savez(tmp, **d)
        else:
            np.savez_compressed(tmp, **d)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "_PackedGraphs":
        with np.load(path, allow_pickle=False) as z:
            return cls._from_arrays({k: z[k] for k in z.files})


def _densify(feat):
    """A feature matrix (dense or scipy sparse) as float32 numpy, or None."""
    if feat is None:
        return None
    if hasattr(feat, "toarray"):
        return feat.toarray().astype(np.float32)
    return np.asarray(feat, dtype=np.float32)


class StaticGraphDataset:
    """Precomputed enclosing-subgraph dataset over a training adjacency
    (scipy sparse or BipartiteCSR, values = rating label + 1) and (u, v)
    links; `u_features` / `v_features` (users x du, items x dv, dense or
    sparse) give each graph its target rows. With `root`, the packed
    arrays are loaded from `<root>/processed/<cache_name>` when that file
    exists, else extracted and written there. `progress` prints a
    heartbeat to stderr while extracting (extract_many)."""

    def __init__(
        self,
        A,
        links,
        labels,
        h: int = 1,
        sample_ratio: float = 1.0,
        max_nodes_per_hop: Optional[int] = None,
        u_features=None,
        v_features=None,
        class_values=None,
        max_num: Optional[int] = None,
        seed: int = 0,
        backend: str = "auto",
        root: Optional[str] = None,
        progress: bool = True,
    ):
        links, labels = _apply_max_num(links, labels, max_num)
        self.cache_path = None
        if root:
            self.cache_path = os.path.join(root, "processed", cache_name(
                A, len(links[0]), labels, h, sample_ratio, max_nodes_per_hop,
                u_features is not None, class_values, seed, backend, max_num))
        if self.cache_path and os.path.isfile(self.cache_path):
            self.packed = _PackedGraphs.load(self.cache_path)
            return
        if not isinstance(A, BipartiteCSR):
            A = BipartiteCSR(A)
        with spans.span("graphs.extract"):
            graphs = extract_many(
                links, labels, A, h, sample_ratio, max_nodes_per_hop,
                _densify(u_features), _densify(v_features), class_values,
                seed=seed, backend=backend, progress=progress)
        with spans.span("graphs.pack"):
            self.packed = _PackedGraphs(graphs)
        if self.cache_path:
            self.packed.save(self.cache_path)

    def __len__(self):
        return len(self.packed)

    def get(self, i: int) -> Subgraph:
        return self.packed.get(i)

    def node_counts(self):
        return self.packed.node_counts()

    def edge_counts(self):
        return self.packed.edge_counts()


class DynamicGraphDataset:
    """Enclosing subgraphs extracted at access time, for datasets too big
    to hold extracted. Takes StaticGraphDataset's arguments, so a caller
    builds either class alike; `root` is unused (nothing is cached).
    Subgraph i is drawn from the stream keyed by (seed, i), so it equals
    the static dataset's graph i, and get(i) equals get_many([..., i,
    ...])'s entry for i, with either engine. The engine is resolved (and
    the C++ one built) here, once."""

    def __init__(
        self,
        A,
        links,
        labels,
        h: int = 1,
        sample_ratio: float = 1.0,
        max_nodes_per_hop: Optional[int] = None,
        u_features=None,
        v_features=None,
        class_values=None,
        max_num: Optional[int] = None,
        seed: int = 0,
        backend: str = "auto",
        root: Optional[str] = None,
    ):
        self.links, self.labels = _apply_max_num(links, labels, max_num)
        self.A = A if isinstance(A, BipartiteCSR) else BipartiteCSR(A)
        self.h = h
        self.sample_ratio = sample_ratio
        self.max_nodes_per_hop = max_nodes_per_hop
        self.u_features = _densify(u_features)
        self.v_features = _densify(v_features)
        self.class_values = class_values
        self.seed = seed
        self.backend = native.resolve_backend(backend)

    def __len__(self):
        return len(self.links[0])

    def get(self, i: int) -> Subgraph:
        return self.get_many(np.asarray([i]))[0]

    def get_many(self, idxs) -> List[Subgraph]:
        idxs = np.asarray(idxs, dtype=np.int64)
        return extract_many(
            (self.links[0][idxs], self.links[1][idxs]), self.labels[idxs],
            self.A, self.h, self.sample_ratio, self.max_nodes_per_hop,
            self.u_features, self.v_features, self.class_values,
            seed=self.seed, backend=self.backend, indices=idxs)


def _map_tensors(batch, fn):
    """A copy of a GraphBatch or DenseBatch with `fn` applied to every
    tensor (the plan tuples' included)."""
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            out[f.name] = tuple(fn(a) for a in v)
        elif hasattr(v, "map"):                     # blocked plans
            out[f.name] = v.map(fn)
        elif isinstance(v, torch.Tensor):
            out[f.name] = fn(v)
    return dataclasses.replace(batch, **out)


class BatchLoader:
    """Padded batches of a static or dynamic dataset, produced ahead of
    the consumer.

    `batch_mode="flat"` yields GraphBatches whose (node_pad, edge_pad)
    come from geometric ladders, with `edge_id` keyed by the graphs'
    dataset ids. `flat_aggregate` (flat_engine's spellings) None,
    "segment" or "auto" attaches no plan; "blocked" the blocked engine's plans (batch.blocked) and
    "pallas" the aggregate kernel's (batch.aligned), both sized by
    plan_capacity_blocks so every batch of one bucket has the same plan
    shape, with output chunks of `plan_rows` node rows and blocks of
    `plan_eblk` edge slots (the JAX package's names and defaults); with
    "pallas" node_pad is rounded up to a multiple of plan_rows (the
    kernel's output chunk) and the batch carries plan_rows.
    `batch_mode="dense"` yields unified-layout DenseBatches whose node and
    edge slots come from per-graph ladders, carrying `edge_id`
    (collate_dense; a static dataset's is the packed edge index). The ladders cover the dataset's worst case when it has
    counts (a static dataset); else they are estimated from 64 evenly
    spaced graphs, and a batch above them extends them geometrically
    (`ladder_overflows` counts it, and a warning says so).

    With `shuffle`, each pass draws the order
    default_rng(SeedSequence([seed, epoch])).permutation, and `epoch` counts
    up by one per pass (set it to replay a given epoch's order), as the JAX
    package's loader does; a shuffled flat loader also attaches the
    src-sorted twin plan (`batch.aligned_t`). Without it the order is the
    dataset's.

    `prefetch` > 0 extracts, collates and plans on min(prefetch, 4)
    threads, at most prefetch + 1 batches ahead, and yields the batches in
    order (the C++ engine and numpy release the GIL); 0 produces them on
    the consumer's thread. The batches are the same either way.
    `pin_memory` puts every batch's tensors in page-locked memory, so that
    `batch.to(card, non_blocking=True)` copies asynchronously.

    `node_ladder` / `edge_ladder` (both or neither) fix the ladders, e.g.
    to capacity_ladders of the full dataset on every rank of a multi-host
    run (parallel/multihost.py).

    `n_devices` D > 1 with `rank` r yields rank r's share of every global
    batch of batch_size graphs (batch_size must divide by D), as the JAX
    package's data-parallel loader stacks it: flat, split_for_devices'
    r-th sub-batch (D sub-batches of batch_size / D graphs in one shared
    bucket); dense, graphs [r * B/D, (r + 1) * B/D) of the batch's
    DenseBatch (the JAX package shards its graph axis). Every rank fetches
    the whole batch to find the shared shape, and runs the same number of
    batches in the same order (the last may leave a rank only padding
    graphs).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, prefetch: int = 2, batch_mode: str = "flat",
                 pin_memory: bool = False, flat_aggregate: Optional[str] = None,
                 node_ladder: Optional[Sequence[int]] = None,
                 edge_ladder: Optional[Sequence[int]] = None,
                 n_devices: int = 0, rank: int = 0, plan_rows: int = PLAN_ROWS,
                 plan_eblk: int = PLAN_EBLK):
        if n_devices > 1 and batch_size % n_devices:
            raise ValueError(
                f"batch_size {batch_size} must divide by n_devices {n_devices}")
        if not 0 <= rank < max(n_devices, 1):
            raise ValueError(f"rank {rank} outside {max(n_devices, 1)} devices")
        if batch_mode not in ("flat", "dense"):
            raise ValueError(f"unknown batch_mode {batch_mode!r} (flat|dense)")
        flat_aggregate = planned_engine(flat_aggregate)
        if batch_mode == "dense" and flat_aggregate is not None:
            raise ValueError("batch_mode='dense' conflicts with flat_aggregate")
        if flat_aggregate is not None and n_devices > 1:
            raise ValueError(f"flat_aggregate={flat_aggregate!r} is a single-device "
                             f"path (DP sub-batches carry no plans)")
        if (node_ladder is None) != (edge_ladder is None):
            raise ValueError("pass both node_ladder and edge_ladder, or neither")
        if plan_rows < 1 or plan_eblk < 1:
            raise ValueError(f"plan_rows {plan_rows} and plan_eblk {plan_eblk} "
                             f"must be positive")
        self.flat_aggregate = flat_aggregate
        self.plan_rows, self.plan_eblk = plan_rows, plan_eblk
        self.n_devices = n_devices
        self.rank = rank
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.batch_mode = batch_mode
        self.pin_memory = pin_memory
        self.epoch = 0
        self.ladder_overflows = 0
        self._ladder_lock = threading.Lock()   # prefetch threads extend ladders
        if node_ladder is None:
            node_ladder, edge_ladder = self._estimate_ladders()
        self.node_ladder, self.edge_ladder = list(node_ladder), list(edge_ladder)

    def _estimate_ladders(self):
        ds = self.dataset
        dense = self.batch_mode == "dense"
        if hasattr(ds, "node_counts") and len(ds):
            nc, ec = ds.node_counts(), ds.edge_counts()
            if dense:      # per-graph slots (nodes, forward edges)
                return (pad_ladder(max(int(nc.max()), 8), base=8),
                        pad_ladder(max(int(ec.max()) // 2, 8), base=8))
            max_n, max_e = topk_sum_bound(nc, ec, self.batch_size)
            return (pad_ladder(max(max_n, 64)),
                    pad_ladder(max(max_e, 128), base=128))
        n = len(ds)
        idx = np.linspace(0, n - 1, num=min(64, n), dtype=np.int64)
        samples = [ds.get(int(i)) for i in idx]
        max_n = max(g.num_nodes for g in samples)
        if dense:
            max_e = max(len(g.src) for g in samples)
            return (pad_ladder(max(max_n, 8), base=8),
                    pad_ladder(max(max_e, 8), base=8))
        max_e = max(g.num_edges for g in samples)
        return (pad_ladder(max(max_n * self.batch_size, 64)),
                pad_ladder(max(max_e * self.batch_size, 128), base=128))

    def _bucket(self, n: int, ladder: List[int], which: str) -> int:
        """bucket_for, extending the ladder geometrically (x1.5, rounded to
        8) when `n` is above it: the new sizes are kept, so a dataset whose
        sampled estimate ran low settles on a few extra shapes. Extensions
        only append the next sizes of one fixed sequence, so the bucket of
        a batch does not depend on the order the threads reach it."""
        with self._ladder_lock:
            if n <= ladder[-1]:
                return bucket_for(n, ladder)
            before = ladder[-1]
            while ladder[-1] < n:
                ladder.append(int(np.ceil(ladder[-1] * 1.5 / 8.0)) * 8)
            self.ladder_overflows += 1
            count = self.ladder_overflows
        logging.getLogger("igmc_torch.batching").warning(
            "%s ladder overflow #%d: batch needs %d > %d; extended to %d",
            which, count, n, before, ladder[-1])
        return bucket_for(n, ladder)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _fetch(self, idxs: np.ndarray) -> List[Subgraph]:
        if hasattr(self.dataset, "get_many"):
            return self.dataset.get_many(idxs)
        return [self.dataset.get(int(i)) for i in idxs]

    @spans.spanned("loader.collate")
    def _make_batch_dense(self, graphs, idxs):
        node_slot = self._bucket(max(g.num_nodes for g in graphs),
                                 self.node_ladder, "node-slot")
        edge_slot = self._bucket(max(len(g.src) for g in graphs),
                                 self.edge_ladder, "edge-slot")
        packed = getattr(self.dataset, "packed", None)
        return collate_dense(graphs, self.batch_size, node_slot, edge_slot,
                             gids=idxs, edge_offsets=(None if packed is None
                                                      else packed.edge_offsets))

    def _make_batch_flat(self, idxs, graphs=None) -> GraphBatch:
        """The flat batch of `idxs`: collated straight from the dataset's
        packed tables (collate_packed, no Subgraph built), or from the
        fetched `graphs` of a dataset without them."""
        packed = getattr(self.dataset, "packed", None)
        with spans.span("loader.collate"):
            if graphs is None:
                nodes = packed.node_offsets[idxs + 1] - packed.node_offsets[idxs]
                edges = packed.edge_offsets[idxs + 1] - packed.edge_offsets[idxs]
                need_n, need_e = int(nodes.sum()), 2 * int(edges.sum())
            else:
                need_n = sum(g.num_nodes for g in graphs)
                need_e = sum(g.num_edges for g in graphs)
            node_pad = self._bucket(need_n, self.node_ladder, "node")
            edge_pad = self._bucket(need_e, self.edge_ladder, "edge")
            if self.flat_aggregate == "pallas":
                # the kernel's output chunking needs num_nodes % rows == 0
                node_pad = -(-node_pad // self.plan_rows) * self.plan_rows
            if graphs is None:
                batch = collate_packed(packed, idxs, self.batch_size, node_pad,
                                       edge_pad, edge_offsets=packed.edge_offsets)
            else:
                batch = collate(graphs, self.batch_size, node_pad, edge_pad, gids=idxs)
        if self.flat_aggregate is not None:
            self._plan(batch, node_pad, edge_pad)
        return batch

    @spans.spanned("loader.plan")
    def _plan(self, batch: GraphBatch, node_pad: int, edge_pad: int):
        """Attach the plans `flat_aggregate` asks for to `batch`."""
        rows, eblk = self.plan_rows, self.plan_eblk
        nb = plan_capacity_blocks(node_pad, edge_pad, rows, eblk)
        if self.flat_aggregate == "blocked":
            batch.blocked = plan_blocked_edges(
                batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
                batch.edge_canon, node_pad, rows, eblk, num_blocks=nb)
            return
        # the forward plan, and its twin for the gradient, in one call
        plans, engine = block_align_plans(
            batch.edge_src.numpy(), batch.edge_dst.numpy(), batch.edge_type.numpy(),
            batch.edge_mask.numpy(), node_pad, eblk=eblk, rows=rows, num_blocks=nb,
            edge_canon=batch.edge_canon.numpy(), twin=self.shuffle)
        spans.count(f"loader.plans_{engine}", len(plans))
        batch.plan_rows = rows
        # (src, dst_local, etype, mask, chunk_of_block, first_of_chunk, ukey)
        aligned = [tuple(torch.from_numpy(a) for a in p[:6] + p[7:]) for p in plans]
        batch.aligned = aligned[0]
        if self.shuffle:
            batch.aligned_t = aligned[1]

    @spans.spanned("loader.collate")
    def _make_batch_dp(self, graphs, idxs):
        """This rank's sub-batch of the global batch of `graphs`."""
        from ..parallel.dp import split_for_devices

        D, per = self.n_devices, self.batch_size // self.n_devices
        if self.batch_mode == "dense":
            whole = self._make_batch_dense(graphs, idxs)
            return whole.graphs(self.rank * per, (self.rank + 1) * per)
        packed = getattr(self.dataset, "packed", None)
        return split_for_devices(
            graphs, D, per, self.node_ladder, self.edge_ladder, gids=idxs,
            edge_offsets=None if packed is None else packed.edge_offsets)[self.rank]

    def make_batch(self, idxs: np.ndarray, index: Optional[int] = None):
        """The batch of dataset indices `idxs` (this rank's sub-batch of it
        with n_devices > 1); `index`, the batch's place in its pass, is the
        group of its spans (loader.fetch, loader.collate, loader.plan,
        loader.pin; utils/spans.py). A single-device flat batch of a
        dataset with packed tables fetches no Subgraph (no loader.fetch)."""
        idxs = np.asarray(idxs, dtype=np.int64)
        if index is not None:
            spans.set_group(index)
        if (self.n_devices <= 1 and self.batch_mode == "flat"
                and getattr(self.dataset, "packed", None) is not None):
            batch = self._make_batch_flat(idxs)     # fetches nothing
        else:
            with spans.span("loader.fetch"):
                graphs = self._fetch(idxs)
            if self.n_devices > 1:
                batch = self._make_batch_dp(graphs, idxs)
            elif self.batch_mode == "dense":
                batch = self._make_batch_dense(graphs, idxs)
            else:
                batch = self._make_batch_flat(idxs, graphs)
        if self.pin_memory:
            with spans.span("loader.pin"):
                batch = _map_tensors(batch, torch.Tensor.pin_memory)
        return batch

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n, dtype=np.int64)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
        return rng.permutation(n).astype(np.int64)

    def __iter__(self) -> Iterator:
        order = self._order()
        self.epoch += 1
        chunks = [order[s : s + self.batch_size]
                  for s in range(0, len(order), self.batch_size)]
        if self.prefetch <= 0:
            for i, idxs in enumerate(chunks):
                yield self.make_batch(idxs, i)
            return
        with cf.ThreadPoolExecutor(max_workers=min(self.prefetch, 4)) as ex:
            pending: deque = deque()
            i = 0
            while i < len(chunks) or pending:
                while i < len(chunks) and len(pending) < self.prefetch + 1:
                    pending.append(ex.submit(self.make_batch, chunks[i], i))
                    i += 1
                yield pending.popleft().result()
