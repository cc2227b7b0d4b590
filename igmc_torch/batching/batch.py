"""Fixed-shape batching: variable-size subgraphs -> padded flat batches.

Port of igmc_tpu/batching/batch.py. Batches are padded up a small
geometric ladder of sizes so every tensor downstream has one of a few
shapes, and every op is masked.

Layout invariants:
  * graphs are concatenated; node/edge indices are offset per graph.
  * per graph, edges are stored [forward..., reverse...] — forward edges are
    user->item (src < dst within the graph). `edge_canon` maps every edge to
    the batch index of its forward copy.
  * padded edges point at node 0 with edge_mask 0; padded nodes/graphs are
    masked via node_mask/graph_mask.
  * `edge_id` is the packed edge id of each edge's forward copy, the key
    of the segment engine's hash edge dropout (ops/dropout.py
    flat_edge_keep): with the graphs' dataset ids, edge j of graph gid gets
    edge_offsets[gid] + j (a static dataset's packed offsets, the id
    batching/device_data.py assemble_batch gives it) or, without offsets,
    gid * DYNAMIC_EDGE_STRIDE + j; without ids, its index in the batch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graphs import native
from ..graphs.extract import Subgraph
from ..utils import spans

# Host-collated edge keys of a dynamic dataset (no packed tables): graph
# gid's edge j is gid * stride + j, distinct for every (gid, j) while a
# graph has fewer than 2**31 forward edges.
DYNAMIC_EDGE_STRIDE = 1 << 31

# The flat layout's aggregate engines. Every `flat_aggregate` argument of
# the package (the loops, BatchLoader, IGMCConfig, the CLI) is resolved by
# flat_engine: None, "segment" and "auto" (the JAX package's spellings)
# name the segment engine, which needs no host-built plans.
FLAT_ENGINES = ("segment", "blocked", "pallas")


def flat_engine(flat_aggregate) -> str:
    """The flat engine a flat_aggregate argument names: 'segment' for
    None, 'segment' and 'auto'; 'blocked' and 'pallas' themselves. Any
    other value raises ValueError."""
    if flat_aggregate in (None, "auto"):
        return "segment"
    if flat_aggregate in FLAT_ENGINES:
        return flat_aggregate
    raise ValueError(f"unknown flat_aggregate {flat_aggregate!r} "
                     f"(segment|auto|blocked|pallas)")


def planned_engine(flat_aggregate) -> Optional[str]:
    """flat_engine's engine when it runs over plans built on the host with
    the batch (GraphBatch.blocked, .aligned): 'blocked' or 'pallas'; None
    for the segment engine."""
    engine = flat_engine(flat_aggregate)
    return None if engine == "segment" else engine


@dataclass
class GraphBatch:
    """A static-shape batch of B disjoint subgraphs (torch tensors)."""

    node_label: torch.Tensor   # int32 [N]   hop/side label per node
    edge_src: torch.Tensor     # int32 [E]   source node (batch-local)
    edge_dst: torch.Tensor     # int32 [E]   destination node (batch-local)
    edge_type: torch.Tensor    # int32 [E]   rating label per edge
    edge_canon: torch.Tensor   # int32 [E]   index of this edge's forward copy
    node2graph: torch.Tensor   # int32 [N]   graph id per node
    node_mask: torch.Tensor    # bool  [N]
    edge_mask: torch.Tensor    # bool  [E]
    y: torch.Tensor            # float32 [B] regression target
    graph_mask: torch.Tensor   # bool  [B]
    target_u: torch.Tensor     # int32 [B]   batch-local node idx of target user
    target_v: torch.Tensor     # int32 [B]   batch-local node idx of target item
    u_feat: Optional[torch.Tensor] = None  # float32 [B, du] target-user features
    v_feat: Optional[torch.Tensor] = None  # float32 [B, dv] target-item features
    # dst-block-aligned edges for the fused aggregate kernel
    # (kernels/rgcn_aggregate.py block_align_edges): (src, dst_local, etype,
    # mask, chunk_of_block, first_of_chunk, ukey), attached by BatchLoader;
    # ukey is the edge-dropout key stream
    aligned: Optional[Tuple[torch.Tensor, ...]] = None
    # its src-sorted twin (block_align_edges_transposed), same layout, for
    # the aggregate's gradient: attached by training loaders only
    aligned_t: Optional[Tuple[torch.Tensor, ...]] = None
    # the output-chunk rows both plans were built with (BatchLoader's
    # plan_rows), which the model's pallas_rows must equal
    plan_rows: Optional[int] = None
    # the blocked engine's dst- and src-major plans (ops/blocked.py
    # BlockedEdges), attached by BatchLoader(flat_aggregate="blocked")
    blocked: Optional[object] = None
    edge_id: Optional[torch.Tensor] = None  # int64 [E] packed id of the forward copy

    @property
    def num_graphs(self) -> int:
        return self.y.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_label.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_src.shape[0]

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        """A copy with every tensor (the aligned and blocked plans
        included) on `device`."""
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "blocked":
                moved[f.name] = None if v is None else v.to(device, non_blocking)
            elif f.name == "plan_rows":
                moved[f.name] = v
            elif isinstance(v, tuple):
                moved[f.name] = tuple(a.to(device, non_blocking=non_blocking)
                                      for a in v)
            else:
                moved[f.name] = (None if v is None
                                 else v.to(device, non_blocking=non_blocking))
        return GraphBatch(**moved)


def topk_sum_bound(node_counts, edge_counts, batch_size: int):
    """Worst-case node/edge totals over ANY batch of `batch_size` graphs:
    the sum of the `batch_size` largest per-graph counts."""
    k = min(batch_size, len(node_counts))
    max_n = int(np.sort(node_counts)[-k:].sum())
    max_e = int(np.sort(edge_counts)[-k:].sum())
    return max_n, max_e


def pad_ladder(max_val: int, base: int = 64, ratio: float = 1.5) -> List[int]:
    """Geometric ladder of pad sizes covering [base, >= max_val].

    ratio 1.5 bounds padding waste at ~33% while keeping the number of
    distinct batch shapes small (~log1.5 of the range).
    """
    sizes = [base]
    while sizes[-1] < max_val:
        sizes.append(int(np.ceil(sizes[-1] * ratio / 8.0)) * 8)
    return sizes


def bucket_for(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder size >= n (ladder is ascending)."""
    for s in ladder:
        if s >= n:
            return s
    return ladder[-1] if ladder and ladder[-1] >= n else int(np.ceil(n / 8.0)) * 8


def collate(
    graphs: Sequence[Subgraph],
    num_graphs: int,
    node_pad: int,
    edge_pad: int,
    gids=None,
    edge_offsets: Optional[np.ndarray] = None,
) -> GraphBatch:
    """Merge subgraphs into one padded disjoint batch-graph (CPU tensors).

    `num_graphs`/`node_pad`/`edge_pad` must be >= the actual totals; the
    remainder is masked padding. `gids` (the graphs' dataset indices) and
    `edge_offsets` (a static dataset's packed offsets) key `edge_id` as the
    module docstring says; padding edges get 0. The graphs are packed
    (batching/dataset.py _PackedGraphs) and collated by collate_packed's
    engine.
    """
    from .dataset import _PackedGraphs    # dataset.py imports this module

    if len(graphs) > num_graphs:
        raise ValueError(f"{len(graphs)} graphs > batch size {num_graphs}")
    packed = _PackedGraphs(graphs)
    return _collate_rows(packed, np.arange(len(graphs), dtype=np.int64), num_graphs,
                         node_pad, edge_pad, _edge_id_base(gids, edge_offsets))


def collate_packed(packed, gids, num_graphs: int, node_pad: int, edge_pad: int,
                   edge_offsets: Optional[np.ndarray] = None) -> GraphBatch:
    """collate of the graphs at rows `gids` of packed tables (batching/
    dataset.py _PackedGraphs; None: every row in order), with `gids` and
    `edge_offsets` keying `edge_id` as collate's do, without building a
    Subgraph. The engine is the C++ one (native/extract.cpp
    igmc_collate_flat: one pass, the interpreter lock released) when its
    library loads, else a vectorised NumPy form; both give collate's
    arrays, and the counter batch.collate_native / batch.collate_numpy
    (utils/spans.py) counts the batch."""
    rows = (np.arange(len(packed), dtype=np.int64) if gids is None
            else np.asarray(gids, dtype=np.int64))
    if len(rows) > num_graphs:
        raise ValueError(f"{len(rows)} graphs > batch size {num_graphs}")
    if len(rows) and (rows.min() < 0 or rows.max() >= len(packed)):
        raise IndexError(f"graph rows outside [0, {len(packed)})")
    return _collate_rows(packed, rows, num_graphs, node_pad, edge_pad,
                         _edge_id_base(gids, edge_offsets))


def _edge_id_base(gids, edge_offsets) -> Optional[np.ndarray]:
    """Each graph's edge-id base (its edge j gets base + j): its packed
    offset, gid * DYNAMIC_EDGE_STRIDE without offsets; None without gids
    (an edge's id is then its forward slot)."""
    if gids is None:
        return None
    gids = np.asarray(gids, dtype=np.int64)
    return (gids * DYNAMIC_EDGE_STRIDE if edge_offsets is None
            else np.asarray(edge_offsets, dtype=np.int64)[gids])


# collate's arrays: (name, dtype, length: 0 node_pad, 1 edge_pad, 2 num_graphs)
_BATCH_ARRAYS = (
    ("node_label", np.int32, 0), ("node2graph", np.int32, 0), ("node_mask", bool, 0),
    ("edge_src", np.int32, 1), ("edge_dst", np.int32, 1), ("edge_type", np.int32, 1),
    ("edge_canon", np.int32, 1), ("edge_mask", bool, 1), ("edge_id", np.int64, 1),
    ("y", np.float32, 2), ("graph_mask", bool, 2), ("target_u", np.int32, 2),
    ("target_v", np.int32, 2),
)


def _over_pad(nodes: int, edges: int, node_pad: int, edge_pad: int) -> ValueError:
    return ValueError(f"batch needs ({nodes} nodes, {edges} edges) "
                      f"> pad ({node_pad}, {edge_pad})")


def _collate_rows(packed, rows, num_graphs, node_pad, edge_pad, id_base) -> GraphBatch:
    if id_base is not None and len(id_base) != len(rows):
        raise ValueError(f"{len(id_base)} graph ids for {len(rows)} graphs")
    sizes = (node_pad, edge_pad, num_graphs)
    if native.available():
        out = {name: np.empty(sizes[n], dtype) for name, dtype, n in _BATCH_ARRAYS}
        _collate_native(packed, rows, id_base, sizes, out)
        engine = "native"
    else:
        out = {name: np.zeros(sizes[n], dtype) for name, dtype, n in _BATCH_ARRAYS}
        _collate_numpy(packed, rows, id_base, sizes, out)
        engine = "numpy"
    spans.count(f"batch.collate_{engine}")
    u_feat = v_feat = None
    if len(rows) and packed.u_feat is not None:
        u_feat = np.zeros((num_graphs, packed.u_feat.shape[1]), np.float32)
        v_feat = np.zeros((num_graphs, packed.v_feat.shape[1]), np.float32)
        u_feat[: len(rows)] = packed.u_feat[rows]
        v_feat[: len(rows)] = packed.v_feat[rows]
    t = torch.from_numpy
    return GraphBatch(**{k: t(v) for k, v in out.items()},
                      u_feat=None if u_feat is None else t(u_feat),
                      v_feat=None if v_feat is None else t(v_feat))


def _collate_native(packed, rows, id_base, sizes, out):
    """_collate_rows' arrays in one call into the C++ engine."""
    lib = native.load()
    node_pad, edge_pad, num_graphs = sizes
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    tables = [i64(packed.node_offsets), i64(packed.edge_offsets),
              i32(packed.node_label), i32(packed.src), i32(packed.dst),
              i32(packed.etype), i32(packed.num_u),
              np.ascontiguousarray(packed.y, dtype=np.float32)]
    G = len(tables[7])
    if (len(tables[0]) != G + 1 or len(tables[1]) != G + 1 or len(tables[6]) != G
            or tables[0][-1] > len(tables[2])
            or not tables[1][-1] <= min(len(tables[3]), len(tables[4]), len(tables[5]))):
        raise ValueError("the packed tables do not match their offsets")
    rows = i64(rows)
    base = None if id_base is None else i64(id_base)
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    totals = np.zeros(2, np.int64)
    arrays = (ctypes.c_void_p * len(out))(*(a.ctypes.data for a in out.values()))
    code = lib.igmc_collate_flat(*map(ptr, tables), G, ptr(rows), ptr(base), len(rows),
                                 num_graphs, node_pad, edge_pad, ptr(totals), arrays)
    if code == 2:
        raise _over_pad(int(totals[0]), int(totals[1]), node_pad, edge_pad)
    if code == 3:
        raise IndexError(f"graph rows outside [0, {G})")
    if code:
        raise RuntimeError(f"igmc_collate_flat failed with code {code}")


def _collate_numpy(packed, rows, id_base, sizes, out):
    """_collate_rows' arrays as whole-array NumPy operations, into `out`
    zeroed: each graph's nodes and forward edges gathered from the tables,
    its edges' slots, shifts and ids repeated from per-graph offsets."""
    node_pad, edge_pad, num_graphs = sizes
    n = len(rows)
    n_lo = packed.node_offsets[rows]
    n_cnt = packed.node_offsets[rows + 1] - n_lo
    e_lo = packed.edge_offsets[rows]
    e_cnt = packed.edge_offsets[rows + 1] - e_lo      # forward edges
    n_off = np.cumsum(n_cnt) - n_cnt                  # nodes before each graph
    f_off = np.cumsum(e_cnt) - e_cnt                  # forward edges before it
    nodes, fwd_edges = int(n_cnt.sum()), int(e_cnt.sum())
    if nodes > node_pad or 2 * fwd_edges > edge_pad:
        raise _over_pad(nodes, 2 * fwd_edges, node_pad, edge_pad)
    graph = np.arange(n)
    at = np.repeat(n_lo - n_off, n_cnt) + np.arange(nodes)
    out["node_label"][:nodes] = packed.node_label[at]
    out["node2graph"][:nodes] = np.repeat(graph, n_cnt)
    out["node_mask"][:nodes] = True
    of = np.repeat(graph, e_cnt)                       # each forward edge's graph
    j = np.arange(fwd_edges) - f_off[of]               # its index in its graph
    at = e_lo[of] + j
    src = packed.src[at] + n_off[of]
    dst = packed.dst[at] + n_off[of]
    fwd = 2 * f_off[of] + j                            # its slot, then its reverse's
    rev = fwd + e_cnt[of]
    for name, f, r in (("edge_src", src, dst), ("edge_dst", dst, src),
                       ("edge_type", packed.etype[at], packed.etype[at])):
        out[name][fwd] = f
        out[name][rev] = r
    out["edge_canon"][:] = np.arange(edge_pad)
    out["edge_canon"][rev] = fwd
    out["edge_mask"][: 2 * fwd_edges] = True
    ids = fwd if id_base is None else id_base[of] + j
    out["edge_id"][fwd] = ids
    out["edge_id"][rev] = ids
    out["y"][:n] = packed.y[rows]
    out["graph_mask"][:n] = True
    out["target_u"][:n] = n_off                        # the target user: first user node
    out["target_v"][:n] = n_off + packed.num_u[rows]   # the target item: first item node


def _feature_tables(graphs: Sequence[Subgraph], num_graphs: int):
    """Zeroed float32 [num_graphs, du] / [num_graphs, dv] tables for the
    graphs' side-feature rows, or (None, None) when they carry none."""
    if not graphs or graphs[0].u_feat is None:
        return None, None
    return (np.zeros((num_graphs, graphs[0].u_feat.shape[0]), dtype=np.float32),
            np.zeros((num_graphs, graphs[0].v_feat.shape[0]), dtype=np.float32))
