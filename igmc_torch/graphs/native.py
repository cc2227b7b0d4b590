"""ctypes binding of the C++ extraction engine (native/extract.cpp), whose
library also builds the fused aggregate's block plans (igmc_plan_blocks,
called by kernels/rgcn_aggregate.py block_align_plans) and collates flat
batches (igmc_collate_flat, called by batching/batch.py collate_packed).

Port of igmc_tpu/graphs/native.py and native_impl.py. The library is
built with g++ on first use (native/build.py) and loaded once per
process; its ABI version must equal ABI_VERSION, else it is refused.
`resolve_backend` turns an extraction backend ("auto", "numpy",
"native") into the engine that runs: "native" raises when the library
cannot be built or loaded, "auto" falls back to NumPy then, and says on
stderr which engine it chose, once per process.

The engine runs in two phases — run (threads walk the CSR) -> sizes ->
fill packed arrays -> free — and returns Subgraph views over one packed
allocation, with no Python work per edge.
"""

from __future__ import annotations

import ctypes as ct
import sys

import numpy as np

from .extract import Subgraph, side_features

ABI_VERSION = 4  # must match igmc_extract_abi_version() in extract.cpp

_LIB = None
_ERROR = None      # why the library could not be built or loaded
_ANNOUNCED = None  # the engine "auto" last said it chose


def load():
    """The engine's ctypes handle, built first if needed. Raises
    RuntimeError naming the cause when it cannot be built or loaded."""
    global _LIB, _ERROR
    if _LIB is None and _ERROR is None:
        try:
            from ..native.build import build

            lib = ct.CDLL(build())
            version = lib.igmc_extract_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"ABI version {version}, expected {ABI_VERSION}")
            _declare(lib)
            _LIB = lib
        except (OSError, RuntimeError, AttributeError) as e:
            _ERROR = f"{type(e).__name__}: {e}"
    if _LIB is None:
        raise RuntimeError(f"the C++ extraction engine is unavailable ({_ERROR})")
    return _LIB


def available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False


def resolve_backend(backend: str) -> str:
    """The engine `backend` runs: "numpy" or "native"."""
    global _ANNOUNCED
    if backend == "numpy":
        return "numpy"
    if backend == "native":
        load()
        return "native"
    if backend != "auto":
        raise ValueError(f"unknown extraction backend {backend!r} "
                         f"(auto|numpy|native)")
    engine = "native" if available() else "numpy"
    if engine != _ANNOUNCED:
        why = "" if engine == "native" else f"; C++ engine unavailable: {_ERROR}"
        print(f"extraction engine: {engine} (backend auto{why})", file=sys.stderr)
        _ANNOUNCED = engine
    return engine


def _declare(lib):
    lib.igmc_extract_run.restype = ct.c_void_p
    lib.igmc_extract_run.argtypes = (
        [ct.c_void_p] * 3 + [ct.c_int64] + [ct.c_void_p] * 3 + [ct.c_int64]
        + [ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int32,
           ct.c_double, ct.c_int64, ct.c_uint64, ct.c_int32])
    lib.igmc_extract_sizes.argtypes = [ct.c_void_p] * 4
    lib.igmc_extract_fill.argtypes = [ct.c_void_p] * 7
    lib.igmc_extract_free.argtypes = [ct.c_void_p]
    lib.igmc_plan_blocks.restype = ct.c_int32
    lib.igmc_plan_blocks.argtypes = (
        [ct.c_void_p] * 5 + [ct.c_int32] + [ct.c_int64] * 5
        + [ct.c_int32, ct.c_void_p, ct.c_void_p])
    lib.igmc_collate_flat.restype = ct.c_int32
    lib.igmc_collate_flat.argtypes = (
        [ct.c_void_p] * 8 + [ct.c_int64] + [ct.c_void_p] * 2 + [ct.c_int64] * 4
        + [ct.c_void_p] * 2)


def _as(arr, dtype):
    a = np.ascontiguousarray(arr, dtype=dtype)
    return a, a.ctypes.data_as(ct.c_void_p)


def extract_many_native(links, labels, A, h, sample_ratio, max_nodes_per_hop,
                        u_features, v_features, class_values, seed,
                        indices=None):
    """graphs/extract.py extract_many on the C++ engine."""
    lib = load()
    us, vs = links
    n = len(us)
    keep = [_as(A.u_indptr, np.int64), _as(A.u_indices, np.int32),
            _as(A.u_data, np.float32), _as(A.v_indptr, np.int64),
            _as(A.v_indices, np.int32), _as(A.v_data, np.float32),
            _as(us, np.int64), _as(vs, np.int64)]
    p = [ptr for _, ptr in keep]
    sid = ct.c_void_p(None)
    if indices is not None:
        keep.append(_as(indices, np.int64))
        sid = keep[-1][1]
    mnph = -1 if max_nodes_per_hop is None else int(max_nodes_per_hop)
    handle = lib.igmc_extract_run(
        p[0], p[1], p[2], A.num_users, p[3], p[4], p[5], A.num_items,
        p[6], p[7], n, sid, int(h), float(sample_ratio), mnph,
        int(seed) & (2**64 - 1), 0)
    ptr = lambda a: a.ctypes.data_as(ct.c_void_p)
    try:
        node_counts = np.zeros(n, np.int64)
        edge_counts = np.zeros(n, np.int64)
        num_u = np.zeros(n, np.int32)
        lib.igmc_extract_sizes(handle, ptr(node_counts), ptr(edge_counts),
                               ptr(num_u))
        node_offsets = np.zeros(n + 1, np.int64)
        edge_offsets = np.zeros(n + 1, np.int64)
        np.cumsum(node_counts, out=node_offsets[1:])
        np.cumsum(edge_counts, out=edge_offsets[1:])
        node_label = np.zeros(int(node_offsets[-1]), np.int32)
        src = np.zeros(int(edge_offsets[-1]), np.int32)
        dst = np.zeros(int(edge_offsets[-1]), np.int32)
        etype = np.zeros(int(edge_offsets[-1]), np.int32)
        lib.igmc_extract_fill(handle, ptr(node_offsets), ptr(edge_offsets),
                              ptr(node_label), ptr(src), ptr(dst), ptr(etype))
    finally:
        lib.igmc_extract_free(handle)

    out = []
    for i in range(n):
        ns, ne = node_offsets[i], node_offsets[i + 1]
        es, ee = edge_offsets[i], edge_offsets[i + 1]
        y = (float(class_values[labels[i]]) if class_values is not None
             else float(labels[i]))
        uf, vf = side_features(us[i], vs[i], u_features, v_features)
        out.append(Subgraph(
            src=src[es:ee], dst=dst[es:ee], etype=etype[es:ee],
            node_label=node_label[ns:ne], num_u=int(num_u[i]),
            num_v=int(ne - ns - num_u[i]), y=y, u_feat=uf, v_feat=vf))
    return out
