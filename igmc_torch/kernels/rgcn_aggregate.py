"""Fused R-GCN aggregate over block-aligned edges: host plans, the CUDA
kernel wrappers (forward K1, backward K2) and their plain PyTorch versions.

Port of igmc_tpu/kernels/rgcn_aggregate.py. The host packs a batch's
edges, sorted by destination, into fixed blocks of `eblk` edges such that
every block only targets one aligned chunk of `rows` output rows
(block_align_edges; block_align_plans builds it and its twin in one call
into the C++ engine, with NumPy where the engine cannot load).
`rgcn_aggregate` then computes, per node row,

    out[i] = sum_{e: dst_e = i} mask_e * sum_b att[etype_e, b] * (x[src_e] @ basis[b])

— the masked segment-SUM of basis-mixed R-GCN messages — with the CUDA
kernel in csrc/rgcn_aggregate_fwd.cu for CUDA tensors, and with
`rgcn_aggregate_ref` for CPU tensors. Its gradient runs over the
src-sorted twin plan (block_align_edges_transposed): the CUDA kernel in
csrc/rgcn_aggregate_bwd.cu for CUDA tensors (`rgcn_aggregate_bwd`), and
`rgcn_aggregate_bwd_ref` for CPU tensors.

Both kernels compute in the run form: the plans order each row's edges by
relation, so the kernels sum the gathered rows of each (row, relation) run
and take one product with W_r = att[r] @ basis per run, not one basis mix
per edge (the kernels' headers say how). They take every shape the JAX
package's Pallas kernels take: any Cin, Cout and number of bases (channels
in 32-wide tiles, one pass over a chunk per tile pair), any relation count,
any block size `eblk` and any `rows` whose shared-memory accumulator fits
the card (up to 5,144 rows on an H100, 6,044 for the forward alone; above
it the wrapper raises, naming the shape).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ..graphs import native
from ..utils import spans

# ---------------------------------------------------------------------------
# Host-side block alignment
# ---------------------------------------------------------------------------

# The plan's default geometry, the JAX package's: output chunks of
# PLAN_ROWS node rows (the CUDA kernels' shared-memory accumulator) and
# blocks of PLAN_EBLK edge slots. BatchLoader(plan_rows=, plan_eblk=) and
# IGMCConfig.pallas_rows set others.
PLAN_ROWS = 256
PLAN_EBLK = 1024


def plan_capacity_blocks(node_pad: int, edge_pad: int, rows: int = PLAN_ROWS,
                         eblk: int = PLAN_EBLK) -> int:
    """Worst-case block count of ANY edge list within (node_pad, edge_pad):
    every NONEMPTY chunk wastes at most one partial block, and at most
    min(n_chunks, edge_pad) chunks can be nonempty. Fixing plans to this
    bound gives every batch of a shape bucket the same plan shape."""
    n_chunks = -(-node_pad // rows)
    return max(1, edge_pad // eblk + min(n_chunks, edge_pad))


def block_align_edges(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_type: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes: int,
    eblk: int = PLAN_EBLK,
    rows: int = PLAN_ROWS,
    num_blocks: Optional[int] = None,
    edge_canon: Optional[np.ndarray] = None,
    ukey_vals: Optional[np.ndarray] = None,
):
    """Sort/pad edges into dst-aligned blocks for the aggregate kernel.

    Returns (src, dst_local, etype, mask, chunk_of_block, first_of_chunk,
    n_blocks, ukey): edge arrays of shape [n_blocks*eblk]; block b only
    contains edges whose dst lies in chunk `chunk_of_block[b]` (rows
    [c*rows, (c+1)*rows)); blocks of one chunk are consecutive, every chunk
    owns at least one block, and `first_of_chunk[b]` marks the first.
    Extra blocks requested by `num_blocks` hold only padding and go to
    chunk 0. Real edges are sorted by (dst, etype), stably: the JAX plan
    sorts by dst alone, so the two plans hold the same edges in the same
    chunks, rows and slots, in another order within a dst row.

    `ukey` is the edge-dropout key stream (None unless `edge_canon` or
    `ukey_vals` is given): `edge_canon * 2 + (src < dst)` per real slot,
    from the undirected-pair ids of GraphBatch.edge_canon, so the keep
    decision can be recomputed on the device as a stateless hash of
    (seed, ukey). `ukey_vals` carries precomputed per-edge keys instead.
    """
    plans, _ = block_align_plans(edge_src, edge_dst, edge_type, edge_mask,
                                 num_nodes, eblk, rows, num_blocks, edge_canon,
                                 ukey_vals)
    return plans[0]


def block_align_edges_transposed(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_type: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes: int,
    eblk: int = PLAN_EBLK,
    rows: int = PLAN_ROWS,
    num_blocks: Optional[int] = None,
    edge_canon: Optional[np.ndarray] = None,
):
    """The src-sorted twin plan: block_align_edges with src and dst swapped
    (so its edges are sorted by (src, etype)).

    The aggregate's gradient scatters to the SOURCE rows, so its kernel
    walks blocks aligned on src chunks. In the returned tuple element 0 is
    the ORIGINAL dst (the rows of the output gradient to gather) and
    element 1 the ORIGINAL src local to its chunk (the dx row); ukey still
    keys the original orientation, so both plans drop the same edges."""
    plans, _ = block_align_plans(edge_src, edge_dst, edge_type, edge_mask,
                                 num_nodes, eblk, rows, num_blocks, edge_canon,
                                 forward=False, twin=True)
    return plans[0]


def block_align_plans(edge_src, edge_dst, edge_type, edge_mask, num_nodes: int,
                      eblk: int = PLAN_EBLK, rows: int = PLAN_ROWS,
                      num_blocks: Optional[int] = None,
                      edge_canon: Optional[np.ndarray] = None,
                      ukey_vals: Optional[np.ndarray] = None,
                      forward: bool = True, twin: bool = False):
    """The forward plan (block_align_edges) and / or its twin
    (block_align_edges_transposed) of one edge list, in that order, and the
    engine that built them: "native", one call into the C++ engine
    (native/extract.cpp igmc_plan_blocks, counting sorts, the interpreter
    lock released) when its library loads, else "numpy" (one stable sort
    and one scatter per array and plan). Both give the same arrays."""
    if num_nodes % rows:
        raise ValueError(f"num_nodes {num_nodes} is not a multiple of rows {rows}")
    keys, from_canon = ukey_vals, False
    if keys is None and edge_canon is not None:
        keys, from_canon = edge_canon, True
    want = [forward, twin]
    if native.available():
        return _plans_native(edge_src, edge_dst, edge_type, edge_mask, num_nodes,
                             eblk, rows, num_blocks, keys, from_canon, want), "native"
    real = np.flatnonzero(edge_mask)
    if len(real) and (edge_src[real].min() < 0 or edge_src[real].max() >= num_nodes
                      or edge_dst[real].min() < 0 or edge_dst[real].max() >= num_nodes):
        raise ValueError(f"edge endpoints outside [0, {num_nodes})")
    if from_canon:
        keys = edge_canon * 2 + (edge_src < edge_dst)
    orients = [(edge_dst, edge_src), (edge_src, edge_dst)]
    return [_plan_numpy(scatter, gather, edge_type, real, num_nodes, eblk, rows,
                        num_blocks, keys)
            for (scatter, gather), w in zip(orients, want) if w], "numpy"


def _too_few_blocks(need: int, num_blocks: int) -> ValueError:
    return ValueError(f"need {need} blocks > requested {num_blocks}")


def _plan_numpy(scatter, gather, edge_type, real, num_nodes, eblk, rows,
                num_blocks, keys):
    """One plan with NumPy: edges sorted stably by (scatter row, etype), each
    at slot block_start[chunk] * eblk + its rank in its chunk."""
    key = (scatter[real].astype(np.int64) << 32) | edge_type[real].astype(np.int64)
    order = real[np.argsort(key, kind="stable")]
    row = scatter[order]
    chunk = row // rows
    counts = np.bincount(chunk, minlength=num_nodes // rows)
    blocks = np.maximum(1, -(-counts // eblk))
    n_blocks = int(blocks.sum())
    if num_blocks is not None:
        if n_blocks > num_blocks:
            raise _too_few_blocks(n_blocks, num_blocks)
        # the extra blocks hold only padding and go to chunk 0
        blocks[0] += num_blocks - n_blocks
        n_blocks = num_blocks
    block_start = np.cumsum(blocks) - blocks
    pos = (block_start[chunk] * eblk + np.arange(len(order))
           - (np.cumsum(counts) - counts)[chunk])

    E = n_blocks * eblk
    out = [np.zeros(E, np.int32) for _ in range(3)] + [np.zeros(E, np.float32)]
    for a, v in zip(out, (gather[order], row - chunk * rows, edge_type[order], 1.0)):
        a[pos] = v
    ukey = None
    if keys is not None:
        ukey = np.zeros(E, np.int32)
        ukey[pos] = keys[order]
    chunk_of_block = np.repeat(np.arange(len(blocks), dtype=np.int32), blocks)
    first_of_chunk = np.zeros(n_blocks, np.int32)
    first_of_chunk[block_start] = 1
    return (*out, chunk_of_block, first_of_chunk, n_blocks, ukey)


def _plans_native(edge_src, edge_dst, edge_type, edge_mask, num_nodes, eblk,
                  rows, num_blocks, keys, from_canon, want):
    lib = native.load()
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    edges = [i32(edge_src), i32(edge_dst), i32(edge_type),
             np.ascontiguousarray(edge_mask, dtype=bool),
             None if keys is None else i32(keys)]
    n_edges = len(edges[3])
    if any(a is not None and a.shape != (n_edges,) for a in edges):
        raise ValueError("the edge arrays differ in length")
    needed = np.zeros(2, np.int64)
    asked = -1 if num_blocks is None else int(num_blocks)
    bits = sum(1 << p for p, w in enumerate(want) if w)

    def call(out):
        code = lib.igmc_plan_blocks(*map(ptr, edges), int(from_canon),
                                    n_edges, int(num_nodes), int(rows),
                                    int(eblk), asked, bits, ptr(needed), out)
        if code == 2:
            raise ValueError(f"edge endpoints outside [0, {num_nodes})")
        if code >= 3:
            raise _too_few_blocks(int(needed[code - 3]), num_blocks)
        if code:
            raise RuntimeError(f"igmc_plan_blocks failed with code {code}")

    if num_blocks is None:
        call(None)     # counts only: the blocks each plan needs
    plans, out = [], (ctypes.c_void_p * 14)()
    for p, w in enumerate(want):
        if not w:
            continue
        nb = int(needed[p]) if num_blocks is None else num_blocks
        E = nb * eblk
        plan = (np.empty(E, np.int32), np.empty(E, np.int32),
                np.empty(E, np.int32), np.empty(E, np.float32),
                None if keys is None else np.empty(E, np.int32),
                np.empty(nb, np.int32), np.empty(nb, np.int32))
        out[7 * p : 7 * p + 7] = [None if a is None else a.ctypes.data for a in plan]
        plans.append(plan[:4] + plan[5:] + (nb, plan[4]))
    call(out)
    return plans


def _dst_global(aligned: Sequence[torch.Tensor], rows: int) -> torch.Tensor:
    """Global dst ids (int64) from (dst_local, chunk_of_block)."""
    src, dstl, _, _, chunk_of_block = aligned[:5]
    eblk = src.shape[0] // chunk_of_block.shape[0]
    return dstl.long() + chunk_of_block.long().repeat_interleave(eblk) * rows


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def rgcn_aggregate_ref(x, att, basis, aligned, rows: int, num_nodes: int):
    """The aggregate in plain PyTorch: gather, basis-mix, one matmul, mask,
    index_add_ on the global dst. Returns [num_nodes, Cout] in x's dtype."""
    src, _, etype, mask = aligned[:4]
    nb, cin, cout = basis.shape
    xs = x[src.long()]                                   # [Ep, Cin]
    ae = att[etype.long()]                               # [Ep, B]
    z = (ae[:, :, None] * xs[:, None, :]).reshape(-1, nb * cin)
    msg = (z @ basis.reshape(nb * cin, cout)) * mask[:, None]
    out = torch.zeros(num_nodes, cout, dtype=msg.dtype, device=msg.device)
    return out.index_add_(0, _dst_global(aligned, rows), msg)


def rgcn_aggregate_bwd_ref(g, x, att, basis, aligned_t, rows: int):
    """The aggregate's gradient in plain PyTorch, over the src-sorted twin
    plan `aligned_t` (block_align_edges_transposed, dropout folded into its
    mask as into the forward plan's). For the output gradient g [N, Cout]:

        gv   = g[dst] * mask                  t_b = gv @ basis_b^T
        dx   = index_add over src of  sum_b ae_b * t_b
        datt = index_add over etype of <t_b, x[src]>
        dbasis_b = (ae_b * x[src])^T @ gv

    with ae = att[etype]. Returns (dx, datt, dbasis) in the inputs' dtype."""
    gdst, _, etype, mask = aligned_t[:4]
    nb, cin, cout = basis.shape
    src = _dst_global(aligned_t, rows)                   # the twin's dst is src
    gv = g[gdst.long()] * mask[:, None]                  # [Ep, Cout]
    xs = x[src]                                          # [Ep, Cin]
    ae = att[etype.long()]                               # [Ep, B]
    t = (gv @ basis.permute(2, 0, 1).reshape(cout, nb * cin)).reshape(-1, nb, cin)
    dx = torch.zeros_like(x).index_add_(0, src, (ae[:, :, None] * t).sum(1))
    datt = torch.zeros_like(att).index_add_(0, etype.long(),
                                            (t * xs[:, None, :]).sum(2))
    z = (ae[:, :, None] * xs[:, None, :]).reshape(-1, nb * cin)
    dbasis = (z.T @ gv).reshape(nb, cin, cout)
    return dx, datt, dbasis


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_N_ARGS = {"rgcn_aggregate_fwd": (9, 8), "rgcn_aggregate_bwd": (13, 9)}
_libs = {}


def _kernel_lib(name: str):
    """The ctypes handle of kernel library `name` (built on first use),
    with its C interface declared: pointers, then ints, then the stream."""
    lib = _libs.get(name)
    if lib is None:
        from .build import load

        lib = load(name)
        n_ptr, n_int = _N_ARGS[name]
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, name)
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = i
        getattr(lib, f"{name}_error_string").argtypes = [i]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _grad_wanted(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _require_twin_plan(aligned_t):
    if aligned_t is None:
        raise RuntimeError(
            "rgcn_aggregate: a gradient needs the src-sorted twin plan "
            "`aligned_t`, which the training loader attaches "
            "(BatchLoader(..., shuffle=True)); call it under torch.no_grad() "
            "to evaluate")


def _check_plan(what, plan, device, ep=None):
    """Device, contiguity and dtypes of a plan's first five arrays; all
    edge arrays of length `ep` (the first array's, by default)."""
    names = ("src", "dst_local", "etype", "mask", "chunk_of_block")
    for name, t in zip(names, plan[:5]):
        if t.device != device:
            raise ValueError(f"rgcn_aggregate: {what} {name} on {t.device}, "
                             f"x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"rgcn_aggregate: {what} {name} must be contiguous")
        want = torch.float32 if name == "mask" else torch.int32
        if t.dtype != want:
            raise TypeError(f"rgcn_aggregate: {what} {name} must be {want}, "
                            f"got {t.dtype}")
    nblk = plan[4].shape[0]
    ep = plan[0].shape[0] if ep is None else ep
    if nblk == 0 or ep % nblk:
        raise ValueError(f"rgcn_aggregate: {ep} {what} edges do not split "
                         f"into {nblk} blocks")
    for name, t in zip(names[:4], plan[:4]):
        if t.shape != (ep,):
            raise ValueError(f"rgcn_aggregate: {what} {name} shape "
                             f"{tuple(t.shape)} != ({ep},)")


def _check_cuda_inputs(x, att, basis, aligned, rows, num_nodes, aligned_t=None):
    """What K1 (and, when a gradient is wanted, K2) does not take raises
    here, before any launch."""
    for name, t in (("x", x), ("att", att), ("basis", basis)):
        if t.device != x.device:
            raise ValueError(f"rgcn_aggregate: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rgcn_aggregate: {name} must be contiguous")
        if t.dtype != torch.float32:
            raise TypeError(f"rgcn_aggregate: {name} must be float32, got {t.dtype}")
    nb, cin, cout = basis.shape
    if x.dim() != 2 or x.shape != (num_nodes, cin):
        raise ValueError(f"rgcn_aggregate: x {tuple(x.shape)} != ({num_nodes}, {cin})")
    if att.dim() != 2 or att.shape[1] != nb:
        raise ValueError(f"rgcn_aggregate: att {tuple(att.shape)} has not {nb} bases")
    if min(nb, cin, cout, att.shape[0]) < 1:
        raise ValueError(f"rgcn_aggregate: empty weights: basis {tuple(basis.shape)}, "
                         f"att {tuple(att.shape)}")
    if num_nodes % rows:
        raise ValueError(f"rgcn_aggregate: num_nodes {num_nodes} % rows {rows} != 0")
    _check_plan("aligned", aligned, x.device)
    if _grad_wanted(x, att, basis):
        _require_twin_plan(aligned_t)
        _check_plan("aligned_t", aligned_t, x.device, aligned[0].shape[0])


def _launch(name, ptrs, ints, device, shape: str):
    """Launch kernel `name` on the current stream of `device`; raises if
    the launch fails. The kernel sizes its own shared memory; a shape
    (`shape` says it) whose smallest need exceeds the card's comes back as
    minus the bytes needed, before any launch."""
    lib = _kernel_lib(name)
    with torch.cuda.device(device):
        err = getattr(lib, name)(*ptrs, *ints,
                                 torch.cuda.current_stream(device).cuda_stream)
    if err < 0:
        have = getattr(torch.cuda.get_device_properties(device),
                       "shared_memory_per_block_optin", "fewer")
        raise ValueError(f"{name}: {shape} needs {-err} bytes of shared memory "
                         f"per block; this card gives a block {have}: plan "
                         f"fewer rows")
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")


def _aggregate_fwd(x, att, basis, aligned, rows: int, num_nodes: int):
    """The forward on x's device: the plain version on the CPU, K1 on CUDA
    (inputs already checked)."""
    if x.device.type == "cpu":
        return rgcn_aggregate_ref(x, att, basis, aligned, rows, num_nodes)
    src, dstl, etype, mask, chunk_of_block = aligned[:5]
    nb, cin, cout = basis.shape
    nblk = chunk_of_block.shape[0]
    out = torch.empty(num_nodes, cout, dtype=torch.float32, device=x.device)
    _launch("rgcn_aggregate_fwd",
            (x.data_ptr(), att.data_ptr(), basis.data_ptr(), src.data_ptr(),
             dstl.data_ptr(), etype.data_ptr(), mask.data_ptr(),
             chunk_of_block.data_ptr(), out.data_ptr()),
            (num_nodes, cin, cout, nb, att.shape[0], rows, nblk,
             src.shape[0] // nblk), x.device,
            f"rows {rows} (Cin {cin}, Cout {cout})")
    rgcn_aggregate.launches += 1
    return out


class _Aggregate(torch.autograd.Function):
    """rgcn_aggregate with its gradient over the src-sorted twin plan:
    forward K1 / rgcn_aggregate_ref, backward K2 / rgcn_aggregate_bwd_ref,
    by the tensors' device."""

    @staticmethod
    def forward(ctx, x, att, basis, aligned, aligned_t, rows, num_nodes):
        ctx.save_for_backward(x, att, basis)
        ctx.aligned_t, ctx.rows = aligned_t, rows
        return _aggregate_fwd(x, att, basis, aligned, rows, num_nodes)

    @staticmethod
    def backward(ctx, g):
        x, att, basis = ctx.saved_tensors
        dx, datt, dbasis = rgcn_aggregate_bwd(
            g.contiguous(), x, att, basis, ctx.aligned_t, ctx.rows,
            need_dx=ctx.needs_input_grad[0])
        return dx, datt, dbasis, None, None, None, None


@spans.spanned("kernels.k1")
def rgcn_aggregate(x, att, basis, aligned, rows: int, num_nodes: int,
                   aligned_t=None):
    """Masked segment-SUM of basis-mixed messages over aligned blocks.

    x [N, Cin] node features; att [R, B]; basis [B, Cin, Cout];
    `aligned` = (src, dst_local, etype, mask, chunk_of_block[, ...]) from
    block_align_edges, as int32/float32 tensors on x's device. Returns
    [num_nodes, Cout] float32 sums (divide by the degree outside for the
    mean).

    Differentiable in x, att and basis when `aligned_t`, the src-sorted
    twin plan with the same dropout folded into its mask, is given; a
    gradient wanted without it raises.

    CUDA tensors go through the hand-written kernels, K1 forward and K2
    backward (built on first use; `rgcn_aggregate.launches` and
    `rgcn_aggregate_bwd.launches` count their launches), and anything they
    do not take raises. The kernels trust the plans' index values
    (checking them would cost a device sync per launch): block_align_edges
    checks them against num_nodes when it builds a plan. CPU tensors take
    the plain versions. A call is span `kernels.k1` (utils/spans.py): on a
    card the checks and K1's launch, on the CPU the plain version.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rgcn_aggregate: no kernel for device {x.device}")
    grad = _grad_wanted(x, att, basis)
    if x.device.type == "cuda":
        _check_cuda_inputs(x, att, basis, aligned, rows, num_nodes, aligned_t)
    elif grad:
        _require_twin_plan(aligned_t)
    if not grad:
        return _aggregate_fwd(x, att, basis, aligned, rows, num_nodes)
    return _Aggregate.apply(x, att, basis, aligned, aligned_t, rows, num_nodes)


rgcn_aggregate.launches = 0


@spans.spanned("kernels.k2")
def rgcn_aggregate_bwd(g, x, att, basis, aligned_t, rows: int,
                       need_dx: bool = True):
    """The aggregate's gradient for the output gradient g [N, Cout]:
    (dx or None, datt, dbasis), as rgcn_aggregate_bwd_ref computes it.

    CPU tensors take rgcn_aggregate_bwd_ref. CUDA tensors go through K2
    (csrc/rgcn_aggregate_bwd.cu; `rgcn_aggregate_bwd.launches` counts its
    launches), which skips dx when `need_dx` is false (layer 1's one-hot
    input); anything it does not take raises. A call is span `kernels.k2`
    (on a card autograd calls it on its device thread)."""
    if g.device.type == "cpu":
        dx, datt, dbasis = rgcn_aggregate_bwd_ref(g, x, att, basis, aligned_t, rows)
        return (dx if need_dx else None), datt, dbasis
    if g.device.type != "cuda":
        raise ValueError(f"rgcn_aggregate_bwd: no kernel for device {g.device}")
    nb, cin, cout = basis.shape
    num_nodes = x.shape[0]
    if (g.device != x.device or g.dtype != torch.float32
            or g.shape != (num_nodes, cout) or not g.is_contiguous()):
        raise ValueError(f"rgcn_aggregate_bwd: g must be a contiguous float32 "
                         f"[{num_nodes}, {cout}] on {x.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    with torch.no_grad():
        _check_cuda_inputs(x, att, basis, aligned_t, rows, num_nodes)
    gdst, srcl, etype, mask, chunk_of_block = aligned_t[:5]
    nrel, nblk = att.shape[0], chunk_of_block.shape[0]
    dx = torch.empty_like(x) if need_dx else None
    datt = torch.empty_like(att)
    dbasis = torch.empty_like(basis)
    # the kernel's global [R, Cin, Cout] dW sum and its CTA ticket, zeroed
    work = torch.zeros(nrel * cin * cout + 1, dtype=torch.float32, device=g.device)
    _launch("rgcn_aggregate_bwd",
            (g.data_ptr(), x.data_ptr(), att.data_ptr(), basis.data_ptr(),
             gdst.data_ptr(), srcl.data_ptr(), etype.data_ptr(), mask.data_ptr(),
             chunk_of_block.data_ptr(), dx.data_ptr() if need_dx else 0,
             datt.data_ptr(), dbasis.data_ptr(), work.data_ptr()),
            (num_nodes, cin, cout, nb, nrel, rows, nblk, gdst.shape[0] // nblk,
             int(need_dx)), g.device,
            f"rows {rows} (Cin {cin}, Cout {cout}, dx {'on' if need_dx else 'off'})")
    rgcn_aggregate_bwd.launches += 1
    return dx, datt, dbasis


rgcn_aggregate_bwd.launches = 0
