"""Fused R-GCN aggregate over dst-block-aligned edges: host plan, CUDA
kernel wrapper and its plain PyTorch version.

Port of igmc_tpu/kernels/rgcn_aggregate.py (forward only). The host packs
a batch's edges, sorted by destination, into fixed blocks of `eblk` edges
such that every block only targets one aligned chunk of `rows` output rows
(block_align_edges). `rgcn_aggregate` then computes, per node row,

    out[i] = sum_{e: dst_e = i} mask_e * sum_b att[etype_e, b] * (x[src_e] @ basis[b])

— the masked segment-SUM of basis-mixed R-GCN messages — with the CUDA
kernel in csrc/rgcn_aggregate_fwd.cu for CUDA tensors, and with
`rgcn_aggregate_ref` for CPU tensors. It has no backward yet: the TPU
package's backward kernel belongs to the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side block alignment
# ---------------------------------------------------------------------------

# The plan's geometry: output chunks of PLAN_ROWS node rows (the CUDA
# kernel's shared-memory accumulator) and blocks of PLAN_EBLK edge slots.
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
):
    """Sort/pad edges into dst-aligned blocks for the aggregate kernel.

    Returns (src, dst_local, etype, mask, chunk_of_block, first_of_chunk,
    n_blocks): edge arrays of shape [n_blocks*eblk]; block b only contains
    edges whose dst lies in chunk `chunk_of_block[b]` (rows
    [c*rows, (c+1)*rows)); blocks of one chunk are consecutive, every chunk
    owns at least one block, and `first_of_chunk[b]` marks the first.
    Extra blocks requested by `num_blocks` hold only padding and go to
    chunk 0.
    """
    if num_nodes % rows:
        raise ValueError(f"num_nodes {num_nodes} is not a multiple of rows {rows}")
    real = np.nonzero(edge_mask)[0]
    if len(real) and (edge_src[real].min() < 0 or edge_src[real].max() >= num_nodes
                      or edge_dst[real].min() < 0 or edge_dst[real].max() >= num_nodes):
        raise ValueError(f"edge endpoints outside [0, {num_nodes})")
    order = real[np.argsort(edge_dst[real], kind="stable")]
    dst_sorted = edge_dst[order]
    chunk_ids = dst_sorted // rows

    # per-chunk edge counts -> per-chunk block counts
    n_chunks = num_nodes // rows
    counts = np.bincount(chunk_ids, minlength=n_chunks)
    blocks_per_chunk = np.maximum(1, -(-counts // eblk))
    n_blocks = int(blocks_per_chunk.sum())
    if num_blocks is not None:
        if n_blocks > num_blocks:
            raise ValueError(f"need {n_blocks} blocks > requested {num_blocks}")
        # distribute the extra blocks to chunk 0 (they hold only padding)
        blocks_per_chunk[0] += num_blocks - n_blocks
        n_blocks = num_blocks

    E = n_blocks * eblk
    src = np.zeros(E, np.int32)
    dstl = np.zeros(E, np.int32)
    etyp = np.zeros(E, np.int32)
    mask = np.zeros(E, np.float32)
    chunk_of_block = np.zeros(n_blocks, np.int32)
    first_of_chunk = np.zeros(n_blocks, np.int32)

    starts = np.concatenate([[0], np.cumsum(counts)])
    b = 0
    for c in range(n_chunks):
        idx = order[starts[c]:starts[c + 1]]
        for k in range(int(blocks_per_chunk[c])):
            sub = idx[k * eblk : (k + 1) * eblk]
            n = len(sub)
            o = b * eblk
            src[o : o + n] = edge_src[sub]
            dstl[o : o + n] = edge_dst[sub] - c * rows
            etyp[o : o + n] = edge_type[sub]
            mask[o : o + n] = 1.0
            chunk_of_block[b] = c
            first_of_chunk[b] = 1 if k == 0 else 0
            b += 1
    return src, dstl, etyp, mask, chunk_of_block, first_of_chunk, n_blocks


def _dst_global(aligned: Sequence[torch.Tensor], rows: int) -> torch.Tensor:
    """Global dst ids (int64) from (dst_local, chunk_of_block)."""
    src, dstl, _, _, chunk_of_block = aligned[:5]
    eblk = src.shape[0] // chunk_of_block.shape[0]
    return dstl.long() + chunk_of_block.long().repeat_interleave(eblk) * rows


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def rgcn_aggregate_ref(x, att, basis, aligned, rows: int, num_nodes: int):
    """The aggregate in plain PyTorch: gather, basis-mix, one matmul, mask,
    index_add_ on the global dst. Returns [num_nodes, Cout] float32."""
    src, _, etype, mask = aligned[:4]
    nb, cin, cout = basis.shape
    xs = x[src.long()]                                   # [Ep, Cin]
    ae = att[etype.long()]                               # [Ep, B]
    z = (ae[:, :, None] * xs[:, None, :]).reshape(-1, nb * cin)
    msg = (z @ basis.reshape(nb * cin, cout)) * mask[:, None]
    out = torch.zeros(num_nodes, cout, dtype=msg.dtype, device=msg.device)
    return out.index_add_(0, _dst_global(aligned, rows), msg)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_MAX_COUT = 32   # one lane per output channel
_MAX_BASES = 8   # the kernel is instantiated for 1..8 bases
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("rgcn_aggregate_fwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rgcn_aggregate_fwd.argtypes = [p] * 9 + [i] * 8 + [p]
        lib.rgcn_aggregate_fwd.restype = i
        lib.rgcn_aggregate_fwd_max_smem.argtypes = []
        lib.rgcn_aggregate_fwd_max_smem.restype = i
        lib.rgcn_aggregate_fwd_error_string.argtypes = [i]
        lib.rgcn_aggregate_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda_inputs(x, att, basis, aligned, rows, num_nodes):
    src, dstl, etype, mask, chunk_of_block = aligned[:5]
    named = {"x": x, "att": att, "basis": basis, "src": src, "dst_local": dstl,
             "etype": etype, "mask": mask, "chunk_of_block": chunk_of_block}
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"rgcn_aggregate: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rgcn_aggregate: {name} must be contiguous")
    for name in ("x", "att", "basis", "mask"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"rgcn_aggregate: {name} must be float32, "
                            f"got {named[name].dtype}")
    for name in ("src", "dst_local", "etype", "chunk_of_block"):
        if named[name].dtype != torch.int32:
            raise TypeError(f"rgcn_aggregate: {name} must be int32, "
                            f"got {named[name].dtype}")
    nb, cin, cout = basis.shape
    if x.dim() != 2 or x.shape != (num_nodes, cin):
        raise ValueError(f"rgcn_aggregate: x {tuple(x.shape)} != ({num_nodes}, {cin})")
    if att.dim() != 2 or att.shape[1] != nb:
        raise ValueError(f"rgcn_aggregate: att {tuple(att.shape)} has not {nb} bases")
    if cout > _MAX_COUT:
        raise ValueError(f"rgcn_aggregate: the kernel takes Cout <= {_MAX_COUT}, "
                         f"got {cout}")
    if not 1 <= nb <= _MAX_BASES:
        raise ValueError(f"rgcn_aggregate: the kernel takes 1 to {_MAX_BASES} "
                         f"bases, got {nb}")
    nblk = chunk_of_block.shape[0]
    ep = src.shape[0]
    if nblk == 0 or ep % nblk:
        raise ValueError(f"rgcn_aggregate: {ep} edges do not split into {nblk} blocks")
    for name in ("dst_local", "etype", "mask"):
        if named[name].shape != (ep,):
            raise ValueError(f"rgcn_aggregate: {name} shape {tuple(named[name].shape)} "
                             f"!= ({ep},)")
    if num_nodes % rows:
        raise ValueError(f"rgcn_aggregate: num_nodes {num_nodes} % rows {rows} != 0")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, att, basis)):
        raise RuntimeError("rgcn_aggregate: the CUDA kernel has no backward yet; "
                           "call it under torch.no_grad()")


def rgcn_aggregate(x, att, basis, aligned, rows: int, num_nodes: int):
    """Masked segment-SUM of basis-mixed messages over aligned blocks.

    x [N, Cin] node features; att [R, B]; basis [B, Cin, Cout];
    `aligned` = (src, dst_local, etype, mask, chunk_of_block[, ...]) from
    block_align_edges, as int32/float32 tensors on x's device. Returns
    [num_nodes, Cout] float32 sums (divide by the degree outside for the
    mean).

    CUDA tensors go through the hand-written kernel (built on first use;
    `rgcn_aggregate.launches` counts its launches) and anything it does not
    take raises. The kernel trusts the plan's index values (checking them
    would cost a device sync per launch): block_align_edges checks them
    against num_nodes when it builds the plan. CPU tensors take
    `rgcn_aggregate_ref`.
    """
    if x.device.type == "cpu":
        return rgcn_aggregate_ref(x, att, basis, aligned, rows, num_nodes)
    if x.device.type != "cuda":
        raise ValueError(f"rgcn_aggregate: no kernel for device {x.device}")
    _check_cuda_inputs(x, att, basis, aligned, rows, num_nodes)
    src, dstl, etype, mask, chunk_of_block = aligned[:5]
    nb, cin, cout = basis.shape
    nblk = chunk_of_block.shape[0]
    lib = _kernel_lib()
    smem = 4 * (nb * cin * cout + att.shape[0] * nb + rows * cout)
    with torch.cuda.device(x.device):
        if smem > lib.rgcn_aggregate_fwd_max_smem():
            raise ValueError(f"rgcn_aggregate: needs {smem} B of shared memory "
                             f"(rows {rows}, basis {tuple(basis.shape)}), over "
                             f"the card's per-block limit")
        out = torch.empty(num_nodes, cout, dtype=torch.float32, device=x.device)
        err = lib.rgcn_aggregate_fwd(
            x.data_ptr(), att.data_ptr(), basis.data_ptr(), src.data_ptr(),
            dstl.data_ptr(), etype.data_ptr(), mask.data_ptr(),
            chunk_of_block.data_ptr(), out.data_ptr(),
            num_nodes, cin, cout, nb, att.shape[0], rows, nblk,
            src.shape[0] // nblk, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.rgcn_aggregate_fwd_error_string(err).decode()
        raise RuntimeError(f"rgcn_aggregate: kernel launch failed: {msg} ({err})")
    rgcn_aggregate.launches += 1
    return out


rgcn_aggregate.launches = 0
