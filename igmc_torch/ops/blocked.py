"""The blocked flat engine: R-GCN aggregation over dst-blocked edges with
one-hot block products, and its backward over the src-blocked twin plan.

Port of igmc_tpu/ops/blocked.py. The host sorts a flat batch's real edges
by aggregation row and packs them into blocks of `eblk` edges, each block
targeting one aligned chunk of `rows` rows (a heavy row spans several
consecutive blocks of its chunk); a second plan does the same by source
row, for the gradient. Then, per group of `group` blocks:

  * forward (dst-major): gather x[src], mix the bases per edge
    (att[type] outer x[src], times the stacked bases), and sum the messages
    into the chunk's rows as onehot(row)^T @ msg; the block partials of one
    chunk are summed into it (a sorted chunk sum over the blocks);
  * backward (src-major, blocked_rgcn_aggregate's autograd Function): for
    the output gradient g, per edge u = g[dst] * mask and dz_b = u @
    basis_b^T; dx sums att[type] . dz into the source rows the same way,
    datt and dbasis accumulate over the groups.

The plans are NumPy (plan_blocked_edges: the JAX package's arrays) turned
into tensors; the products are torch.matmul and the chunk sums index_add.
Edge dropout is the stateless hash of (seed, pair id) or (seed, ukey) on
each plan (dropout_masks), so both plans drop the same directed edges, and
the masks equal the JAX package's bit for bit for one seed. relmean is the
sum with each edge weighted by its inverse (dst, relation) count, carried
in both plans' masks (relmean_weights).

`compute_dtype` bfloat16 rounds the forward's x, att, basis, each edge's
att * x product and the messages, as the JAX package does, and sums in
float32; the backward runs in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.rgcn_aggregate import PLAN_EBLK, PLAN_ROWS
from .dropout import hash_edge_keep


class BlockedPlan(NamedTuple):
    """The edges of one direction, blocked by aggregation row: [NB, eblk]
    per-edge fields and [NB] chunk. Block b's edges all aggregate into
    chunk chunk[b] (rows [c * rows, (c + 1) * rows)), and chunk is
    nondecreasing. `gather` is the global row features are gathered from,
    `row` the aggregation row local to the chunk, `pair` the undirected
    pair id and `ukey` = pair * 2 + (src < dst) the directed one (the
    dropout keys)."""

    gather: torch.Tensor   # int32 [NB, eblk]
    row: torch.Tensor      # int32 [NB, eblk]
    etype: torch.Tensor    # int32 [NB, eblk]
    mask: torch.Tensor     # float32 [NB, eblk]
    pair: torch.Tensor     # int32 [NB, eblk]
    ukey: torch.Tensor     # int32 [NB, eblk]
    chunk: torch.Tensor    # int32 [NB]


class BlockedEdges:
    """The forward (dst-major) and backward (src-major) plans of one edge
    list, with their geometry: `rows` per chunk, `num_nodes` aggregation
    rows, `group` blocks per step, and `num_gather` rows of the table
    features are gathered from (num_nodes by default)."""

    def __init__(self, fwd: BlockedPlan, bwd: BlockedPlan, rows: int,
                 num_nodes: int, group: int = 8, num_gather: Optional[int] = None):
        self.fwd = fwd
        self.bwd = bwd
        self.rows = rows
        self.num_nodes = num_nodes
        self.group = group
        self.num_gather = num_nodes if num_gather is None else num_gather

    def map(self, fn) -> "BlockedEdges":
        """A copy with `fn` applied to every plan tensor."""
        return BlockedEdges(BlockedPlan(*map(fn, self.fwd)), BlockedPlan(*map(fn, self.bwd)),
                            self.rows, self.num_nodes, self.group, self.num_gather)

    def to(self, device, non_blocking: bool = False) -> "BlockedEdges":
        return self.map(lambda t: t.to(device, non_blocking=non_blocking))


def _plan_one(agg: np.ndarray, gat: np.ndarray, etype: np.ndarray,
              pair: np.ndarray, ukey: np.ndarray, mask: np.ndarray,
              num_nodes: int, rows: int, eblk: int, group: int,
              num_blocks: Optional[int] = None) -> BlockedPlan:
    """Sort the real edges by aggregation row, pack them into chunk-aligned
    blocks of eblk, pad the block count to a multiple of `group` (or to a
    fixed `num_blocks`, so every batch of a shape bucket has one plan
    shape). Padding blocks go to the last chunk. NumPy arrays, the JAX
    package's."""
    n_chunks = -(-num_nodes // rows)
    real = np.nonzero(mask)[0]
    order = real[np.argsort(agg[real], kind="stable")]
    chunk_ids = agg[order] // rows
    counts = np.bincount(chunk_ids, minlength=n_chunks)
    bpc = -(-counts // eblk)                 # blocks per chunk (0 if empty)
    nb = max(int(bpc.sum()), 1)
    nb_pad = -(-nb // group) * group
    if num_blocks is not None:
        if nb > num_blocks:
            raise ValueError(f"plan needs {nb} blocks > fixed {num_blocks}")
        nb_pad = -(-num_blocks // group) * group

    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(order)) - starts[chunk_ids]
    block_base = np.concatenate([[0], np.cumsum(bpc)])[:-1]
    blk = (block_base[chunk_ids] + pos // eblk).astype(np.int64)
    slot = (pos % eblk).astype(np.int64)

    def table(values, dtype):
        out = np.zeros((nb_pad, eblk), dtype)
        out[blk, slot] = values
        return out

    chunk = np.full(nb_pad, n_chunks - 1, np.int32)
    real_blocks = np.repeat(np.arange(n_chunks, dtype=np.int32), bpc)
    chunk[: len(real_blocks)] = real_blocks
    return BlockedPlan(table(gat[order], np.int32),
                       table(agg[order] - chunk_ids * rows, np.int32),
                       table(etype[order], np.int32), table(1.0, np.float32),
                       table(pair[order], np.int32), table(ukey[order], np.int32),
                       chunk)


def pad_plan_blocks(plan: BlockedPlan, nb_target: int, n_chunks: int,
                    group: int) -> BlockedPlan:
    """A plan grown to nb_target blocks (rounded up to `group`) with masked
    padding blocks in the last chunk (chunk stays nondecreasing), so that
    plans of different sizes share one shape."""
    nb_target = -(-nb_target // group) * group
    nb, eblk = plan.gather.shape
    if nb > nb_target:
        raise ValueError(f"cannot shrink plan blocks {nb} -> {nb_target}")
    if nb == nb_target:
        return plan
    pad = nb_target - nb
    z = lambda a: np.concatenate([np.asarray(a), np.zeros((pad, eblk), np.asarray(a).dtype)])
    chunk = np.concatenate([np.asarray(plan.chunk), np.full(pad, n_chunks - 1, np.int32)])
    return BlockedPlan(*(z(a) for a in plan[:6]), chunk)


def plan_blocked_edges(edge_src, edge_dst, edge_type, edge_mask, edge_canon,
                       num_nodes: int, rows: int = PLAN_ROWS, eblk: int = PLAN_EBLK,
                       group: int = 8, num_blocks: Optional[int] = None
                       ) -> BlockedEdges:
    """Both plans of a padded flat edge list (GraphBatch fields, numpy or
    CPU tensors), as CPU tensors of the JAX package's NumPy arrays.
    `num_blocks` (e.g. kernels.rgcn_aggregate.plan_capacity_blocks) fixes
    the block count. The directed dropout key is edge_canon * 2 +
    (src < dst), the same in whichever plan holds the edge."""
    src, dst, et, em, pc = (np.asarray(a) for a in
                            (edge_src, edge_dst, edge_type, edge_mask, edge_canon))
    uk = (pc * 2 + (src < dst)).astype(np.int32)
    fwd = _plan_one(dst, src, et, pc, uk, em, num_nodes, rows, eblk, group, num_blocks)
    bwd = _plan_one(src, dst, et, pc, uk, em, num_nodes, rows, eblk, group, num_blocks)
    return BlockedEdges(fwd, bwd, rows, num_nodes, group).map(torch.from_numpy)


def _row_global(plan: BlockedPlan, rows: int) -> torch.Tensor:
    return plan.row.long() + plan.chunk.long()[:, None] * rows


def dropout_masks(blocked: BlockedEdges, p: float, force_undirected: bool, seed: int):
    """(fwd_mask, bwd_mask) with the hash edge dropout of `seed` applied:
    keyed on the pair id with force_undirected (both copies tied), else on
    the directed ukey, so the two plans keep the same directed edges."""
    def one(plan):
        keep = hash_edge_keep(seed, plan.pair if force_undirected else plan.ukey, p)
        return plan.mask * keep.to(plan.mask.dtype)

    return one(blocked.fwd), one(blocked.bwd)


def _chunk_rows(values: torch.Tensor, plan: BlockedPlan, rows: int,
                num_nodes: int) -> torch.Tensor:
    """Per-slot `values` [NB, eblk, *] summed into their aggregation rows,
    [num_nodes, *]."""
    n_chunks = -(-num_nodes // rows)
    out = values.new_zeros((n_chunks * rows,) + tuple(values.shape[2:]))
    out.index_add_(0, _row_global(plan, rows).reshape(-1),
                   values.reshape((-1,) + tuple(values.shape[2:])))
    return out[:num_nodes]


def blocked_degree(plan: BlockedPlan, mask: torch.Tensor, rows: int,
                   num_nodes: int) -> torch.Tensor:
    """The kept (mask-weighted) incoming-edge count per aggregation row,
    [num_nodes]."""
    return _chunk_rows(mask, plan, rows, num_nodes)


def blocked_rel_counts(plan: BlockedPlan, mask: torch.Tensor, R: int, rows: int,
                       num_nodes: int) -> torch.Tensor:
    """The kept incoming-edge count per (aggregation row, relation),
    [num_nodes, R]."""
    n_rows = -(-num_nodes // rows) * rows
    key = _row_global(plan, rows) * R + plan.etype.long()
    out = mask.new_zeros(n_rows * R).index_add_(0, key.reshape(-1), mask.reshape(-1))
    return out.reshape(n_rows, R)[:num_nodes]


def relmean_weights(cinv_flat: torch.Tensor, plan: BlockedPlan, mask, R: int,
                    rows: int, is_fwd: bool) -> torch.Tensor:
    """A plan's per-edge weights mask * 1/c_{dst, type}: the (dst, type)
    key is the aggregation row in the forward plan and the gather row in
    the backward one. `cinv_flat` is [num_nodes * R] (blocked_rel_counts)."""
    key_rows = _row_global(plan, rows) if is_fwd else plan.gather.long()
    idx = (key_rows * R + plan.etype.long()).clamp(0, cinv_flat.shape[0] - 1)
    return mask * cinv_flat[idx]


def _round(t: torch.Tensor, cd) -> torch.Tensor:
    return t if cd is None else t.to(cd).float()


def _groups(plan: BlockedPlan, group: int):
    NB = plan.gather.shape[0]
    if NB % group:
        raise ValueError(f"{NB} blocks do not split into groups of {group}")
    return range(0, NB, group)


def _fwd_pass(x, att, basis, blocked: BlockedEdges, mask, compute_dtype=None):
    """out[i] = sum over edges e with dst_e = i of mask_e * (att[type_e]
    outer x[src_e]) @ basis, [num_nodes, Cout] float32."""
    plan, rows = blocked.fwd, blocked.rows
    nb, cin, cout = basis.shape
    xc = _round(x, compute_dtype)
    bflat = _round(basis, compute_dtype).reshape(nb * cin, cout)
    attc = _round(att, compute_dtype)
    eblk = plan.gather.shape[1]
    parts = []
    for g in _groups(plan, blocked.group):
        s = plan.gather[g:g + blocked.group].long()
        t = plan.etype[g:g + blocked.group].long()
        m = mask[g:g + blocked.group]
        G = s.shape[0]
        xs = xc[s]                                           # [G, eblk, cin]
        ae = _round(attc[t] * _round(m, compute_dtype)[..., None],
                    compute_dtype)                           # [G, eblk, nb]
        z = _round(ae[..., None] * xs[..., None, :], compute_dtype)
        msg = _round(z.reshape(G, eblk, nb * cin) @ bflat, compute_dtype)
        oh = torch.nn.functional.one_hot(plan.row[g:g + blocked.group].long(),
                                         rows).to(msg.dtype)
        parts.append(oh.transpose(1, 2) @ msg)               # [G, rows, cout]
    return _chunk_sum(torch.cat(parts), plan, rows, blocked.num_nodes)


def _chunk_sum(parts: torch.Tensor, plan: BlockedPlan, rows: int,
               num_nodes: int) -> torch.Tensor:
    """Block partials [NB, rows, C] summed into their chunks, [num_nodes, C]."""
    n_chunks = -(-num_nodes // rows)
    out = parts.new_zeros(n_chunks, rows, parts.shape[2])
    out.index_add_(0, plan.chunk.long(), parts)
    return out.reshape(n_chunks * rows, -1)[:num_nodes]


def _bwd_pass(x, att, basis, g, blocked: BlockedEdges, mask, need_dx: bool = True):
    """(dx or None, datt, dbasis) of the forward for its output gradient g,
    over the src-major plan: per edge (gathered at its dst, aggregated at
    its src) u = g[dst] * mask, dz_b = u @ basis_b^T, dx_e = sum_b
    att[type, b] dz_b, datt[type] += <dz_b, x[src]>, dbasis += (att[type]
    outer x[src])^T u."""
    plan, rows = blocked.bwd, blocked.rows
    nb, cin, cout = basis.shape
    R = att.shape[0]
    datt = torch.zeros_like(att)
    dbasis = torch.zeros_like(basis)
    src = _row_global(plan, rows)
    parts = []
    for k in _groups(plan, blocked.group):
        sl = slice(k, k + blocked.group)
        t = plan.etype[sl].long()
        um = g[plan.gather[sl].long()] * mask[sl][..., None]    # [G, eblk, cout]
        ae = att[t]                                             # [G, eblk, nb]
        xs = x[src[sl]]                                         # [G, eblk, cin]
        dz3 = torch.einsum("geo,bio->gebi", um, basis)          # [G, eblk, nb, cin]
        if need_dx:
            dxs = torch.einsum("geb,gebi->gei", ae, dz3)
            oh = torch.nn.functional.one_hot(plan.row[sl].long(), rows).to(dxs.dtype)
            parts.append(oh.transpose(1, 2) @ dxs)              # [G, rows, cin]
        dae = torch.einsum("gebi,gei->geb", dz3, xs)
        datt.index_add_(0, t.reshape(-1), dae.reshape(-1, nb))
        z = (ae[..., None] * xs[..., None, :]).reshape(-1, nb * cin)
        dbasis += (z.t() @ um.reshape(-1, cout)).reshape(nb, cin, cout)
    dx = (_chunk_sum(torch.cat(parts), plan, rows, blocked.num_gather)
          if need_dx else None)
    return dx, datt, dbasis


class _BlockedAggregate(torch.autograd.Function):
    """blocked_rgcn_aggregate: the dst-major forward, the src-major
    backward (the JAX package's custom_vjp)."""

    @staticmethod
    def forward(ctx, x, att, basis, blocked, masks, compute_dtype):
        ctx.save_for_backward(x, att, basis, masks[1])
        ctx.blocked = blocked
        return _fwd_pass(x, att, basis, blocked, masks[0], compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, att, basis, mask_bwd = ctx.saved_tensors
        dx, datt, dbasis = _bwd_pass(x, att, basis, g.contiguous(), ctx.blocked,
                                     mask_bwd, need_dx=ctx.needs_input_grad[0])
        return dx, datt, dbasis, None, None, None


def blocked_rgcn_aggregate(x, att, basis, blocked: BlockedEdges, masks,
                           compute_dtype=None) -> torch.Tensor:
    """Masked segment-SUM of basis-mixed messages, scatter-free both ways:
    x [num_gather, Cin] float32, att [R, nb], basis [nb, Cin, Cout],
    `blocked` from plan_blocked_edges on x's device, `masks` = (fwd_mask,
    bwd_mask) (the plans' masks, or dropout_masks / relmean_weights of
    them). Returns [num_nodes, Cout] float32 sums (divide by
    blocked_degree for the mean); differentiable in x, att and basis."""
    return _BlockedAggregate.apply(x, att, basis, blocked, tuple(masks), compute_dtype)
