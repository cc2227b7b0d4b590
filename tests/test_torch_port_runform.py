"""The run form of the fused R-GCN aggregate on the CPU: a plain-torch
mirror of what the CUDA kernels K1 (csrc/rgcn_aggregate_fwd.cu) and K2
(csrc/rgcn_aggregate_bwd.cu) compute, held against the JAX package's Pallas
kernels in interpret mode and against the port's plain versions
rgcn_aggregate_ref / rgcn_aggregate_bwd_ref.

The kernels walk the plan's live slots in order and cut them into runs of
one (scatter row, relation): the plan orders each row's edges by relation,
so every (row, relation) pair is one run even when dropout zeroes slots in
its middle or the row spans several blocks. Forward: u = sum mask * x[src]
per run, then out[dst] += u @ W_r with W_r = sum_b att[r, b] * basis[b].
Backward over the twin plan: u = sum mask * g[dst] per run, then
dx[src] += u @ W_r^T and dW_r += x[src] outer u, folded into
datt[r, b] = <basis[b], dW_r> and dbasis[b] = sum_r att[r, b] * dW_r."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from igmc_tpu.kernels.rgcn_aggregate import (
    _aggregate_bwd as jax_aggregate_bwd,
    rgcn_aggregate_pallas,
)

from igmc_torch.kernels.rgcn_aggregate import (
    _dst_global, block_align_edges, block_align_edges_transposed,
    rgcn_aggregate_bwd_ref, rgcn_aggregate_ref,
)

torch.set_num_threads(1)

N, E, B, COUT, ROWS, EBLK = 64, 500, 4, 16, 16, 64
RTOL = ATOL = 1e-5   # float32 sums of the same terms in another order


def _runs(plan, nrel):
    """(live slot ids, run id per live slot, first live slot of each run,
    scatter row per slot): runs of consecutive live slots with one
    (scatter row, relation)."""
    row = _dst_global(plan, ROWS)
    live = torch.nonzero(plan[3] != 0)[:, 0]
    key = row[live] * nrel + plan[2][live].long()
    start = torch.ones_like(key, dtype=torch.bool)
    start[1:] = key[1:] != key[:-1]
    # the plan's order makes every (row, relation) pair a single run
    assert int(start.sum()) == int(torch.unique(key).numel())
    return live, torch.cumsum(start.long(), 0) - 1, live[start], row


def run_form_fwd(x, att, basis, plan):
    """K1's method: per-run sums of mask * x[src], one product with W_r per
    run, summed into the run's dst row."""
    src, _, etype, mask = plan[:4]
    w = torch.einsum("rb,bio->rio", att, basis)
    live, run, first, dst = _runs(plan, att.shape[0])
    u = torch.zeros(int(first.numel()), x.shape[1]).index_add_(
        0, run, mask[live, None] * x[src[live].long()])
    msg = torch.bmm(u[:, None, :], w[etype[first].long()])[:, 0]
    return torch.zeros(x.shape[0], basis.shape[2]).index_add_(0, dst[first], msg)


def run_form_bwd(g, x, att, basis, plan_t):
    """K2's method over the twin plan: per-run sums of mask * g[dst]; dx by
    one product with W_r^T per run; dW_r by one outer product per run,
    folded into datt and dbasis."""
    gdst, _, etype, mask = plan_t[:4]
    nrel = att.shape[0]
    w = torch.einsum("rb,bio->rio", att, basis)
    live, run, first, src = _runs(plan_t, nrel)
    u = torch.zeros(int(first.numel()), g.shape[1]).index_add_(
        0, run, mask[live, None] * g[gdst[live].long()])
    rel = etype[first].long()
    dx = torch.zeros_like(x).index_add_(
        0, src[first], torch.bmm(u[:, None, :], w[rel].transpose(1, 2))[:, 0])
    dw = torch.zeros(nrel, x.shape[1], g.shape[1]).index_add_(
        0, rel, x[src[first]][:, :, None] * u[:, None, :])
    datt = torch.einsum("rio,bio->rb", dw, basis)
    dbasis = torch.einsum("rb,rio->bio", att, dw)
    return dx, datt, dbasis


def make_case(case, nrel, cin, seed):
    """Edges, a 20% dropout folded into both plans' masks, both plans and
    the operands at the main path's scales. 'hot_row' sends most edges to
    node 0 and most edges from node 1, so a row of each plan spans several
    blocks."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    if case == "hot_row":
        dst[40:260] = 0
        src[260:] = 1
    etyp = rng.integers(0, nrel, E).astype(np.int32)
    mask = rng.random(E) < 0.9
    canon = np.arange(E, dtype=np.int32)
    kw = dict(eblk=EBLK, rows=ROWS, edge_canon=canon)
    plans = []
    for align in (block_align_edges, block_align_edges_transposed):
        p = align(src, dst, etyp, mask, N, **kw)
        plans.append([torch.from_numpy(a) for a in p[:6] + p[7:]])
    dropped = rng.random(E) < 0.2          # by edge id: both plans drop alike
    for p in plans:
        p.append(p[3] != 0)                # the real slots, before dropout
        p[3] = p[3] * torch.from_numpy(~dropped[p[6].numpy() // 2]).float()
    bound = (B * cin) ** -0.5
    x = rng.uniform(-1, 1, (N, cin)).astype(np.float32)
    att = rng.uniform(-bound, bound, (nrel, B)).astype(np.float32)
    basis = rng.uniform(-bound, bound, (B, cin, COUT)).astype(np.float32)
    g = rng.uniform(-1, 1, (N, COUT)).astype(np.float32)
    return [tuple(p) for p in plans], tuple(map(torch.from_numpy, (x, att, basis, g)))


def _dropped_mid_run(plan):
    """Whether a dropped real slot sits between two live slots of one row
    and relation."""
    row = _dst_global(plan, ROWS).numpy()
    et, m = plan[2].numpy(), plan[3].numpy()
    real = np.nonzero(plan[7].numpy())[0]
    for a, b, c in zip(real[:-2], real[1:-1], real[2:]):
        if (m[b] == 0 and m[a] != 0 and m[c] != 0 and row[a] == row[c]
                and et[a] == et[c]):
            return True
    return False


CASES = [(case, nrel, cin) for case in ("dropout", "hot_row")
         for nrel in (5, 71) for cin in (4, 8)]


@pytest.mark.parametrize("case,nrel,cin", CASES)
def test_run_form_forward_matches_pallas_and_plain(case, nrel, cin):
    """K1's run form on the dst-sorted plan = the Pallas forward kernel
    (interpret mode) = rgcn_aggregate_ref, rtol = atol = 1e-5."""
    (plan, _), (x, att, basis, _) = make_case(case, nrel, cin, seed=nrel + cin)
    if case == "dropout" and nrel == 5:
        assert _dropped_mid_run(plan)
    if case == "hot_row":
        assert int((plan[4] == 0).sum()) >= 3     # node 0's chunk spans blocks
    got = run_form_fwd(x, att, basis, plan)
    want = rgcn_aggregate_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(att.numpy()), jnp.asarray(basis.numpy()),
        tuple(jnp.asarray(a.numpy()) for a in plan[:6]), ROWS, N, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    plain = rgcn_aggregate_ref(x, att, basis, plan, ROWS, N)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case,nrel,cin", CASES)
def test_run_form_backward_matches_pallas_and_plain(case, nrel, cin):
    """K2's run form on the twin plan = the Pallas backward kernel
    (interpret mode, dae segment-summed over etype as its caller does) =
    rgcn_aggregate_bwd_ref, for dx, datt and dbasis, rtol = atol = 1e-5."""
    (_, plan_t), (x, att, basis, g) = make_case(case, nrel, cin, seed=nrel + cin)
    if case == "dropout" and nrel == 5:
        assert _dropped_mid_run(plan_t)
    if case == "hot_row":
        assert int((plan_t[4] == 0).sum()) >= 3   # node 1's chunk spans blocks
    got = run_form_bwd(g, x, att, basis, plan_t)
    gdst, srcl, etyp, mask, chunk, first = (jnp.asarray(a.numpy()) for a in plan_t[:6])
    src = srcl + jnp.repeat(chunk, EBLK) * ROWS
    dx, dae, dbasis = jax_aggregate_bwd(
        jnp.asarray(g.numpy())[gdst], jnp.asarray(x.numpy())[src],
        jnp.asarray(att.numpy())[etyp], srcl, mask,
        jnp.asarray(basis.numpy()).transpose(0, 2, 1).reshape(B * COUT, cin),
        chunk, first, rows=ROWS, num_nodes_out=N, interpret=True)
    want = (np.asarray(dx),
            np.asarray(jax.ops.segment_sum(dae.T, etyp, num_segments=nrel)),
            np.asarray(dbasis).reshape(B, cin, COUT))
    plain = rgcn_aggregate_bwd_ref(g, x, att, basis, plan_t, ROWS)
    for name, gv, wv, pv in zip(("dx", "datt", "dbasis"), got, want, plain):
        np.testing.assert_allclose(gv.numpy(), wv, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(gv.numpy(), pv.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
