"""igmc_torch aggregate gradient against the JAX package on the CPU: the
twin plans with their dropout key streams (exact), the stateless dropout
hash (bit for bit), the plain backward against the Pallas backward kernel
in interpret mode, and autograd through the port's Function against
jax.grad of rgcn_aggregate_pallas_train. The CUDA kernel itself is tested
in test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from igmc_tpu.kernels.rgcn_aggregate import (
    _aggregate_bwd as jax_aggregate_bwd,
    block_align_edges as jax_block_align_edges,
    block_align_edges_transposed as jax_block_align_edges_transposed,
    rgcn_aggregate_pallas_train,
)
from igmc_tpu.parallel.ep import hash_edge_keep as jax_hash_edge_keep

from igmc_torch.kernels.rgcn_aggregate import (
    _check_cuda_inputs, block_align_edges, block_align_edges_transposed,
    rgcn_aggregate, rgcn_aggregate_bwd, rgcn_aggregate_bwd_ref,
)
from igmc_torch.ops import feature_dropout, hash_edge_keep
from torch_plan_checks import assert_plan_matches_jax

torch.set_num_threads(1)


def make_edges(case, N=64, E=500, R=5, seed=0):
    """Random edges with pair ids; 'hot_src' sends most edges FROM node 0
    (its chunk of the src-sorted plan spans several blocks)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    if case == "hot_src":
        src[40:] = 0
    etyp = rng.integers(0, R, E).astype(np.int32)
    mask = rng.random(E) < 0.9
    canon = rng.integers(0, E, E).astype(np.int32)
    return src, dst, etyp, mask, canon


CASES = [("random", 0), ("hot_src", 0), ("random", 3), ("hot_src", 5)]


@pytest.mark.parametrize("case,extra", CASES)
@pytest.mark.parametrize("transposed", [False, True])
def test_plans_with_ukey_match_jax(case, extra, transposed):
    """Both plans with the ukey stream against JAX's: the same geometry,
    the same edges per chunk each with its ukey, and the (dst, etype) or,
    for the twin, (src, etype) order within a row."""
    N, eblk, rows = 64, 64, 16
    src, dst, etyp, mask, canon = make_edges(case, N)
    jfn = jax_block_align_edges_transposed if transposed else jax_block_align_edges
    pfn = block_align_edges_transposed if transposed else block_align_edges
    need = jfn(src, dst, etyp, mask, N, eblk=eblk, rows=rows)[6]
    want = jfn(src, dst, etyp, mask, N, eblk=eblk, rows=rows,
               num_blocks=need + extra, edge_canon=canon)
    got = pfn(src, dst, etyp, mask, N, eblk=eblk, rows=rows,
              num_blocks=need + extra, edge_canon=canon)
    assert len(got) == 8 and got[6] == want[6] == need + extra
    assert_plan_matches_jax(got[:6] + got[7:], want[:6] + want[7:])
    if transposed and case == "hot_src":
        assert (got[4] == 0).sum() >= 4     # node 0's chunk spans blocks
    # the twin plan keys the ORIGINAL orientation: same keys, other order
    fwd = block_align_edges(src, dst, etyp, mask, N, eblk=eblk, rows=rows,
                            edge_canon=canon)
    real = fwd[3] > 0
    np.testing.assert_array_equal(np.sort(got[7][got[3] > 0]),
                                  np.sort(fwd[7][real]))


def test_plan_without_keys_has_no_ukey():
    src, dst, etyp, mask, _ = make_edges("random")
    assert block_align_edges(src, dst, etyp, mask, 64, eblk=64, rows=16)[7] is None


HASH_KEYS = np.concatenate([
    np.random.default_rng(0).integers(0, 2**31 - 1, 20000),
    [0, 1, 2, 2**31 - 2, 2**31 - 1]]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 977, 2**31 - 2, 1234567891])
@pytest.mark.parametrize("p", [0.2, 0.5])
@pytest.mark.parametrize("force_undirected", [False, True])
def test_hash_edge_keep_matches_jax_bit_for_bit(seed, p, force_undirected):
    keys = HASH_KEYS // 2 if force_undirected else HASH_KEYS
    want = np.asarray(jax_hash_edge_keep(
        jnp.asarray(seed, jnp.int32).astype(jnp.uint32), jnp.asarray(keys), p))
    got = hash_edge_keep(seed, torch.from_numpy(keys), p)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.4 < got.float().mean() / (1 - p) < 1.6   # about 1 - p kept


def test_feature_dropout_scales_kept_and_zeroes_the_rest():
    h = torch.arange(1.0, 7.0).reshape(2, 3)
    keep = torch.tensor([[True, False, True], [False, True, True]])
    want = torch.tensor([[2.0, 0.0, 6.0], [0.0, 10.0, 12.0]])
    torch.testing.assert_close(feature_dropout(h, keep, 0.5), want, rtol=0, atol=0)


def _operands(N, R, B, Cin, Cout, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((N, Cin), (R, B), (B, Cin, Cout), (N, Cout)))


def _plans(case, extra, N, R, rows, eblk, seed):
    src, dst, etyp, mask, canon = make_edges(case, N, R=R, seed=seed)
    need = max(block_align_edges(src, dst, etyp, mask, N, eblk=eblk, rows=rows)[6],
               block_align_edges_transposed(src, dst, etyp, mask, N, eblk=eblk,
                                            rows=rows)[6])
    kw = dict(eblk=eblk, rows=rows, num_blocks=need + extra, edge_canon=canon)
    af = block_align_edges(src, dst, etyp, mask, N, **kw)
    at = block_align_edges_transposed(src, dst, etyp, mask, N, **kw)
    return (src, dst, etyp, mask), af[:6] + af[7:], at[:6] + at[7:]


@pytest.mark.parametrize("case,extra", CASES)
def test_bwd_ref_matches_pallas_bwd_interpret(case, extra):
    """rgcn_aggregate_bwd_ref vs the TPU backward kernel (_aggregate_bwd in
    interpret mode, dae segment-summed over etype as its caller does): N 64,
    E 500, rows 16, eblk 64, Cin 8, Cout 16. rtol 1e-5 and atol 1e-6 of the
    output's largest entry (at least 1e-5): float32 sums of the same terms
    in another order, and a datt entry sums ~100 terms of both signs, so
    its rounding scales with the terms, not with the (cancelled) sum."""
    N, R, B, Cin, Cout, rows = 64, 5, 4, 8, 16, 16
    _, _, at = _plans(case, extra, N, R, rows, 64, seed=1)
    x, att, basis, g = _operands(N, R, B, Cin, Cout, seed=1)
    gdst, srcl, etyp, mask, chunk, first = (jnp.asarray(a) for a in at[:6])
    eblk = gdst.shape[0] // chunk.shape[0]
    src = srcl + jnp.repeat(chunk, eblk) * rows
    dx, dae, dbasis = jax_aggregate_bwd(
        jnp.asarray(g)[gdst], jnp.asarray(x)[src], jnp.asarray(att)[etyp],
        srcl, mask, jnp.asarray(basis).transpose(0, 2, 1).reshape(B * Cout, Cin),
        chunk, first, rows=rows, num_nodes_out=N, interpret=True)
    want = (np.asarray(dx),
            np.asarray(jax.ops.segment_sum(dae.T, etyp, num_segments=R)),
            np.asarray(dbasis).reshape(B, Cin, Cout))
    got = rgcn_aggregate_bwd_ref(*(torch.from_numpy(a) for a in (g, x, att, basis)),
                                 tuple(torch.from_numpy(a) for a in at), rows)
    for gv, wv, name in zip(got, want, ("dx", "datt", "dbasis")):
        assert gv.dtype == torch.float32
        np.testing.assert_allclose(gv.numpy(), wv, rtol=1e-5,
                                   atol=max(1e-5, 1e-6 * np.abs(wv).max()),
                                   err_msg=name)
    # the wrapper takes the plain version for CPU tensors and counts nothing
    before = rgcn_aggregate_bwd.launches
    wrapped = rgcn_aggregate_bwd(*(torch.from_numpy(a) for a in (g, x, att, basis)),
                                 tuple(torch.from_numpy(a) for a in at), rows,
                                 need_dx=False)
    assert rgcn_aggregate_bwd.launches == before and wrapped[0] is None
    for gv, wv in zip(wrapped[1:], got[1:]):
        torch.testing.assert_close(gv, wv, rtol=0, atol=0)


# (N, E, R, B, Cin, Cout, rows, eblk, blocks, edge case, loss, tolerance):
# the cases of tests/test_kernels.py, test_pallas_train_grads_match_xla_oracle
# and test_pallas_train_hot_row_grads, at their tolerances
GRAD_CASES = {
    "random": (64, 500, 5, 4, 8, 16, 16, 64, 12, "random", "dot", 5e-4),
    "hot_src": (32, 400, 3, 2, 4, 8, 8, 32, 16, "hot_src", "square", 1e-3),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_autograd_matches_jax_grad_of_pallas_train(name):
    """Gradients through the port's autograd Function (plain forward and
    backward on the CPU) against jax.grad of rgcn_aggregate_pallas_train
    (Pallas forward and backward, interpret mode) on the same plans."""
    N, E, R, B, Cin, Cout, rows, eblk, nblk, case, loss, tol = GRAD_CASES[name]
    rng = np.random.default_rng(3)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    if case == "hot_src":
        src[40:] = 0
    etyp = rng.integers(0, R, E).astype(np.int32)
    mask = rng.random(E) < 0.9
    x, att, basis, gref = _operands(N, R, B, Cin, Cout, seed=3)
    af = block_align_edges(src, dst, etyp, mask, N, eblk=eblk, rows=rows,
                           num_blocks=nblk)[:6]
    at = block_align_edges_transposed(src, dst, etyp, mask, N, eblk=eblk,
                                      rows=rows, num_blocks=nblk)[:6]

    def jax_loss(x, att, basis):
        out = rgcn_aggregate_pallas_train(
            x, att, basis, tuple(jnp.asarray(a) for a in af),
            tuple(jnp.asarray(a) for a in at), rows, N, True)
        return jnp.sum(out * gref) if loss == "dot" else jnp.sum(out ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(att), jnp.asarray(basis))
    xt, attt, basist = (torch.from_numpy(a).requires_grad_(True)
                        for a in (x, att, basis))
    out = rgcn_aggregate(xt, attt, basist, tuple(map(torch.from_numpy, af)),
                         rows, N, aligned_t=tuple(map(torch.from_numpy, at)))
    total = (out * torch.from_numpy(gref)).sum() if loss == "dot" else (out ** 2).sum()
    total.backward()
    np.testing.assert_allclose(total.item(), float(jax_loss(
        jnp.asarray(x), jnp.asarray(att), jnp.asarray(basis))), rtol=2e-5)
    for g, w, gname in zip((xt.grad, attt.grad, basist.grad), want,
                           ("dx", "datt", "dbasis")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol,
                                   err_msg=gname)


def test_gradient_without_twin_plan_raises():
    """A gradient wanted with no twin plan raises and names the training
    loader, on the CPU and in the CUDA input checks; no gradient needs none."""
    N, R, B, Cin, Cout, rows = 64, 5, 4, 8, 16, 16
    _, af, at = _plans("random", 0, N, R, rows, 64, seed=2)
    x, att, basis, _ = _operands(N, R, B, Cin, Cout, seed=2)
    aligned = tuple(map(torch.from_numpy, af))
    basis_g = torch.from_numpy(basis).requires_grad_(True)
    with pytest.raises(RuntimeError, match="shuffle=True"):
        rgcn_aggregate(torch.from_numpy(x), torch.from_numpy(att), basis_g,
                       aligned, rows, N)
    with pytest.raises(RuntimeError, match="shuffle=True"):
        _check_cuda_inputs(torch.from_numpy(x), torch.from_numpy(att), basis_g,
                           aligned, rows, N)
    _check_cuda_inputs(torch.from_numpy(x), torch.from_numpy(att), basis_g,
                       aligned, rows, N, tuple(map(torch.from_numpy, at)))
    with torch.no_grad():
        rgcn_aggregate(torch.from_numpy(x), torch.from_numpy(att), basis_g,
                       aligned, rows, N)


def test_cuda_checks_refuse_wide_input_for_the_backward():
    """A gradient wanted at Cin 40 (past one 32-lane tile, which the kernels
    take since they tile their channels) is refused before any launch only
    for what no kernel takes: a twin plan whose edge count differs from the
    forward plan's. With the matching twin plan the checks pass."""
    N, R, B, Cin, Cout, rows = 64, 5, 4, 40, 16, 16
    _, af, at = _plans("random", 0, N, R, rows, 64, seed=4)
    x, att, basis, _ = _operands(N, R, B, Cin, Cout, seed=4)
    args = (torch.from_numpy(x).requires_grad_(True), torch.from_numpy(att),
            torch.from_numpy(basis), tuple(map(torch.from_numpy, af)), rows, N)
    short = tuple(torch.from_numpy(a[:-64]) for a in at[:4]) + tuple(
        torch.from_numpy(a[:-1]) for a in at[4:6])
    with pytest.raises(ValueError, match="aligned_t"):
        _check_cuda_inputs(*args, short)
    _check_cuda_inputs(*args, tuple(map(torch.from_numpy, at)))