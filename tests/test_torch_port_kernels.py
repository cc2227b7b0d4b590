"""igmc_torch fused R-GCN aggregate: the host aligner and the plain PyTorch
version against the JAX package (Pallas kernel in interpret mode on the
CPU), and the wrapper's input checks. The CUDA kernel itself is tested in
test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from igmc_tpu.kernels.rgcn_aggregate import (
    block_align_edges as jax_block_align_edges,
    rgcn_aggregate_pallas,
)
from igmc_tpu.ops.blocked import plan_capacity_blocks as jax_plan_capacity_blocks

from igmc_torch.kernels.rgcn_aggregate import (
    _check_cuda_inputs, block_align_edges, plan_capacity_blocks,
    rgcn_aggregate, rgcn_aggregate_ref,
)

torch.set_num_threads(1)


def make_edges(case, N=64, E=500, R=5, seed=0):
    """Random edge list; 'hot_row' sends most edges to node 0 (its chunk
    spans several blocks)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    if case == "hot_row":
        dst[40:] = 0
    etyp = rng.integers(0, R, E).astype(np.int32)
    mask = rng.random(E) < 0.9
    return src, dst, etyp, mask


ALIGN_CASES = [
    # (edge case, extra padding blocks beyond the need)
    ("random", 0),
    ("hot_row", 0),
    ("random", 3),
    ("hot_row", 5),
]


@pytest.mark.parametrize("case,extra", ALIGN_CASES)
def test_block_align_edges_matches_jax(case, extra):
    """Exact equality, array for array (integers and 0/1 masks)."""
    N, eblk, rows = 64, 64, 16
    src, dst, etyp, mask = make_edges(case, N)
    need = jax_block_align_edges(src, dst, etyp, mask, N, eblk=eblk,
                                 rows=rows)[6]
    want = jax_block_align_edges(src, dst, etyp, mask, N, eblk=eblk,
                                 rows=rows, num_blocks=need + extra)
    got = block_align_edges(src, dst, etyp, mask, N, eblk=eblk, rows=rows,
                            num_blocks=need + extra)
    assert len(got) == 7
    for g, w in zip(got[:6], want[:6]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[6] == want[6] == need + extra
    if case == "hot_row":
        assert (got[4] == 0).sum() >= 4     # node 0's chunk spans blocks


def test_block_align_edges_rejects_bad_input():
    src, dst, etyp, mask = make_edges("random", 64)
    with pytest.raises(ValueError, match="multiple of rows"):
        block_align_edges(src, dst, etyp, mask, 60, eblk=64, rows=16)
    with pytest.raises(ValueError, match="blocks > requested"):
        block_align_edges(src, dst, etyp, mask, 64, eblk=64, rows=16,
                          num_blocks=1)
    bad = dst.copy()
    bad[0] = 64
    mask = mask.copy()
    mask[0] = True
    with pytest.raises(ValueError, match="outside"):
        block_align_edges(src, bad, etyp, mask, 64, eblk=64, rows=16)


@pytest.mark.parametrize("node_pad,edge_pad,rows,eblk", [
    (256, 128, 256, 1024), (12800, 286152, 256, 1024), (64, 500, 16, 64),
    (100, 3, 16, 64), (5000, 70000, 128, 512),
])
def test_plan_capacity_blocks_matches_jax(node_pad, edge_pad, rows, eblk):
    assert (plan_capacity_blocks(node_pad, edge_pad, rows, eblk)
            == jax_plan_capacity_blocks(node_pad, edge_pad, rows, eblk))


def _operands(N, R, B, Cin, Cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, Cin)).astype(np.float32)
    att = rng.standard_normal((R, B)).astype(np.float32)
    basis = rng.standard_normal((B, Cin, Cout)).astype(np.float32)
    return x, att, basis


@pytest.mark.parametrize("case,extra", ALIGN_CASES)
def test_rgcn_aggregate_ref_matches_pallas_interpret(case, extra):
    """Plain version vs the Pallas kernel (interpret mode) on the same plan:
    N 64, E 500, rows 16, eblk 64, Cin 8, Cout 16. rtol = atol = 1e-5:
    float32 sums of the same terms in another order."""
    N, R, B, Cin, Cout, rows, eblk = 64, 5, 4, 8, 16, 16, 64
    src, dst, etyp, mask = make_edges(case, N, R=R, seed=1)
    x, att, basis = _operands(N, R, B, Cin, Cout, seed=1)
    need = block_align_edges(src, dst, etyp, mask, N, eblk=eblk, rows=rows)[6]
    plan = block_align_edges(src, dst, etyp, mask, N, eblk=eblk, rows=rows,
                             num_blocks=need + extra)
    want = rgcn_aggregate_pallas(
        jnp.asarray(x), jnp.asarray(att), jnp.asarray(basis),
        tuple(jnp.asarray(a) for a in plan[:6]), rows, N, True)
    aligned = tuple(torch.from_numpy(a) for a in plan[:6])
    got = rgcn_aggregate_ref(torch.from_numpy(x), torch.from_numpy(att),
                             torch.from_numpy(basis), aligned, rows, N)
    assert got.shape == (N, Cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)

    # the wrapper takes the plain version for CPU tensors and counts nothing
    before = rgcn_aggregate.launches
    wrapped = rgcn_aggregate(torch.from_numpy(x), torch.from_numpy(att),
                             torch.from_numpy(basis), aligned, rows, N)
    assert rgcn_aggregate.launches == before
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_rgcn_aggregate_ref_matches_edge_list_oracle():
    """The plan changes nothing: same sums as a scatter over the ORIGINAL
    edge list (float64 oracle; atol 1e-4 for float32 rounding)."""
    N, R, B, Cin, Cout = 64, 5, 4, 8, 16
    src, dst, etyp, mask = make_edges("hot_row", N, R=R, seed=3)
    x, att, basis = _operands(N, R, B, Cin, Cout, seed=3)
    plan = block_align_edges(src, dst, etyp, mask, N, eblk=64, rows=16)
    got = rgcn_aggregate_ref(torch.from_numpy(x), torch.from_numpy(att),
                             torch.from_numpy(basis),
                             tuple(torch.from_numpy(a) for a in plan[:6]),
                             16, N)
    w = np.einsum("rb,bio->rio", att.astype(np.float64), basis)
    msg = np.einsum("ei,eio->eo", x[src].astype(np.float64), w[etyp])
    want = np.zeros((N, Cout))
    np.add.at(want, dst[mask], msg[mask])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def _cpu_case(Cin=8, Cout=16):
    N, R, B = 64, 5, 4
    src, dst, etyp, mask = make_edges("random", N, R=R, seed=2)
    x, att, basis = _operands(N, R, B, Cin, Cout, seed=2)
    plan = block_align_edges(src, dst, etyp, mask, N, eblk=64, rows=16)
    return (torch.from_numpy(x), torch.from_numpy(att),
            torch.from_numpy(basis),
            tuple(torch.from_numpy(a) for a in plan[:6]))


@pytest.mark.parametrize("what,error", [
    ("float64 x", TypeError), ("int64 src", TypeError),
    ("cout 64", ValueError), ("9 bases", ValueError), ("x rows", ValueError),
    ("strided x", ValueError), ("mask length", ValueError),
    ("requires grad", RuntimeError),
])
def test_kernel_input_checks(what, error):
    """What the CUDA kernel does not take raises before any launch (the
    checks themselves need no card)."""
    x, att, basis, aligned = _cpu_case()
    rows, N = 16, 64
    if what == "float64 x":
        x = x.double()
    elif what == "int64 src":
        aligned = (aligned[0].long(),) + aligned[1:]
    elif what == "cout 64":
        basis = torch.zeros(4, 8, 64)
    elif what == "9 bases":
        basis = torch.zeros(9, 8, 16)
        att = torch.zeros(5, 9)
    elif what == "x rows":
        x = x[:48]
    elif what == "strided x":
        x = torch.zeros(64, 16)[:, ::2]
    elif what == "mask length":
        aligned = aligned[:3] + (aligned[3][:-1],) + aligned[4:]
    elif what == "requires grad":
        basis = basis.clone().requires_grad_(True)
    with pytest.raises(error):
        _check_cuda_inputs(x, att, basis, aligned, rows, N)


def test_kernel_input_checks_accept_the_real_case():
    x, att, basis, aligned = _cpu_case(Cin=32, Cout=32)
    _check_cuda_inputs(x, att, basis, aligned, 16, 64)


def test_rgcn_aggregate_rejects_other_devices():
    x, att, basis, aligned = _cpu_case()
    with pytest.raises(ValueError, match="no kernel"):
        rgcn_aggregate(x.to("meta"), att, basis, aligned, 16, 64)
