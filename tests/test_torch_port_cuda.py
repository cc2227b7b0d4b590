"""igmc_torch CUDA kernels against their plain PyTorch versions, on the
card only (marker `cuda`; without a card every test skips). This file
imports nothing of JAX, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from igmc_torch.kernels.rgcn_aggregate import (
    block_align_edges, block_align_edges_transposed, rgcn_aggregate,
    rgcn_aggregate_bwd, rgcn_aggregate_bwd_ref, rgcn_aggregate_ref,
)

CASES = [
    # (edge case, extra padding blocks beyond the need)
    ("random", 0),
    ("hot_row", 0),
    ("random", 3),
    ("hot_row", 5),
]


def make_case(case, N, E, R, B, cin, cout, seed):
    """Random edges and operands; 'hot_row' sends most edges to node 0 (its
    chunk spans several blocks)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    if case == "hot_row":
        dst[40:] = 0
    etyp = rng.integers(0, R, E).astype(np.int32)
    mask = rng.random(E) < 0.9
    x = rng.uniform(-1, 1, (N, cin)).astype(np.float32)
    bound = (B * cin) ** -0.5
    att = rng.uniform(-bound, bound, (R, B)).astype(np.float32)
    basis = rng.uniform(-bound, bound, (B, cin, cout)).astype(np.float32)
    return (src, dst, etyp, mask), (x, att, basis)


@pytest.mark.cuda
@pytest.mark.parametrize("case,extra", CASES)
@pytest.mark.parametrize("cin", [4, 32])
def test_cuda_kernel_matches_plain(case, extra, cin):
    """The CUDA kernel vs the plain version on the card (in float64, so
    only the kernel's float32 rounding shows), rtol 1e-5 and atol 1e-4:
    summation order, which shared atomics vary per run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, R, B, Cout, rows, eblk = 512, 5, 4, 32, 256, 1024
    (src, dst, etyp, mask), (x, att, basis) = make_case(
        case, N, 6000, R, B, cin, Cout, seed=5)
    need = block_align_edges(src, dst, etyp, mask, N, eblk=eblk, rows=rows)[6]
    plan = block_align_edges(src, dst, etyp, mask, N, eblk=eblk, rows=rows,
                             num_blocks=need + extra)
    dev = torch.device("cuda")
    args = (torch.from_numpy(x).to(dev), torch.from_numpy(att).to(dev),
            torch.from_numpy(basis).to(dev),
            tuple(torch.from_numpy(a).to(dev) for a in plan[:6]))
    before = rgcn_aggregate.launches
    with torch.no_grad():
        got = rgcn_aggregate(*args, rows, N)
        want = rgcn_aggregate_ref(*(a.double() for a in args[:3]), args[3],
                                  rows, N).float()
    torch.cuda.synchronize()
    assert rgcn_aggregate.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


BWD_CASES = [
    # (edge case, extra padding blocks beyond the need)
    ("random", 0),
    ("hot_src", 0),
    ("random", 64),
]


def assert_close_to_terms(got, want, abs_terms, name):
    """|got - want| <= 1e-5 * (sum of |terms| of that entry) + 1e-7: the
    float32 rounding of a sum taken in any order is bounded by a small
    multiple of eps (6e-8) times the sum of its terms' magnitudes; 1e-5
    leaves ~170 eps for atomics over up to ~2e5 terms."""
    err = (got.double() - want).abs()
    bound = 1e-5 * abs_terms + 1e-7
    worst = float((err - bound).max())
    assert worst <= 0, f"{name}: max error {float(err.max()):.3e} over its bound"


@pytest.mark.cuda
@pytest.mark.parametrize("case,extra", BWD_CASES)
@pytest.mark.parametrize("cin", [4, 32])
def test_cuda_bwd_kernel_matches_plain(case, extra, cin):
    """K2's dx, datt and dbasis vs the plain backward in float64 on the
    src-sorted twin plan (random edges, a hot SOURCE row over several
    blocks, 64 extra padding blocks in chunk 0), with dx skipped too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, E, R, B, Cout, rows, eblk = 512, 6000, 5, 4, 32, 256, 1024
    (src, dst, etyp, mask), (x, att, basis) = make_case(
        "random", N, E, R, B, cin, Cout, seed=6)
    if case == "hot_src":
        src[40:3040] = 7
    need = block_align_edges_transposed(src, dst, etyp, mask, N, eblk=eblk,
                                        rows=rows)[6]
    plan = block_align_edges_transposed(src, dst, etyp, mask, N, eblk=eblk,
                                        rows=rows, num_blocks=need + extra)
    dev = torch.device("cuda")
    g = np.random.default_rng(7).uniform(-1, 1, (N, Cout)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (g, x, att, basis)]
    plan = tuple(torch.from_numpy(a).to(dev) for a in plan[:6])
    want = rgcn_aggregate_bwd_ref(*(a.double() for a in args), plan, rows)
    terms = rgcn_aggregate_bwd_ref(*(a.double().abs() for a in args), plan, rows)
    before = rgcn_aggregate_bwd.launches
    got = rgcn_aggregate_bwd(*args, plan, rows)
    no_dx = rgcn_aggregate_bwd(*args, plan, rows, need_dx=False)
    torch.cuda.synchronize()
    assert rgcn_aggregate_bwd.launches == before + 2 and no_dx[0] is None
    for name, gv, wv, tv in zip(("dx", "datt", "dbasis"), got, want, terms):
        assert_close_to_terms(gv, wv, tv, name)
    for name, gv, wv, tv in zip(("datt", "dbasis"), no_dx[1:], want[1:], terms[1:]):
        assert_close_to_terms(gv, wv, tv, name + " without dx")


@pytest.mark.cuda
def test_cuda_autograd_matches_cpu():
    """Gradients through rgcn_aggregate on the card (K1 forward, K2
    backward) vs the CPU's plain versions, in float32: rtol 1e-5 and atol
    1e-4 of the largest entry (summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, E, R, B, cin, Cout, rows, eblk = 512, 6000, 5, 4, 32, 32, 256, 1024
    (src, dst, etyp, mask), (x, att, basis) = make_case(
        "random", N, E, R, B, cin, Cout, seed=8)
    af = block_align_edges(src, dst, etyp, mask, N, eblk=eblk, rows=rows,
                           num_blocks=12)[:6]
    at = block_align_edges_transposed(src, dst, etyp, mask, N, eblk=eblk,
                                      rows=rows, num_blocks=12)[:6]
    w = np.random.default_rng(9).uniform(-1, 1, (N, Cout)).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in (x, att, basis)]
        out = rgcn_aggregate(*ts, tuple(torch.from_numpy(a).to(dev) for a in af),
                             rows, N, tuple(torch.from_numpy(a).to(dev) for a in at))
        (out * torch.from_numpy(w).to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in ts]
    for name, gc, gg in zip(("dx", "datt", "dbasis"), grads["cpu"], grads["cuda"]):
        torch.testing.assert_close(gg, gc, rtol=1e-5,
                                   atol=1e-4 * float(gc.abs().max()), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("cin", [4, 32])
def test_cuda_kernels_many_relations(cin, need_dx):
    """K1 and K2 at R = 71 (yahoo_music's rating levels; at Cin 32 W_r for
    every relation does not fit a block's shared memory, so both kernels
    take the relations in groups, K2 in a layout of its own with and
    without dx) against the float64 plain versions: K1 rtol 1e-5 / atol
    1e-4, K2 within 1e-5 of each entry's sum of |terms| (datt and dbasis
    only, without dx)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, E, R, B, Cout, rows, eblk = 512, 6000, 71, 4, 32, 256, 1024
    (src, dst, etyp, mask), (x, att, basis) = make_case(
        "hot_row", N, E, R, B, cin, Cout, seed=10)
    dev = torch.device("cuda")
    ops = [torch.from_numpy(a).to(dev) for a in (x, att, basis)]
    plan = tuple(torch.from_numpy(a).to(dev) for a in block_align_edges(
        src, dst, etyp, mask, N, eblk=eblk, rows=rows, num_blocks=16)[:6])
    with torch.no_grad():
        got = rgcn_aggregate(*ops, plan, rows, N)
    want = rgcn_aggregate_ref(*(a.double() for a in ops), plan, rows, N).float()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)

    plan_t = tuple(torch.from_numpy(a).to(dev) for a in block_align_edges_transposed(
        src, dst, etyp, mask, N, eblk=eblk, rows=rows, num_blocks=16)[:6])
    g = torch.from_numpy(np.random.default_rng(11).uniform(
        -1, 1, (N, Cout)).astype(np.float32)).to(dev)
    args = [g] + ops
    want = rgcn_aggregate_bwd_ref(*(a.double() for a in args), plan_t, rows)
    terms = rgcn_aggregate_bwd_ref(*(a.double().abs() for a in args), plan_t, rows)
    got = rgcn_aggregate_bwd(*args, plan_t, rows, need_dx=need_dx)
    torch.cuda.synchronize()
    names = ("dx", "datt", "dbasis")
    if not need_dx:
        assert got[0] is None
        names, got, want, terms = names[1:], got[1:], want[1:], terms[1:]
    for name, gv, wv, tv in zip(names, got, want, terms):
        assert_close_to_terms(gv, wv, tv, name)


@pytest.mark.cuda
def test_cuda_layer1_backward_without_dx():
    """Layer 1 as the model calls it: a one-hot Cin 4 input that wants no
    gradient, through rgcn_aggregate's autograd on the card. K2 runs once,
    with need_dx false, and datt and dbasis match the CPU's plain versions
    (rtol 1e-5, atol 1e-4 of the largest entry: summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, E, R, B, cin, Cout, rows, eblk = 512, 6000, 5, 4, 4, 32, 256, 1024
    (src, dst, etyp, mask), (_, att, basis) = make_case(
        "random", N, E, R, B, cin, Cout, seed=12)
    x = np.eye(cin, dtype=np.float32)[np.random.default_rng(12).integers(0, cin, N)]
    af = block_align_edges(src, dst, etyp, mask, N, eblk=eblk, rows=rows)[:6]
    at = block_align_edges_transposed(src, dst, etyp, mask, N, eblk=eblk,
                                      rows=rows)[:6]
    w = np.random.default_rng(13).uniform(-1, 1, (N, Cout)).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        xt = torch.from_numpy(x).to(dev)
        ts = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in (att, basis)]
        before = rgcn_aggregate_bwd.launches
        out = rgcn_aggregate(xt, *ts, tuple(torch.from_numpy(a).to(dev) for a in af),
                             rows, N, tuple(torch.from_numpy(a).to(dev) for a in at))
        (out * torch.from_numpy(w).to(dev)).sum().backward()
        assert rgcn_aggregate_bwd.launches == before + (dev == "cuda")
        assert xt.grad is None
        grads[dev] = [t.grad.cpu() for t in ts]
    for name, gc, gg in zip(("datt", "dbasis"), grads["cpu"], grads["cuda"]):
        torch.testing.assert_close(gg, gc, rtol=1e-5,
                                   atol=1e-4 * float(gc.abs().max()), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_cuda_blocked_engine_backward_matches_cpu(compute_dtype):
    """The blocked engine's autograd Function (ops/blocked.py) on the card
    against the CPU, forward and backward (dx, datt, dbasis) with hash
    dropout masks: rtol / atol 1e-5 of each largest entry (float32 sums in
    another order); under bfloat16 one bfloat16 ulp (2**-7) of it, since a
    message summed in another order can round to the neighbouring value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from igmc_torch.ops.blocked import (blocked_rgcn_aggregate, dropout_masks,
                                        plan_blocked_edges)

    N, R, B, cin, cout = 600, 5, 4, 32, 32
    (src, dst, etyp, mask), (x, att, basis) = make_case("hot_row", N, 3000, R, B,
                                                         cin, cout, seed=8)
    canon = np.arange(len(src), dtype=np.int32)
    g = np.random.default_rng(9).uniform(-1, 1, (N, cout)).astype(np.float32)
    out = {}
    for where in ("cpu", "cuda"):
        plan = plan_blocked_edges(src, dst, etyp, mask, canon, N, 256, 1024).to(where)
        masks = dropout_masks(plan, 0.2, False, 12345)
        ts = [torch.from_numpy(a).to(where).requires_grad_() for a in (x, att, basis)]
        y = blocked_rgcn_aggregate(*ts, plan, masks, compute_dtype)
        (y * torch.from_numpy(g).to(where)).sum().backward()
        out[where] = [y.detach().cpu()] + [t.grad.cpu() for t in ts]
    tol = 1e-5 if compute_dtype is None else 2.0 ** -7
    for name, a, b in zip(("out", "dx", "datt", "dbasis"), out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * float(b.abs().max()),
                                   msg=name)


# name: (N, E, R, B, Cin, Cout, rows, eblk, hot row): shapes of the JAX
# package's Pallas kernels past the CLI's defaults (more than 8 bases,
# widths past 32, rows 128 / 64, an eblk that is not a multiple of 4), at
# which tests/test_torch_port_shapes.py holds the plain versions against
# JAX
WIDE_SHAPES = {
    "b16_r71": (512, 6000, 71, 16, 32, 32, 256, 1024, False),
    "cin48_cout64": (512, 6000, 5, 4, 48, 64, 256, 1024, False),
    "cin6_cout256": (512, 6000, 10, 1, 6, 256, 256, 1024, False),
    "cin200_cout40_b12": (512, 6000, 5, 12, 200, 40, 256, 1024, False),
    "eblk1000_rows128": (512, 6000, 5, 4, 32, 32, 128, 1000, False),
    "eblk250_rows64_hot": (512, 6000, 5, 4, 32, 32, 64, 250, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE_SHAPES))
def test_cuda_kernels_at_every_jax_shape(name):
    """K1, and K2 with dx on and off, at each shape against the float64
    plain versions: K1 rtol 1e-5 / atol 1e-4, K2 within 1e-5 of each
    entry's sum of |terms|; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, E, R, B, cin, cout, rows, eblk, hot = WIDE_SHAPES[name]
    (src, dst, etyp, mask), (x, att, basis) = make_case(
        "hot_row" if hot else "random", N, E, R, B, cin, cout, seed=14)
    dev = torch.device("cuda")
    ops = [torch.from_numpy(a).to(dev) for a in (x, att, basis)]
    plan = tuple(torch.from_numpy(a).to(dev) for a in block_align_edges(
        src, dst, etyp, mask, N, eblk=eblk, rows=rows)[:6])
    before = rgcn_aggregate.launches
    with torch.no_grad():
        got = rgcn_aggregate(*ops, plan, rows, N)
    want = rgcn_aggregate_ref(*(a.double() for a in ops), plan, rows, N).float()
    torch.cuda.synchronize()
    assert rgcn_aggregate.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)

    plan_t = tuple(torch.from_numpy(a).to(dev) for a in block_align_edges_transposed(
        src, dst, etyp, mask, N, eblk=eblk, rows=rows)[:6])
    g = torch.from_numpy(np.random.default_rng(15).uniform(
        -1, 1, (N, cout)).astype(np.float32)).to(dev)
    args = [g] + ops
    want = rgcn_aggregate_bwd_ref(*(a.double() for a in args), plan_t, rows)
    terms = rgcn_aggregate_bwd_ref(*(a.double().abs() for a in args), plan_t, rows)
    before = rgcn_aggregate_bwd.launches
    got = rgcn_aggregate_bwd(*args, plan_t, rows)
    no_dx = rgcn_aggregate_bwd(*args, plan_t, rows, need_dx=False)
    torch.cuda.synchronize()
    assert rgcn_aggregate_bwd.launches == before + 2 and no_dx[0] is None
    for what, gv, wv, tv in zip(("dx", "datt", "dbasis"), got, want, terms):
        assert_close_to_terms(gv, wv, tv, what)
    for what, gv, wv, tv in zip(("datt", "dbasis"), no_dx[1:], want[1:], terms[1:]):
        assert_close_to_terms(gv, wv, tv, what + " without dx")


@pytest.mark.cuda
def test_cuda_kernels_refuse_rows_past_shared_memory():
    """A plan of 8,192-row chunks: no accumulator of that many rows fits a
    block's shared memory beside one relation's W_r tile, so each wrapper
    raises before any launch, naming the rows and the bytes it needs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, R, B, cin, cout, rows, eblk = 8192, 5, 4, 32, 32, 8192, 1024
    (src, dst, etyp, mask), (x, att, basis) = make_case(
        "random", N, 2000, R, B, cin, cout, seed=16)
    dev = torch.device("cuda")
    ops = [torch.from_numpy(a).to(dev) for a in (x, att, basis)]
    plan = tuple(torch.from_numpy(a).to(dev) for a in block_align_edges(
        src, dst, etyp, mask, N, eblk=eblk, rows=rows)[:6])
    g = torch.zeros(N, cout, device=dev)
    fwd, bwd = rgcn_aggregate.launches, rgcn_aggregate_bwd.launches
    with pytest.raises(ValueError, match="rows 8192 .* bytes of shared memory"):
        with torch.no_grad():
            rgcn_aggregate(*ops, plan, rows, N)
    with pytest.raises(ValueError, match="rows 8192 .* bytes of shared memory"):
        rgcn_aggregate_bwd(g, *ops, plan, rows)
    assert (rgcn_aggregate.launches, rgcn_aggregate_bwd.launches) == (fwd, bwd)
