"""igmc_torch CUDA kernels against their plain PyTorch versions, on the
card only (marker `cuda`; without a card every test skips). This file
imports nothing of JAX, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from igmc_torch.kernels.rgcn_aggregate import (
    block_align_edges, rgcn_aggregate, rgcn_aggregate_ref,
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
