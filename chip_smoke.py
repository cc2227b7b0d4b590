#!/usr/bin/env python3
"""Drive igmc_torch on one CUDA card and check what comes out.

    python3 chip_smoke.py [--raw-data DIR]

Phases, each printing its lines and its seconds; any failure exits
non-zero:
  1. device: the card's name, `nvidia-smi` name and power limit, TF32 off;
  2. build: every CUDA kernel of the package, compiled with nvcc from the
     sources in this checkout, one nvcc per source, all at once (seconds
     and each kernel's ptxas registers and spills);
  3. data: ML-1M ratings (`--raw-data`, default $IGMC_RAW_DATA or the
     repo's raw_data_synth/), testing split with seed 1234, 2,000 held-out
     and 2,000 training pairs, 1-hop subgraphs with at most 100 nodes per
     hop, flat batches of 50 (the training loader shuffled with seed 1 and
     carrying the src-sorted twin plan);
  4. kernel check: each kernel against its plain PyTorch version (run in
     float64) on the card at the main path's shapes (one real ML-1M batch
     at Cin 4 and 32, a hot row spanning several blocks, a plan with 64
     extra padding blocks, and test batch 0's edges with their relations
     redrawn over R = 71 and planned anew), with the time per call of the
     wrapper (CUDA events, the measure of the kernels' earlier recorded
     times, printed beside it), the kernel's device time per launch
     (profiler), the plain version's time in float32 and the least time
     the card could take: K1 (forward) rtol 1e-5 /
     atol 1e-4; K2 (backward: dx, datt, dbasis) within 1e-5 of each entry's
     sum of absolute terms;
  5. evaluation path: a two-checkpoint ensemble of full-width IGMC (random
     weights from two generator seeds, saved as `.pth`) through
     `test_once(..., device="cuda")`, with K1's launch count read right
     after it; the forward time per batch, a profile of the forward, the
     ensemble RMSE recomputed from the card's predictions, and the card's
     predictions on the first batches held against the CPU (atol 1e-4);
  6. training path: `train_multiple_epochs(..., device="cuda")` of
     full-width IGMC (adj_dropout 0.2, feature dropout 0.5, ARR 0.001,
     lr 1e-3) for 2 epochs of 40 steps, evaluating the 2,000 held-out pairs
     after each and checkpointing with `make_logger`, with K1's and K2's
     launch counts read right after it; losses finite and falling; then
     the step time over device-resident batches, a profile of the steps,
     and the epoch wall time split into host collation + planning and the
     rest;
  7. card against CPU: one training step from the same weights, batch and
     noise on the card (K1 + K2) and on the CPU (plain versions): loss to
     rtol 1e-5, every gradient to rtol 1e-4 / atol 1e-4 of its largest
     entry;
  8. closing the loop: `test_once(ensemble=True)` over the two checkpoints
     the training wrote, on the card, with K1's launch count and the RMSE
     recomputed from the card's predictions;
  9. dense evaluation (the JAX CLI's main path): phase 5's ensemble through
     `test_once(..., batch_mode="dense", dense_layout="bipartite")`, its
     size buckets printed, K1 and K2 launching 0 times; the RMSE recomputed
     from the card's dense predictions (1e-5); each member's dense
     predictions against its flat (K1) predictions of phase 5 in dataset
     order (atol 1e-4, the same function on two layouts); the forward time
     per device-assembled batch by bucket (CUDA events), the assembly time,
     a profile of the forward; 5 batches card against CPU (atol 1e-4);
 10. dense training: `train_multiple_epochs(..., batch_mode="dense",
     dense_layout="bipartite")` with phase 6's settings for 2 epochs, K1
     and K2 launching 0 times, losses finite and falling, each epoch's wall
     time split into the host's epoch plan and the rest; the step time over
     device-assembled batches (CUDA events) and a profile of the steps;
 11. card against CPU on the dense path: phase 7's check on a
     device-assembled training batch (hash edge dropout on packed edge ids);
 12. the CLI: `python -m igmc_torch.cli.main --data-name ml_1m --testing
     --ensemble --epochs 2 --save-interval 1` on the same 2,000 + 2,000
     pairs in a subprocess and a temporary directory: exit 0, `batch mode:
     dense (auto)` and `dense layout: bipartite (auto)`, and a log.txt of
     two epoch lines and the ensemble line, each with a finite RMSE.
The last lines are one JSON object of kernel numbers, the card's
`nvidia-smi` line, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores, the rate the kernels' CUDA-core arithmetic runs at.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
RTOL, ATOL = 1e-5, 1e-4          # K1 vs plain version: summation order
TERMS_RTOL = 1e-5                # K2 vs plain version, per sum of |terms|
PRED_ATOL = 1e-4                 # card vs CPU predictions
MANY_RELATIONS = 71              # yahoo_music's rating levels
# the kernels' times per wrapper call before their redesign for the run
# form, CUDA events (this script, NVIDIA H100 80GB HBM3, 700.00 W), by Cin:
# printed beside this run's times, never reported as this run's
BEFORE_MS = {"rgcn_aggregate_fwd": {32: 0.3923, 4: 0.1159},
             "rgcn_aggregate_bwd": {32: 0.5793, 4: 0.4720}}
GRAD_TOL = 1e-4                  # card vs CPU training step
MAX_NUM = 2000                   # held-out pairs scored, training pairs
BATCH_SIZE = 50                  # the CLI's default batch
CPU_BATCHES = 5                  # batches held against the CPU plain path
EPOCHS = 2
ROWS = 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds of `fn()` on the card, by CUDA events over `reps`."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, name: str, reps: int) -> float:
    """Device milliseconds per launch of the kernel whose name contains
    `name`, over `reps` calls of `fn()` (torch.profiler's device time): the
    kernel alone, without the host time of the wrapper around it."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key and e.device_time_total > 0]
    count = sum(e.count for e in hits)
    if count != reps:
        fail(f"profiler saw {count} launches of {name}, expected {reps}")
    return sum(e.device_time_total for e in hits) / 1e3 / count


def _bound(flops: float, nbytes: float) -> dict:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                flops=flops, nbytes=nbytes)


def _pairs(nodes, etype, live, nrel: int) -> int:
    """Distinct (node, relation) pairs among the live slots."""
    return int(np.unique(nodes[live].astype(np.int64) * nrel + etype[live]).size)


def _edges(plan, rows: int):
    """(gather side, scatter side, etype, live) of a plan's real slots, as
    numpy: for the dst-sorted plan (src, dst); for the twin (dst, src)."""
    a0, local, etype, mask, chunk = (t.cpu().numpy() for t in plan[:5])
    eblk = a0.size // chunk.size
    scatter = local.astype(np.int64) + np.repeat(chunk, eblk).astype(np.int64) * rows
    return a0, scatter, etype, mask != 0


def aggregate_bound(x, att, basis, aligned):
    """Least time (ms) for one K1 call on this card, from this call's inputs:
    the larger of its bytes over the memory rate and its float32 operations
    over the CUDA-core rate, counting the least work the function needs,
    not K1's way of doing it.

    Operations: fold W_r = att @ basis once (2*R*B*Cin*Cout), then either
    one [Cin] x [Cin, Cout] product per real edge (2*E*Cin*Cout) or one per
    distinct (src, relation) pair of this batch plus a gather-sum
    (2*P*Cin*Cout + E*Cout), whichever is less. Bytes: the mask over every
    slot, src, dst_local and etype over the real edges, chunk_of_block, x,
    att and basis read once, the output written once. Also returns the
    operations of K1's basis-mix form (2*E*B*Cin*Cout), for comparison."""
    nb, cin, cout = basis.shape
    n, nrel = x.shape[0], att.shape[0]
    src, _, etype, live = _edges(aligned, ROWS)
    e = int(live.sum())
    pairs = _pairs(src, etype, live, nrel)
    flops = (min(2.0 * e * cin * cout, 2.0 * pairs * cin * cout + e * cout)
             + 2.0 * nrel * nb * cin * cout)
    nbytes = 4.0 * (aligned[3].numel() + 3 * e + aligned[4].numel()
                    + x.numel() + att.numel() + basis.numel() + n * cout)
    return dict(_bound(flops, nbytes), e_real=e, pairs=pairs,
                form_ms=1e3 * 2.0 * e * nb * cin * cout / PEAK_F32_FLOP_PER_S)


def aggregate_bwd_bound(x, att, basis, plan_t, need_dx: bool):
    """Least time (ms) for one K2 call on this card, as aggregate_bound
    counts it. Operations: dx is the forward with src and dst swapped,
    min(2*E*Cin*Cout, 2*P_dst*Cin*Cout + E*Cin) with P_dst the distinct
    (dst, relation) pairs (when dx is wanted); dW_r = sum_e x[src] outer
    g[dst] costs min(2*E*Cin*Cout, 2*P_src*Cin*Cout + E*Cout,
    2*P_dst*Cin*Cout + E*Cin); folding dW_r into datt and dbasis costs
    4*R*B*Cin*Cout. Bytes: the mask over every slot, the three index arrays
    over the real edges, chunk_of_block, x, g, att and basis read once,
    dx (when wanted), datt and dbasis written once. Also returns the
    operations of the TPU kernel's basis form (4*E*B*Cin*Cout)."""
    nb, cin, cout = basis.shape
    n, nrel = x.shape[0], att.shape[0]
    dst, src, etype, live = _edges(plan_t, ROWS)
    e = int(live.sum())
    p_src, p_dst = _pairs(src, etype, live, nrel), _pairs(dst, etype, live, nrel)
    per_edge = 2.0 * e * cin * cout
    f_dx = min(per_edge, 2.0 * p_dst * cin * cout + e * cin) if need_dx else 0.0
    f_dw = min(per_edge, 2.0 * p_src * cin * cout + e * cout,
               2.0 * p_dst * cin * cout + e * cin)
    flops = f_dx + f_dw + 4.0 * nrel * nb * cin * cout
    nbytes = 4.0 * (plan_t[3].numel() + 3 * e + plan_t[4].numel()
                    + x.numel() * (2 if need_dx else 1) + n * cout
                    + 2 * (att.numel() + basis.numel()))
    return dict(_bound(flops, nbytes), e_real=e, pairs=(p_src, p_dst),
                form_ms=1e3 * 4.0 * e * nb * cin * cout / PEAK_F32_FLOP_PER_S)


class Phases:
    """Prints each phase's seconds when it ends."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds = {}

    def __call__(self, name):
        self.name, self.start = name, time.perf_counter()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        s = time.perf_counter() - self.start
        self.seconds[self.name] = s
        if exc[0] is None:
            print(f"[time] {self.name}: {s:.2f} s", flush=True)


def operands(b0, cin, R, B, cout, gen):
    """Inputs as the main path gives them: one-hot hop labels into layer 1,
    tanh states in (-1, 1) into layers 2-4, weights at their init scale
    U(+-1/sqrt(B*Cin)), output gradients in (-1, 1)."""
    import torch

    N = b0.num_nodes
    if cin == 4:
        x = torch.nn.functional.one_hot(b0.node_label.long(), 4).float()
    else:
        x = torch.empty(N, cin).uniform_(-1, 1, generator=gen)
    bound = (B * cin) ** -0.5
    att = torch.empty(R, B).uniform_(-bound, bound, generator=gen)
    basis = torch.empty(B, cin, cout).uniform_(-bound, bound, generator=gen)
    g = torch.empty(N, cout).uniform_(-1, 1, generator=gen)
    return x, att, basis, g


def hot_plans(b, b_test, R, hot_side: str, transposed: bool):
    """A real batch's edges plus 3,000 edges into (or out of) node 5, its
    plan with 64 extra padding blocks, as the loader would build them, and
    the plan of test batch 0's edges with relations redrawn over
    MANY_RELATIONS; each with its number of relations."""
    import torch
    from igmc_torch.kernels.rgcn_aggregate import (
        block_align_edges, block_align_edges_transposed)

    align = block_align_edges_transposed if transposed else block_align_edges
    N = b.num_nodes
    src, dst = b.edge_src.numpy(), b.edge_dst.numpy()
    typ, msk = b.edge_type.numpy(), b.edge_mask.numpy()
    rng = torch.Generator().manual_seed(11)
    hot = 3000   # > eblk: one row spanning several blocks
    other = torch.randint(0, N, (hot,), generator=rng, dtype=torch.int32).numpy()
    hot_typ = torch.randint(0, R, (hot,), generator=rng, dtype=torch.int32).numpy()
    five = np.full(hot, 5, np.int32)
    hs, hd = (five, other) if hot_side == "src" else (other, five)
    need = align(src, dst, typ, msk, N)[6]
    many = torch.randint(0, MANY_RELATIONS, (b_test.edge_type.numel(),),
                         generator=rng, dtype=torch.int32).numpy()
    return {
        f"hot_{hot_side}": (align(
            np.concatenate([src, hs]), np.concatenate([dst, hd]),
            np.concatenate([typ, hot_typ]),
            np.concatenate([msk, np.ones(hot, bool)]), N)[:6], R),
        "padding_blocks": (align(src, dst, typ, msk, N, num_blocks=need + 64)[:6], R),
        f"test_batch0_r{MANY_RELATIONS}": (align(
            b_test.edge_src.numpy(), b_test.edge_dst.numpy(), many,
            b_test.edge_mask.numpy(), b_test.num_nodes)[:6], MANY_RELATIONS),
    }, need


def _summary(name, results):
    """One line per kernel: its time per call at Cin 4 and 32 (CUDA events),
    its bound and share of the bound, the recorded time before the
    redesign on the same measure beside it, and the device time per launch
    (profiler)."""
    parts = []
    for cin in (4, 32):
        r, before = results[cin], BEFORE_MS[name][cin]
        parts.append(f"cin={cin} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, "
                     f"{100 * r['bound_ms'] / r['ms']:.2f}% of it; before the redesign "
                     f"{before:.4f} ms, {before / r['ms']:.2f}x faster now; "
                     f"device time {r['device_ms']:.4f} ms)")
    print(f"[kernel] {name} per call: " + "; ".join(parts), flush=True)


def check_k1(b0, R, B, COUT, dev, gen):
    """K1 against its float64 plain version on four plans; times at test
    batch 0."""
    import torch
    from igmc_torch.kernels.rgcn_aggregate import rgcn_aggregate, rgcn_aggregate_ref

    N = b0.num_nodes
    extra, need = hot_plans(b0, b0, R, "dst", transposed=False)
    per_chunk = np.bincount(b0.aligned[4].numpy())
    print(f"[kernel] test batch 0 plan: {b0.aligned[4].shape[0]} blocks "
          f"(capacity), {need} needed; blocks per chunk: chunk 0 "
          f"{per_chunk[0]}, others {per_chunk[1:].min()}-{per_chunk[1:].max()}")
    plans = {"ml1m_batch0": (b0.aligned[:6], R), **extra}
    results, max_err = {}, 0.0
    for plan_name, (plan, nrel) in plans.items():
        aligned = tuple(torch.as_tensor(a).to(dev) for a in plan)
        for cin in (4, 32):
            x, att, basis, _ = (t.to(dev) for t in operands(b0, cin, nrel, B, COUT, gen))
            with torch.no_grad():
                got = rgcn_aggregate(x, att, basis, aligned, ROWS, N)
                # the plain version in float64, so that the comparison sees
                # the kernel's rounding and not the plain version's own
                want = rgcn_aggregate_ref(x.double(), att.double(),
                                          basis.double(), aligned, ROWS, N).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            try:
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            except AssertionError as e:
                fail(f"rgcn_aggregate_fwd disagrees with the plain version on "
                     f"{plan_name} cin={cin}: {e}")
            line = (f"[kernel] rgcn_aggregate_fwd {plan_name} (R {nrel}) cin={cin}: "
                    f"max_abs_err {err:.3e} (rtol {RTOL}, atol {ATOL})")
            if plan_name == "ml1m_batch0":
                with torch.no_grad():
                    call = lambda: rgcn_aggregate(x, att, basis, aligned, ROWS, N)
                    ms = cuda_ms(call, 50)
                    device_ms = kernel_ms(call, "rgcn_aggregate_fwd", 50)
                    plain_ms = cuda_ms(lambda: rgcn_aggregate_ref(x, att, basis, aligned, ROWS, N), 20)
                bnd = aggregate_bound(x, att, basis, aligned)
                results[cin] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                    ep=int(aligned[0].numel()), **bnd)
                line += (f"; {ms:.4f} ms per call (CUDA events; kernel alone "
                         f"{device_ms:.4f} ms, profiler), plain {plain_ms:.4f} ms, "
                         f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: "
                         f"{bnd['flops']:.3e} FLOP, {bnd['nbytes']:.3e} B; "
                         f"{bnd['e_real']} real of {aligned[0].numel()} edge "
                         f"slots, {bnd['pairs']} (src, relation) pairs, N {N}); "
                         f"the TPU kernel's basis-mix FLOP alone {bnd['form_ms']:.4f} ms")
            print(line, flush=True)
    _summary("rgcn_aggregate_fwd", results)
    return results, max_err


def check_k2(bt, b0, R, B, COUT, dev, gen):
    """K2 against its float64 plain version on the training batch's twin
    plan, a hot source row, extra padding and test batch 0's edges over
    MANY_RELATIONS; times at training batch 0."""
    import torch
    from igmc_torch.kernels.rgcn_aggregate import (rgcn_aggregate_bwd,
                                                   rgcn_aggregate_bwd_ref)

    extra, need = hot_plans(bt, b0, R, "src", transposed=True)
    per_chunk = np.bincount(bt.aligned_t[4].numpy())
    print(f"[kernel] training batch 0 twin plan: {bt.aligned_t[4].shape[0]} "
          f"blocks (capacity), {need} needed; blocks per chunk: chunk 0 "
          f"{per_chunk[0]}, others {per_chunk[1:].min()}-{per_chunk[1:].max()}")
    plans = {"ml1m_train_batch0": (bt.aligned_t[:6], R), **extra}
    names = ("dx", "datt", "dbasis")
    results, max_err = {}, dict.fromkeys(names, 0.0)
    for plan_name, (plan, nrel) in plans.items():
        plan = tuple(torch.as_tensor(a).to(dev) for a in plan)
        batch = b0 if nrel == MANY_RELATIONS else bt
        for cin in (4, 32):
            x, att, basis, g = (t.to(dev) for t in operands(batch, cin, nrel, B, COUT, gen))
            with torch.no_grad():
                got = rgcn_aggregate_bwd(g, x, att, basis, plan, ROWS)
                want = rgcn_aggregate_bwd_ref(g.double(), x.double(), att.double(),
                                              basis.double(), plan, ROWS)
                # each entry's sum of |terms|: the scale of its rounding
                terms = rgcn_aggregate_bwd_ref(g.double().abs(), x.double().abs(),
                                               att.double().abs(),
                                               basis.double().abs(), plan, ROWS)
            torch.cuda.synchronize()
            errs = []
            for name, gv, wv, tv in zip(names, got, want, terms):
                err = (gv.double() - wv).abs()
                errs.append(float(err.max()))
                max_err[name] = max(max_err[name], errs[-1])
                over = err - (TERMS_RTOL * tv + 1e-7)
                if float(over.max()) > 0:
                    i = int(over.argmax())
                    fail(f"rgcn_aggregate_bwd {name} disagrees with the plain "
                         f"version on {plan_name} cin={cin}: entry {i} "
                         f"{float(gv.flatten()[i])} vs {float(wv.flatten()[i])}, "
                         f"sum of |terms| {float(tv.flatten()[i])}")
            line = (f"[kernel] rgcn_aggregate_bwd {plan_name} (R {nrel}) cin={cin}: "
                    f"max_abs_err dx {errs[0]:.3e}, datt {errs[1]:.3e}, dbasis "
                    f"{errs[2]:.3e} (within {TERMS_RTOL} of each entry's sum of |terms|)")
            if plan_name == "ml1m_train_batch0":
                need_dx = cin != 4     # layer 1's one-hot input needs no dx
                with torch.no_grad():
                    call = lambda: rgcn_aggregate_bwd(g, x, att, basis, plan, ROWS,
                                                      need_dx=need_dx)
                    ms = cuda_ms(call, 50)
                    device_ms = kernel_ms(call, "rgcn_aggregate_bwd", 50)
                    plain_ms = cuda_ms(lambda: rgcn_aggregate_bwd_ref(
                        g, x, att, basis, plan, ROWS), 20)
                bnd = aggregate_bwd_bound(x, att, basis, plan, need_dx)
                results[cin] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                    need_dx=need_dx, ep=int(plan[0].numel()), **bnd)
                line += (f"; {ms:.4f} ms per call (dx "
                         f"{'on' if need_dx else 'off'}, as the main path; CUDA "
                         f"events; kernel alone {device_ms:.4f} ms, profiler), "
                         f"plain {plain_ms:.4f} "
                         f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: "
                         f"{bnd['flops']:.3e} FLOP, {bnd['nbytes']:.3e} B; "
                         f"{bnd['e_real']} real of {plan[0].numel()} edge slots, "
                         f"(src, dst) relation pairs {bnd['pairs']}); the TPU "
                         f"kernel's basis-form FLOP alone {bnd['form_ms']:.4f} ms")
            print(line, flush=True)
    _summary("rgcn_aggregate_bwd", results)
    return results, max_err


def member_predictions(cfg, states, dev_batches):
    """Each state_dict's predictions on the device-resident batches, and
    its forward ms per batch (CUDA events)."""
    import torch
    from igmc_torch.models import IGMC

    preds_all, fwd_ms = [], []
    for sd in states:
        model = IGMC(cfg, torch.Generator().manual_seed(0))
        model.load_state_dict(sd)
        model = model.to(dev_batches[0].y.device).eval()
        with torch.no_grad():
            model(dev_batches[0])
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            preds = [model(b) for b in dev_batches]
            end.record()
            torch.cuda.synchronize()
        fwd_ms.append(start.elapsed_time(end) / len(dev_batches))
        preds_all.append(preds)
    return preds_all, fwd_ms, model


def recomputed_rmse(member_preds, dev_batches, rmse, what):
    import torch

    ys = torch.cat([b.y[b.graph_mask] for b in dev_batches])
    flat = [torch.cat([p[b.graph_mask] for p, b in zip(preds, dev_batches)])
            for preds in member_preds]
    for p in flat:
        if p.shape != ys.shape or not bool(torch.isfinite(p).all()):
            fail(f"{what}: predictions of shape {tuple(p.shape)} (expected "
                 f"{tuple(ys.shape)}) or not finite")
    again = float(((torch.stack(flat).mean(0) - ys) ** 2).mean().sqrt())
    if abs(again - rmse) > 1e-5:
        fail(f"{what}: test_once RMSE {rmse} != recomputed {again}")
    return again


def profile(fn, label, n):
    """Device time by kernel over `fn()` (torch.profiler); the busy share
    is summed kernel time over the wall window. Returns {kernel key: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    # kernels only: a user annotation (Optimizer.step#Adam.step) spans the
    # kernels it launched, which are counted on their own
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"[profile] {label} over {n}: {window_ms:.3f} ms wall, {busy_ms:.3f} ms "
          f"of kernels (busy share {busy_ms / window_ms:.3f}, profiler on)")
    top = sorted(events, key=lambda e: -e.device_time_total)
    for e in top[:10]:
        print(f"[profile]   {e.device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")
    return {e.key: e.device_time_total / 1e3 for e in events}, busy_ms, window_ms


def dense_eval(cfg, states, ckpts, template, test_ds, flat_preds, dev_batches,
               dev, reset_counts, read_counts, expect):
    """Phase 9: the two-checkpoint ensemble on the dense bipartite layout
    through test_once; its RMSE recomputed from the card's predictions;
    each member's dense predictions against its flat (K1) predictions of
    phase 5; forward time per batch by bucket; the card against the CPU."""
    import torch
    from igmc_torch.batching import DeviceDataset
    from igmc_torch.models import IGMC
    from igmc_torch.train import (DensePass, dense_predict_all, make_eval_step,
                                  plan_buckets, test_once)

    buckets = plan_buckets(test_ds, "bipartite")
    for b in buckets:
        print(f"[dense eval] bucket {b.node_slot} node rows ({b.num_u_slot} users | "
              f"{b.node_slot - b.num_u_slot} items) x {b.edge_slot} edge slots: "
              f"{len(b.indices)} graphs")
    reset_counts()
    t0 = time.perf_counter()
    rmse = test_once(test_ds, template, BATCH_SIZE, ensemble=True, checkpoints=ckpts,
                     batch_mode="dense", dense_layout="bipartite", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_counts("dense_eval")
    print(f"[dense eval] ensemble of {len(ckpts)} over {len(test_ds)} pairs: RMSE "
          f"{rmse:.6f}, {wall:.2f} s wall (device upload and bucket plan included)")
    expect("dense_eval", "rgcn_aggregate_fwd", 0)
    expect("dense_eval", "rgcn_aggregate_bwd", 0)
    if not math.isfinite(rmse):
        fail(f"dense ensemble RMSE is not finite: {rmse}")

    dd = DeviceDataset(test_ds.packed, dev)
    epoch = DensePass.plan(buckets, BATCH_SIZE, 8, dev)
    models, preds = [], []
    for sd in states:
        m = IGMC(cfg, torch.Generator().manual_seed(0))
        m.load_state_dict(sd)
        models.append(m.to(dev).eval())
        preds.append(dense_predict_all(make_eval_step(models[-1]), dd, epoch))
    ys = np.asarray(test_ds.packed.y, np.float32)
    for p in preds:
        if p.shape != ys.shape or not np.isfinite(p).all():
            fail(f"dense predictions of shape {p.shape} (expected {ys.shape}) or "
                 f"not finite")
    again = math.sqrt(float(np.mean((np.mean(preds, axis=0) - ys) ** 2)))
    if abs(again - rmse) > 1e-5:
        fail(f"dense eval: test_once RMSE {rmse} != recomputed {again}")
    worst = 0.0
    for i, (p, fp) in enumerate(zip(preds, flat_preds)):
        flat = torch.cat([q[b.graph_mask] for q, b in zip(fp, dev_batches)]).cpu().numpy()
        diff = float(np.abs(p - flat).max())
        worst = max(worst, diff)
        if not diff <= PRED_ATOL:
            fail(f"member {i + 1}: dense predictions differ from the flat K1 path's "
                 f"by {diff} > {PRED_ATOL}")
    print(f"[dense eval] ensemble RMSE recomputed from the card's dense predictions "
          f"{again:.6f}; dense (bipartite) vs flat (K1) predictions of both members "
          f"in dataset order: max abs diff {worst:.3e} (atol {PRED_ATOL})")

    batches = list(epoch.batches(dd))
    model = models[-1]
    assemble_ms = cuda_ms(lambda: list(epoch.batches(dd)), 5) / len(batches)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: [model(b) for b in batches], 5) / len(batches)
        parts = []
        for bi, b in enumerate(buckets):
            mine = [x for x, k in zip(batches, epoch.bucket_of) if k == bi]
            ms = cuda_ms(lambda: [model(x) for x in mine], 5) / len(mine)
            parts.append(f"bucket {b.node_slot} x {b.edge_slot}: {ms:.4f} ms "
                         f"({len(mine)} batches)")
    print(f"[dense eval] forward {fwd_ms:.4f} ms per batch over {len(batches)} "
          f"device-assembled batches (CUDA events); " + "; ".join(parts)
          + f"; assembly on the card {assemble_ms:.4f} ms per batch")

    def forward_all():
        with torch.no_grad():
            for b in batches:
                model(b)

    _, busy_ms, _ = profile(forward_all, "dense forward", f"{len(batches)} batches")
    print(f"[profile]   device dense forward {busy_ms / len(batches):.4f} ms of "
          f"kernels per batch")
    cpu_model = IGMC(cfg, torch.Generator().manual_seed(0))
    cpu_model.load_state_dict(states[-1])
    cpu_model.eval()
    worst = 0.0
    with torch.no_grad():
        for b in batches[:CPU_BATCHES]:
            p_card, p_cpu = model(b).cpu(), cpu_model(b.to("cpu"))
            worst = max(worst, float((p_card - p_cpu).abs().max()))
            try:
                torch.testing.assert_close(p_card, p_cpu, rtol=0, atol=PRED_ATOL)
            except AssertionError as e:
                fail(f"dense card predictions disagree with the CPU: {e}")
    print(f"[dense eval] card vs CPU on {CPU_BATCHES} dense batches of member 2: "
          f"max abs diff {worst:.3e} (atol {PRED_ATOL})")


def dense_train(cfg, train_ds, test_ds, work, dev, reset_counts, read_counts,
                expect):
    """Phase 10: train_multiple_epochs on the dense bipartite layout; then
    the step time over device-assembled batches and a profile of the steps.
    Returns epoch 1's device-assembled training batches."""
    import torch
    from igmc_torch.batching import DeviceDataset
    from igmc_torch.models import IGMC, draw_noise
    from igmc_torch.train import (DensePass, checkpoint_path, make_optimizer,
                                  make_train_step, plan_buckets,
                                  train_multiple_epochs)
    from igmc_torch.utils import ResultsDir, make_logger

    buckets = plan_buckets(train_ds, "bipartite")
    for b in buckets:
        print(f"[dense train] bucket {b.node_slot} node rows ({b.num_u_slot} | "
              f"{b.node_slot - b.num_u_slot}) x {b.edge_slot} edge slots: "
              f"{len(b.indices)} graphs")
    res = ResultsDir(work, "ml_1m", "_chip_smoke_dense", True)
    infos = []
    log = make_logger(res, 1)

    def logger(info, state):
        infos.append(dict(info))
        log(info, state)

    reset_counts()
    t0 = time.perf_counter()
    final_rmse, state = train_multiple_epochs(
        train_ds, test_ds, IGMC(cfg, torch.Generator().manual_seed(3)),
        epochs=EPOCHS, batch_size=BATCH_SIZE, lr=1e-3, lr_decay_factor=0.1,
        lr_decay_step_size=50, ARR=0.001, test_freq=1, logger=logger, seed=1,
        batch_mode="dense", dense_layout="bipartite", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_counts("dense_train")
    for info, h in zip(infos, state.history):
        print(f"[dense train] epoch {info['epoch']}: train loss "
              f"{info['train_loss']:.6f}, test rmse {info['test_rmse']:.6f}; "
              f"{h['seconds']:.3f} s wall, of which host (epoch plan) "
              f"{h['host_seconds']:.3f} s, the rest "
              f"{h['seconds'] - h['host_seconds']:.3f} s")
    print(f"[dense train] {EPOCHS} epochs, {wall:.2f} s wall (device upload and "
          f"bucket plans included)")
    expect("dense_train", "rgcn_aggregate_fwd", 0)
    expect("dense_train", "rgcn_aggregate_bwd", 0)
    losses = [i["train_loss"] for i in infos]
    rmses = [i["test_rmse"] for i in infos]
    if not all(math.isfinite(v) for v in losses + rmses):
        fail(f"dense training losses {losses} or RMSEs {rmses} are not finite")
    if not losses[1] < losses[0]:
        fail(f"dense: epoch 2's train loss {losses[1]} is not below epoch 1's "
             f"{losses[0]}")
    for e in (1, 2):
        if not os.path.isfile(checkpoint_path(res.path, "model", e)):
            fail(f"dense training wrote no model checkpoint of epoch {e}")

    # the step on device-assembled batches of epoch 1's plan, CUDA events
    dd = DeviceDataset(train_ds.packed, dev)
    epoch = DensePass.plan(buckets, BATCH_SIZE, 8, dev,
                           np.random.default_rng(np.random.SeedSequence([1, 1])))
    dtrain = list(epoch.batches(dd))
    noise_gen = torch.Generator().manual_seed(4)
    noises = [(s, k.to(dev)) for s, k in
              (draw_noise(noise_gen, BATCH_SIZE) for _ in dtrain)]
    m = IGMC(cfg, torch.Generator().manual_seed(3)).to(dev).train()
    step = make_train_step(m, make_optimizer(m.parameters(), 1e-3), 0.001)
    for b, nz in zip(dtrain[:2], noises[:2]):
        step(b, nz)

    def steps_all():
        for b, nz in zip(dtrain, noises):
            step(b, nz)

    step_ms = cuda_ms(steps_all, 1, warmup=0) / len(dtrain)
    print(f"[dense train] step {step_ms:.4f} ms (assembled batch in, forward + "
          f"backward + Adam), CUDA events over {len(dtrain)} device-assembled "
          f"batches")
    _, busy_ms, _ = profile(steps_all, "dense training steps", f"{len(dtrain)} steps")
    print(f"[profile]   {busy_ms / len(dtrain):.4f} ms of kernels per dense step")
    return dtrain


def run_cli(raw_data: str) -> None:
    """Phase 12: `python -m igmc_torch.cli.main` on ML-1M in a subprocess
    and a temporary working directory; it must pick the dense bipartite
    layout itself, train 2 epochs, ensemble and write log.txt."""
    cmd = [sys.executable, "-m", "igmc_torch.cli.main", "--data-name", "ml_1m",
           "--testing", "--ensemble", "--epochs", "2", "--save-interval", "1",
           "--max-train-num", str(MAX_NUM), "--max-test-num", str(MAX_NUM),
           "--max-nodes-per-hop", "100"]
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, IGMC_RAW_DATA=raw_data, PYTHONPATH=path)
    with tempfile.TemporaryDirectory() as cwd:
        t0 = time.perf_counter()
        try:
            out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                                 text=True, timeout=600)
        except subprocess.TimeoutExpired:
            fail("the CLI did not finish within 600 s")
        wall = time.perf_counter() - t0
        print(f"[cli] python {' '.join(cmd[1:])}: exit {out.returncode}, "
              f"{wall:.2f} s")
        if out.returncode != 0:
            print(out.stdout[-4000:])
            print(out.stderr[-4000:], file=sys.stderr)
            fail(f"the CLI exited {out.returncode}")
        lines = out.stdout.splitlines()
        for want in ("batch mode: dense (auto)", "dense layout: bipartite (auto)"):
            if want not in lines:
                fail(f"the CLI did not print {want!r}")
        for line in lines:
            if line.startswith(("batch mode", "dense layout", "Epoch", "Ensemble")):
                print(f"[cli]   {line}")
        log_path = os.path.join(cwd, "results", "ml_1m_testmode", "log.txt")
        log = open(log_path).read().splitlines() if os.path.isfile(log_path) else []
    heads = ["Epoch 1,", "Epoch 2,", "Epoch ensemble of range(-13, 2, 5),"]
    if len(log) != len(heads) or not all(l.startswith(h) for l, h in zip(log, heads)):
        fail(f"the CLI's log.txt reads {log}")
    for line in log:
        if not math.isfinite(float(line.split()[-1])):
            fail(f"the CLI's log.txt has a RMSE that is not finite: {line}")
        print(f"[cli] log.txt: {line}")


def card_vs_cpu_step(cfg, batch, label):
    """One training step's loss and gradients from the same weights (seed
    5), `batch` and noise on the card and on the CPU: loss to rtol 1e-5,
    every gradient to rtol GRAD_TOL / atol GRAD_TOL of its largest entry."""
    import torch
    from igmc_torch.models import IGMC, draw_noise
    from igmc_torch.train import loss_fn

    grads, loss_vals = {}, {}
    noise = draw_noise(torch.Generator().manual_seed(9), batch.num_graphs)
    for where in ("cpu", "cuda"):
        mm = IGMC(cfg, torch.Generator().manual_seed(5)).to(where).train()
        loss, _ = loss_fn(mm, batch.to(where), (noise[0], noise[1].to(where)), 0.001)
        loss.backward()
        loss_vals[where] = loss.item()
        grads[where] = {k: p.grad.cpu() for k, p in mm.named_parameters()}
    if abs(loss_vals["cuda"] - loss_vals["cpu"]) > 1e-5 * abs(loss_vals["cpu"]):
        fail(f"{label}: training loss on the card {loss_vals['cuda']} != CPU "
             f"{loss_vals['cpu']}")
    worst = 0.0
    for k, gc in grads["cpu"].items():
        gg = grads["cuda"][k]
        scale = float(gc.abs().max())
        worst = max(worst, float((gg - gc).abs().max()) / max(scale, 1e-30))
        try:
            torch.testing.assert_close(gg, gc, rtol=GRAD_TOL, atol=GRAD_TOL * scale)
        except AssertionError as e:
            fail(f"{label}: gradient of {k} on the card disagrees with the CPU: {e}")
    print(f"[{label}] one training step: loss {loss_vals['cuda']:.6f} "
          f"(card) vs {loss_vals['cpu']:.6f} (CPU); worst gradient "
          f"difference {worst:.3e} of its parameter's largest entry "
          f"(rtol {GRAD_TOL}, atol {GRAD_TOL} of the largest entry)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--raw-data", default=os.environ.get("IGMC_RAW_DATA")
                    or os.path.join(REPO, "raw_data_synth"),
                    help="directory containing ml_1m/ratings.dat")
    args = ap.parse_args()

    import torch

    phase = Phases()
    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, REPO)
    from igmc_torch.batching import BatchLoader, StaticGraphDataset
    from igmc_torch.data import create_trainvaltest_split
    from igmc_torch.device import resolve_device, tf32_enabled
    from igmc_torch.kernels.build import KERNELS, build_many
    from igmc_torch.kernels.rgcn_aggregate import rgcn_aggregate, rgcn_aggregate_bwd
    from igmc_torch.models import IGMC, IGMCConfig, draw_noise
    from igmc_torch.train import (checkpoint_path, load_checkpoint,
                                  make_optimizer, make_train_step, save_pth,
                                  test_once, train_multiple_epochs)
    from igmc_torch.utils import ResultsDir, make_logger

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[device] {kind}, count {count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, TF32 {'on' if tf32_enabled() else 'off'}")
    print(smi, flush=True)

    # ---- 2. build ----------------------------------------------------------
    with phase("build"):
        paths = build_many(KERNELS)
        for name, path in paths.items():
            log = path + ".log"
            report = open(log).read() if os.path.isfile(log) else ""
            for line in report.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")
                if any(n != "0" for n in re.findall(r"(\d+) bytes spill", line)):
                    print(f"[build] {name}: WARNING: ptxas reports spills")

    # ---- 3. data -----------------------------------------------------------
    with phase("data"):
        os.environ["IGMC_RAW_DATA"] = args.raw_data
        t0 = time.perf_counter()
        split = create_trainvaltest_split("ml_1m", seed=1234, testing=True,
                                          verbose=False)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        kw = dict(h=1, max_nodes_per_hop=100, class_values=split.class_values,
                  max_num=MAX_NUM)
        test_ds = StaticGraphDataset(
            split.adj_train, (split.test_u_indices, split.test_v_indices),
            split.test_labels, **kw)
        train_ds = StaticGraphDataset(
            split.adj_train, (split.train_u_indices, split.train_v_indices),
            split.train_labels, **kw)
        extract_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batches = list(BatchLoader(test_ds, BATCH_SIZE))
        collate_s = time.perf_counter() - t0
        train_loader = BatchLoader(train_ds, BATCH_SIZE, shuffle=True, seed=1)
        train_loader.epoch = 1
        t0 = time.perf_counter()
        train_batches = list(train_loader)
        collate_train_s = time.perf_counter() - t0
        n_nodes = [int(b.node_mask.sum()) for b in batches]
        n_edges = [int(b.edge_mask.sum()) for b in batches]
        print(f"[data] ml_1m split {load_s:.2f} s; {len(test_ds)} test + "
              f"{len(train_ds)} training pairs extracted in {extract_s:.2f} s; "
              f"{len(batches)} test batches collated and planned in "
              f"{collate_s:.2f} s, {len(train_batches)} training batches with "
              f"both plans in {collate_train_s:.2f} s; test batches: mean "
              f"{sum(n_nodes) / len(batches):.1f} nodes, "
              f"{sum(n_edges) / len(batches):.1f} directed edges "
              f"(padded {batches[0].num_nodes} x {batches[0].num_edges}, "
              f"{batches[0].aligned[4].shape[0]} blocks)", flush=True)

    # ---- 4. kernel check ---------------------------------------------------
    R, B, COUT = len(split.class_values), 4, 32
    with phase("kernel check"):
        gen = torch.Generator().manual_seed(7)
        k1, k1_err = check_k1(batches[0], R, B, COUT, dev, gen)
        k2, k2_err = check_k2(train_batches[0], batches[0], R, B, COUT, dev, gen)

    cfg = IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                     num_relations=R, num_bases=4, adj_dropout=0.2)
    layers = len(cfg.latent_dim)
    launches = {}
    dev_batches = [b.to(dev) for b in batches]

    def read_counts(path):
        launches[path] = {"rgcn_aggregate_fwd": rgcn_aggregate.launches,
                          "rgcn_aggregate_bwd": rgcn_aggregate_bwd.launches}

    def reset_counts():
        rgcn_aggregate.launches = rgcn_aggregate_bwd.launches = 0

    def expect(path, name, want):
        got = launches[path][name]
        print(f"[{path}] {name} launches {got} (expected {want})", flush=True)
        if got != want:
            fail(f"{name} launched {got} times on the {path} path, expected {want}")

    with tempfile.TemporaryDirectory() as work:
        # ---- 5. evaluation path --------------------------------------------
        with phase("evaluation path"):
            ckpts = []
            for seed in (1, 2):
                member = IGMC(cfg, torch.Generator().manual_seed(seed))
                ckpts.append(checkpoint_path(work, "model", seed))
                save_pth(ckpts[-1], member.state_dict())
            template = IGMC(cfg, torch.Generator().manual_seed(0))
            reset_counts()
            t0 = time.perf_counter()
            rmse = test_once(test_ds, template, BATCH_SIZE, ensemble=True,
                             checkpoints=ckpts, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            read_counts("eval")
            print(f"[eval] ensemble of {len(ckpts)} over {len(test_ds)} pairs in "
                  f"{len(batches)} batches: RMSE {rmse:.6f}, {wall:.2f} s wall")
            expect("eval", "rgcn_aggregate_fwd", layers * len(batches) * len(ckpts))
            expect("eval", "rgcn_aggregate_bwd", 0)
            if not math.isfinite(rmse):
                fail(f"ensemble RMSE is not finite: {rmse}")
            states = [load_checkpoint(p) for p in ckpts]
            member_preds, fwd_ms, model = member_predictions(cfg, states, dev_batches)
            again = recomputed_rmse(member_preds, dev_batches, rmse, "eval")
            print(f"[eval] forward {fwd_ms[0]:.4f} ms per batch (member 1), "
                  f"{fwd_ms[1]:.4f} ms (member 2), CUDA events over "
                  f"{len(dev_batches)} device-resident batches; ensemble RMSE "
                  f"recomputed from the card's predictions {again:.6f}")

            def forward_all():
                with torch.no_grad():
                    for b in dev_batches:
                        model(b)

            by_key, busy_ms, _ = profile(forward_all, "forward",
                                         f"{len(dev_batches)} batches")
            k1_ms = sum(v for k, v in by_key.items() if "rgcn_aggregate_fwd" in k)
            print(f"[profile]   device forward {busy_ms / len(dev_batches):.4f} ms "
                  f"of kernels per batch; K1 share {k1_ms / max(busy_ms, 1e-9):.3f}")
            cpu_model = IGMC(cfg, torch.Generator().manual_seed(0))
            cpu_model.load_state_dict(states[-1])
            cpu_model.eval()
            worst = 0.0
            with torch.no_grad():
                for b, p_card in zip(batches[:CPU_BATCHES], member_preds[-1]):
                    p_cpu = cpu_model(b)
                    worst = max(worst, float((p_card.cpu() - p_cpu).abs().max()))
                    try:
                        torch.testing.assert_close(p_card.cpu(), p_cpu, rtol=0,
                                                   atol=PRED_ATOL)
                    except AssertionError as e:
                        fail(f"card predictions disagree with the CPU plain path: {e}")
            print(f"[eval] card vs CPU plain path on {CPU_BATCHES} batches of "
                  f"member 2: max abs diff {worst:.3e} (atol {PRED_ATOL})")

        # ---- 6. training path ----------------------------------------------
        with phase("training path"):
            res = ResultsDir(work, "ml_1m", "_chip_smoke", True)
            infos = []
            log = make_logger(res, 1)

            def logger(info, state):
                infos.append(dict(info))
                log(info, state)

            init = IGMC(cfg, torch.Generator().manual_seed(3))
            reset_counts()
            t0 = time.perf_counter()
            final_rmse, state = train_multiple_epochs(
                train_ds, test_ds, init, epochs=EPOCHS, batch_size=BATCH_SIZE,
                lr=1e-3, lr_decay_factor=0.1, lr_decay_step_size=50, ARR=0.001,
                test_freq=1, logger=logger, seed=1, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            read_counts("train")
            steps = EPOCHS * len(train_batches)
            for info, h in zip(infos, state.history):
                print(f"[train] epoch {info['epoch']}: train loss "
                      f"{info['train_loss']:.6f}, test rmse {info['test_rmse']:.6f}; "
                      f"{h['seconds']:.3f} s wall, of which host collation + "
                      f"planning {h['host_seconds']:.3f} s, the rest "
                      f"{h['seconds'] - h['host_seconds']:.3f} s")
            print(f"[train] {EPOCHS} epochs, {steps} steps, {wall:.2f} s wall")
            expect("train", "rgcn_aggregate_fwd",
                   layers * (steps + EPOCHS * len(batches)))
            expect("train", "rgcn_aggregate_bwd", layers * steps)
            losses = [i["train_loss"] for i in infos]
            rmses = [i["test_rmse"] for i in infos]
            if not all(math.isfinite(v) for v in losses + rmses):
                fail(f"training losses {losses} or RMSEs {rmses} are not finite")
            if not losses[1] < losses[0]:
                fail(f"epoch 2's train loss {losses[1]} is not below epoch 1's "
                     f"{losses[0]}")
            trained = [checkpoint_path(res.path, "model", e) for e in (1, 2)]
            for p in trained:
                if not os.path.isfile(p):
                    fail(f"training wrote no {p}")

            # the step on device-resident batches, CUDA events
            dev_train = [b.to(dev) for b in train_batches]
            noise_gen = torch.Generator().manual_seed(4)
            noises = [(s, k.to(dev)) for s, k in
                      (draw_noise(noise_gen, BATCH_SIZE) for _ in dev_train)]
            m = IGMC(cfg, torch.Generator().manual_seed(3)).to(dev).train()
            step = make_train_step(m, make_optimizer(m.parameters(), 1e-3), 0.001)
            for b, nz in zip(dev_train[:2], noises[:2]):
                step(b, nz)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for b, nz in zip(dev_train, noises):
                step(b, nz)
            end.record()
            torch.cuda.synchronize()
            step_ms = start.elapsed_time(end) / len(dev_train)
            print(f"[train] step {step_ms:.4f} ms (forward + backward + Adam), "
                  f"CUDA events over {len(dev_train)} device-resident batches")

            def steps_all():
                for b, nz in zip(dev_train, noises):
                    step(b, nz)

            by_key, busy_ms, window_ms = profile(
                steps_all, "training steps", f"{len(dev_train)} steps")
            share = {k: sum(v for key, v in by_key.items() if k in key)
                     / max(busy_ms, 1e-9)
                     for k in ("rgcn_aggregate_fwd", "rgcn_aggregate_bwd")}
            print(f"[profile]   {busy_ms / len(dev_train):.4f} ms of kernels per "
                  f"step; device-time shares: K1 {share['rgcn_aggregate_fwd']:.3f}, "
                  f"K2 {share['rgcn_aggregate_bwd']:.3f}")

        # ---- 7. card against CPU ---------------------------------------------
        with phase("card against CPU"):
            card_vs_cpu_step(cfg, train_batches[0], "card vs CPU")

        # ---- 8. closing the loop ---------------------------------------------
        with phase("trained ensemble"):
            reset_counts()
            rmse_t = test_once(test_ds, template, BATCH_SIZE, ensemble=True,
                               checkpoints=trained, device="cuda")
            torch.cuda.synchronize()
            read_counts("trained_ensemble")
            expect("trained_ensemble", "rgcn_aggregate_fwd",
                   layers * len(batches) * len(trained))
            trained_preds, _, _ = member_predictions(
                cfg, [load_checkpoint(p) for p in trained], dev_batches)
            again = recomputed_rmse(trained_preds, dev_batches, rmse_t,
                                    "trained ensemble")
            print(f"[trained ensemble] RMSE {rmse_t:.6f} over the checkpoints of "
                  f"epochs 1 and 2 (single model after epoch 2: "
                  f"{final_rmse:.6f}); recomputed from the card's predictions "
                  f"{again:.6f}")

        # ---- 9. dense evaluation ---------------------------------------------
        with phase("dense evaluation"):
            dense_eval(cfg, states, ckpts, template, test_ds, member_preds,
                       dev_batches, dev, reset_counts, read_counts, expect)

        # ---- 10. dense training ----------------------------------------------
        with phase("dense training"):
            dtrain = dense_train(cfg, train_ds, test_ds, work, dev, reset_counts,
                                 read_counts, expect)

        # ---- 11. card against CPU, dense ---------------------------------------
        with phase("card against CPU, dense"):
            card_vs_cpu_step(cfg, dtrain[0], "card vs CPU, dense")

    # ---- 12. the CLI -----------------------------------------------------------
    with phase("cli"):
        run_cli(args.raw_data)

    def entry(name, source, replaces, res, err, extra):
        r32 = res[32]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches["train"][name],
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": err, "ms": r32["ms"], "plain_ms": r32["plain_ms"],
            "bound_ms": r32["bound_ms"], "bound_by": r32["bound_by"],
            "library_ms": None, "device_ms": r32["device_ms"],
            "cin4": {k: res[4][k] for k in ("ms", "device_ms", "plain_ms",
                                            "bound_ms", "bound_by")},
            "shape": (f"ML-1M batch 0: N {batches[0].num_nodes}, {r32['e_real']} "
                      f"real of {r32['ep']} edge slots, Cin 32, Cout {COUT}, "
                      f"B {B}, R {R}"),
            **extra,
        }

    kernels = [
        entry("rgcn_aggregate_fwd", "igmc_torch/kernels/csrc/rgcn_aggregate_fwd.cu",
              "igmc_tpu/kernels/rgcn_aggregate.py:170", k1, k1_err, {}),
        entry("rgcn_aggregate_bwd", "igmc_torch/kernels/csrc/rgcn_aggregate_bwd.cu",
              "igmc_tpu/kernels/rgcn_aggregate.py:236", k2, max(k2_err.values()),
              {f"max_abs_err_{k}": v for k, v in k2_err.items()}),
    ]
    total = time.perf_counter() - phase.t0
    print(f"[time] total {total:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in phase.seconds.items()) + ")")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
