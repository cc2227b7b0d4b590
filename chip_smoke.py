#!/usr/bin/env python3
"""Drive igmc_torch on one CUDA card and check what comes out.

    python3 chip_smoke.py [--raw-data DIR]

Phases, each printing its lines; any failure exits non-zero:
  1. device: the card's name, `nvidia-smi` name and power limit, TF32 off;
  2. build: every CUDA kernel of the package, compiled with nvcc from the
     sources in this checkout (seconds and the ptxas report);
  3. data: ML-1M ratings (`--raw-data`, default $IGMC_RAW_DATA or the
     repo's raw_data_synth/), testing split with seed 1234, 2,000 held-out
     test pairs, 1-hop subgraphs with at most 100 nodes per hop, flat
     batches of 50;
  4. kernel check: each kernel against its plain PyTorch version (run in
     float64) on the card at the main path's shapes (one real ML-1M batch
     at Cin 4 and 32, a hot row spanning several blocks, a plan with extra
     padding blocks), rtol 1e-5 / atol 1e-4, with CUDA-event times of the
     kernel and of the plain version in float32;
  5. main path: a two-checkpoint ensemble evaluation of full-width IGMC
     (random weights from two generator seeds, saved as `.pth`) through
     `test_once(..., flat_aggregate="pallas", device="cuda")`, with every
     kernel's launch count read right after it; then the forward time per
     batch, the ensemble RMSE recomputed from the card's predictions, and
     the card's predictions on the first batches held against the CPU's
     plain path (atol 1e-4).
The last lines are one JSON object of kernel numbers, the card's
`nvidia-smi` line, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores, the rate K1's CUDA-core arithmetic runs at.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
RTOL, ATOL = 1e-5, 1e-4          # kernel vs plain version: summation order
PRED_ATOL = 1e-4                 # card vs CPU predictions
MAX_NUM = 2000                   # held-out pairs scored
BATCH_SIZE = 50                  # the CLI's default batch
CPU_BATCHES = 5                  # batches held against the CPU plain path


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


def aggregate_bound(x, att, basis, aligned):
    """Least time (ms) for one aggregate call on this card, from this call's
    inputs: the larger of its bytes over the memory rate and its float32
    operations over the CUDA-core rate, counting the least work the
    function needs, not K1's way of doing it.

    Operations: fold W_r = att @ basis once (2*R*B*Cin*Cout), then either
    one [Cin] x [Cin, Cout] product per real edge (2*E*Cin*Cout) or one per
    node and relation plus a gather-sum (2*N*R*Cin*Cout + E*Cout), whichever
    is less. Bytes: the mask over every slot, src, dst_local and etype over
    the real edges, chunk_of_block, x, att and basis read once, the output
    written once. Also returns the operations of K1's basis-mix form
    (2*E*B*Cin*Cout), for comparison."""
    src, _, _, mask, chunk_of_block = aligned[:5]
    nb, cin, cout = basis.shape
    n, nrel = x.shape[0], att.shape[0]
    e_real = int(mask.sum().item())
    flops = (min(2.0 * e_real * cin * cout, 2.0 * n * nrel * cin * cout
                 + e_real * cout) + 2.0 * nrel * nb * cin * cout)
    basis_mix_flops = 2.0 * e_real * nb * cin * cout
    nbytes = 4.0 * (mask.numel() + 3 * e_real + chunk_of_block.numel()
                    + x.numel() + att.numel() + basis.numel() + n * cout)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                e_real=e_real, flops=flops, nbytes=nbytes,
                basis_mix_ms=1e3 * basis_mix_flops / PEAK_F32_FLOP_PER_S)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--raw-data", default=os.environ.get("IGMC_RAW_DATA")
                    or os.path.join(REPO, "raw_data_synth"),
                    help="directory containing ml_1m/ratings.dat")
    args = ap.parse_args()

    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, REPO)
    from igmc_torch.batching import BatchLoader, StaticGraphDataset
    from igmc_torch.data import create_trainvaltest_split
    from igmc_torch.device import resolve_device, tf32_enabled
    from igmc_torch.kernels.build import build
    from igmc_torch.kernels.rgcn_aggregate import (
        block_align_edges, rgcn_aggregate, rgcn_aggregate_ref)
    from igmc_torch.models import IGMC, IGMCConfig
    from igmc_torch.train import (checkpoint_path, load_checkpoint, save_pth,
                                  test_once)

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[device] {kind}, count {count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, TF32 {'on' if tf32_enabled() else 'off'}")
    print(smi, flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    path = build("rgcn_aggregate_fwd")
    print(f"[build] rgcn_aggregate_fwd built or found in "
          f"{time.perf_counter() - t0:.2f} s")
    log = path + ".log"
    report = open(log).read() if os.path.isfile(log) else ""
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] rgcn_aggregate_fwd: {line.strip()}")
    sys.stdout.flush()

    # ---- 3. data -----------------------------------------------------------
    os.environ["IGMC_RAW_DATA"] = args.raw_data
    t0 = time.perf_counter()
    split = create_trainvaltest_split("ml_1m", seed=1234, testing=True,
                                      verbose=False)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_ds = StaticGraphDataset(
        split.adj_train, (split.test_u_indices, split.test_v_indices),
        split.test_labels, h=1, max_nodes_per_hop=100,
        class_values=split.class_values, max_num=MAX_NUM)
    extract_s = time.perf_counter() - t0
    loader = BatchLoader(test_ds, BATCH_SIZE)
    t0 = time.perf_counter()
    batches = list(loader)
    collate_s = time.perf_counter() - t0
    n_nodes = [int(b.node_mask.sum()) for b in batches]
    n_edges = [int(b.edge_mask.sum()) for b in batches]
    print(f"[data] ml_1m split {load_s:.2f} s; {len(test_ds)} test pairs "
          f"extracted in {extract_s:.2f} s; {len(batches)} batches collated "
          f"and planned in {collate_s:.2f} s; per batch mean "
          f"{sum(n_nodes) / len(batches):.1f} nodes, "
          f"{sum(n_edges) / len(batches):.1f} directed edges "
          f"(padded {batches[0].num_nodes} x {batches[0].num_edges}, "
          f"{batches[0].aligned[4].shape[0]} blocks)", flush=True)

    # ---- 4. kernel check ---------------------------------------------------
    gen = torch.Generator().manual_seed(7)
    R, B, COUT = len(split.class_values), 4, 32
    b0 = batches[0]
    N = b0.num_nodes
    src0, dst0 = b0.edge_src.numpy(), b0.edge_dst.numpy()
    typ0, msk0 = b0.edge_type.numpy(), b0.edge_mask.numpy()
    need = block_align_edges(src0, dst0, typ0, msk0, N)[6]
    per_chunk = np.bincount(b0.aligned[4].numpy())
    print(f"[kernel] batch 0 plan: {b0.aligned[4].shape[0]} blocks "
          f"(capacity), {need} needed; blocks per chunk: chunk 0 "
          f"{per_chunk[0]}, others {per_chunk[1:].min()}-{per_chunk[1:].max()}")
    rng = torch.Generator().manual_seed(11)
    hot = 3000   # > eblk: one dst row spanning several blocks
    hot_src = torch.randint(0, N, (hot,), generator=rng, dtype=torch.int32).numpy()
    hot_typ = torch.randint(0, R, (hot,), generator=rng, dtype=torch.int32).numpy()
    hot_dst = np.full(hot, 5, np.int32)
    plans = {
        "ml1m_batch0": b0.aligned,
        "hot_row": block_align_edges(
            np.concatenate([src0, hot_src]), np.concatenate([dst0, hot_dst]),
            np.concatenate([typ0, hot_typ]),
            np.concatenate([msk0, np.ones(hot, bool)]), N)[:6],
        "padding_blocks": block_align_edges(src0, dst0, typ0, msk0, N,
                                            num_blocks=need + 64)[:6],
    }
    results = {}
    max_err = 0.0
    for plan_name, plan in plans.items():
        aligned = tuple(torch.as_tensor(a).to(dev) for a in plan)
        for cin in (4, 32):
            # inputs as the main path gives them: one-hot hop labels into
            # layer 1, tanh states in (-1, 1) into layers 2-4, weights at
            # their init scale U(+-1/sqrt(B*Cin))
            if cin == 4:
                x = torch.nn.functional.one_hot(b0.node_label.long(), 4).float()
            else:
                x = torch.empty(N, cin).uniform_(-1, 1, generator=gen)
            bound = (B * cin) ** -0.5
            att = torch.empty(R, B).uniform_(-bound, bound, generator=gen)
            basis = torch.empty(B, cin, COUT).uniform_(-bound, bound, generator=gen)
            x, att, basis = x.to(dev), att.to(dev), basis.to(dev)
            with torch.no_grad():
                got = rgcn_aggregate(x, att, basis, aligned, 256, N)
                # the plain version in float64, so that the comparison sees
                # the kernel's rounding and not the plain version's own
                # (its index_add_ sums a hot row's thousands of terms in
                # float32 atomics, in an order that changes per run)
                want = rgcn_aggregate_ref(x.double(), att.double(),
                                          basis.double(), aligned, 256,
                                          N).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            try:
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            except AssertionError as e:
                fail(f"rgcn_aggregate_fwd disagrees with the plain version on "
                     f"{plan_name} cin={cin}: {e}")
            line = (f"[kernel] rgcn_aggregate_fwd {plan_name} cin={cin}: "
                    f"max_abs_err {err:.3e} (rtol {RTOL}, atol {ATOL})")
            if plan_name == "ml1m_batch0":
                with torch.no_grad():
                    ms = cuda_ms(lambda: rgcn_aggregate(x, att, basis, aligned, 256, N), 50)
                    plain_ms = cuda_ms(lambda: rgcn_aggregate_ref(x, att, basis, aligned, 256, N), 20)
                bnd = aggregate_bound(x, att, basis, aligned)
                results[cin] = dict(ms=ms, plain_ms=plain_ms,
                                    ep=int(aligned[0].numel()), **bnd)
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: "
                         f"{bnd['flops']:.3e} FLOP, {bnd['nbytes']:.3e} B; "
                         f"{bnd['e_real']} real of {aligned[0].numel()} edge "
                         f"slots, N {N}); K1's basis-mix FLOP alone "
                         f"{bnd['basis_mix_ms']:.4f} ms")
            print(line, flush=True)

    # ---- 5. main path ------------------------------------------------------
    cfg = IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                     num_relations=R, num_bases=4)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpts = []
        for seed in (1, 2):
            member = IGMC(cfg, torch.Generator().manual_seed(seed))
            ckpts.append(checkpoint_path(ckpt_dir, "model", seed))
            save_pth(ckpts[-1], member.state_dict())
        template = IGMC(cfg, torch.Generator().manual_seed(0))

        rgcn_aggregate.launches = 0
        t0 = time.perf_counter()
        rmse = test_once(test_ds, template, BATCH_SIZE, ensemble=True,
                         checkpoints=ckpts, flat_aggregate="pallas",
                         device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"rgcn_aggregate_fwd": rgcn_aggregate.launches}
        states = [load_checkpoint(p) for p in ckpts]

    expected = len(cfg.latent_dim) * len(batches) * len(ckpts)
    print(f"[main] ensemble of {len(ckpts)} over {len(test_ds)} pairs in "
          f"{len(batches)} batches: RMSE {rmse:.6f}, {wall:.2f} s wall; "
          f"rgcn_aggregate_fwd launches {launches['rgcn_aggregate_fwd']} "
          f"(expected {expected} = layers x batches x members)", flush=True)
    if launches["rgcn_aggregate_fwd"] != expected:
        fail(f"rgcn_aggregate_fwd launched {launches['rgcn_aggregate_fwd']} "
             f"times on the main path, expected {expected}")
    if not math.isfinite(rmse):
        fail(f"ensemble RMSE is not finite: {rmse}")

    dev_batches = [b.to(dev) for b in batches]
    member_preds = []
    fwd_ms = []
    for sd in states:
        model = IGMC(cfg, torch.Generator().manual_seed(0))
        model.load_state_dict(sd)
        model = model.to(dev).eval()
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
        member_preds.append(preds)
    ys = torch.cat([b.y[b.graph_mask] for b in dev_batches])
    flat = [torch.cat([p[b.graph_mask] for p, b in zip(preds, dev_batches)])
            for preds in member_preds]
    for p in flat:
        if p.shape != ys.shape or not bool(torch.isfinite(p).all()):
            fail(f"predictions of shape {tuple(p.shape)} (expected "
                 f"{tuple(ys.shape)}) or not finite")
    rmse_again = float(((torch.stack(flat).mean(0) - ys) ** 2).mean().sqrt())
    print(f"[main] forward {fwd_ms[0]:.4f} ms per batch (member 1), "
          f"{fwd_ms[1]:.4f} ms (member 2), CUDA events over "
          f"{len(dev_batches)} device-resident batches; ensemble RMSE "
          f"recomputed from the card's predictions {rmse_again:.6f}")
    if abs(rmse_again - rmse) > 1e-5:
        fail(f"test_once RMSE {rmse} != recomputed {rmse_again}")

    # where the forward's device time goes (torch.profiler, one member over
    # every batch); the busy share is summed kernel time over the window
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in dev_batches:
            model(b)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"[profile] forward over {len(dev_batches)} batches: {window_ms:.3f} ms "
          f"wall, {busy_ms:.3f} ms of kernels (busy share "
          f"{busy_ms / window_ms:.3f}, profiler on)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
        print(f"[profile]   {e.device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")

    cpu_model = IGMC(cfg, torch.Generator().manual_seed(0))
    cpu_model.load_state_dict(states[0])
    cpu_model.eval()
    worst = 0.0
    with torch.no_grad():
        for b, p_card in zip(batches[:CPU_BATCHES], member_preds[0]):
            p_cpu = cpu_model(b)
            worst = max(worst, float((p_card.cpu() - p_cpu).abs().max()))
            try:
                torch.testing.assert_close(p_card.cpu(), p_cpu, rtol=0,
                                           atol=PRED_ATOL)
            except AssertionError as e:
                fail(f"card predictions disagree with the CPU plain path: {e}")
    print(f"[main] card vs CPU plain path on {CPU_BATCHES} batches of "
          f"member 1: max abs diff {worst:.3e} (atol {PRED_ATOL})")

    r32 = results[32]
    kernels = [{
        "name": "rgcn_aggregate_fwd",
        "route": "cuda",
        "source": "igmc_torch/kernels/csrc/rgcn_aggregate_fwd.cu",
        "replaces": "igmc_tpu/kernels/rgcn_aggregate.py:170",
        "launches": launches["rgcn_aggregate_fwd"],
        "max_abs_err": max_err,
        "ms": r32["ms"],
        "plain_ms": r32["plain_ms"],
        "bound_ms": r32["bound_ms"],
        "bound_by": r32["bound_by"],
        "library_ms": None,
        "shape": (f"ML-1M batch 0: N {N}, {r32['e_real']} real of {r32['ep']} "
                  f"edge slots, Cin 32, Cout {COUT}, B {B}, R {R}"),
        "cin4": {k: results[4][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "basis_mix_ms": {"cin32": r32["basis_mix_ms"],
                         "cin4": results[4]["basis_mix_ms"]},
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
