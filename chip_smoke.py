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
     hop extracted by the C++ engine (built with g++ from the checkout),
     flat batches of 50 (the training loader shuffled with seed 1 and
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
     pairs in a subprocess and a working directory that phase 23 reuses:
     exit 0, `batch mode:
     dense (auto)` and `dense layout: bipartite (auto)`, and a log.txt of
     two epoch lines and the ensemble line, each with a finite RMSE;
 13. side features, card against CPU: one ML-1M training batch of 50
     with `--use-features` widths (users.dat's gender, age, occupation and
     zip one-hots; movies.dat's genres): one step on the flat layout (K1 +
     K2, launches counted) and one on the dense bipartite layout, each held
     against the CPU with phase 7's tolerances, lin1's feature columns
     included;
 14. ml_100k through the CLI: `python -m igmc_torch.cli.main --data-name
     ml_100k --testing --ensemble --use-features --epochs 2
     --save-interval 1` in a subprocess: the official-split and features
     lines, the C++ engine chosen, a log.txt with finite RMSEs;
 15. serving at full width on ML-1M: `Predictor` over phase 10's two
     checkpoints (C++ engine) scores phase 9's 2,000 held-out pairs equal
     to test_once's dense unified ensemble predictions (atol 1e-5); 200
     pairs against a CPU Predictor (atol 1e-4); a cold-start user scored
     finite; an out-of-range pair refused; a slot_ladder giving the same
     scores; then calls of 1, 128 and 2,000 pairs timed with each engine
     (host extraction apart from the device part, CUDA events), pairs per
     second, and the device's busy share over a 2,000-pair call;
 16. the serving CLI: `python -m igmc_torch.cli.predict` on phase 14's
     results in a subprocess, one line per pair, equal to an in-process
     Predictor's scores to 1e-6;
 17. the main path's options, on phase 10's checkpoints and the same
     pairs, K1 and K2 launching 0 times: bfloat16 (the dense bipartite
     test_once ensemble's RMSE beside float32's, predictions within 0.05;
     one training step card vs CPU, loss rtol BF16_LOSS_RTOL, gradients
     BF16_GRAD_TOL of the largest entry; a bfloat16 Predictor's scores
     equal test_once's bfloat16 dense unified ensemble to 1e-5 with
     deterministic scatters, the difference without them printed; forward
     and step times beside float32's); the strategies (adjacency
     predictions equal edge's on the unified layout, rtol 1e-5, and the
     relation-slotted layout's (DeviceDataset(rel_sort=R), plan_rel_caps)
     equal the bipartite edge layout's, rtol 1e-4 / atol 1e-5; one
     training step of each card vs CPU; forward time per batch of each;
     edge-k is the edge code and is not run apart); giant batches (one
     step of 1,000 training graphs in slices of 50 against the whole-row
     step from the same weights, row and noise, dropout on: loss rel 1e-5,
     gradients CHUNK_GRAD_TOL, parameters atol 5e-5, each step's time and
     peak memory; `train_multiple_epochs(batch_mode="dense",
     dense_chunk=50, batch_size=1000, epochs=2)` with finite losses); and
     the CLI on ml_100k with `--compute-dtype bfloat16 --dense-chunk 10
     --dense-strategy adjacency` in a subprocess (exit 0, the JAX CLI's
     `batch mode: dense (--dense-chunk)` and `dense layout: unified
     (auto)`, finite RMSEs in log.txt);
 18. dynamic data, caches and JAX checkpoints: `DynamicGraphDataset`s of
     the same 2,000 + 2,000 pairs (C++ engine), (a) dense training
     (host-collated unified batches, K1/K2 0 launches) for 2 epochs with
     prefetch 2 and with prefetch 0, each epoch's wall time and the host's
     waiting share printed; the two runs again with deterministic scatters,
     losses and RMSEs equal to 1e-6 relative; a host-collated step card vs
     CPU (phase 7's tolerances; hash dropout on dynamic edge keys); the
     step's CUDA-event time and an epoch's busy share with each prefetch;
     host-collated predictions of phase 3's static test set equal to its
     device-assembled ones (1e-5) and test_once's RMSE of the dynamic test
     set equal to the static one's; (b) flat training through K1/K2 (plans
     built on the prefetch threads) for 1 epoch on DYN_FLAT_PAIRS training
     and held-out pairs, launches counted, held against the CPU twin with
     the same noise (DYN_FLAT_RTOL); (c) ml_25m
     data from `write_ml25m_format` cut to ML25M_CUT, loaded by the port's
     time split (R = 10), 1 epoch of dynamic dense training, finite RMSE;
     (d) a `StaticGraphDataset(root=...)` cache of 20,000 training pairs
     written and loaded back equal (extraction, save and load seconds,
     MiB); (f) the CLI with `--dynamic-dataset --profile-dir` on ml_100k for
     2 epochs (the trace is of epoch 2, as in the JAX package): a non-empty
     trace and finite RMSEs. The JAX `.ckpt` loader is host code that the
     tier-1 tests hold against flax; this machine has no flax to write one;
 19. the Monti datasets (tests/torch_fixtures/monti: synthetic flixster,
     douban and yahoo_music in the published shapes, MATLAB v7.3): each
     file read through igmc_torch.data.hdf5 (timed) and held against the
     generator's .npz twin (this machine has no h5py), the split and the
     C++ extraction timed, the median subgraph node counts; the port CLI
     in a subprocess with IGMC_RAW_DATA at the fixtures: flixster
     `--testing --ensemble` 2 epochs on every pair, yahoo_music
     `--testing` (R = 71) 1 epoch, douban `--testing` cut to MONTI_CUT
     pairs (depth, not width) 1 epoch; finite RMSEs in log.txt, each
     epoch's wall time (the CLI's Duration);
 20. the GNN, DGCNN and DGCNN_RS families at the CLI's widths on
     flixster's static dense unified batches: a training step card vs
     CPU (loss rtol 1e-5, gradients 1e-4 of the largest entry; for DGCNN
     on the first batch whose SortPool row order is the same on both,
     the keys held to KEY_ATOL on every batch looked at), one epoch of
     training and evaluation (K1/K2 0 launches), the forward's time per
     batch (CUDA events) and its kernels (profiler), the step's time, its
     kernels and the busy share; then the CLI with `--model dgcnn_rs
     --testing --epochs 1`;
 21. the flat segment and blocked engines (the JAX package's default flat
     path), K1 and K2 launching 0 times: on phase 6's ML-1M pairs
     `train_multiple_epochs(batch_mode="flat")` device-resident for 2
     epochs, test_once's RMSE recomputed from the card's predictions
     (1e-5), the forward's ms per batch (CUDA events) and its kernels by
     name, the step's time and busy share, a card-vs-CPU step (phase 7's
     tolerances) for each conv_strategy and for aggr relmean; the blocked
     engine for 1 epoch, its host planning and its forward and step times
     over BLOCKED_BATCHES batches, and a card-vs-CPU step with dropout on; the
     yahoo_music fixture (R 71) for 1 epoch with conv_strategy auto (its
     choice printed); GNN, DGCNN and DGCNN_RS on flixster's flat batches,
     a card-vs-CPU step each (DGCNN on a batch whose SortPool order agrees)
     and an epoch; the CLI on ml_100k with `--batch-mode flat` for 1 epoch
     (FLAT_CLI), finite RMSEs in log.txt;
 22. several devices (igmc_torch.parallel), K1 and K2 launching 0 times,
     at full width on phase 6 / 10's ML-1M pairs: world size 1 over NCCL in
     this process (the dense DP step equal to the plain step bit for bit
     with deterministic scatters; EP at one rank against the flat segment
     forward, rtol / atol EP_TOL), then two ranks sharing the card over
     gloo (collectives staged through host memory: their times measure the
     port, not scaling): the dense DP step and a flat DP step against the
     single-device step with dropout on (phase 7's tolerances), one
     dense-DP epoch on the bipartite layout with the ranks' parameters
     identical bit for bit after it and the DP test RMSE within 1e-5 of the
     single-device RMSE of the same parameters, Predictor(mesh=) on the
     2,000 held-out pairs against Predictor (SERVE_ATOL), EP on a giant
     batch of EP_GRAPHS graphs (the forward against the flat forward, one
     train step per local aggregate, blocked against segment to phase 7's
     tolerances); the DP step and all_reduce times at both world sizes,
     the EP forward time and comm_stats' halo against all-gather bytes per
     layer, printed beside the card's name and power limit; then the CLI on
     ml_100k (MULTI_CLI_CUT pairs) for 1 epoch with `--n-devices 2` and with
     `--parallel ep --n-devices 2`, finite RMSEs in log.txt;
 23. the last modules (K1 and K2 launching 0 times in this process), at the
     CLI's full width: (b) `python -m igmc_torch.cli.resilient
     --stall-timeout STALL_TIMEOUT_S -- --data-name ml_100k --testing
     --epochs 3 --save-interval 1 --n-devices 2` (two ranks on the card over
     gloo) in the background: once the epoch-1 model and optimizer `.pth`
     exist the child's process group gets SIGSTOP (alive and silent, as
     under a hung collective); the supervisor must kill it, leave no
     process of that group, relaunch with `--continue-from` >= 1 and exit 0
     with epoch 3 last in log.txt and two launches in supervisor.log (the
     child's longest silence and the seconds from the stop to the relaunch
     printed); meanwhile (a) `--no-train --transfer <phase 12's results>
     --epochs 2 --visualize` on phase 12's pairs in a subprocess (exit 0,
     the PDF's structure and its 10 titles, `Transfer learning rmse is:`
     equal to test_once on the card to 1e-5), then visualize in this
     process on the card: its choice equal to the ranking of the card's
     own predict_all (deterministic scatters) and held against the CPU's
     (predictions atol 1e-4; a different choice only across a near tie,
     the smallest gaps printed), the seconds of prediction and drawing; and
     (c) `python -m igmc_torch.scripts.transfer_experiment --small` in a
     fresh directory, three finite transfer RMSEs. Budget LAST_BUDGET_S,
     printed;
 24. every shape of the JAX package's kernels past the CLI's defaults: (a)
     at each EVERY_SHAPE (4 and 16 bases at R 71; Cin 48 /
     Cout 64; Cin 6 / Cout 256, past one relation's shared memory in K2
     untiled; Cin 200 / Cout 40 / 12 bases; rows 128 with eblk 1,000 and
     1,001) on test batch 0's edges, K1 and K2 with dx on and off against
     their float64 plain versions at phase 4's tolerances, each one's time
     per call (CUDA events), device time (profiler), plain time and share
     of its bound; (b) `python -m igmc_torch.cli.main --data-name
     yahoo_music --testing --batch-mode flat --flat-aggregate pallas
     --num-bases 16 --epochs 1` on the Monti fixture (R 71) in this
     process, a finite RMSE in log.txt and K1 / K2 launching 4 x (training
     + test batches) / 4 x training batches; (c) a training step of IGMC
     with WIDE_STEP (Cin 64, 16 bases, pallas_rows 128) over blocks of
     WIDE_STEP_EBLK slots on yahoo_music, card against CPU at phase 7's
     gates, K1 / K2 launching 4 times each. Budget SHAPES_BUDGET_S, printed.
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
SERVE_ATOL = 1e-5                # Predictor vs test_once on the card
MANY_RELATIONS = 71              # yahoo_music's rating levels
# the kernels' times per wrapper call before their redesign for the run
# form, CUDA events (this script, NVIDIA H100 80GB HBM3, 700.00 W), by Cin:
# printed beside this run's times, never reported as this run's
BEFORE_MS = {"rgcn_aggregate_fwd": {32: 0.3923, 4: 0.1159},
             "rgcn_aggregate_bwd": {32: 0.5793, 4: 0.4720}}
GRAD_TOL = 1e-4                  # card vs CPU training step
# bfloat16 card vs CPU training step: the two sum in float32 in another
# order, so a state lying at a bfloat16 rounding midpoint can round one ulp
# (2**-8 of its value) apart and carry that through the later layers; ten
# times the float32 bounds (measured on an H100: loss 1e-7 relative,
# gradients 1.7e-6 of the largest entry)
BF16_LOSS_RTOL, BF16_GRAD_TOL = 1e-4, 1e-3
GIANT_BATCH, GIANT_CHUNK = 1000, 50
CHUNK_GRAD_TOL = 1e-5            # chunked vs whole-row step gradients
# dynamic flat training, card against CPU with the same noise: each step
# agrees to GRAD_TOL (phase 7); over one epoch of 40 Adam steps the mean
# loss and the RMSE may drift further
DYN_FLAT_RTOL = 1e-3
# ml_25m-format data, cut from 162,541 users x 59,047 movies x 25,000,095
# ratings so that writing and loading take well under a minute
# (synthesize_ratings draws each user's items over all movies' weights)
ML25M_CUT = dict(n_users=20_000, n_movies=8_000, n_ratings=1_000_000, seed=0)
CACHE_PAIRS = 20_000             # ML-1M training pairs through the .npz cache
# phase 18 (b): the training and held-out pairs of dynamic flat training
# through K1/K2 and its CPU twin, cut in depth from MAX_NUM (the twin's
# epoch on the CPU took ~76 s of the run) to keep the whole run within its
# budget once phase 22 came
DYN_FLAT_PAIRS = 500
# the Monti fixtures (tests/torch_make_monti_fixtures.py) and each CLI run:
# flags past --data-name NAME --testing, and the epochs they train
MONTI_ROOT = os.path.join(REPO, "tests", "torch_fixtures", "monti")
MONTI_CLI = {
    "flixster": (["--ensemble", "--epochs", "2", "--save-interval", "1"], 2),
    "yahoo_music": (["--epochs", "1"], 1),
    "douban": (["--max-train-num", "10000", "--max-test-num", "2000",
                "--epochs", "1"], 1),
}
MONTI_CUT = {"douban": (10_000, 2_000)}   # depth cut: training, test pairs
FAMILY_STEPS = 40                # training batches timed per family
# phase 21: blocked batches timed on the card (each step launches ~10,000
# kernels, and the profiler's trace of 10 steps took over a minute to read)
BLOCKED_BATCHES = 2
# phase 21's CLI run on ml_100k, flags past --data-name ml_100k --testing
# and the epochs it trains. Cut in depth to keep the whole run within its
# budget once phase 22 came: one run of 1 epoch, where there were three (2
# epochs of --batch-mode flat, 1 of --flat-aggregate blocked, 1 of --model
# dgcnn --batch-mode flat; ~70 s); phase 21 still drives the blocked engine
# and DGCNN's flat form in the library, and tier-1 runs all three flags
# through the CLI on the CPU
FLAT_CLI = {
    "segment": (["--batch-mode", "flat", "--epochs", "1"], 1),
}
# phase 22: the EP giant batch (ML-1M test graphs), the steps and
# all_reduces timed per world size, and the CLI runs on ml_100k (flags past
# --data-name ml_100k --testing --epochs 1). MULTI_CLI_CUT bounds their
# depth: the repo's synthetic ml_100k (1,988 + 497 pairs) runs whole, a
# real one given with --raw-data (80,000 + 20,000) runs cut
EP_GRAPHS = 400
EP_TOL = 2e-5                    # EP vs flat forward (the JAX package's bound)
DP_TIMED = 20
MULTI_CLI = {
    "dp": (["--n-devices", "2"], "Data-parallel training over 2 devices"),
    "ep": (["--parallel", "ep", "--n-devices", "2"],
           "Edge-partitioned training over 2 devices"),
}
MULTI_CLI_CUT = ["--max-train-num", "2000", "--max-test-num", "500"]
# phase 23: the visualize CLI on phase 12's results (flags past --transfer
# DIR), the supervisor's stall timeout and its child's flags, and the
# phase's budget in seconds (printed, not enforced)
VIS_CLI = ["--data-name", "ml_1m", "--testing", "--no-train", "--epochs", "2",
           "--visualize", "--max-train-num", "2000", "--max-test-num", "2000",
           "--max-nodes-per-hop", "100"]
VIS_PANELS = 10
# the supervisor's stall timeout; phase 23 prints the child's longest
# silence in each launch (a two-rank start: spawning, the ranks' imports,
# device and group set-up), so the margin under it is seen
STALL_TIMEOUT_S = 15
SUPERVISED_CLI = ["--data-name", "ml_100k", "--testing", "--epochs", "3",
                  "--save-interval", "1", "--n-devices", "2"]
LAST_BUDGET_S = 150
# SortPool keys (the DGCNN trunk's last channel, tanh) card vs CPU
KEY_ATOL = 1e-5
# phase 24: shapes of the JAX package's Pallas kernels past the CLI's
# defaults (more than 8 bases, widths past 32, other rows and eblk), each on
# ML-1M test batch 0's edges (relations redrawn over R when R is not the
# batch's 5): name -> (R, B, Cin, Cout, rows, eblk). The first is
# yahoo_music's shape at the CLI's 4 bases, timed as the reference of the
# 16-base row
EVERY_SHAPE = {
    "b4_cin32_cout32_r71": (71, 4, 32, 32, 256, 1024),
    "b16_cin32_cout32_r71": (71, 16, 32, 32, 256, 1024),
    "b4_cin48_cout64_r5": (5, 4, 48, 64, 256, 1024),
    "b1_cin6_cout256_r10": (10, 1, 6, 256, 256, 1024),
    "b12_cin200_cout40_r5": (5, 12, 200, 40, 256, 1024),
    "b4_cin32_cout32_rows128_eblk1000": (5, 4, 32, 32, 128, 1000),
    "b4_cin32_cout32_rows128_eblk1001": (5, 4, 32, 32, 128, 1001),
}
# phase 24 (b): the CLI's flags past --data-name yahoo_music --testing, the
# setting the JAX CLI gives for high-R studies; (c) the wide training step
SHAPES_CLI = ["--batch-mode", "flat", "--flat-aggregate", "pallas",
              "--num-bases", "16", "--epochs", "1"]
WIDE_STEP = dict(latent_dim=(64, 64, 64, 64), num_bases=16, pallas_rows=128)
WIDE_STEP_EBLK = 256
SHAPES_BUDGET_S = 60
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
    kernel alone, without the host time of the wrapper around it. The
    profiler can drop device records: a trace that does not hold all `reps`
    launches is taken again, at most four times, and said so; when every
    trace lost some, the mean is over the launches of the fullest one
    (each record is one launch's own duration), and said so. It fails when
    no trace holds any launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen, best = [], (0, 0.0)
    for _ in range(5):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if name in e.key and e.device_time_total > 0]
        count = sum(e.count for e in hits)
        total = sum(e.device_time_total for e in hits) / 1e3
        if count == reps:
            if seen:
                print(f"[profile] {name}: the profiler saw {seen} of {reps} "
                      f"launches before a full trace; traced again")
            return total / count
        seen.append(count)
        best = max(best, (count, total))
    if best[0] == 0:
        fail(f"profiler saw no launch of {name} in {len(seen)} traces")
    print(f"[profile] {name}: the profiler saw {seen} of {reps} launches in "
          f"{len(seen)} traces; the time per launch is the mean over the "
          f"{best[0]} of the fullest")
    return best[1] / best[0]


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


def aggregate_bound(x, att, basis, aligned, rows=ROWS):
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
    src, _, etype, live = _edges(aligned, rows)
    e = int(live.sum())
    pairs = _pairs(src, etype, live, nrel)
    flops = (min(2.0 * e * cin * cout, 2.0 * pairs * cin * cout + e * cout)
             + 2.0 * nrel * nb * cin * cout)
    nbytes = 4.0 * (aligned[3].numel() + 3 * e + aligned[4].numel()
                    + x.numel() + att.numel() + basis.numel() + n * cout)
    return dict(_bound(flops, nbytes), e_real=e, pairs=pairs,
                form_ms=1e3 * 2.0 * e * nb * cin * cout / PEAK_F32_FLOP_PER_S)


def aggregate_bwd_bound(x, att, basis, plan_t, need_dx: bool, rows=ROWS):
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
    dst, src, etype, live = _edges(plan_t, rows)
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


def bwd_errors(got, want, terms, where: str) -> dict:
    """K2's (dx or None, datt, dbasis) against the float64 plain version:
    fails unless each entry is within TERMS_RTOL of its sum of |terms|
    (+1e-7); returns each output's max abs error."""
    errs = {}
    for name, gv, wv, tv in zip(("dx", "datt", "dbasis"), got, want, terms):
        if gv is None:
            continue
        err = (gv.double() - wv).abs()
        errs[name] = float(err.max())
        over = err - (TERMS_RTOL * tv + 1e-7)
        if float(over.max()) > 0:
            i = int(over.argmax())
            fail(f"rgcn_aggregate_bwd {name} disagrees with the plain version "
                 f"{where}: entry {i} {float(gv.flatten()[i])} vs "
                 f"{float(wv.flatten()[i])}, sum of |terms| {float(tv.flatten()[i])}")
    return errs


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
            errs = bwd_errors(got, want, terms, f"on {plan_name} cin={cin}")
            for name in names:
                max_err[name] = max(max_err[name], errs[name])
            line = (f"[kernel] rgcn_aggregate_bwd {plan_name} (R {nrel}) cin={cin}: "
                    f"max_abs_err dx {errs['dx']:.3e}, datt {errs['datt']:.3e}, "
                    f"dbasis {errs['dbasis']:.3e} (within {TERMS_RTOL} of each "
                    f"entry's sum of |terms|)")
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
    Returns epoch 1's device-assembled training batches and the paths of
    the two checkpoints it wrote."""
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
    ckpts = [checkpoint_path(res.path, "model", e) for e in (1, 2)]
    for c in ckpts:
        if not os.path.isfile(c):
            fail(f"dense training wrote no {c}")

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
    return dtrain, ckpts


def _subprocess(cmd, raw_data, cwd, what, timeout=600):
    """Run `cmd` in `cwd` with the port importable and IGMC_RAW_DATA set;
    fail unless it exits 0. Returns (stdout lines, stderr, seconds)."""
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, IGMC_RAW_DATA=raw_data, PYTHONPATH=path)
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"{what} did not finish within {timeout} s")
    wall = time.perf_counter() - t0
    print(f"[{what}] python {' '.join(cmd[1:])}: exit {out.returncode}, "
          f"{wall:.2f} s")
    if out.returncode != 0:
        print(out.stdout[-4000:])
        print(out.stderr[-4000:], file=sys.stderr)
        fail(f"{what} exited {out.returncode}")
    return out.stdout.splitlines(), out.stderr, wall


def _check_log(cwd, name, heads, what):
    """The CLI's log.txt under `cwd`: one line per head, finite RMSEs."""
    log_path = os.path.join(cwd, "results", f"{name}_testmode", "log.txt")
    log = open(log_path).read().splitlines() if os.path.isfile(log_path) else []
    if len(log) != len(heads) or not all(l.startswith(h) for l, h in zip(log, heads)):
        fail(f"{what}: log.txt reads {log}")
    for line in log:
        if not math.isfinite(float(line.split()[-1])):
            fail(f"{what}: log.txt has a RMSE that is not finite: {line}")
        print(f"[{what}] log.txt: {line}")
    return [float(l.split()[-1]) for l in log]


def run_cli(raw_data: str, cwd: str) -> float:
    """Phase 12: `python -m igmc_torch.cli.main` on ML-1M in a subprocess
    and the working directory `cwd` (phase 23 visualizes its results); it
    must pick the dense bipartite layout itself, train 2 epochs, ensemble
    and write log.txt. Returns its wall seconds."""
    cmd = [sys.executable, "-m", "igmc_torch.cli.main", "--data-name", "ml_1m",
           "--testing", "--ensemble", "--epochs", "2", "--save-interval", "1",
           "--max-train-num", str(MAX_NUM), "--max-test-num", str(MAX_NUM),
           "--max-nodes-per-hop", "100"]
    lines, _, wall = _subprocess(cmd, raw_data, cwd, "cli")
    for want in ("batch mode: dense (auto)", "dense layout: bipartite (auto)"):
        if want not in lines:
            fail(f"the CLI did not print {want!r}")
    for line in lines:
        if line.startswith(("batch mode", "dense layout", "Epoch", "Ensemble")):
            print(f"[cli]   {line}")
    _check_log(cwd, "ml_1m", ["Epoch 1,", "Epoch 2,",
                              "Epoch ensemble of range(-13, 2, 5),"], "cli")
    return wall


def family_model(cfg, generator):
    """The model of `cfg`'s family: IGMC, GNN or DGCNN (DGCNN_RS)."""
    from igmc_torch.models import DGCNN, GNN, IGMC, DGCNNConfig, GNNConfig

    return {GNNConfig: GNN, DGCNNConfig: DGCNN}.get(type(cfg), IGMC)(cfg, generator)


def card_vs_cpu_step(cfg, batch, label, loss_rtol=1e-5, grad_tol=GRAD_TOL):
    """One training step's loss and gradients from the same weights (seed
    5), `batch` and noise on the card and on the CPU, for the model family
    of `cfg`: loss to `loss_rtol`, every gradient to rtol / atol `grad_tol`
    of its largest entry (with side features, lin1's feature columns are
    reported apart). Returns (the loss's relative difference, the worst
    gradient difference over its parameter's largest entry)."""
    import torch
    from igmc_torch.models import draw_noise
    from igmc_torch.train import loss_fn

    grads, loss_vals = {}, {}
    noise = draw_noise(torch.Generator().manual_seed(9), batch.num_graphs)
    for where in ("cpu", "cuda"):
        mm = family_model(cfg, torch.Generator().manual_seed(5)).to(where).train()
        loss, _ = loss_fn(mm, batch.to(where), (noise[0], noise[1].to(where)), 0.001)
        loss.backward()
        loss_vals[where] = loss.item()
        grads[where] = {k: p.grad.cpu() for k, p in mm.named_parameters()}
    if abs(loss_vals["cuda"] - loss_vals["cpu"]) > loss_rtol * abs(loss_vals["cpu"]):
        fail(f"{label}: training loss on the card {loss_vals['cuda']} != CPU "
             f"{loss_vals['cpu']}")
    worst = 0.0
    for k, gc in grads["cpu"].items():
        gg = grads["cuda"][k]
        scale = float(gc.abs().max())
        worst = max(worst, float((gg - gc).abs().max()) / max(scale, 1e-30))
        try:
            torch.testing.assert_close(gg, gc, rtol=grad_tol, atol=grad_tol * scale)
        except AssertionError as e:
            fail(f"{label}: gradient of {k} on the card disagrees with the CPU: {e}")
    extra = ""
    if getattr(cfg, "side_features", False):
        cols = 2 * sum(cfg.latent_dim)
        gc, gg = grads["cpu"]["lin1.weight"][:, cols:], grads["cuda"]["lin1.weight"][:, cols:]
        if not float(gc.abs().max()) > 0:
            fail(f"{label}: lin1's feature columns got no gradient")
        extra = (f"; lin1's {gc.shape[1]} feature columns: worst difference "
                 f"{float((gg - gc).abs().max()) / float(gc.abs().max()):.3e} of "
                 f"their largest gradient")
    print(f"[{label}] one training step: loss {loss_vals['cuda']:.6f} "
          f"(card) vs {loss_vals['cpu']:.6f} (CPU); worst gradient "
          f"difference {worst:.3e} of its parameter's largest entry "
          f"(loss rtol {loss_rtol}; rtol {grad_tol}, atol {grad_tol} of the largest "
          f"entry){extra}")
    return abs(loss_vals["cuda"] - loss_vals["cpu"]) / abs(loss_vals["cpu"]), worst


def features_phase(split, cfg, dev, reset_counts, read_counts, expect):
    """Phase 13: one ML-1M training batch of 50 with side features, one
    step on the flat layout (K1 + K2) and one on the dense bipartite
    layout, each card against CPU."""
    from dataclasses import replace

    from igmc_torch.batching import BatchLoader, DeviceDataset, StaticGraphDataset
    from igmc_torch.train import DensePass, plan_buckets

    t0 = time.perf_counter()
    ds = StaticGraphDataset(
        split.adj_train, (split.train_u_indices, split.train_v_indices),
        split.train_labels, h=1, max_nodes_per_hop=100,
        u_features=split.u_features, v_features=split.v_features,
        class_values=split.class_values, max_num=BATCH_SIZE, backend="native")
    du, dv = ds.packed.u_feat.shape[1], ds.packed.v_feat.shape[1]
    fcfg = replace(cfg, side_features=True, n_side_features=du + dv)
    loader = BatchLoader(ds, BATCH_SIZE, shuffle=True, seed=1, flat_aggregate="pallas")
    loader.epoch = 1
    flat = next(iter(loader))
    buckets = plan_buckets(ds, "bipartite")
    dd = DeviceDataset(ds.packed, dev)
    dense = next(DensePass.plan(buckets, BATCH_SIZE, 8, dev,
                                np.random.default_rng(1)).batches(dd))
    print(f"[features] {len(ds)} training pairs with {du} user features "
          f"(gender, age, occupation, zip one-hots) and {dv} item features "
          f"(genres): lin1 takes {2 * sum(cfg.latent_dim)} + {du + dv} inputs; "
          f"data {time.perf_counter() - t0:.2f} s")
    reset_counts()
    card_vs_cpu_step(fcfg, flat, "features, flat")
    card_vs_cpu_step(fcfg, dense, "features, dense")
    read_counts("features")
    layers = len(cfg.latent_dim)
    expect("features", "rgcn_aggregate_fwd", layers)
    expect("features", "rgcn_aggregate_bwd", layers)


def run_cli_100k(raw_data, cwd):
    """Phase 14: the port CLI on ml_100k's official split with side
    features, on the card, in a subprocess."""
    cmd = [sys.executable, "-m", "igmc_torch.cli.main", "--data-name", "ml_100k",
           "--testing", "--ensemble", "--use-features", "--epochs", "2",
           "--save-interval", "1"]
    lines, err, _ = _subprocess(cmd, raw_data, cwd, "cli ml_100k")
    want = "Using official MovieLens split u1.base/u1.test with 20% validation..."
    if want not in lines:
        fail(f"the ml_100k CLI did not print {want!r}")
    feats = [l for l in lines if l.startswith("Number of user features")]
    if len(feats) != 1:
        fail("the ml_100k CLI did not print its features line")
    if "extraction engine: native (backend auto)" not in err:
        fail("the ml_100k CLI did not extract with the C++ engine")
    for line in lines:
        if line.startswith(("Using official", "Number of", "batch mode",
                            "dense layout", "Epoch", "Ensemble")):
            print(f"[cli ml_100k]   {line}")
    _check_log(cwd, "ml_100k", ["Epoch 1,", "Epoch 2,",
                                "Epoch ensemble of range(-28, 2, 10),"], "cli ml_100k")
    return os.path.join(cwd, "results", "ml_100k_testmode")


def serving(split, cfg, ckpts, test_ds, dev):
    """Phase 15: Predictor on ML-1M at full width from phase 10's
    checkpoints; returns the timing table."""
    import torch
    from igmc_torch.batching import DeviceDataset
    from igmc_torch.batching.dataset import _apply_max_num
    from igmc_torch.models import IGMC
    from igmc_torch.serve import Predictor
    from igmc_torch.train import (DensePass, dense_predict_all, load_checkpoint,
                                  make_eval_step, plan_buckets, test_once)

    (us, vs), _ = _apply_max_num((split.test_u_indices, split.test_v_indices),
                                 split.test_labels, MAX_NUM)
    kw = dict(h=1, max_nodes_per_hop=100, batch_size=BATCH_SIZE)
    t0 = time.perf_counter()
    pred = Predictor(split.adj_train, split.class_values, cfg, checkpoints=ckpts,
                     backend="native", device="cuda", **kw)
    print(f"[serve] Predictor of {len(ckpts)} checkpoints on the card, engine "
          f"{pred.engine}, built in {time.perf_counter() - t0:.2f} s")
    if pred.engine != "native":
        fail("the Predictor did not take the C++ extraction engine")
    got = pred.predict(us, vs)

    # test_once's dense unified ensemble on the same subgraphs
    template = IGMC(cfg, torch.Generator().manual_seed(0))
    rmse = test_once(test_ds, template, BATCH_SIZE, ensemble=True, checkpoints=ckpts,
                     batch_mode="dense", dense_layout="unified", device="cuda")
    dd = DeviceDataset(test_ds.packed, dev)
    epoch = DensePass.plan(plan_buckets(test_ds, "unified"), BATCH_SIZE, 8, dev)
    members = []
    for c in ckpts:
        m = IGMC(cfg, torch.Generator().manual_seed(0))
        m.load_state_dict(load_checkpoint(c))
        members.append(dense_predict_all(make_eval_step(m.to(dev).eval()), dd, epoch))
    want = np.mean(members, axis=0)
    ys = np.asarray(test_ds.packed.y, np.float32)
    again = math.sqrt(float(np.mean((want - ys) ** 2)))
    if abs(again - rmse) > 1e-5:
        fail(f"serving: test_once's unified RMSE {rmse} != recomputed {again}")
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"served scores of shape {got.shape} or not finite")
    diff = float(np.abs(got - want).max())
    if not diff <= SERVE_ATOL:
        fail(f"served scores differ from test_once's unified ensemble by {diff}")
    served_rmse = math.sqrt(float(np.mean((got - ys) ** 2)))
    print(f"[serve] {len(us)} held-out pairs: scores vs test_once's dense unified "
          f"ensemble predictions max abs diff {diff:.3e} (atol {SERVE_ATOL}); RMSE "
          f"{served_rmse:.6f} served, {rmse:.6f} test_once")

    cpu = Predictor(split.adj_train, split.class_values, cfg, checkpoints=ckpts,
                    backend="native", device="cpu", **kw)
    diff = float(np.abs(cpu.predict(us[:200], vs[:200]) - got[:200]).max())
    if not diff <= PRED_ATOL:
        fail(f"served scores on the card differ from the CPU's by {diff}")
    print(f"[serve] 200 pairs, card vs CPU Predictor: max abs diff {diff:.3e} "
          f"(atol {PRED_ATOL})")

    # a cold-start user: no training rating in the serving adjacency
    cold_u = int(us[0])
    adj = split.adj_train.tolil()
    adj[cold_u, :] = 0
    adj = adj.tocsr()
    adj.eliminate_zeros()
    cold = Predictor(adj, split.class_values, cfg, checkpoints=ckpts,
                     backend="native", device="cuda", **kw)
    score = cold.predict([cold_u, cold_u], [int(vs[0]), int(vs[1])])
    if not np.isfinite(score).all():
        fail(f"a cold-start pair scored {score}")
    print(f"[serve] cold-start user {cold_u} (0 training ratings): scores {score}")
    try:
        pred.predict([0, split.adj_train.shape[0]], [0, 0])
        fail("an out-of-range pair was scored")
    except ValueError as e:
        print(f"[serve] out-of-range pair refused: {e}")

    ds = pred.subgraphs(us, vs)
    r8 = lambda v: int(-(-int(v) // 8) * 8)
    ladder = [(r8(np.median(ds.node_counts())), r8(np.median(ds.edge_counts() // 2))),
              (r8(ds.node_counts().max()), r8((ds.edge_counts() // 2).max()))]
    laddered = Predictor(split.adj_train, split.class_values, cfg, checkpoints=ckpts,
                         backend="native", device="cuda", slot_ladder=ladder, **kw)
    diff = float(np.abs(laddered.predict(us, vs) - got).max())
    if not diff <= SERVE_ATOL:
        fail(f"slot_ladder {ladder} changes the scores by {diff}")
    print(f"[serve] slot_ladder {ladder}: same scores, max abs diff {diff:.3e}")

    numpy_pred = Predictor(split.adj_train, split.class_values, cfg,
                           checkpoints=ckpts, backend="numpy", device="cuda", **kw)
    timings = {}
    for engine, p in (("native", pred), ("numpy", numpy_pred)):
        for n, reps in ((1, 20), (128, 5), (MAX_NUM, 3)):
            host, device, total = [], [], []
            for r in range(reps + 1):
                sel = slice((r * n) % MAX_NUM, (r * n) % MAX_NUM + n)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sub = p.subgraphs(us[sel], vs[sel])
                t1 = time.perf_counter()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                p.score(sub)
                end.record()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if r:          # the first call warms up
                    host.append(1e3 * (t1 - t0))
                    device.append(start.elapsed_time(end))
                    total.append(1e3 * (t2 - t0))
            row = {k: float(np.median(v)) for k, v in
                   (("host_ms", host), ("device_ms", device), ("total_ms", total))}
            row["pairs_per_s"] = 1e3 * n / row["total_ms"]
            timings[f"{engine}_{n}"] = row
            print(f"[serve] {engine} engine, {n} pair(s) per call (median of "
                  f"{reps}): {row['total_ms']:.3f} ms = host extraction "
                  f"{row['host_ms']:.3f} ms + device part {row['device_ms']:.3f} ms "
                  f"(CUDA events: upload, assembly, {len(ckpts)} members, fetch); "
                  f"{row['pairs_per_s']:.1f} pairs/s")
    _, busy_ms, window_ms = profile(lambda: pred.predict(us, vs),
                                    "serving call (native engine)", f"{MAX_NUM} pairs")
    timings["busy_share"] = busy_ms / window_ms
    return timings


def run_predict_cli(raw_data, cwd, results):
    """Phase 16: the serving CLI on phase 14's results, in a subprocess;
    its lines against an in-process Predictor's scores."""
    from igmc_torch.data import load_official_trainvaltest_split
    from igmc_torch.models import IGMCConfig
    from igmc_torch.serve import Predictor

    split = load_official_trainvaltest_split("ml_100k", testing=True)
    us, vs = split.test_u_indices[:50], split.test_v_indices[:50]
    pairs, out = os.path.join(cwd, "pairs.csv"), os.path.join(cwd, "preds.csv")
    with open(pairs, "w") as f:
        f.write("user,item\n" + "".join(f"{u},{v}\n" for u, v in zip(us, vs)))
    cmd = [sys.executable, "-m", "igmc_torch.cli.predict", "--data-name", "ml_100k",
           "--testing", "--results-dir", results, "--epochs", "2", "--ensemble",
           "--use-features", "--pairs", pairs, "--out", out]
    _, err, wall = _subprocess(cmd, raw_data, cwd, "cli predict")
    rows = [l.split(",") for l in open(out).read().splitlines()]
    if len(rows) != len(us):
        fail(f"the serving CLI printed {len(rows)} lines for {len(us)} pairs")
    uf, vf = split.u_features.toarray(), split.v_features.toarray()
    cfg = IGMCConfig(num_relations=len(split.class_values), side_features=True,
                     n_side_features=uf.shape[1] + vf.shape[1])
    pred = Predictor.from_results_dir(results, split.adj_train, split.class_values,
                                      cfg, epochs=2, interval=10, span=30,
                                      max_nodes_per_hop=10000, u_features=uf,
                                      v_features=vf, batch_size=128, device="cuda")
    want = pred.predict(us, vs)
    worst = 0.0
    for (u, v, s), w, uu, vv in zip(rows, want, us, vs):
        if (int(u), int(v)) != (int(uu), int(vv)):
            fail(f"the serving CLI's line {u},{v} is not the pair {uu},{vv}")
        worst = max(worst, abs(float(s) - float(w)))
    if not worst <= 1e-6:
        fail(f"the serving CLI's scores differ from the Predictor's by {worst}")
    said = [l for l in err.splitlines() if l.startswith("ensemble of")]
    print(f"[cli predict] {len(rows)} lines, {wall:.2f} s; scores vs an in-process "
          f"Predictor: max abs diff {worst:.3e} (1e-6; printed %.6f); "
          + "; ".join(said))


def _model(cfg, state, dev):
    import torch
    from igmc_torch.models import IGMC

    m = IGMC(cfg, torch.Generator().manual_seed(0))
    m.load_state_dict(state)
    return m.to(dev).eval()


def _forward_times(label, model, batches):
    """Forward ms per batch (CUDA events) and ms of kernels per batch
    (profiler) of `model` over `batches`."""
    import torch

    def forward_all():
        with torch.no_grad():
            for b in batches:
                model(b)

    wall = cuda_ms(forward_all, 2, warmup=1) / len(batches)
    _, busy_ms, _ = profile(forward_all, f"{label} forward", f"{len(batches)} batches")
    kern = busy_ms / len(batches)
    print(f"[options] {label}: forward {wall:.4f} ms per batch (CUDA events), "
          f"{kern:.4f} ms of kernels per batch (profiler), {len(batches)} batches")
    return {"forward_ms": wall, "forward_kernel_ms": kern}


def _step_ms(cfg, batches, dev):
    """Training step ms (assembled batch in; forward, backward and Adam) by
    CUDA events over `batches`, after two warm-up steps."""
    import torch
    from igmc_torch.models import IGMC, draw_noise
    from igmc_torch.train import make_optimizer, make_train_step

    gen = torch.Generator().manual_seed(4)
    noises = [(s, k.to(dev)) for s, k in
              (draw_noise(gen, b.num_graphs) for b in batches)]
    m = IGMC(cfg, torch.Generator().manual_seed(3)).to(dev).train()
    step = make_train_step(m, make_optimizer(m.parameters(), 1e-3), 0.001)
    for b, nz in zip(batches[:2], noises[:2]):
        step(b, nz)

    def steps_all():
        for b, nz in zip(batches, noises):
            step(b, nz)

    return cuda_ms(steps_all, 1, warmup=0) / len(batches)


def options_phase(split, cfg, ckpts, train_ds, test_ds, dtrain, dev, raw_data,
                  cwd, reset_counts, read_counts, expect):
    """Phase 17: the main path's options at full width. Returns the numbers
    it measured."""
    from dataclasses import replace

    import torch
    from igmc_torch.batching import DeviceDataset, assemble_dense, plan_rel_caps
    from igmc_torch.batching.dataset import _apply_max_num
    from igmc_torch.models import IGMC, draw_noise
    from igmc_torch.serve import Predictor
    from igmc_torch.train import (DensePass, dense_predict_all, load_checkpoint,
                                  make_dense_row_step, make_eval_step,
                                  make_optimizer, plan_buckets, test_once,
                                  train_multiple_epochs)

    out = {}
    R = cfg.num_relations
    bf16 = replace(cfg, compute_dtype="bfloat16")
    states = [load_checkpoint(c) for c in ckpts]
    dd = DeviceDataset(test_ds.packed, dev)
    passes = {lay: DensePass.plan(plan_buckets(test_ds, lay), BATCH_SIZE, 8, dev)
              for lay in ("bipartite", "unified")}

    def ensemble(c, layout, rel_caps=None, data=dd):
        return np.mean([dense_predict_all(make_eval_step(_model(c, st, dev)), data,
                                          passes[layout], rel_caps)
                        for st in states], axis=0)

    # ---- bfloat16 ---------------------------------------------------------
    reset_counts()
    rmse, ens = {}, {}
    for name, c in (("float32", cfg), ("bfloat16", bf16)):
        rmse[name] = test_once(test_ds, IGMC(c, torch.Generator().manual_seed(0)),
                               BATCH_SIZE,
                               ensemble=True, checkpoints=ckpts, batch_mode="dense",
                               dense_layout="bipartite", device="cuda")
        ens[name] = ensemble(c, "bipartite")
    ys = np.asarray(test_ds.packed.y, np.float32)
    again = math.sqrt(float(np.mean((ens["bfloat16"] - ys) ** 2)))
    if abs(again - rmse["bfloat16"]) > 1e-5:
        fail(f"bfloat16: test_once RMSE {rmse['bfloat16']} != recomputed {again}")
    worst = float(np.abs(ens["bfloat16"] - ens["float32"]).max())
    print(f"[options] bfloat16 dense bipartite ensemble of {len(ckpts)} over "
          f"{len(test_ds)} pairs: RMSE {rmse['bfloat16']:.6f} (float32 "
          f"{rmse['float32']:.6f}); worst |bfloat16 - float32| prediction "
          f"{worst:.3e} (limit 0.05)")
    if not worst <= 0.05:
        fail(f"bfloat16 predictions differ from float32's by {worst}")
    out["bf16_rmse"], out["f32_rmse"], out["bf16_worst_diff"] = (
        rmse["bfloat16"], rmse["float32"], worst)
    card_vs_cpu_step(bf16, dtrain[0], "options, bfloat16 card vs CPU",
                     BF16_LOSS_RTOL, BF16_GRAD_TOL)

    (us, vs), _ = _apply_max_num((split.test_u_indices, split.test_v_indices),
                                 split.test_labels, MAX_NUM)
    pred = Predictor(split.adj_train, split.class_values, bf16, checkpoints=ckpts,
                     backend="native", device="cuda", h=1, max_nodes_per_hop=100,
                     batch_size=BATCH_SIZE)
    loose = float(np.abs(pred.predict(us, vs) - ensemble(bf16, "unified")).max())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got, want = pred.predict(us, vs), ensemble(bf16, "unified")
        t_rmse = test_once(test_ds, IGMC(bf16, torch.Generator().manual_seed(0)),
                           BATCH_SIZE,
                           ensemble=True, checkpoints=ckpts, batch_mode="dense",
                           dense_layout="unified", device="cuda")
    finally:
        torch.use_deterministic_algorithms(False)
    diff = float(np.abs(got - want).max())
    again = math.sqrt(float(np.mean((want - ys) ** 2)))
    print(f"[options] bfloat16 Predictor vs test_once's bfloat16 dense unified "
          f"ensemble on {len(us)} pairs: max abs diff {diff:.3e} with deterministic "
          f"scatters (atol {SERVE_ATOL}), {loose:.3e} without; RMSE test_once "
          f"{t_rmse:.6f}, recomputed {again:.6f}")
    if not diff <= SERVE_ATOL or abs(again - t_rmse) > 1e-5:
        fail(f"bfloat16 served scores differ from test_once's by {diff}")
    out["bf16_serve_diff"], out["bf16_serve_diff_nondeterministic"] = diff, loose

    batches = list(passes["bipartite"].batches(dd))
    for name, c in (("float32", cfg), ("bfloat16", bf16)):
        out[f"{name}_bipartite"] = _forward_times(
            f"{name} dense bipartite", _model(c, states[-1], dev), batches)
        out[f"{name}_bipartite"]["step_ms"] = ms = _step_ms(c, dtrain, dev)
        print(f"[options] {name}: training step {ms:.4f} ms (CUDA events over "
              f"{len(dtrain)} dense bipartite batches)")
    read_counts("options_bf16")
    expect("options_bf16", "rgcn_aggregate_fwd", 0)
    expect("options_bf16", "rgcn_aggregate_bwd", 0)

    # ---- strategies -------------------------------------------------------
    reset_counts()
    edge = ensemble(cfg, "unified")
    adj = ensemble(replace(cfg, dense_strategy="adjacency"), "unified")
    rel = float((np.abs(adj - edge) / np.abs(edge)).max())
    print(f"[options] adjacency vs edge, unified ensemble on {len(edge)} pairs: "
          f"max relative diff {rel:.3e} (rtol 1e-5)")
    if not np.allclose(adj, edge, rtol=1e-5, atol=1e-6):
        fail(f"adjacency predictions differ from edge's by {rel} relative")
    etypes = lambda ds: np.split(ds.packed.etype, ds.packed.edge_offsets[1:-1])
    caps = plan_rel_caps(etypes(test_ds) + etypes(train_ds), R)
    dd_rel = DeviceDataset(test_ds.packed, dev, rel_sort=R)
    relslot = ensemble(cfg, "bipartite", caps, dd_rel)
    diff = float(np.abs(relslot - ens["float32"]).max())
    print(f"[options] relation-slotted (rel_caps {caps}, {sum(caps)} edge slots) vs "
          f"bipartite edge ensemble: max abs diff {diff:.3e} (rtol 1e-4, atol 1e-5)")
    if not np.allclose(relslot, ens["float32"], rtol=1e-4, atol=1e-5):
        fail(f"relation-slotted predictions differ from bipartite edge's by {diff}")
    out["relslot_caps"] = list(caps)

    dd_train = DeviceDataset(train_ds.packed, dev)
    rng = lambda: np.random.default_rng(np.random.SeedSequence([1, 1]))
    uni_train = next(DensePass.plan(plan_buckets(train_ds, "unified"), BATCH_SIZE, 8,
                                    dev, rng()).batches(dd_train))
    rel_train = next(DensePass.plan(plan_buckets(train_ds, "bipartite"), BATCH_SIZE, 8,
                                    dev, rng()).batches(
        DeviceDataset(train_ds.packed, dev, rel_sort=R), caps))
    card_vs_cpu_step(replace(cfg, dense_strategy="adjacency"), uni_train,
                     "options, adjacency card vs CPU")
    card_vs_cpu_step(cfg, rel_train, "options, relation-slotted card vs CPU")
    uni = list(passes["unified"].batches(dd))
    for strategy in ("edge", "adjacency"):
        out[f"{strategy}_unified"] = _forward_times(
            f"{strategy} unified", _model(replace(cfg, dense_strategy=strategy),
                                          states[-1], dev), uni)
    out["relslot_bipartite"] = _forward_times(
        "relation-slotted bipartite", _model(cfg, states[-1], dev),
        list(passes["bipartite"].batches(dd_rel, caps)))
    read_counts("options_strategies")
    expect("options_strategies", "rgcn_aggregate_fwd", 0)
    expect("options_strategies", "rgcn_aggregate_bwd", 0)

    # ---- giant batches ------------------------------------------------------
    reset_counts()
    big = plan_buckets(train_ds, "bipartite", max_buckets=1)[0]
    row = torch.from_numpy(np.random.default_rng(2).permutation(big.indices)
                           [:GIANT_BATCH].astype(np.int64)).to(dev)
    assemble = lambda gids: assemble_dense(dd_train, gids, big.node_slot,
                                           big.edge_slot, big.num_u_slot)
    noise = draw_noise(torch.Generator().manual_seed(6), GIANT_BATCH)
    noise = (noise[0], noise[1].to(dev))
    res = {}
    for chunk in (GIANT_CHUNK, 0):
        m = IGMC(cfg, torch.Generator().manual_seed(3)).to(dev).train()
        row_step = make_dense_row_step(m, make_optimizer(m.parameters(), 1e-3),
                                       chunk, 0.001)
        step = lambda: row_step(assemble, row, noise)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = step()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        params = {k: v.detach().clone() for k, v in m.state_dict().items()}
        grads = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        ms = cuda_ms(step, 3, warmup=0)
        res[chunk] = (loss.item(), params, grads)
        tag = f"chunk {chunk}" if chunk else "whole row"
        out[f"giant_{'chunked' if chunk else 'whole'}"] = {
            "step_ms": ms, "peak_mib": peak / 2**20, "base_mib": base / 2**20}
        print(f"[options] giant batch of {GIANT_BATCH} ({big.node_slot} node rows x "
              f"{big.edge_slot} edge slots), {tag}: loss {loss.item():.6f}; "
              f"first step {1e3 * first_s:.1f} ms, then {ms:.2f} ms per step (CUDA "
              f"events); peak memory {peak / 2**20:.1f} MiB "
              f"(torch.cuda.max_memory_allocated, {base / 2**20:.1f} MiB before)")
    (l_c, p_c, g_c), (l_w, p_w, g_w) = res[GIANT_CHUNK], res[0]
    worst = max(float((p_c[k] - p_w[k]).abs().max()) for k in p_w)
    g_worst = 0.0
    for k, gw in g_w.items():
        scale = float(gw.abs().max())
        g_worst = max(g_worst, float((g_c[k] - gw).abs().max()) / max(scale, 1e-30))
        try:
            torch.testing.assert_close(g_c[k], gw, rtol=CHUNK_GRAD_TOL,
                                       atol=CHUNK_GRAD_TOL * scale)
        except AssertionError as e:
            fail(f"the chunked giant-batch step's gradient of {k} differs from "
                 f"the whole-row step's: {e}")
    print(f"[options] chunked vs whole-row step: loss rel diff "
          f"{abs(l_c - l_w) / abs(l_w):.3e} (1e-5), gradients worst diff "
          f"{g_worst:.3e} of the largest entry (rtol {CHUNK_GRAD_TOL}, atol "
          f"{CHUNK_GRAD_TOL} of the largest entry), parameters max abs diff "
          f"{worst:.3e} (5e-5); peak memory ratio "
          f"{out['giant_chunked']['peak_mib'] / out['giant_whole']['peak_mib']:.3f}")
    if abs(l_c - l_w) > 1e-5 * abs(l_w) or not worst <= 5e-5:
        fail(f"the chunked giant-batch step differs from the whole-row step "
             f"(loss {l_c} vs {l_w}, parameters {worst})")
    infos = []
    t0 = time.perf_counter()
    train_multiple_epochs(
        train_ds, test_ds, IGMC(cfg, torch.Generator().manual_seed(3)), epochs=2,
        batch_size=GIANT_BATCH, lr=1e-3, lr_decay_factor=0.1, lr_decay_step_size=50,
        ARR=0.001, seed=1, batch_mode="dense", dense_layout="bipartite",
        dense_chunk=GIANT_CHUNK, device="cuda",
        logger=lambda info, state: infos.append(dict(info)))
    torch.cuda.synchronize()
    losses = [(i["train_loss"], i["test_rmse"]) for i in infos]
    print(f"[options] train_multiple_epochs(dense_chunk={GIANT_CHUNK}, batch_size="
          f"{GIANT_BATCH}): (train loss, test rmse) per epoch {losses}, "
          f"{time.perf_counter() - t0:.2f} s")
    if len(losses) != 2 or not all(math.isfinite(v) for p in losses for v in p):
        fail(f"giant-batch training gave {losses}")
    read_counts("options_dense_chunk")
    expect("options_dense_chunk", "rgcn_aggregate_fwd", 0)
    expect("options_dense_chunk", "rgcn_aggregate_bwd", 0)

    # ---- the CLI ---------------------------------------------------------
    cmd = [sys.executable, "-m", "igmc_torch.cli.main", "--data-name", "ml_100k",
           "--testing", "--ensemble", "--epochs", "1", "--save-interval", "1",
           "--compute-dtype", "bfloat16", "--dense-chunk", "10",
           "--dense-strategy", "adjacency"]
    lines = _subprocess(cmd, raw_data, cwd, "cli options")[0]
    for want in ("batch mode: dense (--dense-chunk)", "dense layout: unified (auto)"):
        if want not in lines:
            fail(f"the options CLI did not print {want!r}")
    _check_log(cwd, "ml_100k", ["Epoch 1,", "Epoch ensemble of range(-29, 1, 10),"],
               "cli options")
    return out


def _dynamic_run(cfg, train, test, prefetch, epochs=EPOCHS, device="cuda", **kw):
    """train_multiple_epochs of full-width IGMC (seed 3) on `train` /
    `test`; returns (infos, state, wall seconds)."""
    import torch
    from igmc_torch.models import IGMC
    from igmc_torch.train import train_multiple_epochs

    infos = []
    t0 = time.perf_counter()
    _, state = train_multiple_epochs(
        train, test, IGMC(cfg, torch.Generator().manual_seed(3)), epochs=epochs,
        batch_size=BATCH_SIZE, lr=1e-3, lr_decay_factor=0.1, lr_decay_step_size=50,
        ARR=0.001, seed=1, prefetch=prefetch, device=device,
        logger=lambda info, s: infos.append(dict(info)), **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals = [v for i in infos for v in (i["train_loss"], i["test_rmse"])]
    if len(infos) != epochs or not all(math.isfinite(v) for v in vals):
        fail(f"dynamic training ({kw}, prefetch {prefetch}) gave {infos}")
    return infos, state, wall


def dynamic_phase(split, cfg, test_ds, dense_ckpts, dev, raw_data, work,
                  reset_counts, read_counts, expect):
    """Phase 18: dynamic data (dense host-collated and flat through K1/K2),
    ml_25m-format data, the subgraph cache and the CLI with
    --dynamic-dataset --profile-dir. Returns the numbers it measured."""
    from dataclasses import replace

    import torch
    from igmc_torch.batching import (BatchLoader, DeviceDataset,
                                     DynamicGraphDataset, StaticGraphDataset)
    from igmc_torch.data import create_trainvaltest_split, write_ml25m_format
    from igmc_torch.models import IGMC, draw_noise
    from igmc_torch.train import (DensePass, dense_predict_all, load_checkpoint,
                                  make_eval_step, make_optimizer, make_train_step,
                                  plan_buckets, predict_all, test_once, train_epoch)

    out = {}
    layers = len(cfg.latent_dim)
    kw = dict(h=1, max_nodes_per_hop=100, class_values=split.class_values,
              max_num=MAX_NUM, backend="native")
    train_dyn = DynamicGraphDataset(
        split.adj_train, (split.train_u_indices, split.train_v_indices),
        split.train_labels, **kw)
    test_dyn = DynamicGraphDataset(
        split.adj_train, (split.test_u_indices, split.test_v_indices),
        split.test_labels, **kw)

    # ---- (a) dynamic dense training ----------------------------------------
    dense_kw = dict(batch_mode="dense", dense_layout="unified")
    runs = {}
    for prefetch in (2, 0):
        reset_counts()
        infos, state, wall = _dynamic_run(cfg, train_dyn, test_dyn, prefetch,
                                          **dense_kw)
        read_counts(f"dynamic_dense_p{prefetch}")
        expect(f"dynamic_dense_p{prefetch}", "rgcn_aggregate_fwd", 0)
        expect(f"dynamic_dense_p{prefetch}", "rgcn_aggregate_bwd", 0)
        runs[prefetch] = infos
        out[f"dense_prefetch{prefetch}"] = {"wall_s": wall, "epochs": [
            {"seconds": h["seconds"], "host_seconds": h["host_seconds"],
             "train_loss": i["train_loss"], "test_rmse": i["test_rmse"]}
            for i, h in zip(infos, state.history)]}
        for info, h in zip(infos, state.history):
            print(f"[dynamic] dense, prefetch {prefetch}, epoch {info['epoch']}: "
                  f"train loss {info['train_loss']:.6f}, test rmse "
                  f"{info['test_rmse']:.6f}; {h['seconds']:.3f} s wall, host "
                  f"(waiting for extraction + collation) {h['host_seconds']:.3f} s "
                  f"({h['host_seconds'] / h['seconds']:.3f} of it)")
        losses = [i["train_loss"] for i in infos]
        if not losses[1] < losses[0]:
            fail(f"dynamic dense: epoch 2's loss {losses[1]} is not below {losses[0]}")
    # the same run serially and with prefetch: the same batches and noise;
    # scatters made deterministic so the two runs are the same arithmetic
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = {p: _dynamic_run(cfg, train_dyn, test_dyn, p, **dense_kw)[0]
               for p in (2, 0)}
    finally:
        torch.use_deterministic_algorithms(False)
    worst = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(det[2], det[0])
                for k in ("train_loss", "test_rmse"))
    loose = max(abs(a["train_loss"] - b["train_loss"]) / abs(b["train_loss"])
                for a, b in zip(runs[2], runs[0]))
    print(f"[dynamic] prefetch 2 vs 0, deterministic scatters: losses and RMSEs "
          f"max relative diff {worst:.3e} (limit 1e-6); without them, losses "
          f"{loose:.3e}")
    if not worst <= 1e-6:
        fail(f"dynamic dense training with prefetch 2 differs from prefetch 0 by "
             f"{worst} relative")
    out["prefetch_loss_rel_diff"] = worst

    loader = BatchLoader(train_dyn, BATCH_SIZE, shuffle=True, seed=1,
                         batch_mode="dense", pin_memory=True)
    loader.epoch = 1
    host_batches = list(loader)
    card_vs_cpu_step(cfg, host_batches[0], "dynamic, card vs CPU")
    dev_batches = [b.to(dev) for b in host_batches]
    noise_gen = torch.Generator().manual_seed(4)
    noises = [(s, k.to(dev)) for s, k in
              (draw_noise(noise_gen, BATCH_SIZE) for _ in dev_batches)]
    m = IGMC(cfg, torch.Generator().manual_seed(3)).to(dev).train()
    step = make_train_step(m, make_optimizer(m.parameters(), 1e-3), 0.001)

    def steps_all():
        for b, nz in zip(dev_batches, noises):
            step(b, nz)

    steps_all()
    out["dense_step_ms"] = cuda_ms(steps_all, 1, warmup=0) / len(dev_batches)
    slots = sorted({(b.node_slot, b.edge_slot) for b in host_batches})
    print(f"[dynamic] host-collated dense step {out['dense_step_ms']:.4f} ms "
          f"(forward + backward + Adam, batch on the card), CUDA events over "
          f"{len(dev_batches)} batches; slot shapes (nodes, edges) {slots}")
    for prefetch in (2, 0):
        ld = BatchLoader(train_dyn, BATCH_SIZE, shuffle=True, seed=1,
                         batch_mode="dense", prefetch=prefetch, pin_memory=True)
        gen = torch.Generator().manual_seed(5)
        m.train()
        _, busy_ms, window_ms = profile(
            lambda: train_epoch(step, ld, gen, len(train_dyn), dev),
            f"dynamic dense epoch, prefetch {prefetch}", f"{len(ld)} steps")
        out[f"dense_prefetch{prefetch}"]["busy_share"] = busy_ms / window_ms

    model = _model(cfg, load_checkpoint(dense_ckpts[0]), dev)
    eval_fn = make_eval_step(model)
    host, _ = predict_all(eval_fn, BatchLoader(test_ds, BATCH_SIZE, batch_mode="dense",
                                               pin_memory=True), dev)
    device = dense_predict_all(eval_fn, DeviceDataset(test_ds.packed, dev),
                               DensePass.plan(plan_buckets(test_ds, "unified"),
                                              BATCH_SIZE, 8, dev))
    diff = float(np.abs(host - device).max())
    template = IGMC(cfg, torch.Generator().manual_seed(0))
    r_static = test_once(test_ds, template, BATCH_SIZE, params=load_checkpoint(
        dense_ckpts[0]), batch_mode="dense", dense_layout="unified", device="cuda")
    r_dyn = test_once(test_dyn, template, BATCH_SIZE, params=load_checkpoint(
        dense_ckpts[0]), batch_mode="dense", dense_layout="unified", device="cuda")
    print(f"[dynamic] host-collated vs device-assembled unified predictions of the "
          f"static test set ({len(host)} pairs): max abs diff {diff:.3e} (atol 1e-5); "
          f"test_once RMSE dynamic {r_dyn:.6f}, static {r_static:.6f}")
    if not diff <= 1e-5 or abs(r_dyn - r_static) > 1e-5:
        fail(f"host-collated predictions differ from device-assembled ones by "
             f"{diff} (RMSE {r_dyn} vs {r_static})")
    out["host_vs_device_pred_diff"] = diff

    # ---- (b) dynamic flat training through K1 / K2 -------------------------
    flat_kw = dict(batch_mode="flat", flat_aggregate="pallas", epochs=1)
    cut = dict(kw, max_num=DYN_FLAT_PAIRS)
    train_flat = DynamicGraphDataset(
        split.adj_train, (split.train_u_indices, split.train_v_indices),
        split.train_labels, **cut)
    test_flat = DynamicGraphDataset(
        split.adj_train, (split.test_u_indices, split.test_v_indices),
        split.test_labels, **cut)
    reset_counts()
    infos, state, wall = _dynamic_run(cfg, train_flat, test_flat, 2, **flat_kw)
    read_counts("dynamic_flat")
    steps = len(BatchLoader(train_flat, BATCH_SIZE))
    expect("dynamic_flat", "rgcn_aggregate_fwd",
           layers * (steps + len(BatchLoader(test_flat, BATCH_SIZE))))
    expect("dynamic_flat", "rgcn_aggregate_bwd", layers * steps)
    h = state.history[0]
    t0 = time.perf_counter()
    cpu_infos = _dynamic_run(cfg, train_flat, test_flat, 2, device="cpu", **flat_kw)[0]
    cpu_s = time.perf_counter() - t0
    rel = max(abs(infos[0][k] - cpu_infos[0][k]) / abs(cpu_infos[0][k])
              for k in ("train_loss", "test_rmse"))
    print(f"[dynamic] flat (K1 + K2, plans built on the prefetch threads), 1 epoch "
          f"of {steps} steps: train loss {infos[0]['train_loss']:.6f}, test rmse "
          f"{infos[0]['test_rmse']:.6f}; {h['seconds']:.3f} s wall, host "
          f"{h['host_seconds']:.3f} s; CPU twin (plain versions, same noise) "
          f"{cpu_infos[0]['train_loss']:.6f} / {cpu_infos[0]['test_rmse']:.6f} in "
          f"{cpu_s:.1f} s: max relative diff {rel:.3e} (limit {DYN_FLAT_RTOL})")
    if not rel <= DYN_FLAT_RTOL:
        fail(f"dynamic flat training on the card differs from the CPU by {rel}")
    out["flat"] = {"seconds": h["seconds"], "host_seconds": h["host_seconds"],
                   "card_vs_cpu_rel": rel}

    # ---- (c) ml_25m-format data ----------------------------------------------
    root25 = os.path.join(work, "raw25m")
    t0 = time.perf_counter()
    write_ml25m_format(root25, **ML25M_CUT)
    write_s = time.perf_counter() - t0
    old_raw = os.environ.get("IGMC_RAW_DATA")
    os.environ["IGMC_RAW_DATA"] = root25
    try:
        t0 = time.perf_counter()
        s25 = create_trainvaltest_split("ml_25m", testing=True, verbose=False)
        load_s = time.perf_counter() - t0
    finally:
        os.environ["IGMC_RAW_DATA"] = old_raw
    R25 = len(s25.class_values)
    n_all = len(s25.train_labels) + len(s25.test_labels)
    print(f"[dynamic] ml_25m format {ML25M_CUT}: written in {write_s:.2f} s, loaded "
          f"and split by time in {load_s:.2f} s; {n_all} ratings, R = {R25} "
          f"({s25.class_values.tolist()}), {len(s25.train_labels)} training "
          f"(train + val) and {len(s25.test_labels)} test links")
    if R25 != 10 or len(s25.test_labels) != n_all - int(n_all * 0.8):
        fail(f"ml_25m: R = {R25}, {len(s25.test_labels)} test links of {n_all}")
    kw25 = dict(kw, class_values=s25.class_values)
    tr25 = DynamicGraphDataset(s25.adj_train, (s25.train_u_indices,
                               s25.train_v_indices), s25.train_labels, **kw25)
    te25 = DynamicGraphDataset(s25.adj_train, (s25.test_u_indices,
                               s25.test_v_indices), s25.test_labels, **kw25)
    infos, state, wall = _dynamic_run(replace(cfg, num_relations=R25), tr25, te25, 2,
                                      epochs=1, **dense_kw)
    print(f"[dynamic] ml_25m dynamic dense, 1 epoch of {len(tr25)} pairs: train loss "
          f"{infos[0]['train_loss']:.6f}, test rmse {infos[0]['test_rmse']:.6f} over "
          f"{len(te25)} pairs; {wall:.2f} s")
    out["ml25m"] = {"write_s": write_s, "load_s": load_s, "ratings": n_all,
                    "rmse": infos[0]["test_rmse"], "train_s": wall}

    # ---- (d) the subgraph cache ----------------------------------------------
    root = os.path.join(work, "cache", "train")
    ckw = dict(kw, max_num=CACHE_PAIRS, root=root)
    links = (split.train_u_indices, split.train_v_indices)
    t0 = time.perf_counter()
    first = StaticGraphDataset(split.adj_train, links, split.train_labels, **ckw)
    build_s = time.perf_counter() - t0
    mib = os.path.getsize(first.cache_path) / 2**20
    t0 = time.perf_counter()
    again = StaticGraphDataset(split.adj_train, links, split.train_labels, **ckw)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    StaticGraphDataset(split.adj_train, links, split.train_labels,
                       **dict(ckw, root=None))
    extract_s = time.perf_counter() - t0
    for k in ("node_offsets", "edge_offsets", "node_label", "src", "dst", "etype",
              "num_u", "y"):
        a, b = getattr(first.packed, k), getattr(again.packed, k)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail(f"the subgraph cache's {k} did not load back equal")
    raw_mib = sum(getattr(first.packed, k).nbytes for k in
                  ("node_label", "src", "dst", "etype")) / 2**20
    print(f"[dynamic] subgraph cache of {CACHE_PAIRS} ML-1M training pairs "
          f"({os.path.basename(first.cache_path)}): extraction {extract_s:.2f} s, "
          f"extraction + save {build_s:.2f} s (save {build_s - extract_s:.2f} s), "
          f"load {load_s:.2f} s; {mib:.1f} MiB on disk for {raw_mib:.1f} MiB of "
          f"arrays; loaded arrays equal")
    out["cache"] = {"pairs": CACHE_PAIRS, "extract_s": extract_s,
                    "save_s": build_s - extract_s, "load_s": load_s, "mib": mib,
                    "raw_mib": raw_mib}

    # ---- (f) the CLI with --dynamic-dataset --profile-dir --------------------
    cwd = os.path.join(work, "dynamic_cli")
    os.makedirs(cwd)
    prof_dir = os.path.join(cwd, "prof")
    cmd = [sys.executable, "-m", "igmc_torch.cli.main", "--data-name", "ml_100k",
           "--testing", "--dynamic-dataset", "--epochs", "2", "--profile-dir",
           prof_dir]
    lines = _subprocess(cmd, raw_data, cwd, "cli dynamic")[0]
    trace = os.path.join(prof_dir, "epoch2.trace.json")
    size = os.path.getsize(trace) if os.path.isfile(trace) else 0
    if not size or f"torch.profiler trace of epoch 2 written to {prof_dir}" not in lines:
        fail(f"the dynamic CLI wrote no trace ({trace}: {size} bytes)")
    _check_log(cwd, "ml_100k", ["Epoch 1,", "Epoch 2,"], "cli dynamic")
    print(f"[cli dynamic] trace {os.path.basename(trace)}: {size / 2**20:.1f} MiB")
    out["cli_trace_mib"] = size / 2**20
    return out


def _cli_duration(lines, what):
    """(final RMSE, training seconds) from the CLI's "Final Test RMSE: x,
    Duration: y" line."""
    for line in lines:
        m = re.match(r"Final Test RMSE: (\S+), Duration: (\S+)", line)
        if m:
            return float(m.group(1)), float(m.group(2))
    fail(f"{what} printed no 'Final Test RMSE' line")


def monti_phase(dev, work, reset_counts, read_counts, expect):
    """Phase 19: the Monti fixtures. Each file read through
    igmc_torch.data.hdf5 (timed) and held against its .npz twin; the split
    (load_data_monti, timed), the C++ extraction of the pairs the CLI
    uses (timed) and their median node count; then the port CLI on the
    card in a subprocess (flixster --ensemble 2 epochs, yahoo_music R = 71
    1 epoch, douban cut to MONTI_CUT pairs 1 epoch), finite RMSEs in
    log.txt. Returns (numbers, flixster's (split, train, test) datasets)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_make_monti_fixtures import FILE, from_twin

    import scipy.sparse as sp
    from igmc_torch.batching import StaticGraphDataset
    from igmc_torch.data import load_data_monti, load_matlab_file

    numbers, flixster = {}, None
    raw_before = os.environ.get("IGMC_RAW_DATA", "")
    for name, (flags, epochs) in MONTI_CLI.items():
        path = os.path.join(MONTI_ROOT, name, FILE + ".mat")
        with np.load(os.path.join(MONTI_ROOT, name, FILE + ".npz")) as npz:
            twin = from_twin(npz)
        t0 = time.perf_counter()
        fields = {f: load_matlab_file(path, f) for f in twin}
        read_s = time.perf_counter() - t0
        for f, want in twin.items():
            got, want = fields[f], want.astype(np.float32)
            same = (got.shape == want.shape and got.dtype == np.float32
                    and (((got != want).nnz == 0) if sp.issparse(want)
                         else np.array_equal(got, want)))
            if not same or sp.issparse(got) != sp.issparse(want):
                fail(f"monti {name}: field {f} read through igmc_torch.data.hdf5 "
                     f"differs from the generator's .npz twin")
        os.environ["IGMC_RAW_DATA"] = MONTI_ROOT
        t0 = time.perf_counter()
        split = load_data_monti(name, testing=True)
        split_s = time.perf_counter() - t0
        max_train, max_test = MONTI_CUT.get(name, (None, None))
        kw = dict(h=1, class_values=split.class_values, backend="native")
        t0 = time.perf_counter()
        train_ds = StaticGraphDataset(split.adj_train, (split.train_u_indices,
                                                        split.train_v_indices),
                                      split.train_labels, max_num=max_train, **kw)
        test_ds = StaticGraphDataset(split.adj_train, (split.test_u_indices,
                                                       split.test_v_indices),
                                     split.test_labels, max_num=max_test, **kw)
        extract_s = time.perf_counter() - t0
        med = float(np.median(train_ds.node_counts()))
        med_test = float(np.median(test_ds.node_counts()))
        R = len(split.class_values)
        print(f"[monti] {name}: {len(twin)} fields read in {read_s:.3f} s, equal to "
              f"the .npz twin; split in {split_s:.3f} s ({len(split.train_labels)} "
              f"training + {len(split.test_labels)} test links, R = {R}); "
              f"{len(train_ds)} + {len(test_ds)} subgraphs extracted in "
              f"{extract_s:.3f} s (C++ engine); median nodes {med:.1f} (training), "
              f"{med_test:.1f} (test)", flush=True)
        cwd = os.path.join(work, f"monti_{name}")
        os.makedirs(cwd)
        cmd = [sys.executable, "-m", "igmc_torch.cli.main", "--data-name", name,
               "--testing"] + flags
        reset_counts()
        lines, _, cli_s = _subprocess(cmd, MONTI_ROOT, cwd, f"monti cli {name}")
        read_counts(f"monti_{name}")
        for want in ("batch mode: dense (auto)", "dense layout: unified (auto)"):
            if want not in lines:
                fail(f"the {name} CLI did not print {want!r}")
        rmse, train_s = _cli_duration(lines, f"the {name} CLI")
        heads = [f"Epoch {e}," for e in range(1, epochs + 1)]
        if "--ensemble" in flags:
            heads.append(f"Epoch ensemble of range({epochs - 30}, {epochs}, 10),")
        rmses = _check_log(cwd, name, heads, f"monti cli {name}")
        print(f"[monti] {name}: CLI {cli_s:.2f} s wall; {epochs} epoch(s) of training "
              f"and evaluation {train_s:.3f} s ({train_s / epochs:.3f} s per epoch, "
              f"the CLI's Duration); RMSEs {rmses}", flush=True)
        numbers[name] = {"read_s": read_s, "split_s": split_s, "extract_s": extract_s,
                         "train_graphs": len(train_ds), "test_graphs": len(test_ds),
                         "median_nodes": med, "median_nodes_test": med_test,
                         "relations": R, "cli_s": cli_s, "epoch_s": train_s / epochs,
                         "rmses": rmses}
        if name == "flixster":
            flixster = (split, train_ds, test_ds)
    os.environ["IGMC_RAW_DATA"] = raw_before
    return numbers, flixster


def _sort_order(model, batch, noise):
    """(SortPool's row order [B, k], the keys [B, n] with padding at -inf)
    of a DGCNN model on `batch` in training mode under `noise`."""
    import torch

    with torch.no_grad():
        keys = model.trunk(batch, noise[0])[..., -1]
    keys = torch.where(batch.node_mask, keys, torch.full_like(keys, -math.inf))
    order = torch.argsort(-keys, dim=1, stable=True)[:, :model.cfg.k]
    return order, keys


def _min_gap(keys) -> float:
    """The smallest nonzero gap between two finite keys of one graph."""
    k = keys.cpu().numpy()
    smallest = math.inf
    for row in k:
        gaps = np.diff(np.sort(row[np.isfinite(row)]))
        gaps = gaps[gaps > 0]
        if gaps.size:
            smallest = min(smallest, float(gaps.min()))
    return smallest


def families_phase(flixster, dev, work, reset_counts, read_counts, expect):
    """Phase 20: GNN, DGCNN and DGCNN_RS at the CLI's widths on the
    flixster fixture's static dense unified batches: a training step card
    vs CPU, one epoch of training and evaluation, the forward's kernel
    time, the step time and the busy share; then the CLI with --model
    dgcnn_rs. Returns the numbers it measured."""
    import torch
    from igmc_torch.batching import DeviceDataset
    from igmc_torch.models import (DGCNNConfig, GNNConfig, draw_noise,
                                   sortpool_k_from_dataset)
    from igmc_torch.train import (DensePass, make_optimizer, make_train_step,
                                  plan_buckets, train_multiple_epochs)

    split, train_ds, test_ds = flixster
    R = len(split.class_values)
    k = sortpool_k_from_dataset(train_ds.node_counts(), 0.6)
    configs = {
        "gnn": GNNConfig(num_features=4),
        "dgcnn": DGCNNConfig(num_features=4, latent_dim=(32, 32, 32, 1), k=k,
                             num_relations=R, num_bases=4),
        "dgcnn_rs": DGCNNConfig(num_features=4, latent_dim=(32, 32, 32, 1), k=k,
                                relational=True, num_relations=R, num_bases=4),
    }
    dd_train = DeviceDataset(train_ds.packed, dev)
    dd_test = DeviceDataset(test_ds.packed, dev)
    tr_pass = DensePass.plan(plan_buckets(train_ds, "unified"), BATCH_SIZE, 8, dev,
                             np.random.default_rng(1))
    te_pass = DensePass.plan(plan_buckets(test_ds, "unified"), BATCH_SIZE, 8, dev)
    train_batches = [b for _, b in zip(range(FAMILY_STEPS), tr_pass.batches(dd_train))]
    test_batches = list(te_pass.batches(dd_test))
    print(f"[families] flixster: {len(train_ds)} training + {len(test_ds)} test "
          f"graphs, unified slots {[(b.node_slot, b.edge_slot) for b in tr_pass.buckets]}, "
          f"SortPool k {k} (60th percentile of the training graphs' node counts)")
    numbers = {"k": k}
    for name, cfg in configs.items():
        out = numbers[name] = {}
        # card vs CPU. DGCNN's SortPool ranks rows by keys the card and the
        # CPU agree on only to ~1e-7, so two rows closer than that may swap
        # and change the loss by far more: the keys are held to KEY_ATOL on
        # every batch scanned, and the step on the first batch whose pooled
        # row order is the same on both
        noise = draw_noise(torch.Generator().manual_seed(9), BATCH_SIZE)
        pick, gap, key_diff, swapped = 0, math.inf, 0.0, []
        if name != "gnn":
            cpu_model = family_model(cfg, torch.Generator().manual_seed(5)).train()
            card_model = family_model(cfg, torch.Generator().manual_seed(5)).to(dev)
            card_model.train()
            card_noise = (noise[0], noise[1].to(dev))
            for pick, b in enumerate(train_batches):
                o_card, k_card = _sort_order(card_model, b, card_noise)
                o_cpu, k_cpu = _sort_order(cpu_model, b.to("cpu"), noise)
                live = torch.isfinite(k_cpu)
                key_diff = max(key_diff, float((k_card.cpu() - k_cpu)[live].abs().max()))
                if key_diff > KEY_ATOL:
                    fail(f"families {name}: SortPool keys on the card differ from the "
                         f"CPU's by {key_diff:.3e} on batch {pick}")
                if torch.equal(o_card.cpu(), o_cpu):
                    gap = _min_gap(k_cpu)
                    break
                swapped.append(_min_gap(k_cpu))
            else:
                fail(f"families {name}: the pooled row order differs between the card "
                     f"and the CPU on all {len(train_batches)} batches")
        print(f"[families] {name}: card vs CPU on training batch {pick}"
              + (f" ({len(swapped)} earlier batches pooled rows in another order, "
                 f"smallest key gaps {['%.1e' % g for g in swapped]}; keys within "
                 f"{key_diff:.3e}; this batch's smallest gap {gap:.3e})"
                 if name != "gnn" else ""))
        loss_rel, worst = card_vs_cpu_step(cfg, train_batches[pick].to("cpu"),
                                           f"families {name}, card vs CPU")
        # one epoch of training and evaluation through the loop
        reset_counts()
        t0 = time.perf_counter()
        rmse, state = train_multiple_epochs(
            train_ds, test_ds, family_model(cfg, torch.Generator().manual_seed(3)),
            epochs=1, batch_size=BATCH_SIZE, lr=1e-3, lr_decay_factor=0.1,
            lr_decay_step_size=50, ARR=0.001, batch_mode="dense",
            dense_layout="unified", seed=1, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        read_counts(f"family_{name}")
        expect(f"family_{name}", "rgcn_aggregate_fwd", 0)
        expect(f"family_{name}", "rgcn_aggregate_bwd", 0)
        if not math.isfinite(rmse):
            fail(f"families {name}: the epoch's test RMSE is {rmse}")
        h = state.history[0]
        # the forward: CUDA events and kernels per test batch
        model = state.model.eval()

        def forward_all():
            with torch.no_grad():
                for b in test_batches:
                    model(b)

        fwd_ms = cuda_ms(forward_all, 2, warmup=1) / len(test_batches)
        _, busy_fwd, _ = profile(forward_all, f"{name} forward",
                                 f"{len(test_batches)} batches")
        # the step: CUDA events, then the profiler's busy share
        gen = torch.Generator().manual_seed(4)
        noises = [(s_, kp.to(dev)) for s_, kp in
                  (draw_noise(gen, BATCH_SIZE) for _ in train_batches)]
        m = family_model(cfg, torch.Generator().manual_seed(3)).to(dev).train()
        step = make_train_step(m, make_optimizer(m.parameters(), 1e-3), 0.001)

        def steps_all():
            for b, nz in zip(train_batches, noises):
                step(b, nz)

        step_ms = cuda_ms(steps_all, 1, warmup=1) / len(train_batches)
        _, busy_step, window = profile(steps_all, f"{name} training steps",
                                       f"{len(train_batches)} steps")
        out.update({"card_vs_cpu_batch": pick, "sortpool_gap": gap,
                    "key_diff": key_diff, "order_swaps": len(swapped),
                    "loss_rel_diff": loss_rel, "grad_worst": worst,
                    "epoch_s": h["seconds"], "host_s": h["host_seconds"],
                    "train_wall_s": wall, "rmse": rmse,
                    "forward_ms": fwd_ms,
                    "forward_kernel_ms": busy_fwd / len(test_batches),
                    "step_ms": step_ms,
                    "step_kernel_ms": busy_step / len(train_batches),
                    "step_busy_share": busy_step / window})
        print(f"[families] {name}: 1 epoch ({len(train_ds)} graphs) {h['seconds']:.3f} s "
              f"wall (epoch plan {h['host_seconds']:.3f} s), test RMSE {rmse:.6f}; "
              f"forward {fwd_ms:.4f} ms per batch (CUDA events), "
              f"{busy_fwd / len(test_batches):.4f} ms of kernels (profiler); step "
              f"{step_ms:.4f} ms (CUDA events), {busy_step / len(train_batches):.4f} "
              f"ms of kernels, busy share {busy_step / window:.3f}", flush=True)
    cwd = os.path.join(work, "families_cli")
    os.makedirs(cwd)
    cmd = [sys.executable, "-m", "igmc_torch.cli.main", "--data-name", "flixster",
           "--testing", "--model", "dgcnn_rs", "--epochs", "1"]
    reset_counts()
    lines, _, cli_s = _subprocess(cmd, MONTI_ROOT, cwd, "families cli")
    read_counts("families_cli")
    params = [l for l in lines if l.startswith("Total number of parameters is ")]
    if not params or "dense layout: unified (auto)" not in lines:
        fail(f"the dgcnn_rs CLI printed {lines[-12:]}")
    rmses = _check_log(cwd, "flixster", ["Epoch 1,"], "families cli")
    numbers["cli"] = {"wall_s": cli_s, "rmse": rmses[0], "params": params[0]}
    print(f"[families] CLI --model dgcnn_rs: {params[0]}; {cli_s:.2f} s wall")
    return numbers


def _flat_sort_order(model, batch, noise):
    """(SortPool's row order [N] on a flat batch: graph by graph, keys
    descending, padding last; the keys [N] with padding at -inf) of a
    DGCNN model in training mode under `noise`."""
    import torch

    with torch.no_grad():
        keys = model.trunk(batch, noise[0])[:, -1]
    keys = torch.where(batch.node_mask, keys, torch.full_like(keys, -math.inf))
    gid = torch.where(batch.node_mask, batch.node2graph.long(), batch.num_graphs)
    by_key = torch.argsort(-keys, stable=True)
    return by_key[torch.argsort(gid[by_key], stable=True)], keys


def _flat_min_gap(keys, batch) -> float:
    """The smallest nonzero gap between two keys of one graph of a flat batch."""
    k = keys.cpu().numpy()
    n2g = batch.node2graph.cpu().numpy()
    smallest = math.inf
    for g in np.unique(n2g[np.isfinite(k)]):
        gaps = np.diff(np.sort(k[(n2g == g) & np.isfinite(k)]))
        gaps = gaps[gaps > 0]
        if gaps.size:
            smallest = min(smallest, float(gaps.min()))
    return smallest


def _timed_passes(model, train_batches, test_batches, dev, label):
    """The forward's ms per test batch (CUDA events) and ms of kernels
    (profiler, which also prints them by name), the training step's ms
    (CUDA events), ms of kernels and busy share, over device-resident
    batches."""
    import torch
    from igmc_torch.models import draw_noise
    from igmc_torch.train import make_optimizer, make_train_step

    model.eval()

    def forward_all():
        with torch.no_grad():
            for b in test_batches:
                model(b)

    fwd_ms = cuda_ms(forward_all, 2, warmup=1) / len(test_batches)
    _, busy_fwd, _ = profile(forward_all, f"{label} forward",
                             f"{len(test_batches)} batches")
    gen = torch.Generator().manual_seed(4)
    noises = [(s, k.to(dev)) for s, k in
              (draw_noise(gen, b.num_graphs) for b in train_batches)]
    model.train()
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-3), 0.001)

    def steps_all():
        for b, nz in zip(train_batches, noises):
            step(b, nz)

    step_ms = cuda_ms(steps_all, 1, warmup=1) / len(train_batches)
    _, busy_step, window = profile(steps_all, f"{label} training steps",
                                   f"{len(train_batches)} steps")
    return {"forward_ms": fwd_ms, "forward_kernel_ms": busy_fwd / len(test_batches),
            "step_ms": step_ms, "step_kernel_ms": busy_step / len(train_batches),
            "step_busy_share": busy_step / window}


def _flat_train(model, train_ds, test_ds, epochs, label, **kw):
    """train_multiple_epochs on the flat layout on the card; fails unless
    every loss and RMSE is finite. Returns (infos, state, wall seconds)."""
    import torch
    from igmc_torch.train import train_multiple_epochs

    infos = []
    t0 = time.perf_counter()
    _, state = train_multiple_epochs(
        train_ds, test_ds, model, epochs=epochs, batch_size=BATCH_SIZE, lr=1e-3,
        lr_decay_factor=0.1, lr_decay_step_size=50, ARR=0.001, seed=1,
        batch_mode="flat", device="cuda", logger=lambda i, s: infos.append(dict(i)),
        **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals = [v for i in infos for v in (i["train_loss"], i["test_rmse"])]
    if len(infos) != epochs or not all(math.isfinite(v) for v in vals):
        fail(f"{label}: flat training gave {infos}")
    for info, h in zip(infos, state.history):
        print(f"[flat] {label}: epoch {info['epoch']}: train loss "
              f"{info['train_loss']:.6f}, test rmse {info['test_rmse']:.6f}; "
              f"{h['seconds']:.3f} s wall (host {h['host_seconds']:.3f} s)")
    return infos, state, wall


def flat_engines_phase(split, cfg, train_ds, test_ds, flixster, dev, raw_data, work,
                       reset_counts, read_counts, expect):
    """Phase 21: the flat segment and blocked engines at full width, K1 and
    K2 launching 0 times. ML-1M (phase 6's pairs): segment training
    device-resident for 2 epochs, test_once's RMSE recomputed from the
    card's predictions, forward and step times, a card-vs-CPU step per
    conv_strategy and for relmean; the blocked engine for 1 epoch, a
    batch's host planning, forward and step times and a card-vs-CPU step
    with dropout on; yahoo_music (R 71) for 1 epoch with
    conv_strategy auto; GNN, DGCNN and DGCNN_RS on flixster's flat batches
    (a card-vs-CPU step, an epoch each); the CLI on ml_100k with the flat
    engines (FLAT_CLI). Returns the numbers it measured."""
    from dataclasses import replace

    import torch
    from igmc_torch.batching import BatchLoader, DeviceDataset, StaticGraphDataset
    from igmc_torch.data import load_data_monti
    from igmc_torch.models import (IGMC, DGCNNConfig, GNNConfig, draw_noise,
                                   sortpool_k_from_dataset)
    from igmc_torch.models.rgcn import conv_strategy_for
    from igmc_torch.train import FlatPass, dense_predict_all, make_eval_step, test_once

    out = {"seconds": {}}
    seg = replace(cfg, flat_aggregate="segment")
    t_part = [time.perf_counter()]

    def part(name):
        """Record and print the seconds since the last part ended."""
        now = time.perf_counter()
        out["seconds"][name] = now - t_part[0]
        print(f"[flat] part {name}: {now - t_part[0]:.2f} s", flush=True)
        t_part[0] = now

    reset_counts()

    # (a) ML-1M on the segment engine, device-resident
    infos, state, wall = _flat_train(IGMC(seg, torch.Generator().manual_seed(3)),
                                     train_ds, test_ds, EPOCHS, "ML-1M segment")
    losses = [i["train_loss"] for i in infos]
    if not losses[1] < losses[0]:
        fail(f"flat segment: epoch 2's train loss {losses[1]} is not below "
             f"epoch 1's {losses[0]}")
    model = state.model
    t_rmse = test_once(test_ds, model, BATCH_SIZE, device="cuda")
    dd_test = DeviceDataset(test_ds.packed, dev)
    te_pass = FlatPass.plan(test_ds, BATCH_SIZE, 8, dev)
    preds = dense_predict_all(make_eval_step(model.eval()), dd_test, te_pass)
    ys = np.asarray(test_ds.packed.y, np.float32)
    if preds.shape != ys.shape or not np.isfinite(preds).all():
        fail(f"flat segment: predictions of shape {preds.shape} or not finite")
    again = math.sqrt(float(np.mean((preds - ys) ** 2)))
    if abs(again - t_rmse) > 1e-5 or abs(t_rmse - infos[-1]["test_rmse"]) > 1e-5:
        fail(f"flat segment: test_once RMSE {t_rmse}, recomputed {again}, "
             f"training's last {infos[-1]['test_rmse']}")
    print(f"[flat] ML-1M segment: {EPOCHS} epochs device-resident in {wall:.2f} s "
          f"wall; test_once RMSE {t_rmse:.6f}, recomputed from the card's "
          f"predictions {again:.6f}; pads (nodes, directed edges) "
          f"({te_pass.node_pad}, {te_pass.edge_pad})", flush=True)
    dd_train = DeviceDataset(train_ds.packed, dev)
    order = np.random.default_rng(1).permutation(len(train_ds))
    tr_pass = FlatPass.plan(train_ds, BATCH_SIZE, 8, dev, order)
    train_batches = list(tr_pass.batches(dd_train))
    test_batches = list(te_pass.batches(dd_test))
    b0 = train_batches[0]
    out["ml1m_segment"] = {"epoch_s": [h["seconds"] for h in state.history],
                           "host_s": [h["host_seconds"] for h in state.history],
                           "train_wall_s": wall, "rmse": t_rmse,
                           "strategy_auto": conv_strategy_for(
                               "auto", b0.num_edges, b0.num_nodes, seg.num_relations),
                           **_timed_passes(IGMC(seg, torch.Generator().manual_seed(3))
                                           .to(dev), train_batches, test_batches, dev,
                                           "flat segment")}
    o = out["ml1m_segment"]
    print(f"[flat] ML-1M segment (auto = {o['strategy_auto']}): forward "
          f"{o['forward_ms']:.4f} ms per batch (CUDA events), "
          f"{o['forward_kernel_ms']:.4f} ms of kernels; step {o['step_ms']:.4f} ms, "
          f"{o['step_kernel_ms']:.4f} ms of kernels, busy share "
          f"{o['step_busy_share']:.3f}", flush=True)
    part("segment training and timing")
    b0_cpu = b0.to("cpu")
    for strategy in ("dispatch", "basis-mix", "per-edge"):
        o[f"card_vs_cpu_{strategy}"] = card_vs_cpu_step(
            replace(seg, conv_strategy=strategy), b0_cpu, f"flat segment {strategy}")
        part(f"segment card vs CPU, {strategy}")
    o["card_vs_cpu_relmean"] = card_vs_cpu_step(replace(seg, aggr="relmean"), b0_cpu,
                                                "flat segment relmean")
    part("segment card vs CPU, relmean")

    # (b) ML-1M on the blocked engine
    blk = replace(cfg, flat_aggregate="blocked")
    infos, state, wall = _flat_train(IGMC(blk, torch.Generator().manual_seed(3)),
                                     train_ds, test_ds, 1, "ML-1M blocked",
                                     flat_aggregate="blocked")
    part("blocked epoch")
    loader = BatchLoader(train_ds, BATCH_SIZE, shuffle=True, seed=1,
                         flat_aggregate="blocked")
    loader.epoch = 1
    bb = next(iter(loader))
    # the host's part of a blocked batch (collate + both plans), and the
    # device's over BLOCKED_BATCHES batches already on the card
    t0 = time.perf_counter()
    loader.make_batch(order[:BATCH_SIZE])
    plan_ms = 1e3 * (time.perf_counter() - t0)
    chunks = [order[s:s + BATCH_SIZE] for s in range(
        0, min(BLOCKED_BATCHES * BATCH_SIZE, len(order)), BATCH_SIZE)]
    test_loader = BatchLoader(test_ds, BATCH_SIZE, flat_aggregate="blocked")
    timed = _timed_passes(IGMC(blk, torch.Generator().manual_seed(3)).to(dev),
                          [loader.make_batch(c).to(dev) for c in chunks],
                          [test_loader.make_batch(c).to(dev) for c in chunks], dev,
                          "flat blocked")
    out["ml1m_blocked"] = {"epoch_s": state.history[0]["seconds"],
                           "host_s": state.history[0]["host_seconds"],
                           "rmse": infos[0]["test_rmse"],
                           "blocks": int(bb.blocked.fwd.chunk.shape[0]),
                           "host_batch_ms": plan_ms, **timed}
    part("blocked timing")
    out["ml1m_blocked"]["card_vs_cpu"] = card_vs_cpu_step(blk, bb, "flat blocked")
    part("blocked card vs CPU")
    o = out["ml1m_blocked"]
    print(f"[flat] ML-1M blocked ({o['blocks']} blocks per plan): a batch's host "
          f"collation + both plans {plan_ms:.1f} ms; forward {o['forward_ms']:.4f} ms "
          f"per batch (CUDA events), {o['forward_kernel_ms']:.4f} ms of kernels; step "
          f"{o['step_ms']:.4f} ms, {o['step_kernel_ms']:.4f} ms of kernels, busy "
          f"share {o['step_busy_share']:.3f}", flush=True)

    # (c) yahoo_music (R 71), segment engine, conv_strategy auto
    raw_before = os.environ.get("IGMC_RAW_DATA", "")
    os.environ["IGMC_RAW_DATA"] = MONTI_ROOT
    ysplit = load_data_monti("yahoo_music", testing=True)
    os.environ["IGMC_RAW_DATA"] = raw_before
    kw = dict(h=1, class_values=ysplit.class_values, backend="native")
    ytrain = StaticGraphDataset(ysplit.adj_train, (ysplit.train_u_indices,
                                                   ysplit.train_v_indices),
                                ysplit.train_labels, **kw)
    ytest = StaticGraphDataset(ysplit.adj_train, (ysplit.test_u_indices,
                                                  ysplit.test_v_indices),
                               ysplit.test_labels, **kw)
    R = len(ysplit.class_values)
    ycfg = replace(seg, num_relations=R)
    infos, state, wall = _flat_train(IGMC(ycfg, torch.Generator().manual_seed(3)),
                                     ytrain, ytest, 1, f"yahoo_music R {R}")
    yb = next(FlatPass.plan(ytrain, BATCH_SIZE, 8, dev).batches(
        DeviceDataset(ytrain.packed, dev)))
    chose = conv_strategy_for("auto", yb.num_edges, yb.num_nodes, R)
    print(f"[flat] yahoo_music: {len(ytrain)} + {len(ytest)} pairs, R {R}: auto "
          f"chose {chose} (E {yb.num_edges} < N {yb.num_nodes} x R / 4 = "
          f"{yb.num_nodes * R // 4}: {yb.num_edges < yb.num_nodes * R // 4})")
    part("yahoo_music")
    out["yahoo_segment"] = {"pairs": [len(ytrain), len(ytest)], "relations": R,
                            "strategy_auto": chose, "epoch_s": state.history[0]["seconds"],
                            "rmse": infos[0]["test_rmse"]}

    # (d) the families' flat forms on flixster
    fsplit, ftrain, ftest = flixster
    fR = len(fsplit.class_values)
    k = sortpool_k_from_dataset(ftrain.node_counts(), 0.6)
    configs = {
        "gnn": GNNConfig(num_features=4),
        "dgcnn": DGCNNConfig(num_features=4, latent_dim=(32, 32, 32, 1), k=k,
                             num_relations=fR, num_bases=4),
        "dgcnn_rs": DGCNNConfig(num_features=4, latent_dim=(32, 32, 32, 1), k=k,
                                relational=True, num_relations=fR, num_bases=4),
    }
    fdd = DeviceDataset(ftrain.packed, dev)
    fbatches = [b for _, b in zip(range(FAMILY_STEPS), FlatPass.plan(
        ftrain, BATCH_SIZE, 8, dev, np.random.default_rng(1).permutation(
            len(ftrain))).batches(fdd))]
    fam = out["families"] = {}
    for name, fcfg in configs.items():
        noise = draw_noise(torch.Generator().manual_seed(9), BATCH_SIZE)
        pick, swapped = 0, []
        if name != "gnn":
            cpu_model = family_model(fcfg, torch.Generator().manual_seed(5)).train()
            card_model = family_model(fcfg, torch.Generator().manual_seed(5)).to(dev)
            card_model.train()
            for pick, b in enumerate(fbatches):
                o_card, k_card = _flat_sort_order(card_model, b, (noise[0], noise[1].to(dev)))
                o_cpu, k_cpu = _flat_sort_order(cpu_model, b.to("cpu"), noise)
                live = torch.isfinite(k_cpu)
                diff = float((k_card.cpu() - k_cpu)[live].abs().max())
                if diff > KEY_ATOL:
                    fail(f"flat {name}: SortPool keys on the card differ from the "
                         f"CPU's by {diff:.3e} on batch {pick}")
                if torch.equal(o_card.cpu(), o_cpu):
                    break
                swapped.append(_flat_min_gap(k_cpu, b))
            else:
                fail(f"flat {name}: the pooled row order differs between the card "
                     f"and the CPU on all {len(fbatches)} batches")
        loss_rel, worst = card_vs_cpu_step(fcfg, fbatches[pick].to("cpu"),
                                           f"flat {name} (batch {pick}, "
                                           f"{len(swapped)} earlier order swaps)")
        infos, state, wall = _flat_train(
            family_model(fcfg, torch.Generator().manual_seed(3)), ftrain, ftest, 1,
            f"flixster {name}")
        fam[name] = {"card_vs_cpu_batch": pick, "order_swaps": len(swapped),
                     "loss_rel_diff": loss_rel, "grad_worst": worst,
                     "epoch_s": state.history[0]["seconds"],
                     "rmse": infos[0]["test_rmse"]}
        part(f"family {name}")

    # (e) the CLI on ml_100k with the flat engines
    cli = out["cli"] = {}
    for tag, (flags, epochs) in FLAT_CLI.items():
        cwd = os.path.join(work, f"flat_cli_{tag}")
        os.makedirs(cwd)
        cmd = ([sys.executable, "-m", "igmc_torch.cli.main", "--data-name", "ml_100k",
                "--testing"] + flags)
        lines, _, cli_s = _subprocess(cmd, raw_data, cwd, f"flat cli {tag}")
        rmse, train_s = _cli_duration(lines, f"the flat {tag} CLI")
        rmses = _check_log(cwd, "ml_100k", [f"Epoch {e}," for e in range(1, epochs + 1)],
                           f"flat cli {tag}")
        cli[tag] = {"wall_s": cli_s, "epoch_s": train_s / epochs, "rmses": rmses}
        part(f"cli {tag}")
    read_counts("flat_engines")
    expect("flat_engines", "rgcn_aggregate_fwd", 0)
    expect("flat_engines", "rgcn_aggregate_bwd", 0)
    return out



def _grads(model) -> dict:
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _compare_steps(label, got, want, loss_rtol=1e-5, grad_tol=GRAD_TOL):
    """`got` and `want` = (loss, gradients by name): fail unless the loss
    agrees to loss_rtol and every gradient to grad_tol of its largest
    entry (phase 7's tolerances). Returns (loss relative difference, worst
    gradient difference over its largest entry)."""
    (lg, gg), (lw, gw) = got, want
    rel = abs(lg - lw) / max(abs(lw), 1e-30)
    if rel > loss_rtol:
        fail(f"{label}: loss {lg} != {lw} (rtol {loss_rtol})")
    worst = 0.0
    for k, w in gw.items():
        d = float((gg[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, d)
        if d > grad_tol:
            fail(f"{label}: gradient of {k} differs by {d:.3e} of its largest entry")
    print(f"[multi] {label}: loss {lg:.6f} vs {lw:.6f} (rel {rel:.3e}); worst "
          f"gradient difference {worst:.3e} of its largest entry", flush=True)
    return rel, worst


def _dense_row(train_ds, dev):
    """(DeviceDataset, the first bipartite row's assemble, the row) of the
    training set on `dev`."""
    from igmc_torch.batching import DeviceDataset
    from igmc_torch.train import DensePass, plan_buckets

    dd = DeviceDataset(train_ds.packed, dev)
    rows = DensePass.plan(plan_buckets(train_ds, "bipartite"), BATCH_SIZE, 1, dev)
    return (lambda g: rows.assemble(dd, rows.bucket_of[0], g)), rows.gids[0]


def _giant_batch(test_ds, D):
    """The first EP_GRAPHS held-out graphs collated flat, node pad a
    multiple of 8 * D (build_ep_batches' quantum)."""
    from igmc_torch.batching.batch import collate

    graphs = [test_ds.get(i) for i in range(EP_GRAPHS)]
    q = 8 * D
    node_pad = -(-sum(g.num_nodes for g in graphs) // q) * q
    edge_pad = -(-sum(g.num_edges for g in graphs) // 8) * 8
    return collate(graphs, EP_GRAPHS, node_pad, edge_pad)


def _ep_forward_check(label, model, batch, mesh):
    """The EP forward of `batch` over the mesh against the flat segment
    forward (EP_TOL); returns (max abs error, EP forward ms by CUDA events,
    the EPBatch, this rank's shard)."""
    import torch
    from igmc_torch.parallel import ep

    epb = ep.partition_batch(batch, mesh.size)
    shard = ep.ep_shard(epb, mesh.rank, mesh.device)
    with torch.no_grad():
        got = mesh.all_gather(ep.ep_forward(model, shard, mesh)).cpu()
        want = model(batch.to(mesh.device)).cpu()
        ms = cuda_ms(lambda: ep.ep_forward(model, shard, mesh), 5)
    err = float((got - want).abs().max())
    try:
        torch.testing.assert_close(got, want, rtol=EP_TOL, atol=EP_TOL)
    except AssertionError as e:
        fail(f"{label}: the EP forward disagrees with the flat forward: {e}")
    print(f"[multi] {label}: EP forward of {batch.num_graphs} graphs ({batch.num_nodes} "
          f"node rows, {int(batch.edge_mask.sum())} directed edges) over "
          f"{mesh.size} rank(s) vs the flat segment forward: max abs diff "
          f"{err:.3e} (rtol/atol {EP_TOL}); {ms:.3f} ms per forward", flush=True)
    return err, ms, epb, shard


def _world1(mesh, spec):
    """Phase 22 at world size 1 (this process, NCCL): the dense DP step
    equals the plain step bit for bit; step and all_reduce times; EP at one
    rank equals the flat segment forward."""
    import torch
    from igmc_torch.models import IGMC, draw_noise
    from igmc_torch.train import make_dense_row_step, make_dp_row_step, make_optimizer

    if mesh.backend != "nccl":
        fail(f"world size 1 on the card ran over {mesh.backend}, not nccl")
    cfg, dev = spec["cfg"], mesh.device
    assemble, row = _dense_row(spec["train"], dev)
    seed, keep = draw_noise(torch.Generator().manual_seed(9), BATCH_SIZE)
    noise = (seed, keep.to(dev))
    models, losses = [], []
    # scatters made deterministic so that the two steps are the same
    # arithmetic (index_add's atomics sum in a varying order)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for make in (lambda m, o: make_dense_row_step(m, o, 0, 0.001),
                     lambda m, o: make_dp_row_step(m, o, mesh, 0.001)):
            m = IGMC(cfg, torch.Generator().manual_seed(5)).to(dev).train()
            step = make(m, make_optimizer(m.parameters(), 1e-3))
            losses.append(step(assemble, row, noise)[0])
            models.append((m, step))
    finally:
        torch.use_deterministic_algorithms(False)
    diffs = {k: float((a - b).detach().abs().max()) for (k, a), b in
             zip(models[0][0].named_parameters(), models[1][0].parameters())}
    if not (torch.equal(losses[0], losses[1]) and not any(diffs.values())):
        fail(f"world size 1: the dense DP step is not the plain step bit for bit: "
             f"loss {float(losses[0])!r} vs {float(losses[1])!r}, parameters "
             f"{ {k: v for k, v in diffs.items() if v} }")
    print(f"[multi] world 1 (nccl): with deterministic scatters the dense DP step "
          f"equals the plain step bit for bit (loss {float(losses[0]):.6f}, every "
          f"parameter after Adam)", flush=True)
    dp_step = models[1][1]
    out = {"dp_step_ms": cuda_ms(lambda: dp_step(assemble, row, noise), DP_TIMED)}
    bucket = torch.zeros(sum(p.numel() for p in models[1][0].parameters()) + 1,
                         device=dev)
    out["all_reduce_ms"] = cuda_ms(lambda: mesh.all_reduce(bucket), DP_TIMED)
    model = IGMC(cfg, torch.Generator().manual_seed(5)).to(dev).eval()
    out["ep_err"], out["ep_fwd_ms"], _, _ = _ep_forward_check(
        "world 1", model, _giant_batch(spec["test"], 1), mesh)
    return out


def _world2(mesh, spec):
    """Phase 22 on one rank of the two-rank group sharing the card (gloo):
    the checks of multi_device_phase; returns this rank's numbers."""
    import numpy as np
    import torch
    from igmc_torch.batching import DeviceDataset
    from igmc_torch.batching.batch import collate, pad_ladder
    from igmc_torch.kernels.rgcn_aggregate import rgcn_aggregate, rgcn_aggregate_bwd
    from igmc_torch.models import IGMC, draw_noise
    from igmc_torch.parallel import dp, ep
    from igmc_torch.serve import Predictor
    from igmc_torch.train import (DensePass, dense_eval_rmse, make_dense_row_step,
                                  make_dp_row_step, make_eval_step, make_optimizer,
                                  make_train_step, plan_buckets, train_multiple_epochs)

    cfg, dev, r = spec["cfg"], mesh.device, mesh.rank
    train_ds, test_ds = spec["train"], spec["test"]
    out = {"rank": r, "backend": mesh.backend, "device": str(dev)}
    new = lambda: IGMC(cfg, torch.Generator().manual_seed(5)).to(dev).train()
    noise_cpu = draw_noise(torch.Generator().manual_seed(9), BATCH_SIZE)
    noise = (noise_cpu[0], noise_cpu[1].to(dev))

    # the dense DP step against the single-device step on one gid row
    assemble, row = _dense_row(train_ds, dev)
    m1 = new()
    l1, _ = make_dense_row_step(m1, make_optimizer(m1.parameters(), 1e-3), 0,
                                0.001)(assemble, row, noise)
    m2 = new()
    dp_step = make_dp_row_step(m2, make_optimizer(m2.parameters(), 1e-3), mesh, 0.001)
    l2, _ = dp_step(assemble, row, noise)
    out["dense_step"] = _compare_steps(f"rank {r}: dense DP step vs single-device",
                                       (float(l2), _grads(m2)), (float(l1), _grads(m1)))
    out["dp_step_ms"] = cuda_ms(lambda: dp_step(assemble, row, noise), DP_TIMED)
    bucket = torch.zeros(sum(p.numel() for p in m2.parameters()) + 1, device=dev)
    out["all_reduce_ms"] = cuda_ms(lambda: mesh.all_reduce(bucket), DP_TIMED)

    # one dense-DP epoch on the bipartite layout; the DP RMSE against the
    # single-device RMSE of the same parameters
    t0 = time.perf_counter()
    rmse, state = train_multiple_epochs(
        train_ds, test_ds, new(), epochs=1, batch_size=BATCH_SIZE, lr=1e-3,
        lr_decay_factor=0.1, lr_decay_step_size=50, ARR=0.001, seed=1,
        batch_mode="dense", dense_layout="bipartite", mesh=mesh)
    torch.cuda.synchronize()
    out["epoch_s"] = time.perf_counter() - t0
    out["dp_rmse"] = rmse
    out["params"] = torch.cat([p.detach().reshape(-1) for p in
                               state.model.parameters()]).cpu().numpy()
    if r == 0:
        test_pass = DensePass.plan(plan_buckets(test_ds, "bipartite"), BATCH_SIZE, 8, dev)
        out["single_rmse"] = dense_eval_rmse(make_eval_step(state.model.eval()),
                                             DeviceDataset(test_ds.packed, dev), test_pass)
        if abs(out["single_rmse"] - rmse) > 1e-5:
            fail(f"the DP test RMSE {rmse} != the single-device RMSE "
                 f"{out['single_rmse']} of the same parameters")

    # one flat-DP (segment) step against the single-device step
    idx = np.arange(BATCH_SIZE)
    graphs = [train_ds.get(int(i)) for i in idx]
    nl = pad_ladder(sum(g.num_nodes for g in graphs))
    el = pad_ladder(sum(g.num_edges for g in graphs), base=128)
    offs = train_ds.packed.edge_offsets
    whole = collate(graphs, BATCH_SIZE, nl[-1], el[-1], gids=idx, edge_offsets=offs)
    part = dp.split_for_devices(graphs, mesh.size, BATCH_SIZE // mesh.size, nl, el,
                                gids=idx, edge_offsets=offs)[r]
    m1, m2 = new(), new()
    l1, _ = make_train_step(m1, make_optimizer(m1.parameters(), 1e-3), 0.001)(
        whole.to(dev), noise)
    l2, _ = dp.make_dp_train_step(m2, make_optimizer(m2.parameters(), 1e-3), mesh,
                                  0.001)(part.to(dev), dp.rank_noise(mesh, noise,
                                                                      BATCH_SIZE))
    out["flat_step"] = _compare_steps(f"rank {r}: flat DP step vs single-device",
                                      (float(l2), _grads(m2)), (float(l1), _grads(m1)))

    # Predictor(mesh=) on the held-out pairs against the single-device one
    kw = dict(h=1, max_nodes_per_hop=100, batch_size=BATCH_SIZE, backend="native")
    us, vs = spec["pairs"]
    pm = Predictor(spec["adj"], spec["class_values"], cfg, checkpoints=spec["ckpts"],
                   mesh=mesh, **kw)
    t0 = time.perf_counter()
    got = pm.predict(us, vs)
    out["serve_s"] = time.perf_counter() - t0
    if r == 0:
        want = Predictor(spec["adj"], spec["class_values"], cfg,
                         checkpoints=spec["ckpts"], device=str(dev), **kw).predict(us, vs)
        out["serve_diff"] = float(np.abs(got - want).max())
        if not out["serve_diff"] <= SERVE_ATOL:
            fail(f"Predictor(mesh=) differs from Predictor by {out['serve_diff']}")

    # EP on a giant batch: the forward against the flat forward, one train
    # step per local aggregate, the two within phase 7's tolerances
    batch = _giant_batch(test_ds, mesh.size)
    out["ep_err"], out["ep_fwd_ms"], epb, shard = _ep_forward_check(
        f"rank {r}", new().eval(), batch, mesh)
    out["comm"] = ep.comm_stats(epb)
    t0 = time.perf_counter()
    plans = ep.build_ep_blocked(epb).shard(r, dev)
    out["blocked_plan_s"] = time.perf_counter() - t0
    steps = {}
    for name, pl in (("segment", None), ("blocked", plans)):
        m = new()
        st = ep.make_ep_train_step(m, make_optimizer(m.parameters(), 1e-3), mesh, 0.001)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = st(shard, 7, pl)
        torch.cuda.synchronize()
        steps[name] = (float(loss), _grads(m))
        out[f"ep_{name}_step_ms"] = 1e3 * (time.perf_counter() - t0)
    out["ep_step"] = _compare_steps(f"rank {r}: EP step blocked vs segment",
                                    steps["blocked"], steps["segment"])
    out["launches"] = {"rgcn_aggregate_fwd": rgcn_aggregate.launches,
                       "rgcn_aggregate_bwd": rgcn_aggregate_bwd.launches}
    return out


def multi_device_phase(split, cfg, train_ds, test_ds, dense_ckpts, raw_data, work,
                       smi, reset_counts, read_counts, expect):
    """Phase 22: the multi-device modes (igmc_torch.parallel) at full width
    on phase 6 / 10's ML-1M pairs, K1 and K2 launching 0 times: world size 1
    over NCCL in this process, then two ranks sharing the card over gloo
    (collectives staged through host memory: their times measure the
    port, not NVLink scaling), then the CLI with --n-devices 2 and
    --parallel ep --n-devices 2. Returns the numbers it measured."""
    from dataclasses import replace

    import numpy as np
    from igmc_torch.batching.dataset import _apply_max_num
    from igmc_torch.parallel import spawn

    t_phase = time.perf_counter()
    seg = replace(cfg, flat_aggregate="segment")
    (us, vs), _ = _apply_max_num((split.test_u_indices, split.test_v_indices),
                                 split.test_labels, MAX_NUM)
    spec = dict(cfg=seg, train=train_ds, test=test_ds, adj=split.adj_train,
                class_values=split.class_values, ckpts=dense_ckpts, pairs=(us, vs))
    reset_counts()
    w1 = spawn(_world1, 1, "cuda", args=(spec,))[0]
    read_counts("multi_device")
    expect("multi_device", "rgcn_aggregate_fwd", 0)
    expect("multi_device", "rgcn_aggregate_bwd", 0)

    t0 = time.perf_counter()
    w2 = spawn(_world2, 2, "cuda", args=(spec,))
    w2_s = time.perf_counter() - t0
    for r in w2:
        if r["backend"] != "gloo":
            fail(f"two ranks on one card ran over {r['backend']}, not gloo")
        for name, n in r["launches"].items():
            print(f"[multi] rank {r['rank']}: {name} launches {n} (expected 0)")
            if n:
                fail(f"{name} launched {n} times in rank {r['rank']}")
    if not np.array_equal(w2[0]["params"], w2[1]["params"]):
        fail("the two ranks' parameters differ after the DP epoch")
    print(f"[multi] world 2 (gloo, one card): the ranks' {w2[0]['params'].size} "
          f"parameters are identical bit for bit after the DP epoch "
          f"({w2[0]['epoch_s']:.2f} s); DP test RMSE {w2[0]['dp_rmse']:.6f}, "
          f"single-device {w2[0]['single_rmse']:.6f}; Predictor(mesh=) on "
          f"{len(us)} pairs vs Predictor: max abs diff {w2[0]['serve_diff']:.3e}; "
          f"the two-rank run took {w2_s:.2f} s", flush=True)

    cli = {}
    for name, (flags, line) in MULTI_CLI.items():
        cwd = os.path.join(work, f"multi_cli_{name}")
        os.makedirs(cwd)
        cmd = ([sys.executable, "-m", "igmc_torch.cli.main", "--data-name", "ml_100k",
                "--testing", "--epochs", "1"] + MULTI_CLI_CUT + flags)
        lines, err, wall = _subprocess(cmd, raw_data, cwd, f"multi cli {name}")
        if line not in lines:
            fail(f"the {name} CLI did not print {line!r}")
        if "2 rank(s) over gloo" not in err:
            fail(f"the {name} CLI's ranks did not run over gloo")
        cli[name] = {"rmse": _check_log(cwd, "ml_100k", ["Epoch 1,"],
                                        f"multi cli {name}")[0], "seconds": wall}

    comm = w2[0]["comm"]
    out = {
        "world1": w1,
        "world2": {k: [r[k] for r in w2] for k in
                   ("dp_step_ms", "all_reduce_ms", "ep_fwd_ms", "ep_segment_step_ms",
                    "ep_blocked_step_ms", "epoch_s", "serve_s", "blocked_plan_s",
                    "dense_step", "flat_step", "ep_step", "ep_err")},
        "dp_rmse": w2[0]["dp_rmse"], "single_rmse": w2[0]["single_rmse"],
        "serve_diff": w2[0]["serve_diff"], "comm": comm, "cli": cli,
        "seconds": time.perf_counter() - t_phase,
    }
    print(f"[multi] {smi}: DP step {w1['dp_step_ms']:.4f} ms at world 1 (nccl), "
          f"{w2[0]['dp_step_ms']:.4f} / {w2[1]['dp_step_ms']:.4f} ms at world 2 "
          f"(gloo, both ranks on this one card: not a scaling figure); all_reduce of "
          f"the gradient bucket {w1['all_reduce_ms']:.4f} ms (world 1), "
          f"{w2[0]['all_reduce_ms']:.4f} ms (world 2) per step")
    print(f"[multi] {smi}: EP forward of {EP_GRAPHS} graphs {w1['ep_fwd_ms']:.3f} ms "
          f"(world 1), {w2[0]['ep_fwd_ms']:.3f} ms (world 2); halo exchange "
          f"{comm['halo_bytes_per_layer']} bytes per layer vs all_gather "
          f"{comm['allgather_bytes_per_layer']} bytes "
          f"({comm['halo_rows_per_pair']} vs {comm['local_nodes']} rows per pair; "
          f"{comm['reduction_x']}x fewer bytes over all layers and the readout)")
    print(f"[multi] {smi}: phase seconds {out['seconds']:.2f}", flush=True)
    return out


def _ranking_gaps(preds, num: int):
    """(the smallest gap between neighbouring ranked predictions, the
    smallest among the num + 1 highest and the num + 1 lowest: the gaps
    that decide which graphs are drawn and in which order)."""
    gaps = np.diff(np.sort(np.asarray(preds, np.float64)))
    return float(gaps.min()), float(min(gaps[:num].min(), gaps[-num:].min()))


def _visualize_check(raw_data, cwd12, cli_wall, smi):
    """Phase 23 (a): the visualize CLI on phase 12's checkpoints in a
    subprocess (exit 0, the PDF's structure and titles, the transfer RMSE
    against test_once on the card), then visualize in this process on the
    card against the card's own predict_all and the CPU's ranking."""
    import contextlib
    import copy
    import io

    import torch
    from igmc_torch.batching import BatchLoader
    from igmc_torch.cli.main import (build_datasets, build_model, build_parser,
                                     choose_layouts, load_split, rating_maps)
    from igmc_torch.device import resolve_device
    from igmc_torch.models import set_flat_engine
    from igmc_torch.train import (load_checkpoint, make_eval_step, predict_all,
                                  resolve_checkpoint, test_once)
    from igmc_torch.train import visualize as vis
    from igmc_torch.utils.pdf import check_pdf

    res12 = os.path.join(cwd12, "results", "ml_1m_testmode")
    argv = VIS_CLI + ["--transfer", res12]
    cmd = [sys.executable, "-m", "igmc_torch.cli.main"] + argv
    lines, _, wall = _subprocess(cmd, raw_data, cwd12, "visualize cli")
    found = [l for l in lines if l.startswith("Transfer learning rmse is: ")]
    if len(found) != 1 or not math.isfinite(float(found[0].split()[-1])):
        fail(f"the visualize CLI printed {found} for the transfer RMSE")
    cli_rmse = float(found[0].split()[-1])
    pdf = os.path.join(res12, "visualization_ml_1m_prediction.pdf")
    if f"saved {os.path.join('results', 'ml_1m_testmode', os.path.basename(pdf))}" \
            not in lines or not os.path.isfile(pdf):
        fail("the visualize CLI wrote no visualization_ml_1m_prediction.pdf")
    try:
        content = check_pdf(pdf)
    except ValueError as e:
        fail(f"the visualize CLI's PDF: {e}")
    titles = re.findall(r"/F1 20 Tf \S+ \S+ Td \((.*)\) Tj ET", content)
    if len(titles) != VIS_PANELS:
        fail(f"the visualize CLI's PDF has {len(titles)} titles, not {VIS_PANELS}")

    # the same datasets, model and checkpoint in this process, on the card
    here = os.getcwd()
    os.chdir(cwd12)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            args = build_parser().parse_args(argv)
            split = load_split(args, *rating_maps(args))
            train_graphs, _, test_graphs, _ = build_datasets(args, split)
            batch_mode = choose_layouts(args, train_graphs)[0]
            model = build_model(args, split)
            params = load_checkpoint(resolve_checkpoint(res12, "model", args.epochs))
            rmse = test_once(test_graphs, model, BATCH_SIZE, params=params,
                             batch_mode=batch_mode, device="cuda")
    finally:
        os.chdir(here)
    if abs(rmse - cli_rmse) > 1e-5:
        fail(f"the visualize CLI's transfer RMSE {cli_rmse} is not test_once's "
             f"{rmse:.6f} on the card (1e-5)")
    model.load_state_dict(params)

    seen = {}
    steps = {"predict": vis.predict, "choose": vis.choose, "draw": vis.draw}

    def spy(name):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = steps[name](*a, **k)
            torch.cuda.synchronize()
            seen[name] = out
            seen[f"{name}_s"] = time.perf_counter() - t0
            return out
        return run

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name in steps:
            setattr(vis, name, spy(name))
        with tempfile.TemporaryDirectory() as out_dir, \
                contextlib.redirect_stdout(io.StringIO()):
            vis.visualize(model, test_graphs, out_dir, "ml_1m", split.class_values,
                          batch_size=BATCH_SIZE, device="cuda")
        dev = resolve_device("cuda")
        card = set_flat_engine(copy.deepcopy(model).to(dev).eval(), "segment")
        own, _ = predict_all(make_eval_step(card), BatchLoader(test_graphs, BATCH_SIZE),
                             dev)
    finally:
        for name, fn in steps.items():
            setattr(vis, name, fn)
        torch.use_deterministic_algorithms(False)
    preds, ys = seen["predict"]
    chosen = seen["choose"]
    num = VIS_PANELS // 2
    if not np.array_equal(own, preds) or vis.choose(own, ys, num) != chosen:
        fail("visualize's predictions or choice differ from the card's own "
             "predict_all with deterministic scatters")
    cpu_preds, _ = vis.predict(model, test_graphs, BATCH_SIZE, device="cpu")
    diff = float(np.abs(cpu_preds - preds).max())
    if diff > PRED_ATOL:
        fail(f"visualize's predictions on the card and the CPU differ by {diff:.3e}")
    cpu_chosen = vis.choose(cpu_preds, ys, num)
    smallest, deciding = _ranking_gaps(preds, num)
    if cpu_chosen != chosen and deciding > 2 * PRED_ATOL:
        fail(f"the CPU chose {cpu_chosen}, the card {chosen}, with no near tie "
             f"(deciding gap {deciding:.3e})")
    print(f"[last] visualize: {len(preds)} test graphs; the card chose {chosen} "
          f"(its own predict_all: the same, predictions equal with deterministic "
          f"scatters); the CPU {'the same' if cpu_chosen == chosen else cpu_chosen}, "
          f"predictions within {diff:.3e}; smallest gap between neighbouring ranked "
          f"predictions {smallest:.3e}, {deciding:.3e} among the drawn ranks")
    print(f"[last] {smi}: visualize CLI {wall:.2f} s wall (phase 12's training CLI "
          f"{cli_wall:.2f} s); transfer RMSE {cli_rmse:.6f} = test_once {rmse:.6f}; "
          f"in this process prediction {seen['predict_s']:.3f} s, drawing "
          f"{seen['draw_s']:.3f} s", flush=True)
    return {"cli_s": wall, "phase12_cli_s": cli_wall, "rmse": cli_rmse,
            "predict_s": seen["predict_s"], "draw_s": seen["draw_s"],
            "cpu_diff": diff, "min_gap": smallest, "deciding_gap": deciding,
            "cpu_same_choice": cpu_chosen == chosen}


class Supervised:
    """Phase 23 (b): `python -m igmc_torch.cli.resilient` over a two-rank
    ml_100k run on the card (gloo), started in the background. A watcher
    thread stops the child's process group (SIGSTOP: alive and silent, as
    under a hung collective) as soon as the epoch-1 checkpoints exist, then
    waits for the supervisor to kill it and relaunch; `finish` checks that
    no process of the stopped group is left, that the relaunch resumed
    from epoch >= 1 and that the supervisor exited 0 with epoch 3 logged.
    (a) and (c) run meanwhile: the supervisor spends most of this time
    waiting out its stall timeout."""

    def __init__(self, raw_data, work):
        import threading

        cwd = os.path.join(work, "resilient_run")
        os.makedirs(cwd)
        self.res = os.path.join(cwd, "results", "ml_100k_testmode")
        self.sup_log = os.path.join(self.res, "supervisor.log")
        self.out_path = os.path.join(work, "resilient_out.txt")
        path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
        env = dict(os.environ, IGMC_RAW_DATA=raw_data, PYTHONPATH=path)
        cmd = [sys.executable, "-m", "igmc_torch.cli.resilient", "--stall-timeout",
               str(STALL_TIMEOUT_S), "--"] + SUPERVISED_CLI
        self.error, self.relaunch_s, self.pgid = None, None, None
        self.silence = [0.0, 0.0]       # the longest silence of each launch
        self.t0 = time.perf_counter()
        with open(self.out_path, "w") as out:
            self.sup = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=out,
                                        stderr=subprocess.STDOUT)
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def launches(self):
        """(each launch's resume epoch, each child's process group) so far."""
        text = open(self.sup_log).read() if os.path.isfile(self.sup_log) else ""
        return (re.findall(r"=== supervisor: launching \(resume=(\w+)\) ===", text),
                [int(g) for g in re.findall(r"child pid \d+ \(process group (\d+)\)",
                                            text)])

    def _until(self, cond, timeout: float) -> bool:
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > timeout:
                return False
            time.sleep(0.01)
        return True

    def _watch(self) -> None:
        import signal

        ckpts = [os.path.join(self.res, f"{k}_checkpoint1.pth")
                 for k in ("model", "optimizer")]
        seen = {"size": -1, "since": time.perf_counter(), "launch": 0}

        def track():
            # keeps the longest time the child's log did not grow
            now = time.perf_counter()
            size = os.path.getsize(self.sup_log) if os.path.isfile(self.sup_log) else 0
            if size != seen["size"]:
                seen.update(size=size, since=now)
            k = seen["launch"]
            self.silence[k] = max(self.silence[k], now - seen["since"])

        def checkpointed():
            track()
            return all(os.path.isfile(c) for c in ckpts) or self.sup.poll() is not None

        try:
            if not self._until(checkpointed, 300):
                self.error = "no epoch-1 checkpoints within 300 s"
                return
            resumes, groups = self.launches()
            if self.sup.poll() is not None or len(groups) != 1:
                self.error = (f"the supervised run ended or relaunched before its "
                              f"stop (launches {resumes})")
                return
            self.pgid = groups[0]
            os.killpg(self.pgid, signal.SIGSTOP)
            t_stop = time.perf_counter()
            if not self._until(lambda: len(self.launches()[0]) > 1
                               or self.sup.poll() is not None, STALL_TIMEOUT_S + 120):
                self.error = "no relaunch after the stop"
                return
            self.relaunch_s = time.perf_counter() - t_stop
            try:
                os.killpg(self.pgid, 0)
                self.error = f"a process of the stopped child's group {self.pgid} survived"
            except ProcessLookupError:
                pass
            # the relaunched child's longest silence, to the supervisor's end
            seen.update(size=-1, since=time.perf_counter(), launch=1)
            self._until(lambda: track() or self.sup.poll() is not None, 400)
        except OSError as e:
            self.error = f"the watcher: {e!r}"

    def abort(self) -> None:
        """Stop every process of the supervised run (a check failed)."""
        import signal

        if self.sup.poll() is None:
            for group in self.launches()[1]:
                try:
                    os.killpg(group, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            self.sup.kill()
            self.sup.wait()

    def finish(self, smi) -> dict:
        try:
            rc = self.sup.wait(timeout=420)
        except subprocess.TimeoutExpired:
            rc = None
        self.thread.join(timeout=60)
        wall = time.perf_counter() - self.t0
        if rc is None or self.error or self.thread.is_alive():
            self.abort()
            print(open(self.sup_log).read()[-4000:] if os.path.isfile(self.sup_log)
                  else "")
            fail(f"the supervised run: {self.error or 'did not end'}")
        resumes, _ = self.launches()
        if rc != 0:
            print(open(self.out_path).read()[-4000:])
            fail(f"the supervisor exited {rc}")
        if len(resumes) != 2 or resumes[0] != "None" or not resumes[1].isdigit() \
                or int(resumes[1]) < 1:
            fail(f"supervisor.log shows the launches {resumes}, not a fresh one and "
                 f"one with --continue-from >= 1")
        log = open(os.path.join(self.res, "log.txt")).read().splitlines()
        if not log or not log[-1].startswith("Epoch 3,") or \
                not math.isfinite(float(log[-1].split()[-1])):
            fail(f"the supervised run's log.txt ends {log[-1:]}")
        print(f"[last] supervisor: child group {self.pgid} stopped after the epoch-1 "
              f"checkpoints; killed, none of its processes left, relaunched with "
              f"--continue-from {resumes[1]}, exit 0; log.txt: {log[-1]}")
        print(f"[last] {smi}: the child's longest silence {self.silence[0]:.2f} s "
              f"before the stop, {self.silence[1]:.2f} s after the relaunch; stop to "
              f"relaunch {self.relaunch_s:.2f} s (stall "
              f"timeout {STALL_TIMEOUT_S} s + the supervisor's poll and 20 s SIGTERM "
              f"grace); the supervised run {wall:.2f} s, (a) and (c) running beside "
              f"it", flush=True)
        return {"relaunch_s": self.relaunch_s, "seconds": wall,
                "resume": int(resumes[1]), "epochs_logged": len(log),
                "longest_silence_s": self.silence}


def _transfer_check(raw_data, work, smi):
    """Phase 23 (c): `python -m igmc_torch.scripts.transfer_experiment
    --small` in a fresh directory: exit 0 and a summary with three finite
    transfer RMSEs."""
    cwd = os.path.join(work, "transfer_run")
    os.makedirs(cwd)
    cmd = [sys.executable, "-m", "igmc_torch.scripts.transfer_experiment", "--small"]
    lines, _, wall = _subprocess(cmd, raw_data, cwd, "transfer experiment")
    try:
        summary = json.loads(lines[-1])
        rmses = {k: float(summary[f"{k}_transfer_rmse"])
                 for k in ("flixster", "douban", "yahoo_music")}
    except (ValueError, KeyError, IndexError) as e:
        fail(f"the transfer experiment's summary line: {e}")
    if not all(math.isfinite(v) for v in rmses.values()):
        fail(f"the transfer experiment's RMSEs are not finite: {rmses}")
    print(f"[last] {smi}: transfer experiment --small {wall:.2f} s; "
          f"{summary['pth_exported']} source .pth; transfer RMSEs {rmses}", flush=True)
    return {"seconds": wall, **rmses}


def last_modules_phase(raw_data, cwd12, cli_wall, work, smi, reset_counts,
                       read_counts, expect):
    """Phase 23: the last modules of the JAX package, K1 and K2 launching 0
    times (in this process): (b) the supervisor over a wedged two-rank run
    in the background, while (a) --visualize on phase 12's checkpoints and
    (c) the transfer experiment run. Returns the numbers it measured."""
    t_phase = time.perf_counter()
    reset_counts()
    supervised = Supervised(raw_data, work)
    try:
        out = {"visualize": _visualize_check(raw_data, cwd12, cli_wall, smi)}
        read_counts("last_modules")
        expect("last_modules", "rgcn_aggregate_fwd", 0)
        expect("last_modules", "rgcn_aggregate_bwd", 0)
        out["transfer"] = _transfer_check(raw_data, work, smi)
    except BaseException:
        supervised.abort()
        raise
    out["supervisor"] = supervised.finish(smi)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[last] {smi}: phase seconds {out['seconds']:.2f} (budget "
          f"{LAST_BUDGET_S} s{'' if out['seconds'] <= LAST_BUDGET_S else ', OVER'})",
          flush=True)
    return out


def _shape_kernels(b0, R_batch, name, spec, dev, gen):
    """Phase 24 (a) at one shape: K1, and K2 with dx on and off, against
    their float64 plain versions on test batch 0's edges planned with the
    shape's rows and eblk (its relations redrawn over R where R is not the
    batch's R_batch); each one's time per call (CUDA events) and K1's
    and K2's (dx on) device time per launch, the plain versions' times in
    float32 and the bounds."""
    import torch
    from igmc_torch.kernels.rgcn_aggregate import (
        block_align_edges, block_align_edges_transposed, rgcn_aggregate,
        rgcn_aggregate_bwd, rgcn_aggregate_bwd_ref, rgcn_aggregate_ref)

    R, B, cin, cout, rows, eblk = spec
    N = b0.num_nodes
    etype = b0.edge_type.numpy()
    if R != R_batch:
        rng = torch.Generator().manual_seed(R)
        etype = torch.randint(0, R, etype.shape, generator=rng,
                              dtype=torch.int32).numpy()
    edges = (b0.edge_src.numpy(), b0.edge_dst.numpy(), etype, b0.edge_mask.numpy(), N)
    plan = tuple(torch.as_tensor(a).to(dev)
                 for a in block_align_edges(*edges, eblk=eblk, rows=rows)[:6])
    plan_t = tuple(torch.as_tensor(a).to(dev)
                   for a in block_align_edges_transposed(*edges, eblk=eblk,
                                                         rows=rows)[:6])
    x, att, basis, g = (t.to(dev) for t in operands(b0, cin, R, B, cout, gen))
    out = {"shape": f"R {R}, B {B}, Cin {cin}, Cout {cout}, rows {rows}, eblk {eblk}, "
                    f"N {N}, {plan[0].numel()} edge slots"}
    with torch.no_grad():
        got = rgcn_aggregate(x, att, basis, plan, rows, N)
        want = rgcn_aggregate_ref(x.double(), att.double(), basis.double(), plan,
                                  rows, N).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        try:
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        except AssertionError as e:
            fail(f"rgcn_aggregate_fwd disagrees with the plain version at {name}: {e}")
        del got, want
        call = lambda: rgcn_aggregate(x, att, basis, plan, rows, N)
        out["fwd"] = dict(max_abs_err=err, ms=cuda_ms(call, 20),
                          device_ms=kernel_ms(call, "rgcn_aggregate_fwd", 20),
                          plain_ms=cuda_ms(lambda: rgcn_aggregate_ref(
                              x, att, basis, plan, rows, N), 5),
                          **aggregate_bound(x, att, basis, plan, rows))
        args64 = [a.double() for a in (g, x, att, basis)]
        want = rgcn_aggregate_bwd_ref(*args64, plan_t, rows)
        terms = rgcn_aggregate_bwd_ref(*(a.abs() for a in args64), plan_t, rows)
        del args64
        for need_dx in (True, False):
            got = rgcn_aggregate_bwd(g, x, att, basis, plan_t, rows, need_dx=need_dx)
            torch.cuda.synchronize()
            errs = bwd_errors(got, want, terms,
                              f"at {name}, dx {'on' if need_dx else 'off'}")
            call = lambda: rgcn_aggregate_bwd(g, x, att, basis, plan_t, rows,
                                              need_dx=need_dx)
            key = "bwd" if need_dx else "bwd_no_dx"
            out[key] = dict(max_abs_err=max(errs.values()), errs=errs,
                            ms=cuda_ms(call, 20),
                            **aggregate_bwd_bound(x, att, basis, plan_t, need_dx, rows))
            if need_dx:
                out[key]["device_ms"] = kernel_ms(call, "rgcn_aggregate_bwd", 20)
                out[key]["plain_ms"] = cuda_ms(lambda: rgcn_aggregate_bwd_ref(
                    g, x, att, basis, plan_t, rows), 5)
        del want, terms
    for key, label in (("fwd", "rgcn_aggregate_fwd"), ("bwd", "rgcn_aggregate_bwd dx on"),
                       ("bwd_no_dx", "rgcn_aggregate_bwd dx off")):
        r = out[key]
        extra = "".join(f", {k} {r[k]:.4f} ms" for k in ("device_ms", "plain_ms") if k in r)
        print(f"[shapes] {name} {label}: max_abs_err {r['max_abs_err']:.3e}; "
              f"{r['ms']:.4f} ms per call{extra}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.2f}% of it", flush=True)
    return out


def every_shape_phase(b0, R_batch, dev, work, smi, reset_counts, read_counts, expect):
    """Phase 24: the shapes of the JAX package's Pallas kernels beyond the
    CLI's defaults. (a) K1 and K2 at each EVERY_SHAPE against their float64
    plain versions, timed; (b) the CLI with SHAPES_CLI on the yahoo_music
    fixture (R 71) in this process, its K1 / K2 launches counted; (c) a card
    vs CPU training step of WIDE_STEP IGMC over plans of 128 rows and blocks
    of WIDE_STEP_EBLK slots. Returns the numbers it measured."""
    import contextlib
    import io

    import torch
    from igmc_torch.batching import BatchLoader, StaticGraphDataset
    from igmc_torch.cli.main import main as cli_main
    from igmc_torch.data import load_data_monti
    from igmc_torch.models import IGMCConfig

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(24)
    out = {"shapes": {name: _shape_kernels(b0, R_batch, name, spec, dev, gen)
                      for name, spec in EVERY_SHAPE.items()}}
    torch.cuda.empty_cache()

    # (b) the CLI in this process, so that its launches are counted here
    raw_before, cwd_before = os.environ.get("IGMC_RAW_DATA"), os.getcwd()
    os.environ["IGMC_RAW_DATA"] = MONTI_ROOT
    split = load_data_monti("yahoo_music", testing=True)
    n_train = -(-len(split.train_labels) // BATCH_SIZE)
    n_test = -(-len(split.test_labels) // BATCH_SIZE)
    cwd = os.path.join(work, "shapes_cli")
    os.makedirs(cwd)
    argv = ["--data-name", "yahoo_music", "--testing"] + SHAPES_CLI
    reset_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            cli_main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd_before)
        if raw_before is None:
            os.environ.pop("IGMC_RAW_DATA")
        else:
            os.environ["IGMC_RAW_DATA"] = raw_before
    cli_s = time.perf_counter() - t0
    read_counts("shapes_cli")
    lines = buf.getvalue().splitlines()
    if "batch mode: flat (--flat-aggregate pallas)" not in lines:
        fail(f"the yahoo_music CLI did not run the pallas engine: {lines[-20:]}")
    rmses = _check_log(cwd, "yahoo_music", ["Epoch 1,"], "shapes cli")
    print(f"[shapes] cli {' '.join(argv)} in this process: {cli_s:.2f} s; "
          f"{n_train} training and {n_test} test batches", flush=True)
    expect("shapes_cli", "rgcn_aggregate_fwd", 4 * (n_train + n_test))
    expect("shapes_cli", "rgcn_aggregate_bwd", 4 * n_train)
    out["cli"] = {"seconds": cli_s, "rmse": rmses[0], "train_batches": n_train,
                  "test_batches": n_test}

    # (c) widths past 32, 16 bases, 128-row chunks, 256-slot blocks
    R = len(split.class_values)
    ds = StaticGraphDataset(split.adj_train, (split.train_u_indices,
                                              split.train_v_indices),
                            split.train_labels, h=1, class_values=split.class_values,
                            max_num=BATCH_SIZE, backend="native")
    batch = next(iter(BatchLoader(ds, BATCH_SIZE, shuffle=True, seed=1,
                                  flat_aggregate="pallas",
                                  plan_rows=WIDE_STEP["pallas_rows"],
                                  plan_eblk=WIDE_STEP_EBLK)))
    cfg = IGMCConfig(num_features=4, num_relations=R, adj_dropout=0.2,
                     flat_aggregate="pallas", **WIDE_STEP)
    reset_counts()
    loss_rel, grad_rel = card_vs_cpu_step(cfg, batch, "shapes card vs CPU")
    read_counts("shapes_step")
    expect("shapes_step", "rgcn_aggregate_fwd", len(cfg.latent_dim))
    expect("shapes_step", "rgcn_aggregate_bwd", len(cfg.latent_dim))
    out["step"] = {"loss_rel": loss_rel, "grad_rel": grad_rel, "relations": R,
                   "nodes": batch.num_nodes, "blocks": int(batch.aligned[4].numel())}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[shapes] {smi}: phase seconds {out['seconds']:.2f} (budget "
          f"{SHAPES_BUDGET_S} s{'' if out['seconds'] <= SHAPES_BUDGET_S else ', OVER'})",
          flush=True)
    return out


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
                  max_num=MAX_NUM, backend="native")
        test_ds = StaticGraphDataset(
            split.adj_train, (split.test_u_indices, split.test_v_indices),
            split.test_labels, **kw)
        train_ds = StaticGraphDataset(
            split.adj_train, (split.train_u_indices, split.train_v_indices),
            split.train_labels, **kw)
        extract_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batches = list(BatchLoader(test_ds, BATCH_SIZE, flat_aggregate="pallas"))
        collate_s = time.perf_counter() - t0
        train_loader = BatchLoader(train_ds, BATCH_SIZE, shuffle=True, seed=1,
                                   flat_aggregate="pallas")
        train_loader.epoch = 1
        t0 = time.perf_counter()
        train_batches = list(train_loader)
        collate_train_s = time.perf_counter() - t0
        n_nodes = [int(b.node_mask.sum()) for b in batches]
        n_edges = [int(b.edge_mask.sum()) for b in batches]
        print(f"[data] ml_1m split {load_s:.2f} s; {len(test_ds)} test + "
              f"{len(train_ds)} training pairs extracted in {extract_s:.2f} s "
              f"(C++ engine, its build included); "
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

    # phases 5-8, 13 and 18's flat runs hold the fused kernels (K1/K2): the
    # model's flat engine and the loops' flat_aggregate say "pallas"
    cfg = IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                     num_relations=R, num_bases=4, adj_dropout=0.2,
                     flat_aggregate="pallas")
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
                             checkpoints=ckpts, flat_aggregate="pallas",
                             device="cuda")
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
                test_freq=1, logger=logger, seed=1, flat_aggregate="pallas",
                device="cuda")
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
                               checkpoints=trained, flat_aggregate="pallas",
                               device="cuda")
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
            dtrain, dense_ckpts = dense_train(cfg, train_ds, test_ds, work, dev,
                                              reset_counts, read_counts, expect)

        # ---- 11. card against CPU, dense ---------------------------------------
        with phase("card against CPU, dense"):
            card_vs_cpu_step(cfg, dtrain[0], "card vs CPU, dense")

        # ---- 12. the CLI -------------------------------------------------------
        cwd_cli = os.path.join(work, "cli_run")
        os.makedirs(cwd_cli)
        with phase("cli"):
            cli_wall = run_cli(args.raw_data, cwd_cli)

        # ---- 13. side features, card against CPU ----------------------------------
        with phase("features"):
            features_phase(split, cfg, dev, reset_counts, read_counts, expect)

        # ---- 14. ml_100k through the CLI --------------------------------------
        cwd100k = os.path.join(work, "ml_100k_run")
        os.makedirs(cwd100k)
        with phase("cli ml_100k"):
            results100k = run_cli_100k(args.raw_data, cwd100k)

        # ---- 15. serving -------------------------------------------------------
        with phase("serving"):
            serve_times = serving(split, cfg, dense_ckpts, test_ds, dev)

        # ---- 16. the serving CLI ------------------------------------------------
        with phase("cli predict"):
            run_predict_cli(args.raw_data, cwd100k, results100k)

        # ---- 17. the main path's options ------------------------------------------
        cwd_options = os.path.join(work, "options_run")
        os.makedirs(cwd_options)
        with phase("options"):
            options = options_phase(split, cfg, dense_ckpts, train_ds, test_ds, dtrain,
                                    dev, args.raw_data, cwd_options, reset_counts,
                                    read_counts, expect)

        # ---- 18. dynamic data, caches and JAX checkpoints ------------------------
        with phase("dynamic"):
            dynamic = dynamic_phase(split, cfg, test_ds, dense_ckpts, dev,
                                    args.raw_data, work, reset_counts, read_counts,
                                    expect)

        # ---- 19. the Monti datasets -------------------------------------------
        with phase("monti"):
            monti, flixster = monti_phase(dev, work, reset_counts, read_counts, expect)

        # ---- 20. the GNN, DGCNN and DGCNN_RS families ----------------------------
        with phase("families"):
            families = families_phase(flixster, dev, work, reset_counts, read_counts,
                                      expect)

        # ---- 21. the flat segment and blocked engines ---------------------------
        with phase("flat engines"):
            flat = flat_engines_phase(split, cfg, train_ds, test_ds, flixster, dev,
                                      args.raw_data, work, reset_counts, read_counts,
                                      expect)

        # ---- 22. several devices ------------------------------------------------
        with phase("multi-device"):
            multi = multi_device_phase(split, cfg, train_ds, test_ds, dense_ckpts,
                                       args.raw_data, work, smi, reset_counts,
                                       read_counts, expect)

        # ---- 23. the last modules ---------------------------------------------
        with phase("last modules"):
            last = last_modules_phase(args.raw_data, cwd_cli, cli_wall, work, smi,
                                      reset_counts, read_counts, expect)

        # ---- 24. every shape of the JAX package's kernels ------------------------
        with phase("every shape"):
            shapes = every_shape_phase(batches[0], R, dev, work, smi, reset_counts,
                                       read_counts, expect)

    def entry(name, source, replaces, res, err, extra):
        r32 = res[32]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches[p][name]
                            for p in ("train", "features", "dynamic_flat")),
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

    sources = {"rgcn_aggregate_fwd": ("igmc_torch/kernels/csrc/rgcn_aggregate_fwd.cu",
                                      "igmc_tpu/kernels/rgcn_aggregate.py:170"),
               "rgcn_aggregate_bwd": ("igmc_torch/kernels/csrc/rgcn_aggregate_bwd.cu",
                                      "igmc_tpu/kernels/rgcn_aggregate.py:236")}
    kernels = [
        entry("rgcn_aggregate_fwd", *sources["rgcn_aggregate_fwd"], k1, k1_err, {}),
        entry("rgcn_aggregate_bwd", *sources["rgcn_aggregate_bwd"], k2,
              max(k2_err.values()), {f"max_abs_err_{k}": v for k, v in k2_err.items()}),
    ]
    # phase 24's shapes: launches are the counts of its CLI run and step
    for shape, r in shapes["shapes"].items():
        for name, key in (("rgcn_aggregate_fwd", "fwd"), ("rgcn_aggregate_bwd", "bwd")):
            kernels.append({
                "name": name, "route": "cuda", "source": sources[name][0],
                "replaces": sources[name][1],
                "launches": sum(launches[p][name] for p in ("shapes_cli", "shapes_step")),
                "max_abs_err": r[key]["max_abs_err"], "ms": r[key]["ms"],
                "plain_ms": r[key]["plain_ms"], "bound_ms": r[key]["bound_ms"],
                "bound_by": r[key]["bound_by"], "library_ms": None,
                "device_ms": r[key]["device_ms"], "shape": f"{shape}: {r['shape']}",
                **({"dx_off_ms": r["bwd_no_dx"]["ms"],
                    "dx_off_bound_ms": r["bwd_no_dx"]["bound_ms"]} if key == "bwd" else {}),
            })
    total = time.perf_counter() - phase.t0
    print(f"[time] total {total:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in phase.seconds.items()) + ")")
    print(f"[serve] timings: {json.dumps(serve_times)}")
    print(f"[options] numbers: {json.dumps(options)}")
    print(f"[dynamic] numbers: {json.dumps(dynamic)}")
    print(f"[monti] numbers: {json.dumps(monti)}")
    print(f"[families] numbers: {json.dumps(families)}")
    print(f"[flat] numbers: {json.dumps(flat)}")
    print(f"[multi] numbers: {json.dumps(multi)}")
    print(f"[last] numbers: {json.dumps(last)}")
    print(f"[shapes] numbers: {json.dumps(shapes)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
