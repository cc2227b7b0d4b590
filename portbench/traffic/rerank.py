"""A closed loop of reranking calls to Predictor.predict.

One caller, no think time. Each call scores one user against
`candidates` items: the user drawn from the held-out pairs' users,
weighted by their held-out pairs; the items drawn without replacement
from the items the user has no training rating for, weighted by their
training popularity. The calls are a fixed set of `request_set` calls,
drawn from the configuration's `requests_seed`, so every run seed sends
the same calls in another order (a permutation per cycle from the seed).

Set-up builds the ensemble (one member per checkpoint of the
configuration's `ensemble_epochs`) from the run's weights, writes
them as .pth files under TMPDIR (the Predictor loads them as it loads
checkpoints), and makes `warmup_calls` calls. The window then calls
until `seconds` have passed; a call's latency runs from the call to the
scores in host memory. A traced run adds `traced_calls` calls under the
profiler after the window. Once the window has closed and the predictor
is freed, the reference re-extracts the pairs of `compared_calls` calls
drawn from the seed and scores them with every member.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..lib import weights
from ..lib.cell import Context, Outcome
from ..lib.data import load_split
from ..lib.trace import traced
from ..reference import compare
from ..reference import extract as rx
from ..reference import igmc as ri
from .train import EXTRACT_BACKEND, _config_model, tf32


def request_set(split, n_calls: int, candidates: int, seed: int):
    """[(user, items)] of the fixed request set."""
    rng = np.random.default_rng(seed)
    popularity = np.asarray((split.adj != 0).sum(axis=0)).ravel().astype(np.float64)
    rated = split.adj.tocsr()
    calls = []
    for _ in range(n_calls):
        u = int(split.test_u[rng.integers(len(split.test_u))])
        w = popularity.copy()
        w[rated.indices[rated.indptr[u]:rated.indptr[u + 1]]] = 0.0
        items = rng.choice(len(w), size=candidates, replace=False, p=w / w.sum())
        calls.append((u, items.astype(np.int64)))
    return calls


def run(ctx: Context) -> Outcome:
    from igmc_torch.serve import Predictor

    cfg, prm, dev, spans = ctx.config, ctx.params, ctx.device, ctx.spans
    model_cfg, data_cfg = cfg["model"], cfg["data"]
    memo = {} if ctx.cache is None else ctx.cache
    key = ("serve", ctx.cell, json.dumps(data_cfg, sort_keys=True), prm["request_set"])
    if key not in memo:
        split = load_split(cfg)
        memo[key] = split, request_set(split, prm["request_set"], prm["candidates"],
                                           data_cfg["requests_seed"])
    split, calls = memo[key]
    R = split.num_relations
    ctx.stage("set-up: data and request set")
    members = weights.make_members(model_cfg, R, ctx.seed, len(model_cfg["ensemble_epochs"]),
                                   dev)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        paths = []
        for i, sd in enumerate(members):
            paths.append(os.path.join(tmp, f"model_{i}.pth"))
            torch.save({k: v.cpu() for k, v in sd.items()}, paths[-1])
        pred = Predictor(split.adj, split.class_values, _config_model(cfg, R, "segment"),
                         checkpoints=paths, h=model_cfg["hops"],
                         max_nodes_per_hop=data_cfg["max_nodes_per_hop"],
                         backend=prm.get("extract_backend", EXTRACT_BACKEND),
                         batch_size=model_cfg["batch_size"],
                         device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ctx.stage("set-up: members and predictor")
    if ctx.trace:
        pred.subgraphs = spans.wrap("extract", pred.subgraphs)
        pred.score = spans.wrap("score", pred.score)
    if ctx.fault == "altered":
        score = pred.score
        pred.score = lambda ds: score(ds) + np.eye(1, len(ds), 0, dtype=np.float32)[0]

    order_rng = np.random.default_rng(weights.sub_seed(ctx.seed, weights.REQUESTS))
    order = []

    def next_call():
        if not order:
            order.extend(order_rng.permutation(len(calls)).tolist())
        return order.pop(0)

    for _ in range(prm["warmup_calls"]):
        u, items = calls[next_call()]
        pred.predict(np.full(len(items), u), items)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = ctx.since_start()
    ctx.stage("set-up: warm-up calls")

    done, latencies, failed = [], [], 0
    spans.reset()
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        c = next_call()
        u, items = calls[c]
        t0 = time.perf_counter()
        try:
            with spans("predict"):
                scores = pred.predict(np.full(len(items), u), items)
        except RuntimeError:
            failed += 1
            continue
        latencies.append(time.perf_counter() - t0)
        done.append((c, scores))
    window_s = time.perf_counter() - t_start
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    lat = np.asarray(latencies)
    p95 = float(np.quantile(lat, 0.95, method="higher")) if lat.size else float("inf")
    pairs = sum(len(s) for _, s in done)
    layer = {"kind": "serve", "window_s": window_s, "calls": len(done),
             "latency_s": float(lat.sum()),
             "extract_s": spans.seconds.get("extract", 0.0)}
    trace = None
    if ctx.trace:
        def slice_():
            for _ in range(prm["traced_calls"]):
                u, items = calls[next_call()]
                with spans("predict"):
                    pred.predict(np.full(len(items), u), items)

        trace = traced(slice_)
        layer["trace"] = trace
    del pred
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = _compare(ctx, split, calls, done, members, model_cfg)
    ok, rows = compare.judge(numbers, ctx.cell)
    return Outcome(
        end_to_end={"setup_s": setup_s, "serve_p95_ms": 1e3 * p95,
                    "serve_pairs_per_s": pairs / window_s},
        layer=layer, compared=rows, correct=ok and failed == 0,
        attempted=len(done) + failed, failed=failed,
        memory_peak_bytes=int(memory_peak), trace=trace,
        notes=[f"{len(done)} calls ({pairs} pairs) in {window_s:.3f} s; median "
               f"{1e3 * float(np.median(lat)) if lat.size else float('nan'):.3f} ms, "
               f"p95 {1e3 * p95:.3f} ms over {lat.size} calls; set-up {setup_s:.3f} s"]
        + ctx.stage_notes())


def _compare(ctx: Context, split, calls, done, members, model: dict):
    """The reference scores a sample of the window's calls (drawn from the
    seed) with every member and averages, in float64; the control does so
    in TF32."""
    prm = ctx.params
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, weights.SAMPLE))
    pick = rng.choice(len(done), size=min(prm["compared_calls"], len(done)), replace=False)
    A = rx.Adjacency(split.adj)
    cap = ctx.config["data"]["max_nodes_per_hop"]
    dev = ctx.device
    got, want, ctl = [], [], []
    for i in pick:
        c, scores = done[i]
        u, items = calls[c]
        graphs = rx.extract_links(A, np.full(len(items), u), items, np.arange(len(items)),
                                  model["hops"], cap)
        b = ri.make_batch(graphs, np.zeros(len(items)), dev)
        with torch.no_grad():
            want.append(torch.stack([ri.forward({k: v.double() for k, v in m.items()},
                                                model, b) for m in members]).mean(0))
            if ctx.control == "tf32":
                with tf32():
                    ctl.append(torch.stack([ri.forward(m, model, b) for m in members]).mean(0))
        got.append(scores)
    want = torch.cat(want).cpu().numpy()
    got = torch.cat(ctl).cpu().numpy() if ctl else np.concatenate(got)
    return compare.serve_numbers(got, want)
