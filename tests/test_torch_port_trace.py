"""igmc_torch's spans and counters (utils/spans.py) on the CPU: off, a span
reads no clock and builds nothing; on, nested spans give parents, sums
and self time, threads recording at once lose no record, a full buffer
counts what it drops; the flat fused-aggregate pass, the dense pass and
Predictor.predict give the same numbers with spans on and off and record
each of their spans once per step, batch or call; a profiler's trace
carries the main thread's `igmc:` ranges, and --profile-dir's does."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from igmc_torch.batching import BatchLoader, StaticGraphDataset
from igmc_torch.batching.device_data import DeviceDataset
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.serve import Predictor
from igmc_torch.train import (DensePass, make_dense_row_step, make_optimizer,
                              make_train_step, plan_buckets, save_pth,
                              train_multiple_epochs)
from igmc_torch.train.loop import dense_train_epoch, train_epoch
from igmc_torch.utils import spans

torch.set_num_threads(1)

BATCH = 50
CLASS_VALUES = np.arange(1.0, 6.0)
TRAIN = ("train.fetch", "train.inputs", "train.forward", "train.backward",
         "train.optimizer")
LOADER = ("loader.fetch", "loader.collate", "loader.plan", "loader.pin")
SERVE = ("serve.subgraphs", "serve.upload", "serve.buckets", "serve.rows",
         "serve.members", "serve.fetch")


@pytest.fixture(autouse=True)
def clean_spans():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def rating_matrix(nu=60, nv=70, density=0.12, seed=0):
    rng = np.random.default_rng(seed)
    M = sp.random(nu, nv, density=density, format="csr",
                  random_state=np.random.RandomState(seed))
    M.data = rng.integers(1, 6, M.nnz).astype(np.float64)
    return M


@pytest.fixture(scope="module")
def dataset():
    M = rating_matrix()
    u, v = M.nonzero()
    n = min(len(u), 3 * BATCH - 10)            # 3 batches, the last short
    labels = (M[u[:n], v[:n]].A1 - 1).astype(np.int64)
    return StaticGraphDataset(M, (u[:n], v[:n]), labels, h=1,
                              class_values=CLASS_VALUES, backend="numpy",
                              progress=False)


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_reads_no_clock_builds_no_range_and_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while spans are off")

    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert spans.span("a") is spans.span("b")

    @spans.spanned("c")
    def f(x):
        return x + 1

    with spans.span("a"):
        assert f(1) == 2
    assert spans.count("n", 5) == 0
    spans.set_group(3)
    snap = spans.snapshot()
    assert snap["spans"] == {} and snap["records"] == []
    assert snap["counters"] == {"spans.dropped": 0}


def test_on_without_a_profiler_builds_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    spans.enable()
    with spans.span("a"):
        pass
    assert spans.snapshot()["spans"]["a"]["calls"] == 1


def test_nested_spans_give_parents_groups_sums_and_self_time(monkeypatch):
    ticks = iter([0, 10, 30, 40, 70, 100, 200, 260])
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    assert spans.enable() is False and spans.enable() is True
    spans.set_group(7)

    @spans.spanned("inner")
    def inner():
        pass

    with spans.span("outer"):           # 0 .. 100
        inner()                         # 10 .. 30
        with spans.span("inner"):       # 40 .. 70
            spans.set_group(8)
    with spans.span("other"):           # 200 .. 260
        pass
    snap = spans.snapshot()
    rec = {(r.name, r.start_ns): r for r in snap["records"]}
    outer = rec[("outer", 0)]
    assert rec[("inner", 10)].parent == rec[("inner", 40)].parent == outer.index
    assert outer.parent == rec[("other", 200)].parent == -1
    assert [outer.group, rec[("inner", 10)].group, rec[("inner", 40)].group,
            rec[("other", 200)].group] == [7, 7, 7, 8]
    assert all(r.thread == threading.get_ident() for r in snap["records"])
    s = snap["spans"]
    assert s["outer"] == {"calls": 1, "seconds": 100e-9, "self_seconds": 50e-9}
    assert s["inner"] == {"calls": 2, "seconds": 50e-9, "self_seconds": 50e-9}
    assert s["other"]["seconds"] == s["other"]["self_seconds"] == 60e-9
    assert spans.count("c") == 1 and spans.count("c", 4) == 5
    assert spans.snapshot()["counters"] == {"c": 5, "spans.dropped": 0}


def test_four_threads_recording_at_once_lose_no_record():
    n, threads = 2000, 4
    spans.enable()
    start = threading.Barrier(threads)

    def work(k):
        start.wait(timeout=30)
        for i in range(n):
            spans.set_group(k)
            with spans.span("outer"):
                with spans.span("inner"):
                    spans.count("ops")

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(was)
    snap = spans.snapshot()
    assert snap["spans"]["outer"]["calls"] == snap["spans"]["inner"]["calls"] == n * threads
    assert snap["counters"]["ops"] == n * threads
    records = {r.index: r for r in snap["records"]}
    assert len(records) == 2 * n * threads
    for r in records.values():
        if r.name == "inner":
            p = records[r.parent]
            assert p.name == "outer" and p.thread == r.thread and p.group == r.group
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        else:
            assert r.parent == -1
    assert len({r.group for r in records.values()}) == threads


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 5)
    spans.enable()
    for _ in range(8):
        with spans.span("a"):
            pass
    snap = spans.snapshot()
    assert snap["spans"]["a"]["calls"] == 5
    assert snap["counters"]["spans.dropped"] == 3
    spans.reset()
    with spans.span("a"):
        pass
    assert spans.snapshot()["counters"] == {"spans.dropped": 0}


def test_reset_forgets_open_spans_and_disable_keeps_records():
    spans.enable()
    with spans.span("open across reset"):
        with spans.span("closed before reset"):
            pass
        spans.reset()
        with spans.span("opened after reset"):
            pass
    (after,) = spans.snapshot()["records"]
    assert after.name == "opened after reset" and after.parent == -1
    spans.reset()
    with spans.span("kept"):
        spans.disable()
    with spans.span("off"):
        pass
    assert list(spans.snapshot()["spans"]) == ["kept"]


def _flat_passes(dataset, on: bool, passes: int = 2):
    """Two passes of flat fused-aggregate training (plain versions of K1 /
    K2 on the CPU, prefetch 2, pinned batches off): losses, parameters
    and the spans' snapshot."""
    if on:
        spans.enable()
    cfg = IGMCConfig(num_relations=5, num_bases=4, flat_aggregate="pallas")
    model = IGMC(cfg, torch.Generator().manual_seed(3)).train()
    opt = make_optimizer(model.parameters(), 1e-3)
    step = make_train_step(model, opt, 0.001)
    loader = BatchLoader(dataset, BATCH, shuffle=True, seed=5, prefetch=2,
                         flat_aggregate="pallas", plan_rows=cfg.pallas_rows)
    gen = torch.Generator().manual_seed(11)
    losses = [train_epoch(step, loader, gen, len(dataset), torch.device("cpu"))
              for _ in range(passes)]
    snap = spans.snapshot()
    spans.disable()
    return losses, model.state_dict(), snap


def test_flat_pallas_pass_is_bit_identical_with_spans_on(dataset):
    off_losses, off_params, off_snap = _flat_passes(dataset, on=False)
    on_losses, on_params, snap = _flat_passes(dataset, on=True)
    assert off_snap["records"] == []
    assert on_losses == off_losses
    for name, p in off_params.items():
        assert torch.equal(p, on_params[name]), name
    steps = 2 * ((len(dataset) + BATCH - 1) // BATCH)
    s = snap["spans"]
    # a pass's last fetch finds the loader's end
    assert s["train.fetch"]["calls"] == steps + 2
    for name in TRAIN[1:]:
        assert s[name]["calls"] == steps, name
    for name in LOADER[1:3]:
        assert s[name]["calls"] == steps, name
    # the packed dataset's batches fetch no Subgraph; one collation each
    assert "loader.fetch" not in s
    assert "loader.pin" not in s                     # pin_memory off
    assert sum(snap["counters"].get(f"batch.collate_{e}", 0)
               for e in ("native", "numpy")) == steps
    assert s["kernels.k1"]["calls"] == s["kernels.k2"]["calls"] == 4 * steps
    assert snap["counters"]["train.steps"] == steps
    # the edge counters read the batches the loader makes
    loader = BatchLoader(dataset, BATCH, shuffle=True, seed=5, prefetch=0)
    masks = [b.edge_mask for _ in range(2) for b in loader]
    assert snap["counters"]["batch.edges"] == sum(int(m.sum()) for m in masks)
    assert snap["counters"]["batch.edge_slots"] == sum(m.numel() for m in masks)
    # step i's spans and the loader's batch i share group i
    rec = by_name(snap["records"])
    main = threading.get_ident()
    assert [r.group for r in rec["train.fetch"]] == [0, 1, 2, 3] * 2
    for name in TRAIN:
        if name != "train.fetch":
            assert [r.group for r in rec[name]] == [0, 1, 2] * 2, name
        assert all(r.thread == main and r.parent == -1 for r in rec[name]), name
    for name in LOADER[1:3]:
        assert sorted(r.group for r in rec[name]) == [0, 0, 1, 1, 2, 2], name
        assert all(r.thread != main for r in rec[name]), name
    fwd = {r.index for r in rec["train.forward"]}
    assert all(r.parent in fwd for r in rec["kernels.k1"])


def test_dense_pass_records_its_inputs_once_and_each_step(dataset):
    cfg = IGMCConfig(num_relations=5, num_bases=4)
    runs = []
    for on in (False, True):
        if on:
            spans.enable()
        model = IGMC(cfg, torch.Generator().manual_seed(3)).train()
        step = make_dense_row_step(model, make_optimizer(model.parameters(), 1e-3),
                                   0, 0.001)
        dd = DeviceDataset(dataset.packed, torch.device("cpu"))
        rows = DensePass.plan(plan_buckets(dataset, "unified"), BATCH, 8, "cpu",
                              np.random.default_rng(2))
        loss = dense_train_epoch(step, dd, rows, torch.Generator().manual_seed(4),
                                 len(dataset))
        runs.append((loss, model.state_dict(), spans.snapshot()))
        spans.disable()
    (loss0, p0, _), (loss1, p1, snap) = runs
    assert loss0 == loss1
    assert all(torch.equal(p, p1[k]) for k, p in p0.items())
    S = len(rows.bucket_of)
    s = snap["spans"]
    assert s["pass.plan"]["calls"] == s["train.inputs"]["calls"] == 1
    assert snap["counters"]["train.steps"] == s["pass.assemble"]["calls"] == S
    for name in TRAIN[2:]:
        assert s[name]["calls"] == S, name
    rec = by_name(snap["records"])
    assert [r.group for r in rec["train.inputs"]] == [-1]
    assert [r.group for r in rec["train.forward"]] == list(range(S))


def test_predictor_scores_are_bit_identical_with_spans_on(dataset, tmp_path):
    M = rating_matrix()
    cfg = IGMCConfig(num_relations=5, num_bases=4)
    paths = [str(tmp_path / f"model_{s}.pth") for s in (1, 2)]
    for s, path in zip((1, 2), paths):
        save_pth(path, IGMC(cfg, torch.Generator().manual_seed(s)).state_dict())
    pred = Predictor(M, CLASS_VALUES, cfg, checkpoints=paths, batch_size=BATCH,
                     backend="numpy", device="cpu")
    rng = np.random.default_rng(0)
    calls = [(rng.integers(0, 60, 80), rng.integers(0, 70, 80)) for _ in range(3)]
    off = [pred.predict(u, v) for u, v in calls]
    rows = sum(len(DensePass.plan(pred._buckets(pred.subgraphs(u, v)), BATCH, 1,
                                  "cpu").bucket_of) for u, v in calls)
    spans.enable()
    on = [pred.predict(u, v) for u, v in calls]
    snap = spans.snapshot()
    for a, b in zip(off, on):
        assert np.array_equal(a, b)
    s = snap["spans"]
    for name in SERVE + ("graphs.extract", "graphs.pack", "pass.plan"):
        assert s[name]["calls"] == 3, name
    assert s["pass.assemble"]["calls"] == rows
    assert snap["counters"]["serve.calls"] == 3
    assert snap["counters"]["serve.member_forwards"] == rows    # one stacked forward a row
    rec = by_name(snap["records"])
    for name in SERVE:
        assert [r.group for r in rec[name]] == [1, 2, 3], name
        assert all(r.parent == -1 for r in rec[name]), name
    sub = {r.index for r in rec["serve.subgraphs"]}
    assert all(r.parent in sub for r in rec["graphs.extract"] + rec["graphs.pack"])
    members_idx = {r.index for r in rec["serve.members"]}
    assert all(r.parent in members_idx for r in rec["pass.assemble"])


def test_a_profiler_sees_the_main_threads_ranges():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("off"):
            torch.ones(4).sum()
        spans.enable()
        with spans.span("outer"):
            with spans.span("inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"igmc:outer", "igmc:inner"} <= names
    assert "igmc:off" not in names
    assert spans.snapshot()["spans"]["outer"]["calls"] == 1


def test_profile_dir_trace_carries_the_program_spans(dataset, tmp_path):
    model = IGMC(IGMCConfig(num_relations=5, num_bases=4),
                 torch.Generator().manual_seed(1))
    train_multiple_epochs(dataset, dataset, model, epochs=2, batch_size=BATCH, lr=1e-3,
                          lr_decay_factor=0.1, lr_decay_step_size=50, ARR=0.001,
                          flat_aggregate="pallas", profile_dir=str(tmp_path),
                          device="cpu", progress=False)
    with open(tmp_path / "epoch2.trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for name in TRAIN + ("kernels.k1", "kernels.k2"):
        assert "igmc:" + name in names, name
    assert not spans.on                 # off again after the profiled epoch
    assert spans.snapshot()["spans"]["train.forward"]["calls"] == 3
