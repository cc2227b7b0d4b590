"""Spans and counters inside igmc_torch: where the host's time goes.

    from igmc_torch.utils import spans

    spans.enable()
    scores = predictor.predict(users, items)
    snap = spans.snapshot()
    snap["spans"]["serve.subgraphs"]   # {"calls": 1, "seconds": ..., "self_seconds": ...}
    snap["counters"]["serve.calls"]    # 1
    spans.disable()

Off (the default), `span(name)` returns one shared context that does
nothing: it reads no clock and builds no object, `spanned` functions call
straight through, and `count` and `set_group` return at once. On
(`enable()`), every span is kept in memory as one record: its name, start
and end (time.perf_counter_ns), the index of the span that encloses it on
the same thread (its parent, -1 at the top), the thread and a group. The
buffer holds CAPACITY records; the counter `spans.dropped` counts the spans
that did not fit. While a torch.profiler is recording, an open span is also
a `record_function("igmc:<name>")` range, so the profiler's trace
(`--profile-dir`) carries the program's spans on its own clock.

A group ties the spans of one unit of work together: `set_group(g)` sets
the group of the spans this thread opens next. The spans of serving call
i (the `serve.calls` count) share i, the spans of training step i of a
pass share i, and so does the loader's collation of batch i of the pass,
on whichever thread made it.

The program's spans and counters (PERF.md §3 names the metric each feeds):

  * serving (serve.py): serve.subgraphs (graphs.extract, graphs.pack),
    serve.upload, serve.buckets, serve.rows (pass.plan), serve.members
    (pass.assemble), serve.fetch; counters serve.calls and
    serve.member_forwards (the ensemble forwards run: one a row when the
    members are folded into one stacked forward, M a row when they run
    in turn);
  * training (train/loop.py): train.fetch, train.inputs, train.forward
    (kernels.k1), train.backward (kernels.k2), train.optimizer;
    pass.plan, pass.assemble; counters train.steps, batch.edges,
    batch.edge_slots;
  * the loader's threads (batching/dataset.py): loader.fetch,
    loader.collate, loader.plan, loader.pin; counters loader.plans_native,
    loader.plans_numpy (the block plans each engine built);
  * collation (batching/batch.py): counters batch.collate_native,
    batch.collate_numpy (the flat batches each engine collated).

Thread-safe: the loader's prefetch threads record beside the main thread.
The state is the process's, as the kernels' launch counters are.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import Counter
from typing import NamedTuple

import torch.autograd.profiler as _profiler

PREFIX = "igmc:"
CAPACITY = 1_000_000

on = False

_lock = threading.Lock()
_records: list = []
_counters: Counter = Counter()
_generation = 0          # reset() bumps it; spans opened before do not record
_local = threading.local()


class Record(NamedTuple):
    """One finished span."""
    index: int           # its place in the buffer
    name: str
    start_ns: int
    end_ns: int
    parent: int          # index of the enclosing span on its thread, or -1
    thread: int
    group: int


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "index", "generation", "parent", "group", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.group = getattr(_local, "group", -1)
        with _lock:
            self.generation = _generation
            outer = stack[-1] if stack else None
            self.parent = (outer.index if outer is not None
                           and outer.generation == _generation else -1)
            self.index = len(_records)
            if self.index < CAPACITY:
                _records.append(None)
            else:
                self.index = -1
                _counters["spans.dropped"] += 1
        stack.append(self)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        if self.index >= 0:
            rec = (self.name, self.start, end, self.parent, threading.get_ident(),
                   self.group)
            with _lock:
                if self.generation == _generation:
                    _records[self.index] = rec
        return False


def span(name: str):
    """A context that times its body as span `name` (nothing when off)."""
    return _Span(name) if on else _OFF


def spanned(name: str):
    """Decorator: every call of the function inside span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            if not on:
                return fn(*args, **kw)
            with _Span(name):
                return fn(*args, **kw)
        return inner
    return wrap


def count(name: str, n: int = 1) -> int:
    """Add `n` to counter `name`; returns its new value (0 when off).
    Compute an argument that costs work only `if spans.on`."""
    if not on:
        return 0
    with _lock:
        _counters[name] += n
        return _counters[name]


def set_group(group: int) -> None:
    """The group of the spans this thread opens next (nothing when off)."""
    if on:
        _local.group = int(group)


def enable() -> bool:
    """Record spans and counters from now on; returns whether they were
    recorded already."""
    global on
    was, on = on, True
    return was


def disable() -> None:
    """Stop recording; what was recorded stays until reset()."""
    global on
    on = False


def reset() -> None:
    """Forget every record and counter (spans open now are not recorded)."""
    global _generation
    with _lock:
        _records.clear()
        _counters.clear()
        _generation += 1


def snapshot() -> dict:
    """What was recorded since the last reset():

    {"spans": {name: {"calls", "seconds", "self_seconds"}},
     "counters": {name: value}, "records": [Record, ...]}

    A span's self seconds are its duration less its children's (the spans
    it enclosed on its thread). Spans still open are left out."""
    with _lock:
        raw = list(_records)
        counters = dict(_counters)
    counters.setdefault("spans.dropped", 0)
    records = [Record(i, *r) for i, r in enumerate(raw) if r is not None]
    covered = Counter()
    for r in records:
        if r.parent >= 0:
            covered[r.parent] += r.end_ns - r.start_ns
    sums = {}
    for r in records:
        s = sums.setdefault(r.name, [0, 0, 0])
        s[0] += 1
        s[1] += r.end_ns - r.start_ns
        s[2] += r.end_ns - r.start_ns - covered[r.index]
    return {"spans": {name: {"calls": c, "seconds": ns / 1e9, "self_seconds": own / 1e9}
                      for name, (c, ns, own) in sums.items()},
            "counters": counters, "records": records}
