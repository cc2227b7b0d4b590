"""The harness's own spans around the program's calls.

A span sums the host seconds spent inside it per name. In a traced run
(`on`) each span is also a `torch.profiler.record_function` range named
`pb:<name>`, so that the device trace can say which span the host was in
during an idle gap. In an untraced run a span does nothing.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

PREFIX = "pb:"


class Spans:
    def __init__(self, on: bool):
        self.on = on
        self.seconds = defaultdict(float)

    @contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(PREFIX + name):
            yield
        self.seconds[name] += time.perf_counter() - t0

    def reset(self):
        """Forget what was summed so far (the set-up's spans)."""
        self.seconds.clear()

    def wrap(self, name: str, fn):
        """`fn` with every call inside span `name`."""
        if not self.on:
            return fn

        def timed(*args, **kw):
            with self(name):
                return fn(*args, **kw)

        return timed

    def timed_iter(self, name: str, iterable):
        """`iterable` with every next() inside span `name`."""
        it = iter(iterable)
        while True:
            with self(name):
                item = next(it, StopIteration)
            if item is StopIteration:
                return
            yield item
