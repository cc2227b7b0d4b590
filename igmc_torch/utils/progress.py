"""A heartbeat for long host loops: the counterpart of the JAX package's
tqdm bars, which a supervisor (cli/resilient.py) reads as liveness.

    beat = Heartbeat("extracting subgraphs", total=n)
    for i in ...:
        ...
        beat(i + 1)         # prints "extracting subgraphs i/n" to stderr,
                            # at most once every HEARTBEAT_S seconds

Nothing goes to stdout (the CLI's lines and log.txt stay as they are).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional

HEARTBEAT_S = 30.0


class Heartbeat:
    """Called with a count of work done; prints `<label> <done>/<total>`
    (or `<label> <done>` without a total) to stderr when `interval`
    seconds of `clock` (default time.monotonic) have passed since it was
    made or last printed."""

    def __init__(self, label: str, total: Optional[int] = None,
                 interval: float = HEARTBEAT_S,
                 clock: Optional[Callable[[], float]] = None):
        self.label, self.total, self.interval = label, total, interval
        self.clock = clock or time.monotonic
        self.last = self.clock()

    def __call__(self, done: int) -> None:
        now = self.clock()
        if now - self.last < self.interval:
            return
        self.last = now
        of = "" if self.total is None else f"/{self.total}"
        print(f"{self.label} {done}{of}", file=sys.stderr, flush=True)
