"""A device trace of a slice of work, and what the harness reads from it.

`traced(fn)` runs `fn()` under torch.profiler (CPU and CUDA activity),
ends with a synchronise, and returns a DeviceTrace: every kernel the card
ran (name, start, end, in the profiler's microseconds), the harness's
`pb:` spans on the host, and the slice's window. From it:

  * busy_s: the union of the kernels' intervals within the window;
  * window_s: the window's length, from the harness's `pb:window` range;
  * top_ops: the kernels that took most device time, summed by name;
  * idle_gaps: the longest stretches of the window in which no kernel ran,
    each named by the innermost harness span the host was in when the gap
    began ("host" when none was open);
  * count(name) / device_s(name): launches and device seconds of the
    kernels whose name contains `name`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from .spans import PREFIX


@dataclass
class DeviceTrace:
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _merged(self):
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels
                     if e > lo and s < hi)
        out = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged()) / 1e6

    def count(self, name: str) -> int:
        return sum(1 for k, _, _ in self.kernels if name in k)

    def device_s(self, name: str) -> float:
        return sum(e - s for k, s, e in self.kernels if name in k) / 1e6

    def top_ops(self, n: int = 10):
        tot = {}
        for k, s, e in self.kernels:
            tot[k] = tot.get(k, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        lo, hi = self.window
        merged, gaps, cur = self._merged(), [], lo
        for s, e in merged:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for s, e in longest:
            inner = [sp for sp in self.spans if sp[1] <= s < sp[2]]
            name = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "host"
            out.append([name, (e - s) / 1e6])
        return out


def traced(fn) -> DeviceTrace:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(PREFIX + "window"):
            fn()
            sync()
    out = DeviceTrace()
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                out.kernels.append((e.name, float(tr.start), float(tr.end)))
        elif e.name.startswith(PREFIX):
            if e.name == PREFIX + "window":
                out.window = (float(tr.start), float(tr.end))
            else:
                out.spans.append((e.name[len(PREFIX):], float(tr.start), float(tr.end)))
    return out
