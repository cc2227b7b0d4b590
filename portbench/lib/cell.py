"""What run.py hands a traffic runner, and what the runner hands back."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .spans import Spans
from .trace import DeviceTrace


@dataclass
class Context:
    cell: str              # the workload's name in BENCHMARK.json
    config: dict           # portbench/configs/<config>.json
    params: dict           # portbench/traffic/<traffic>.json, then workloads/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: object         # torch.device
    t0: float              # time.perf_counter() at process start
    spans: Spans = None
    control: Optional[str] = None   # calibration only: "tf32" runs the reference's control
    fault: Optional[str] = None     # tests only: a fault planted in the timed path
    cache: Optional[dict] = None    # calibration only: data and datasets kept across runs

    stages: List[Tuple[str, float]] = field(default_factory=list)

    def since_start(self) -> float:
        return time.perf_counter() - self.t0

    def stage(self, name: str):
        """Mark the end of a stage of set-up."""
        self.stages.append((name, self.since_start()))

    def stage_notes(self) -> List[str]:
        return [f"{name} (done at {t:.3f} s)" for name, t in self.stages]


@dataclass
class Outcome:
    end_to_end: Dict[str, float]
    layer: Dict[str, object]               # what the per-layer metric readers read
    compared: List[Tuple[str, float, float]]
    correct: bool
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[DeviceTrace] = None
    notes: List[str] = field(default_factory=list)
    leaves: Optional[list] = None          # training: the worst change leaves (calibration)
