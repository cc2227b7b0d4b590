"""Every cell run end to end on the CPU at a small size: the reference
agrees with the port's CPU path, and a run with the timed path broken
underneath (each fault the cell can have) comes out not correct. A
`cuda` test holds the control (the reference in TF32 put in the
program's place) to failing on the card."""

import json
import os

import pytest

from portbench.run import run_cell

from .conftest import ROOT

SMALL = {
    "ml1m-train-dense": dict(config_over={"data": {"train_pool": 150}}),
    "yahoo-train-dense": dict(config_over={"data": {"train_pool": 150}}),
    "ml1m-train-pallas": dict(config_over={"data": {"train_pool": 150}}),
    "ml1m-serve-rerank": dict(params_over={"request_set": 4, "warmup_calls": 1,
                                           "traced_calls": 1, "compared_calls": 2}),
}
# cells whose runner, configuration and limits the harness keeps while
# BENCHMARK.json leaves them out (PERF.md, open questions)
PARKED = {"ml1m-train-dense": ("igmc-ml1m", "train-dense"),
          "yahoo-train-dense": ("igmc-yahoo", "train-dense")}
FAULTS = [("ml1m-train-dense", "frozen"), ("ml1m-train-dense", "half_batch"),
          ("yahoo-train-dense", "frozen"), ("yahoo-train-dense", "half_batch"),
          ("ml1m-train-pallas", "frozen"), ("ml1m-train-pallas", "half_batch"),
          ("ml1m-serve-rerank", "altered")]


def _bench():
    """BENCHMARK.json with the parked cells added."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    have = {c["name"] for c in b["configs"]}
    b["configs"] += [{"name": c, "file": f"portbench/configs/{c}.json"}
                     for c in sorted({c for c, _ in PARKED.values()} - have)]
    have = {w["name"] for w in b["workloads"]}
    b["workloads"] += [{"name": n, "config": c, "traffic": t, "chips": 1}
                       for n, (c, t) in PARKED.items() if n not in have]
    return b


@pytest.mark.parametrize("cell", list(SMALL))
def test_reference_agrees_with_the_port_on_the_cpu(cell, cache):
    result, outcome = run_cell(cell, 2**31 + 77, 0.1, False, device="cpu", cache=cache,
                               bench=_bench(), **SMALL[cell])
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault, cache):
    result, _ = run_cell(cell, 2**31 + 78, 0.1, False, device="cpu", fault=fault,
                         cache=cache, bench=_bench(), **SMALL[cell])
    assert not result["correct"], result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_the_control_is_not_correct_on_the_card(cell, card, cache):
    for seed in (11, 12, 13):
        result, _ = run_cell(cell, seed, 0.5, False, device=card, control="tf32",
                             cache=cache, bench=_bench(), **SMALL[cell])
        assert not result["correct"], result["compared"]
