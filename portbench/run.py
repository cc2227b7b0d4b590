#!/usr/bin/env python3
"""Run one cell of the benchmark of igmc_torch once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The cell's entry
there names its configuration (portbench/configs/<config>.json) and its
traffic mix (portbench/traffic/<traffic>.json, whose `kind` names the
runner portbench/traffic/<kind>.py); portbench/workloads/<cell>.json, if
present, adds the cell's own settings over the mix. With --trace 0 the
last line of standard output carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, each read by portbench/metrics/<name>.py
from what the run recorded. The numbers that decide `correct` are printed
beside their limits as the last lines of standard error and under the
result's last key, `compared`.

The run needs a CUDA card: without one (or with fewer than the cell
asks for) it exits 3 and prints no result. It exits 4 and prints no result
if jax, jaxlib, flax or igmc_tpu was loaded by the end of the run.
Caches of the program's builds stay inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "igmc_tpu")


def _environment():
    """Fixed cache directories inside the checkout; no JAX in libraries."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_setup(bench: dict, workload: str, config_over=None, params_over=None):
    """(cell entry, configuration, parameters) of `workload`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = _merge(load_json(os.path.join(ROOT, config["file"])), config_over)
    params = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    own = os.path.join(HERE, "workloads", f"{workload}.json")
    if os.path.isfile(own):
        params = _merge(params, load_json(own))
    return cell, config, _merge(params, params_over)


def _metrics(bench: dict, cell: str, trace: bool, outcome):
    """{name: {value, unit}} of the cell's end-to-end metrics (trace off)
    or per-layer metrics (trace on); a reader that finds nothing to read
    leaves its metric out."""
    out = {}
    if not trace:
        for m in bench["end_to_end"]:
            if cell in m.get("workloads", [cell]) and m["name"] in outcome.end_to_end:
                out[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
        return out
    for m in bench["per_layer"]:
        if cell not in m.get("workloads", [cell]):
            continue
        reader = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                             "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(outcome.layer)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             control=None, fault=None, config_over=None, params_over=None, t0=None,
             cache=None, bench=None):
    """Run one cell; returns (result dict, Outcome). `device` defaults to the
    first card; the CPU (tests), a calibration `control` and a planted
    `fault` (tests) are not for the benchmark's own runs, nor is a `cache`
    dict that keeps the data and datasets across runs of one process, nor
    a `bench` in BENCHMARK.json's place (tests of cells it does not hold)."""
    _environment()
    import torch

    from portbench.lib.cell import Context
    from portbench.lib.spans import Spans

    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, params = cell_setup(bench, workload, config_over, params_over)
    dev = torch.device(device or "cuda:0")
    tf32 = bool(config["model"].get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    runner = importlib.import_module(f"portbench.traffic.{params['kind']}")
    ctx = Context(cell=workload, config=config, params=params, seed=seed,
                  seconds=seconds, trace=trace, device=dev,
                  t0=T0 if t0 is None else t0, spans=Spans(trace),
                  control=control, fault=fault, cache=cache)
    outcome = runner.run(ctx)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": bool(outcome.correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": _metrics(bench, workload, trace, outcome),
              "device": device_info}
    if trace and outcome.trace is not None:
        device_info["busy_s"] = outcome.trace.busy_s
        device_info["window_s"] = outcome.trace.window_s
        result["breakdown"] = {"device_ops": outcome.trace.top_ops(10),
                               "idle_gaps": outcome.trace.idle_gaps(10)}
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in outcome.compared}
    return result, outcome


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    if not os.path.isfile(os.path.join(ROOT, "BENCHMARK.json")):
        print("no BENCHMARK.json at the checkout's root", file=sys.stderr)
        return 2
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, outcome = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures igmc_torch "
              f"alone", file=sys.stderr)
        return 4
    for note in outcome.notes:
        print(note, file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
