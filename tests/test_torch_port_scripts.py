"""igmc_torch/scripts, the port's experiment scripts, against the JAX
package's scripts/: run_fdy.sh and run_transfer_exps.sh run with a stub
`python` first on PATH that records its arguments, and both packages'
scripts must record the same argument lists except for the CLI module,
each of which the port's parser accepts; summarize_fdy gives
scripts/summarize_fdy.py's numbers and lines on the same log files; and
transfer_experiment --small runs end to end on the CPU."""

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from igmc_torch.cli.main import build_parser
from igmc_torch.scripts import summarize_fdy, transfer_experiment

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = os.path.join(REPO, "scripts")
PORT_SCRIPTS = os.path.join(REPO, "igmc_torch", "scripts")
MODULES = {"jax": "igmc_tpu.cli.main", "port": "igmc_torch.cli.main"}


def _jax_summarize():
    spec = importlib.util.spec_from_file_location(
        "jax_summarize_fdy", os.path.join(JAX_SCRIPTS, "summarize_fdy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorded(which, script, args, tmp_path):
    """(exit code, [argv of each `python` call]) of one package's script."""
    bin_dir = tmp_path / f"bin_{which}"
    bin_dir.mkdir(exist_ok=True)
    record = tmp_path / f"calls_{which}.jsonl"
    record.write_text("")
    stub = bin_dir / "python"
    stub.write_text(f"#!{sys.executable}\nimport json, sys\n"
                    f"open({str(record)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n")
    stub.chmod(0o755)
    root = JAX_SCRIPTS if which == "jax" else PORT_SCRIPTS
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    out = subprocess.run(["bash", os.path.join(root, script)] + args, env=env,
                         cwd=str(tmp_path), capture_output=True, text=True, timeout=60)
    return out.returncode, [json.loads(l) for l in record.read_text().splitlines()]


@pytest.mark.parametrize("script,args", [
    ("run_fdy.sh", ["flixster"]),
    ("run_fdy.sh", ["yahoo_music"]),
    ("run_transfer_exps.sh", ["flixster"]),
    ("run_transfer_exps.sh", ["douban", "results/src_testmode"]),
    ("run_transfer_exps.sh", ["yahoo_music"]),
    ("run_transfer_exps.sh", ["ml_1m"]),
])
def test_scripts_run_the_same_argv_as_jax(script, args, tmp_path):
    """The same exit code and the same `python` calls as the JAX script,
    the module name aside (run_fdy: five seeds; run_transfer_exps: the
    target's relations and multiplier, or an exit for an unknown one);
    every call parses with the port's build_parser."""
    rc_j, calls_j = _recorded("jax", script, args, tmp_path)
    rc_p, calls_p = _recorded("port", script, args, tmp_path)
    assert rc_p == rc_j
    assert len(calls_p) == len(calls_j) == {"run_fdy.sh": 5}.get(
        script, 0 if args[0] == "ml_1m" else 1)
    for cj, cp in zip(calls_j, calls_p):
        assert cj[:2] == ["-m", MODULES["jax"]] and cp[:2] == ["-m", MODULES["port"]]
        assert cp[2:] == cj[2:]
        parsed = build_parser().parse_args(cp[2:])
        assert parsed.data_name == args[0] and parsed.testing


def test_scripts_pass_extra_flags_through(tmp_path):
    """Flags after the script's own arguments reach every call (e.g.
    --device cpu on a machine without a card)."""
    _, calls = _recorded("port", "run_fdy.sh", ["douban", "--device", "cpu"], tmp_path)
    assert len(calls) == 5 and all(c[-2:] == ["--device", "cpu"] for c in calls)
    _, calls = _recorded("port", "run_transfer_exps.sh",
                         ["douban", "src/", "--device", "cpu"], tmp_path)
    assert calls[0][-2:] == ["--device", "cpu"] and "src/" in calls[0]


def _write_logs(root):
    """log.txt files for three datasets: five seeds of douban, two of
    flixster (one empty), none of yahoo_music."""
    rng = np.random.default_rng(11)
    for name, seeds in (("douban", range(1, 6)), ("flixster", (2, 4))):
        for s in seeds:
            d = os.path.join(root, f"{name}_s{s}_testmode")
            os.makedirs(d)
            lines = [f"Epoch {e}, train loss {rng.random():.4f}, test rmse "
                     f"{rng.random():.6f}\n" for e in range(1, 4)]
            lines.append("Epoch ensemble of range(10, 40, 10), train loss 0.0000, "
                         f"test rmse {0.7 + rng.random() / 10:.6f}\n")
            with open(os.path.join(d, "log.txt"), "w") as f:
                f.writelines(lines if (name, s) != ("flixster", 4) else [])


def test_summarize_equals_jax_script(tmp_path, monkeypatch, capsys):
    """summarize() returns scripts/summarize_fdy.summarize's arrays on the
    same log files (missing and empty logs skipped, any line), and main
    prints the same lines."""
    _write_logs(str(tmp_path))
    jax_mod = _jax_summarize()
    for kw in ({}, {"line_num": 0}, {"datasets": ("flixster",)}):
        want = jax_mod.summarize(str(tmp_path), **kw)
        got = summarize_fdy.summarize(str(tmp_path), **kw)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert list(summarize_fdy.summarize(str(tmp_path))) == ["douban", "flixster"]
    outs = []
    for mod in (jax_mod, summarize_fdy):
        monkeypatch.setattr(sys, "argv", ["summarize_fdy", "--results-root",
                                          str(tmp_path)])
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "$\\pm$" in outs[0]


def test_transfer_experiment_small_on_cpu(tmp_path, monkeypatch, capsys):
    """transfer_experiment --small (1 epoch) on the CPU in a fresh working
    directory: the synthetic ml_100k written under raw_data_synth/, the
    source's one .pth counted, the three Monti targets read from the
    repo's fixtures, and a last JSON line with the JAX script's keys and
    three finite transfer RMSEs."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("IGMC_RAW_DATA", "")
    transfer_experiment.main(["--small", "--epochs", "1", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"source", "epochs", "pth_exported", "flixster_transfer_rmse",
                            "douban_transfer_rmse", "yahoo_music_transfer_rmse"}
    assert summary["epochs"] == 1 and summary["pth_exported"] == 1
    assert summary["source"] == "results/ml_100k_mnph200_testmode"
    for name in ("flixster", "douban", "yahoo_music"):
        assert math.isfinite(summary[f"{name}_transfer_rmse"])
    assert (tmp_path / "raw_data_synth" / "ml_100k" / "u1.base").is_file()
    assert transfer_experiment.target_root("flixster", "raw_data_synth") == \
        transfer_experiment.FIXTURES
