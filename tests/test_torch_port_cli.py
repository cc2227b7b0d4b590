"""igmc_torch's CLI against the JAX package's CLI on a small synthetic
ML-1M (igmc_tpu.data.synthetic.write_ml1m_format; the port on --device
cpu): the same `batch mode` and `dense layout` lines under each layout
rule, a training run with --ensemble writing log.txt in the same format
with RMSEs in a stated band, the files of a results directory, and every
unported flag refused by name."""

import os
import re

import numpy as np
import pytest
import torch

from igmc_tpu.cli.main import main as jax_main
from igmc_tpu.data.synthetic import write_ml1m_format

from igmc_torch.cli.main import build_parser, main as port_main, unported_flags

torch.set_num_threads(1)

# ratings dense enough that the median subgraph has >= 128 nodes at
# --max-nodes-per-hop 100, as ML-1M's has: the auto rule picks bipartite
BASE = ["--data-name", "ml_1m", "--testing", "--max-nodes-per-hop", "100",
        "--batch-size", "25"]
LOG_LINE = re.compile(r"^Epoch (\d+|ensemble of range\(-?\d+, \d+, \d+\)), "
                      r"train loss \d+\.\d{4}, test rmse (\d+\.\d{6})$")
LAYOUT_LINE = re.compile(r"^(batch mode|dense layout): ")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=150, n_movies=120, n_ratings=10000, seed=0)
    return str(root)


def run(which, argv, raw, cwd, monkeypatch, capsys):
    """One CLI's main in `cwd`; returns its stdout lines."""
    monkeypatch.setenv("IGMC_RAW_DATA", raw)
    os.makedirs(cwd, exist_ok=True)
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    if which == "jax":
        jax_main(argv)
    else:
        port_main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("flags,want", [
    ([], ["batch mode: dense (auto)", "dense layout: bipartite (auto)"]),
    (["--max-nodes-per-hop", "10"],             # small graphs
     ["batch mode: dense (auto)", "dense layout: unified (auto)"]),
    (["--flat-aggregate", "pallas"], ["batch mode: flat (--flat-aggregate pallas)"]),
    (["--batch-mode", "dense", "--dense-layout", "unified"], []),
    (["--dense-layout", "bipartite"], ["batch mode: dense (auto)"]),
])
def test_layout_lines_match_jax(raw, tmp_path, monkeypatch, capsys, flags, want):
    argv = BASE + ["--no-train", "--max-train-num", "60", "--max-test-num", "20"] + flags
    lines = {w: [l for l in run(w, argv, raw, str(tmp_path / w), monkeypatch, capsys)
                 if LAYOUT_LINE.match(l)] for w in ("jax", "port")}
    assert lines["port"] == lines["jax"] == want


def test_training_run_matches_jax_cli(raw, tmp_path, monkeypatch, capsys):
    """Both CLIs train 3 epochs from their own seeded inits (JAX's PRNGKey,
    the port's torch generator) with their own dropout noise, checkpoint
    every epoch and ensemble: log.txt has the same lines in the same
    format, both losses fall, and the test RMSEs agree within 0.25 after
    every epoch and within 0.05 after the last, and in the ensemble line
    (measured: 0.163 apart after epoch 1, 0.0066 after epoch 3)."""
    argv = BASE + ["--ensemble", "--epochs", "3", "--save-interval", "1",
                   "--max-train-num", "200", "--max-test-num", "100", "--lr", "0.005"]
    logs, outs = {}, {}
    for w in ("jax", "port"):
        outs[w] = run(w, argv, raw, str(tmp_path / w), monkeypatch, capsys)
        res = tmp_path / w / "results" / "ml_1m_testmode"
        logs[w] = (res / "log.txt").read_text().splitlines()
        assert (res / "cmd_input.txt").read_text().startswith("python ")
        assert (res / "source_snapshot.txt").is_file()
    port_res = tmp_path / "port" / "results" / "ml_1m_testmode"
    snapshot = (port_res / "source_snapshot.txt").read_text()
    assert " cli/main.py\n" in snapshot and "rgcn_aggregate_fwd.cu" in snapshot
    for e in (1, 2, 3):
        for kind in ("model", "optimizer"):
            assert (port_res / f"{kind}_checkpoint{e}.pth").is_file()
    assert len(logs["port"]) == len(logs["jax"]) == 4
    for i, (got, want) in enumerate(zip(logs["port"], logs["jax"])):
        mg, mw = LOG_LINE.match(got), LOG_LINE.match(want)
        assert mg and mw, (got, want)
        assert mg.group(1) == mw.group(1)
        band = 0.25 if i < 2 else 0.05
        assert abs(float(mg.group(2)) - float(mw.group(2))) < band, (got, want)
    for w in ("jax", "port"):
        losses = [float(l.split(",")[1].split()[-1]) for l in logs[w][:3]]
        assert losses[2] < losses[0]
        assert np.isfinite(float(logs[w][-1].split()[-1]))
        assert "Ensemble test rmse is: " + logs[w][-1].split()[-1] in outs[w]


@pytest.mark.parametrize("flags,named", [
    (["--parallel", "ep"], "--parallel ep"),
    (["--n-devices", "2"], "--n-devices 2"),
    (["--dynamic-train"], "--dynamic-*"),
    (["--dynamic-dataset"], "--dynamic-*"),
    (["--use-features"], "--use-features"),
    (["--dense-chunk", "10"], "--dense-chunk"),
    (["--compute-dtype", "bfloat16"], "--compute-dtype bfloat16"),
    (["--dense-strategy", "adjacency"], "--dense-strategy adjacency"),
    (["--visualize"], "--visualize"),
    (["--profile-dir", "p"], "--profile-dir"),
    (["--extract-backend", "native"], "--extract-backend native"),
    (["--model", "gnn"], "--model gnn"),
    (["--model", "dgcnn_rs"], "--model dgcnn_rs"),
    (["--flat-aggregate", "segment"], "--flat-aggregate segment"),
    (["--flat-aggregate", "blocked"], "--flat-aggregate blocked"),
    (["--batch-mode", "flat"], "segment engine"),
])
def test_unported_flags_are_refused_by_name(flags, named, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=re.escape(named) + ".*not ported"):
        port_main(BASE + flags + ["--device", "cpu"])
    assert not os.path.exists(tmp_path / "results")


def test_cli_defaults_datasets_and_device(raw, tmp_path, monkeypatch):
    """The JAX CLI's defaults plus --device cuda; other datasets exit naming
    what is missing; the default device raises without a card."""
    args = build_parser().parse_args([])
    assert (args.device, args.batch_mode, args.dense_layout, args.superbatch,
            args.dense_buckets, args.epochs, args.batch_size) == (
        "cuda", "auto", "auto", 8, 3, 80, 50)
    assert unported_flags(args) == []
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("IGMC_RAW_DATA", raw)
    with pytest.raises(SystemExit, match="flixster.*not ported"):
        port_main(["--data-name", "flixster", "--device", "cpu"])
    with pytest.raises(SystemExit, match="conflicts"):
        port_main(BASE + ["--flat-aggregate", "pallas", "--batch-mode", "dense",
                          "--max-train-num", "20", "--max-test-num", "20",
                          "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(BASE)
