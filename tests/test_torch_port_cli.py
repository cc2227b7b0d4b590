"""igmc_torch's CLI against the JAX package's CLI on a small synthetic
ML-1M (igmc_tpu.data.synthetic.write_ml1m_format; the port on --device
cpu): the same `batch mode` and `dense layout` lines under each layout
rule (dynamic data included), a training run with --ensemble writing
log.txt in the same format with RMSEs in a stated band, the files of a
results directory, every unported flag refused by name, the flat engines
(segment, blocked, DGCNN's flat form) trained through the CLI,
ml_100k's official split with side features trained by both CLIs to RMSEs
in a stated band, and the multi-device modes (--n-devices, --parallel ep,
--ep-local-aggregate) trained through the CLI on two CPU ranks, with the
JAX CLI's exits. The main path's
options (--compute-dtype, --dense-chunk, --dense-strategy, --flat-aggregate
segment) are in test_torch_port_options.py."""

import os
import re

import numpy as np
import pytest
import torch

from igmc_tpu.cli.main import main as jax_main
from igmc_tpu.data.synthetic import write_ml1m_format, write_ml100k_format

from igmc_torch.cli.main import (build_parser, check_ep, choose_layouts,
                                 main as port_main, parallel_mode, unported_flags)

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
    (["--flat-aggregate", "segment"],           # no flat engine: dense, as in JAX
     ["batch mode: dense (auto)", "dense layout: bipartite (auto)"]),
    (["--dense-chunk", "5"],
     ["batch mode: dense (--dense-chunk)", "dense layout: bipartite (auto)"]),
    (["--dense-strategy", "adjacency"],         # auto keeps the unified layout
     ["batch mode: dense (auto)", "dense layout: unified (auto)"]),
    (["--dynamic-dataset"],                     # dynamic data: unified slots
     ["batch mode: dense (auto)", "dense layout: unified (auto)"]),
    (["--batch-mode", "flat"], []),             # the segment engine
    (["--flat-aggregate", "blocked"], ["batch mode: flat (--flat-aggregate blocked)"]),
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


# flags of the flat engines and the multi-device modes, refused until they
# were ported: they pass unported_flags and choose the JAX CLI's (layout,
# engine), or the edge-partitioned path ("ep"), or exit with its own
# message (--batch-size 25 does not split over 2, 4 or 8 devices, so the
# auto batch mode under --n-devices is flat, as in the JAX CLI)
PORTED = "ported: "


@pytest.mark.parametrize("flags,named", [
    (["--parallel", "ep"], PORTED + "ep"),
    (["--n-devices", "2"], PORTED + "flat segment"),
    (["--dynamic-train", "--parallel", "ep"], PORTED + "ep"),
    (["--dynamic-dataset", "--visualize"], "--visualize (it draws with matplotlib)"),
    (["--model", "dgcnn", "--parallel", "ep"],
     PORTED + "--parallel ep implements the IGMC model"),
    (["--batch-mode", "flat", "--flat-aggregate", "segment"], PORTED + "flat segment"),
    (["--dynamic-test", "--model", "gnn", "--visualize"],
     "--visualize (it draws with matplotlib)"),
    (["--dense-chunk", "10", "--parallel", "ep"],
     PORTED + "--dense-chunk is the single-device giant-batch path"),
    (["--visualize"], "--visualize (it draws with matplotlib)"),
    (["--profile-dir", "p", "--flat-aggregate", "blocked"], PORTED + "flat blocked"),
    (["--dynamic-val", "--n-devices", "4"], PORTED + "flat segment"),
    (["--model", "gnn", "--batch-mode", "flat"], PORTED + "flat segment"),
    (["--model", "dgcnn_rs", "--n-devices", "2"], PORTED + "flat segment"),
    (["--n-devices", "8", "--compute-dtype", "bfloat16"], PORTED + "flat segment"),
    (["--flat-aggregate", "blocked"], PORTED + "flat blocked"),
    (["--batch-mode", "flat"], PORTED + "flat segment"),
    (["--dense-chunk", "5", "--dynamic-train", "--model", "dgcnn",
      "--flat-aggregate", "blocked"],
     PORTED + "--flat-aggregate blocked/pallas applies to the R-GCN trunk; "
              "use --model igmc"),
    (["--dense-chunk", "5", "--n-devices", "2"],
     PORTED + "--dense-chunk is single-device; for multi-chip giant batches"),
])
def test_unported_flags_are_refused_by_name(flags, named, tmp_path, monkeypatch):
    """Flags of code not ported exit naming the flag before any data is
    read. The flat engines' and the multi-device modes' flags (PORTED)
    pass unported_flags and choose the flat layout and their engine, or
    the edge-partitioned path, or exit with the JAX CLI's message."""
    monkeypatch.chdir(tmp_path)
    if not named.startswith(PORTED):
        with pytest.raises(SystemExit, match=re.escape(named) + ".*not ported"):
            port_main(BASE + flags + ["--device", "cpu"])
        assert not os.path.exists(tmp_path / "results")
        return
    args = build_parser().parse_args(BASE + flags + ["--device", "cpu"])
    assert unported_flags(args) == []
    want = named[len(PORTED):]
    if parallel_mode(args) == "ep":
        if want.startswith("--"):
            with pytest.raises(SystemExit, match=re.escape(want)):
                check_ep(args)
        else:
            check_ep(args)
            assert want == "ep"
    elif want.startswith("--"):
        with pytest.raises(SystemExit, match=re.escape(want)):
            choose_layouts(args, None)
    else:
        mode, engine = want.split()
        assert choose_layouts(args, None) == (
            mode, None if engine == "segment" else engine, "unified")


@pytest.mark.parametrize("flags", [["--batch-mode", "flat"],
                                   ["--flat-aggregate", "blocked"],
                                   ["--model", "dgcnn", "--batch-mode", "flat"]])
def test_flat_engines_train_through_the_cli(raw, tmp_path, monkeypatch, capsys, flags):
    """The flat engines through the CLI (the segment engine, the blocked
    engine, DGCNN's flat form), 2 epochs on 60 + 20 pairs: log.txt holds
    two epoch lines in the JAX format with finite RMSEs; for the segment
    engine the JAX CLI's RMSEs lie within 0.25 of the port's (another
    noise stream, 2 epochs)."""
    argv = BASE + ["--max-train-num", "60", "--max-test-num", "20", "--epochs", "2",
                   "--max-nodes-per-hop", "10"] + flags
    whos = ("port", "jax") if flags == ["--batch-mode", "flat"] else ("port",)
    logs = {}
    for w in whos:
        run(w, argv, raw, str(tmp_path / w), monkeypatch, capsys)
        with open(os.path.join(str(tmp_path / w), "results", "ml_1m_testmode",
                               "log.txt")) as f:
            logs[w] = f.read().splitlines()
        assert [LOG_LINE.match(l).group(1) for l in logs[w]] == ["1", "2"], logs[w]
        assert all(np.isfinite(float(LOG_LINE.match(l).group(2))) for l in logs[w])
    if "jax" in logs:
        for a, b in zip(logs["port"], logs["jax"]):
            assert abs(float(LOG_LINE.match(a).group(2))
                       - float(LOG_LINE.match(b).group(2))) < 0.25, (a, b)


def test_cli_defaults_datasets_and_device(raw, tmp_path, monkeypatch):
    """The JAX CLI's defaults plus --device cuda; a Monti dataset whose
    file is absent raises naming it; the default device raises without a
    card."""
    args = build_parser().parse_args([])
    assert (args.device, args.batch_mode, args.dense_layout, args.superbatch,
            args.dense_buckets, args.epochs, args.batch_size) == (
        "cuda", "auto", "auto", 8, 3, 80, 50)
    assert unported_flags(args) == []
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("IGMC_RAW_DATA", raw)
    with pytest.raises(FileNotFoundError,
                       match="flixster/training_test_dataset.mat not found"):
        port_main(["--data-name", "flixster", "--device", "cpu"])
    with pytest.raises(SystemExit, match="conflicts"):
        port_main(BASE + ["--flat-aggregate", "pallas", "--batch-mode", "dense",
                          "--max-train-num", "20", "--max-test-num", "20",
                          "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(BASE)


def test_ml100k_with_features_matches_jax_cli(tmp_path_factory, tmp_path,
                                             monkeypatch, capsys):
    """ml_100k's official u1.base / u1.test split with --use-features, 2
    epochs and the ensemble, through both CLIs (the C++ extraction engine
    on both sides): the same split and features lines, log.txt in the same
    format, and test RMSEs within 0.15 of each other after each epoch and
    in the ensemble line (each side draws its own init and dropout;
    measured: 0.021 apart after epoch 1, 0.056 after epoch 2)."""
    raw = tmp_path_factory.mktemp("raw100k")
    write_ml100k_format(str(raw), n_users=120, n_movies=100, n_ratings=2500,
                        seed=4)
    argv = ["--data-name", "ml_100k", "--testing", "--ensemble",
            "--use-features", "--epochs", "2", "--save-interval", "1",
            "--max-train-num", "600", "--max-test-num", "200",
            "--batch-size", "25", "--lr", "0.005"]
    logs, outs = {}, {}
    for w in ("jax", "port"):
        outs[w] = run(w, argv, str(raw), str(tmp_path / w), monkeypatch, capsys)
        logs[w] = (tmp_path / w / "results" / "ml_100k_testmode" / "log.txt"
                   ).read_text().splitlines()
    for line in ("Using official MovieLens split u1.base/u1.test with 20% "
                 "validation...",):
        assert line in outs["jax"] and line in outs["port"]
    feats = [[l for l in outs[w] if l.startswith("Number of user features")]
             for w in ("jax", "port")]
    assert feats[0] == feats[1] and len(feats[0]) == 1
    assert len(logs["port"]) == len(logs["jax"]) == 3
    for got, want in zip(logs["port"], logs["jax"]):
        mg, mw = LOG_LINE.match(got), LOG_LINE.match(want)
        assert mg and mw, (got, want)
        assert mg.group(1) == mw.group(1)
        assert abs(float(mg.group(2)) - float(mw.group(2))) < 0.15, (got, want)
    assert logs["port"][-1].startswith("Epoch ensemble of range(-28, 2, 10),")


def test_unported_flags_name_only_visualize():
    """Of the JAX CLI's flags, only --visualize is refused: every other one
    passes unported_flags, the multi-device ones included."""
    args = build_parser().parse_args(
        ["--parallel", "ep", "--n-devices", "8", "--ep-local-aggregate", "blocked",
         "--visualize"])
    assert unported_flags(args) == ["--visualize (it draws with matplotlib)"]
    args.visualize = False
    assert unported_flags(args) == []


@pytest.fixture(scope="module")
def raw100k(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw100k_multi")
    write_ml100k_format(str(root), n_users=120, n_movies=100, n_ratings=2500, seed=4)
    return str(root)


ML100K = ["--data-name", "ml_100k", "--testing", "--max-train-num", "200",
          "--max-test-num", "50", "--batch-size", "10"]


@pytest.mark.parametrize("flags,msg", [
    (["--parallel", "ep", "--model", "gnn"], "--parallel ep implements the IGMC model"),
    (["--parallel", "ep", "--dense-chunk", "5"], "--dense-chunk is the single-device"),
    (["--parallel", "ep", "--dense-layout", "unified"], "--dense-layout applies to"),
    (["--n-devices", "2", "--dense-chunk", "5"], "--dense-chunk is single-device;"),
])
def test_multi_device_exits_match_jax(raw100k, tmp_path, monkeypatch, flags, msg):
    """The JAX CLI's exits under --parallel ep (another model, --dense-chunk,
    --dense-layout) and --dense-chunk with --n-devices > 1: the port exits
    with the JAX CLI's message, word for word."""
    monkeypatch.setenv("IGMC_RAW_DATA", raw100k)
    got = {}
    for w, main in (("jax", jax_main), ("port", port_main)):
        monkeypatch.chdir(tmp_path)
        argv = ML100K + flags + (["--device", "cpu"] if w == "port" else [])
        with pytest.raises(SystemExit) as e:
            main(argv)
        got[w] = str(e.value)
    assert got["port"] == got["jax"] and got["port"].startswith(msg)


@pytest.mark.parametrize("flags,line", [
    (["--n-devices", "2"], "Data-parallel training over 2 devices"),
    (["--parallel", "ep", "--n-devices", "2"], "Edge-partitioned training over 2 devices"),
    (["--parallel", "ep", "--n-devices", "2", "--ep-local-aggregate", "blocked"],
     "Edge-partitioned training over 2 devices"),
])
def test_multi_device_cli_trains_on_two_cpu_ranks(raw100k, tmp_path, monkeypatch,
                                                  capfd, flags, line):
    """--device cpu with two ranks (gloo) on the offline ml_100k fixture,
    1 epoch with --ensemble: rank 0 prints the JAX CLI's line and writes
    log.txt in the JAX format (the epoch line and the ensemble line, finite
    RMSEs; after DP the ensemble runs on one device, after EP through
    test_once_ep). Data-parallel training equals the single-device CLI run
    on the same flags: its epoch RMSE within 1e-5."""
    monkeypatch.setenv("IGMC_RAW_DATA", raw100k)
    argv = ML100K + ["--epochs", "1", "--ensemble", "--save-interval", "1",
                     "--device", "cpu"]
    logs = {}
    runs = {"multi": flags} | ({"single": []} if "ep" not in flags else {})
    for name, extra in runs.items():
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        capfd.readouterr()
        port_main(argv + extra)
        out = capfd.readouterr().out.splitlines()
        logs[name] = (tmp_path / name / "results" / "ml_100k_testmode" / "log.txt"
                      ).read_text().splitlines()
        if name == "multi":
            assert line in out
            assert "batch mode: dense (auto)" in out or "ep" in flags
    log = logs["multi"]
    assert len(log) == 2, log
    assert LOG_LINE.match(log[0]).group(1) == "1"
    assert log[1].startswith("Epoch ensemble of range(-29, 1, 10),")
    assert all(np.isfinite(float(LOG_LINE.match(l).group(2))) for l in log)
    if "single" in logs:
        a, b = (float(LOG_LINE.match(logs[k][0]).group(2)) for k in ("multi", "single"))
        assert abs(a - b) < 1e-5, (a, b)
