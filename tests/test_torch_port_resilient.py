"""igmc_torch.cli.resilient, the stall-resilient supervisor, mirroring
tests/test_resilient.py on the port: the resumable epoch (model AND
optimizer `.pth`), a stall killed and resumed, the restart budget, stale
checkpoints ignored on the first launch, an exit code never negative and
a clean run of the port's CLI; then what the port adds: a stall kill
takes down every process a spawning child started (torch.multiprocessing,
as --n-devices does), the child runs `python -u` with PYTHONUNBUFFERED,
and the heartbeat the supervisor reads while the port extracts subgraphs
or trains (utils/progress.py, here with a fake clock)."""

import ctypes
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from igmc_torch.cli import resilient
from igmc_torch.cli.resilient import latest_checkpoint_epoch, supervise
from igmc_torch.graphs import BipartiteCSR, extract_many
from igmc_torch.graphs import extract as port_extract
from igmc_torch.graphs import native
from igmc_torch.utils import progress

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_latest_checkpoint_epoch(tmp_path):
    """The largest epoch with both .pth files; a JAX .ckpt, a model file
    without its optimizer file and a malformed name are not resumable."""
    assert latest_checkpoint_epoch(str(tmp_path)) is None
    assert latest_checkpoint_epoch(str(tmp_path / "absent")) is None
    for e in (5, 10):
        for kind in ("model", "optimizer"):
            (tmp_path / f"{kind}_checkpoint{e}.pth").write_bytes(b"x")
    (tmp_path / "model_checkpoint15.pth").write_bytes(b"x")       # no optimizer
    (tmp_path / "model_checkpoint20.ckpt").write_bytes(b"x")      # JAX's
    (tmp_path / "optimizer_checkpoint20.ckpt").write_bytes(b"x")
    (tmp_path / "optimizer_checkpoint25.pth").write_bytes(b"x")   # no model
    (tmp_path / "model_checkpointX.pth").write_bytes(b"x")
    assert latest_checkpoint_epoch(str(tmp_path)) == 10
    (tmp_path / "optimizer_checkpoint15.pth").write_bytes(b"x")
    assert latest_checkpoint_epoch(str(tmp_path)) == 15


def _toy_child(tmp_path):
    """A child that STALLS on the first run (after writing the epoch-3
    checkpoints) and exits 0 once launched with --continue-from 3."""
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        res = sys.argv[1]
        print("child start", sys.argv, flush=True)
        if "--continue-from" not in sys.argv:
            for kind in ("model", "optimizer"):
                open(os.path.join(res, kind + "_checkpoint3.pth"), "wb").close()
            print("checkpoint 3 saved; now wedging", flush=True)
            time.sleep(600)  # wedge: no further output
        else:
            assert sys.argv[sys.argv.index("--continue-from") + 1] == "3"
            print("resumed fine", flush=True)
    """))
    return script


def test_supervise_kills_stall_and_resumes(tmp_path):
    script = _toy_child(tmp_path)
    res = tmp_path / "res"
    res.mkdir()
    calls = []

    def build_cmd(resume):
        calls.append(resume)
        cmd = [sys.executable, str(script), str(res)]
        if resume is not None:
            cmd += ["--continue-from", str(resume)]
        return cmd

    rc, history = supervise(build_cmd, str(res), str(tmp_path / "sup.log"),
                            stall_timeout=3.0, max_restarts=2, poll=0.3,
                            term_grace=5.0)
    assert rc == 0
    assert calls == [None, 3]
    assert len(history) == 1 and history[0][0].startswith("stalled")
    assert history[0][1] == 3
    log = (tmp_path / "sup.log").read_text()
    assert "wedging" in log and "resumed fine" in log
    assert log.count("=== supervisor: launching") == 2
    assert log.count("=== supervisor: child pid ") == 2


def test_supervise_restart_budget(tmp_path):
    script = tmp_path / "crash.py"
    script.write_text("import sys; print('boom', flush=True); sys.exit(7)")
    res = tmp_path / "res"
    res.mkdir()
    rc, history = supervise(
        lambda resume: [sys.executable, str(script)],
        str(res), str(tmp_path / "sup.log"),
        stall_timeout=30.0, max_restarts=2, poll=0.2)
    assert rc == 7
    assert len(history) == 3  # initial failure + 2 restarts, all recorded
    assert all(reason == "exit 7" and resume is None for reason, resume in history)


def test_resilient_cli_end_to_end(tmp_path):
    """The real wrapper supervises a clean run of the port's CLI (the
    offline synthetic ml_100k, --device cpu, 1 epoch on 80 + 40 pairs) in a
    subprocess and exits 0 with a log.txt and a supervisor.log."""
    env = dict(os.environ, PYTHONPATH=REPO,
               IGMC_RAW_DATA=os.path.join(REPO, "raw_data_synth"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "igmc_torch.cli.resilient", "--stall-timeout", "600",
         "--", "--data-name", "ml_100k", "--testing", "--epochs", "1",
         "--max-train-num", "80", "--max-test-num", "40", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    res = tmp_path / "results" / "ml_100k_testmode"
    log = (res / "log.txt").read_text().strip().splitlines()
    assert len(log) == 1 and log[0].startswith("Epoch 1,")
    assert np.isfinite(float(log[-1].split(" ")[-1]))
    sup = (res / "supervisor.log").read_text()
    assert sup.count("=== supervisor: launching (resume=None) ===") == 1
    assert "Epoch 1, train loss" in sup


def test_supervise_first_launch_ignores_stale_checkpoints(tmp_path):
    """Checkpoints left by a PREVIOUS run must not turn a fresh run into
    a silent no-op resume: only post-failure relaunches scan the dir."""
    res = tmp_path / "res"
    res.mkdir()
    for kind in ("model", "optimizer"):
        (res / f"{kind}_checkpoint80.pth").write_bytes(b"stale")
    script = tmp_path / "ok.py"
    script.write_text("print('fresh run', flush=True)")
    calls = []

    def build_cmd(resume):
        calls.append(resume)
        return [sys.executable, str(script)]

    rc, history = supervise(build_cmd, str(res), str(tmp_path / "sup.log"),
                            stall_timeout=30.0, max_restarts=1, poll=0.2)
    assert rc == 0 and calls == [None] and history == []


def test_supervise_exit_code_never_negative(tmp_path):
    """A signal-killed child's raw negative returncode must not leak as
    the supervisor's exit status."""
    script = tmp_path / "sigkill.py"
    script.write_text(
        "import os, signal; os.kill(os.getpid(), signal.SIGKILL)")
    res = tmp_path / "res"
    res.mkdir()
    rc, history = supervise(
        lambda resume: [sys.executable, str(script)],
        str(res), str(tmp_path / "sup.log"),
        stall_timeout=30.0, max_restarts=1, poll=0.2)
    assert rc == 1 and len(history) == 2


def test_stall_kill_leaves_no_spawned_rank_alive(tmp_path):
    """A child that starts two ranks with torch.multiprocessing.spawn (as
    --n-devices 2 does), records their pids and wedges: after the stall
    kill no process of its group is left, the ranks included (the
    supervisor reaps them as their subreaper), and the relaunch resumes."""
    script = tmp_path / "spawner.py"
    script.write_text(textwrap.dedent("""
        import os, sys, threading, time

        wedged = threading.Event()

        def alive():
            # output until the wedge, so a slow start (importing torch on a
            # loaded machine) is never taken for the stall
            while not wedged.is_set():
                print("alive", flush=True)
                time.sleep(0.5)

        if __name__ == "__main__":
            print("child start", flush=True)
            threading.Thread(target=alive, daemon=True).start()

        import torch.multiprocessing as mp

        def rank(r, out):
            with open(os.path.join(out, f"rank{r}.pid"), "w") as f:
                f.write(str(os.getpid()))
            time.sleep(600)

        if __name__ == "__main__":
            res = sys.argv[1]
            if "--continue-from" in sys.argv:
                print("resumed", flush=True)
                sys.exit(0)
            with open(os.path.join(res, "group.pid"), "w") as f:
                f.write(str(os.getpgid(0)))
            ctx = mp.spawn(rank, args=(res,), nprocs=2, join=False)
            while not all(os.path.isfile(os.path.join(res, f"rank{r}.pid"))
                          for r in range(2)):
                time.sleep(0.1)
            for kind in ("model", "optimizer"):
                open(os.path.join(res, kind + "_checkpoint1.pth"), "wb").close()
            print("two ranks up; wedging", flush=True)
            wedged.set()
            ctx.join()
    """))
    res = tmp_path / "res"
    res.mkdir()

    def build_cmd(resume):
        return [sys.executable, str(script), str(res)] + (
            [] if resume is None else ["--continue-from", str(resume)])

    was = _subreaper()
    rc, history = supervise(build_cmd, str(res), str(tmp_path / "sup.log"),
                            stall_timeout=3.0, max_restarts=1, poll=0.3,
                            term_grace=5.0)
    assert _subreaper() == was          # restored on return
    assert rc == 0, (tmp_path / "sup.log").read_text()
    assert len(history) == 1 and history[0] == (history[0][0], 1)
    assert history[0][0].startswith("stalled")
    pids = [int((res / f"rank{r}.pid").read_text()) for r in range(2)]
    pgid = int((res / "group.pid").read_text())
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    with pytest.raises(ProcessLookupError):
        os.killpg(pgid, 0)
    assert "two ranks up" in (tmp_path / "sup.log").read_text()


def _subreaper():
    """This process's PR_GET_CHILD_SUBREAPER setting (0 off Linux)."""
    if not sys.platform.startswith("linux"):
        return 0
    was = ctypes.c_int(0)
    ctypes.CDLL(None).prctl(resilient.PR_GET_CHILD_SUBREAPER, ctypes.byref(was),
                            0, 0, 0)
    return was.value


def test_reap_gives_up_on_an_unkillable_group(tmp_path, monkeypatch):
    """A group that outlives SIGKILL (a process stuck in a device call; here
    killpg is made a no-op) holds the supervisor for `grace` seconds, not
    for ever: the survivor is logged and the supervisor goes on."""
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"],
                             start_new_session=True)
    try:
        monkeypatch.setattr(resilient.os, "killpg", lambda pgid, sig: None)
        with open(tmp_path / "sup.log", "wb") as log_f:
            t0 = time.monotonic()
            resilient._reap_group(child.pid, 1.0, log_f)
            waited = time.monotonic() - t0
        assert 1.0 <= waited < 10.0
        assert child.poll() is None
        assert (f"process group {child.pid} still alive"
                in (tmp_path / "sup.log").read_text())
    finally:
        child.kill()
        child.wait()


def test_child_runs_unbuffered_with_the_callers_flags(tmp_path, monkeypatch):
    """main launches `python -u -m igmc_torch.cli.main` with the caller's
    flags (--device and --n-devices pass through) and PYTHONUNBUFFERED=1;
    the caller's --continue-from applies to the first launch only; the log
    defaults to <results dir>/supervisor.log."""
    monkeypatch.chdir(tmp_path)
    seen = {}

    def fake_supervise(build_cmd, res_dir, log_path, **kw):
        seen.update(fresh=build_cmd(None), resumed=build_cmd(4), res_dir=res_dir,
                    log_path=log_path, **kw)
        return 0, []

    monkeypatch.setattr(resilient, "supervise", fake_supervise)
    rc = resilient.main(["--stall-timeout", "15", "--", "--data-name", "ml_100k",
                         "--testing", "--continue-from", "2", "--n-devices", "2",
                         "--device", "cpu"])
    assert rc == 0
    flags = ["--data-name", "ml_100k", "--testing", "--n-devices", "2",
             "--device", "cpu"]
    assert seen["fresh"] == [sys.executable, "-u", "-m", "igmc_torch.cli.main"] + flags
    assert seen["resumed"] == seen["fresh"] + ["--continue-from", "4"]
    assert seen["initial_resume"] == 2 and seen["stall_timeout"] == 15.0
    assert seen["env"]["PYTHONUNBUFFERED"] == "1"
    assert seen["res_dir"] == os.path.join("results", "ml_100k_testmode")
    assert seen["log_path"] == os.path.join(seen["res_dir"], "supervisor.log")


class FakeClock:
    """Advances `step` seconds per call."""

    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def test_heartbeat_prints_to_stderr_at_most_every_30s(monkeypatch, capsys):
    """Heartbeat prints `<label> i/n` to stderr once 30 s of its clock have
    passed since the last line, never to stdout; extract_many(progress=True)
    beats per graph on the NumPy engine and per slice on the C++ engine,
    and extracts the same graphs as without it; a training run beats per
    epoch."""
    beat = progress.Heartbeat("work", 10, clock=FakeClock(11.0))
    for i in range(1, 11):
        beat(i)
    out = capsys.readouterr()
    assert out.out == ""
    # readings 11 (creation), 22, 33, ...: a line at 44 (beat 3), 77, 110
    assert out.err.splitlines() == ["work 3/10", "work 6/10", "work 9/10"]

    rng = np.random.default_rng(3)
    M = (rng.random((30, 30)) < 0.3) * rng.integers(1, 6, (30, 30))
    us, vs = np.nonzero(M)
    labels = M[us, vs] - 1
    A = BipartiteCSR(sp.csr_matrix(M.astype(np.float32)))
    monkeypatch.setattr(progress.time, "monotonic", FakeClock(16.0))
    backends = ["numpy"] + (["native"] if native.available() else [])
    monkeypatch.setattr(port_extract, "NATIVE_SLICE", 7)
    for backend in backends:
        want = extract_many((us, vs), labels, A, h=1, backend=backend)
        got = extract_many((us, vs), labels, A, h=1, backend=backend, progress=True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.node_label, b.node_label)
            np.testing.assert_array_equal(a.src, b.src)
            np.testing.assert_array_equal(a.etype, b.etype)
        out = capsys.readouterr()
        assert out.out == ""
        lines = out.err.splitlines()
        step = 1 if backend == "numpy" else 7
        assert lines and all(l.startswith("extracting subgraphs ") for l in lines)
        done = [int(l.split()[-1].split("/")[0]) for l in lines]
        assert all(l.endswith(f"/{len(us)}") for l in lines)
        # readings 16 (creation), 32, 48, ...: a line at every 2nd beat
        assert done[:2] == [2 * step, 4 * step]

    # a training run beats once per epoch (as JAX's tqdm bar over epochs)
    from igmc_torch.batching import StaticGraphDataset
    from igmc_torch.models import IGMC, IGMCConfig
    from igmc_torch.train import train_multiple_epochs

    ds = StaticGraphDataset(A, (us[:40], vs[:40]), labels[:40], h=1,
                            backend="numpy", progress=False)
    monkeypatch.setattr(progress.time, "monotonic", FakeClock(31.0))
    train_multiple_epochs(ds, ds, IGMC(IGMCConfig(num_relations=5, num_bases=4),
                                       torch.Generator().manual_seed(0)),
                          epochs=3, batch_size=20, lr=1e-3, lr_decay_factor=0.1,
                          lr_decay_step_size=50, device="cpu")
    out = capsys.readouterr()
    assert out.err.splitlines() == ["epochs 1/3", "epochs 2/3", "epochs 3/3"]
    assert "Epoch 3," in out.out
