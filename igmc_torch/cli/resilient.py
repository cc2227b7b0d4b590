"""Stall-resilient training supervisor: run the CLI, resume after a hang.

    python -m igmc_torch.cli.resilient [--stall-timeout S] [--max-restarts N]
        [--log FILE] -- <ordinary igmc_torch.cli.main arguments>

Port of igmc_tpu/cli/resilient.py. A long unattended run can wedge without
crashing (a collective that never returns, a card that stops answering).
This wrapper automates the operator's loop of kill and `--continue-from`:

  * the child, `python -u -m igmc_torch.cli.main ...` with
    PYTHONUNBUFFERED=1 (so the ranks that `--n-devices` spawns write
    unbuffered too), runs in its OWN session and process group, and is
    cleaned up by killing that exact group, never by pattern: SIGTERM,
    then SIGKILL after a grace period. While it supervises, the
    supervisor is the children's subreaper (Linux), so it also reaps the
    spawned ranks; after every launch no process of the child's group is
    left, save one that outlives SIGKILL for a grace period (stuck in the
    kernel), which is logged and left behind;
  * liveness = mtime of the child's combined stdout/stderr log (the CLI's
    lines, the epoch lines and the extraction heartbeat on stderr);
  * on a stall or a nonzero exit the child is relaunched with
    `--continue-from E`, E the latest epoch whose model AND optimizer
    checkpoints (`.pth`) both exist, which is what the port's
    `--continue-from` resumes from (from scratch when there is none). The
    first launch uses the caller's own `--continue-from` as given, so
    checkpoints of an earlier run never turn a fresh run into a resume;
  * a child that exits 0 ends the loop; more than --max-restarts
    interventions end it with the history and a positive exit code.

The checkpoint cadence (--save-interval) bounds the recomputed work, and a
resumed run replays the shuffle and noise of the epochs it runs, so the
supervised run's log.txt is the same run with repeated epoch ranges.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import signal
import subprocess
import sys
import time

PR_SET_CHILD_SUBREAPER = 36
PR_GET_CHILD_SUBREAPER = 37

def latest_checkpoint_epoch(res_dir: str):
    """Largest E with both model_checkpoint<E>.pth and
    optimizer_checkpoint<E>.pth in `res_dir`, or None (a JAX `.ckpt` and a
    model file whose optimizer file is missing are not resumable)."""
    best = None
    if os.path.isdir(res_dir):
        names = set(os.listdir(res_dir))
        for name in names:
            m = re.fullmatch(r"model_checkpoint(\d+)\.pth", name)
            if m and f"optimizer_checkpoint{m.group(1)}.pth" in names:
                e = int(m.group(1))
                best = e if best is None else max(best, e)
    return best


def child_results_dir(child_args):
    """The results dir the child will write, resolved as cli.main resolves
    it (its own parser and ResultsDir)."""
    from ..utils.logging import ResultsDir
    from .main import build_parser

    args = build_parser().parse_args(child_args)
    return ResultsDir("results", args.data_name, args.save_appendix,
                      args.testing).path


def _set_subreaper(on: int) -> int:
    """Make orphaned descendants (the ranks of a killed child) this
    process's children while `on`, so that they can be reaped; returns the
    previous setting. Linux only (elsewhere a no-op returning 0)."""
    if not sys.platform.startswith("linux"):
        return 0
    libc = ctypes.CDLL(None, use_errno=True)
    was = ctypes.c_int(0)
    libc.prctl(PR_GET_CHILD_SUBREAPER, ctypes.byref(was), 0, 0, 0)
    libc.prctl(PR_SET_CHILD_SUBREAPER, int(on), 0, 0, 0)
    return was.value


def _reap_group(pgid: int, grace: float, log_f) -> None:
    """Kill whatever is left of process group `pgid` and reap those of its
    processes that are this process's children, for at most `grace`
    seconds: a process stuck in the kernel (a device call that never
    returns) ignores SIGKILL, and is logged and left behind."""
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        return
    deadline = time.monotonic() + grace
    while True:
        try:
            if os.waitpid(-pgid, os.WNOHANG)[0]:
                continue
        except ChildProcessError:
            return
        if time.monotonic() >= deadline:
            log_f.write(f"=== supervisor: process group {pgid} still alive "
                        f"{grace:.0f}s after SIGKILL; going on ===\n".encode())
            return
        time.sleep(0.05)


def supervise(build_cmd, res_dir: str, log_path: str,
              stall_timeout: float = 900.0, max_restarts: int = 5,
              poll: float = 5.0, term_grace: float = 20.0,
              sleep_fn=time.sleep, initial_resume=None, env=None):
    """Run build_cmd(resume_epoch) children until one exits 0.

    Returns (exit_code, history), history a list of (reason, resume_epoch)
    per intervention. `build_cmd` maps the resume epoch (None = fresh) to
    an argv list; the FIRST launch uses `initial_resume` exactly as given
    (the caller's own --continue-from, or None), only relaunches after a
    failure scan `res_dir` (latest_checkpoint_epoch). Each launch appends
    to `log_path` a line naming it and the child's pid, which is also its
    process group. `env` is the children's environment (default this
    process's). While it runs, this process is its descendants' subreaper
    (the setting is restored on return)."""
    was_subreaper = _set_subreaper(1)
    try:
        return _supervise(build_cmd, res_dir, log_path, stall_timeout,
                          max_restarts, poll, term_grace, sleep_fn,
                          initial_resume, env)
    finally:
        _set_subreaper(was_subreaper)


def _supervise(build_cmd, res_dir, log_path, stall_timeout, max_restarts,
               poll, term_grace, sleep_fn, initial_resume, env):
    history = []
    restarts = 0
    resume = initial_resume
    while True:
        cmd = build_cmd(resume)
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        with open(log_path, "ab", buffering=0) as log_f:
            log_f.write(f"\n=== supervisor: launching (resume={resume}) "
                        f"===\n".encode())
            child = subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT,
                                     start_new_session=True, env=env)
            pgid = child.pid            # the leader of its own session
            log_f.write(f"=== supervisor: child pid {child.pid} (process group "
                        f"{pgid}) ===\n".encode())
            stalled = False
            while True:
                rc = child.poll()
                if rc is not None:
                    break
                age = time.time() - os.stat(log_path).st_mtime
                if age > stall_timeout:
                    stalled = True
                    # the child's OWN process group; it may end on its own
                    # in this window, a vanished group has exited
                    try:
                        os.killpg(pgid, signal.SIGTERM)
                    except ProcessLookupError:
                        pass
                    try:
                        child.wait(timeout=term_grace)
                    except subprocess.TimeoutExpired:
                        try:
                            os.killpg(pgid, signal.SIGKILL)
                        except ProcessLookupError:
                            pass
                        try:
                            child.wait(timeout=term_grace)
                        except subprocess.TimeoutExpired:
                            pass        # stuck in the kernel: _reap_group logs it
                    rc = child.returncode
                    break
                sleep_fn(poll)
            _reap_group(pgid, term_grace, log_f)
        if not stalled and rc == 0:
            return 0, history
        reason = (f"stalled (no output {stall_timeout:.0f}s)" if stalled
                  else f"exit {rc}")
        restarts += 1
        resume = latest_checkpoint_epoch(res_dir)
        history.append((reason, resume))
        print(f"supervisor: child {reason}; "
              f"restart {restarts}/{max_restarts} from "
              f"{'scratch' if resume is None else f'epoch {resume}'}",
              flush=True)
        if restarts > max_restarts:
            print(f"supervisor: giving up after {max_restarts} restarts; "
                  f"history: {history}", flush=True)
            # a positive exit status (a signal-killed child's rc is negative)
            return rc if rc and rc > 0 else 1, history


def main(argv=None):
    p = argparse.ArgumentParser(
        description="stall-resilient wrapper around igmc_torch.cli.main "
                    "(args after -- pass through)")
    p.add_argument("--stall-timeout", type=float, default=900.0,
                   help="seconds without child output before the run is "
                        "declared wedged and resumed from the last "
                        "checkpoint (default 900)")
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--log", default="",
                   help="supervisor log file (default "
                        "<results-dir>/supervisor.log)")
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        own, child_args = argv[:split], argv[split + 1:]
    else:
        own, child_args = [], argv
    args = p.parse_args(own)
    if not child_args:
        p.error("no child arguments; usage: ... -- --data-name flixster ...")

    res_dir = child_results_dir(child_args)
    log_path = args.log or os.path.join(res_dir, "supervisor.log")

    # the supervisor owns resumption AFTER a failure; the caller's own
    # --continue-from (if any) applies to the first launch only
    base = list(child_args)
    initial_resume = None
    if "--continue-from" in base:
        i = base.index("--continue-from")
        initial_resume = int(base[i + 1])
        del base[i:i + 2]

    def build_cmd(resume):
        cmd = [sys.executable, "-u", "-m", "igmc_torch.cli.main"] + base
        if resume is not None:
            cmd += ["--continue-from", str(resume)]
        return cmd

    rc, history = supervise(build_cmd, res_dir, log_path,
                            stall_timeout=args.stall_timeout,
                            max_restarts=args.max_restarts,
                            initial_resume=initial_resume,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"))
    if history:
        print(f"supervisor: {len(history)} intervention(s): {history}",
              flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
