"""Results directory and the reference's per-epoch log format.

Port of igmc_tpu/utils/logging.py (ResultsDir, make_logger):
  * results/<data_name><save_appendix>_<testmode|valmode>/;
  * cmd_input.txt — the command line, appended per run;
  * source_snapshot.txt — the git revision and a content hash of every
    source file of this package (the reference copies its sources);
  * log.txt — one line per epoch, "Epoch {}, train loss {:.4f}, test rmse
    {:.6f}" (the reference's summarize script parses the last token);
  * model_checkpoint<E>.pth and optimizer_checkpoint<E>.pth every
    `save_interval` epochs.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys

from ..train.checkpoints import checkpoint_path, save_optimizer_state
from ..train.interop import save_pth


class ResultsDir:
    def __init__(self, base: str, data_name: str, save_appendix: str,
                 testing: bool):
        mode = "testmode" if testing else "valmode"
        self.path = os.path.join(base, f"{data_name}{save_appendix}_{mode}")
        os.makedirs(self.path, exist_ok=True)

    def record_cmd(self) -> None:
        cmd = "python " + " ".join(sys.argv) + "\n"
        with open(os.path.join(self.path, "cmd_input.txt"), "a") as f:
            f.write(cmd)
        print("Command line input: " + cmd + " is saved.")

    def snapshot_source(self) -> None:
        """Write source_snapshot.txt: the git revision (when the package
        sits in a git checkout) and a sha256 prefix of each .py, .cpp, .cu
        and .cuh file of igmc_torch/ (the C++ extraction engine and the
        CUDA kernels included)."""
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        lines = []
        try:
            rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=pkg_root,
                                 capture_output=True, text=True,
                                 timeout=10).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            rev = ""
        if rev:
            lines.append(f"git_revision {rev}")
        for dirpath, _, files in sorted(os.walk(pkg_root)):
            for fn in sorted(files):
                if fn.endswith((".py", ".cpp", ".cu", ".cuh")):
                    p = os.path.join(dirpath, fn)
                    with open(p, "rb") as f:
                        h = hashlib.sha256(f.read()).hexdigest()[:16]
                    lines.append(f"{h} {os.path.relpath(p, pkg_root)}")
        with open(os.path.join(self.path, "source_snapshot.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def log_line(self, text: str) -> None:
        with open(os.path.join(self.path, "log.txt"), "a") as f:
            f.write(text + "\n")


def make_logger(res_dir: ResultsDir, save_interval: int):
    """Per-epoch callback for train_multiple_epochs: append to log.txt,
    checkpoint the model and the optimizer every `save_interval` epochs."""

    def logger(info, state):
        epoch = info["epoch"]
        res_dir.log_line("Epoch {}, train loss {:.4f}, test rmse {:.6f}".format(
            epoch, info["train_loss"], info["test_rmse"]))
        if isinstance(epoch, int) and epoch % save_interval == 0 and state is not None:
            print("Saving model states...")
            save_pth(checkpoint_path(res_dir.path, "model", epoch),
                     state.model.state_dict())
            save_optimizer_state(checkpoint_path(res_dir.path, "optimizer", epoch),
                                 state.optimizer)

    return logger
