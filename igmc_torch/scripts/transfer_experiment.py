"""The transfer experiment end to end: ML-100K source -> the three Monti
targets, offline.

    python -m igmc_torch.scripts.transfer_experiment [--small] [--epochs N]
        [--raw-root D] [--max-train-num N] [--device cuda|cpu]

  1. write a synthetic ml_100k in the real file schema under --raw-root
     (igmc_torch/data/synthetic.py) and train the source model through the
     CLI (official u1 split, no side features, --max-nodes-per-hop 200,
     results/ml_100k_mnph200_testmode/), which writes `.pth` checkpoints;
  2. count the source's model `.pth` files (`pth_exported`: the port's
     checkpoints are already in the reference's format, nothing to export);
  3. transfer the source zero-shot to flixster, douban and yahoo_music with
     run_transfer_exps.sh's flags (--dynamic-dataset, 5 relations, yahoo's
     predictions x 20), each target read from <raw-root>/<name> if it is
     there, else ./raw_data/<name>, else the repo's synthetic fixtures in
     the published shapes (tests/torch_fixtures/monti/<name>).

--small: a 40x smaller source, 2 epochs, 500 test pairs per target
(--debug). Writes results/ and data/ under the working directory and
prints one summary JSON line last: source, epochs, pth_exported and
<target>_transfer_rmse.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..cli.main import main as cli
from ..data.synthetic import write_ml100k_format

TARGETS = (("flixster", 1), ("douban", 1), ("yahoo_music", 20))
FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "torch_fixtures", "monti")


def target_root(name: str, raw_root: str) -> str:
    """The directory holding <name>/ for a transfer target: the raw root,
    ./raw_data or the repo's fixtures, the first that has it."""
    for root in (raw_root, os.path.join(os.getcwd(), "raw_data"), FIXTURES):
        if os.path.isdir(os.path.join(root, name)):
            return os.path.abspath(root)
    raise FileNotFoundError(
        f"no {name}/ under {raw_root}, ./raw_data or {FIXTURES}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--small", action="store_true",
                   help="tiny source + 2 epochs (a quick end-to-end check)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--raw-root", default="raw_data_synth")
    p.add_argument("--max-train-num", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.small:
        sizes = dict(n_users=120, n_movies=100, n_ratings=2500)
        epochs = args.epochs or 2
    else:
        sizes = dict(n_users=943, n_movies=1682, n_ratings=100_000)
        epochs = args.epochs or 40
    write_ml100k_format(args.raw_root, seed=0, **sizes)
    device = ["--device", args.device]

    # 1) the source model (official split, testmode, mnph 200 as the
    #    reference's transfer source uses)
    os.environ["IGMC_RAW_DATA"] = os.path.abspath(args.raw_root)
    src_args = [
        "--data-name", "ml_100k", "--testing",
        "--epochs", str(epochs), "--batch-size", "50",
        "--max-nodes-per-hop", "200", "--save-appendix", "_mnph200",
        "--save-interval", "10" if epochs >= 10 else "1",
        "--test-freq", str(max(1, epochs // 4)),
    ]
    if args.max_train_num:
        src_args += ["--max-train-num", str(args.max_train_num),
                     "--max-test-num", str(args.max_train_num // 4)]
    cli(src_args + device)
    src_dir = "results/ml_100k_mnph200_testmode"

    # 2) the source's checkpoints are .pth already
    n_pth = len(glob.glob(os.path.join(src_dir, "model_checkpoint*.pth")))
    print(f"{n_pth} .pth model checkpoints in {src_dir}")

    # 3) the three targets, as run_transfer_exps.sh runs them
    summary = {"source": src_dir, "epochs": epochs, "pth_exported": n_pth}
    for data, multiply_by in TARGETS:
        os.environ["IGMC_RAW_DATA"] = target_root(data, args.raw_root)
        cli([
            "--data-name", data, "--epochs", str(epochs), "--testing",
            "--no-train", "--ensemble", "--transfer", src_dir,
            "--dynamic-dataset", "--num-relations", "5",
            "--multiply-by", str(multiply_by),
        ] + (["--max-test-num", "500", "--debug"] if args.small else []) + device)
        with open(f"results/{data}_testmode/log.txt") as f:
            summary[f"{data}_transfer_rmse"] = float(
                f.read().strip().splitlines()[-1].split(" ")[-1])
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
