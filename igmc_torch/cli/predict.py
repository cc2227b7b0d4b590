"""Serving CLI: score (user, item) pairs from a trained results directory.

    python -m igmc_torch.cli.predict --data-name ml_100k --testing \
        --results-dir results/ml_100k_testmode --epochs 40 --ensemble \
        [--use-features] [--device cuda|cpu] --pairs pairs.csv --out preds.csv

Port of igmc_tpu/cli/predict.py (plus `--device`, default the CUDA card,
which must be present): loads the dataset's training adjacency with the
split construction of training (`cli.main.load_split`), builds a
`serve.Predictor` ensemble from the results directory's `.pth` (or the
JAX package's `.ckpt`) checkpoints (the CLI's ensemble range
convention), and scores pairs from a CSV/TSV file (or stdin) of
`user,item` indices. `--transfer` serves a
model of `--num-relations` relations on another dataset, its adjacency
bucketed by the same post_rating_map as training's `--transfer`.

Output: one `user,item,prediction` line per input pair.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="score (user, item) pairs with a trained IGMC model")
    p.add_argument("--data-name", required=True)
    p.add_argument("--testing", action="store_true", default=False,
                   help="use the testmode adjacency (must match training)")
    p.add_argument("--results-dir", required=True,
                   help="results dir holding model_checkpoint<E>.pth (or .ckpt)")
    p.add_argument("--epochs", type=int, required=True,
                   help="final epoch anchoring the ensemble range")
    p.add_argument("--ensemble", action="store_true", default=False,
                   help="average the standard checkpoint range; default "
                        "uses only checkpoint <epochs>")
    p.add_argument("--pairs", default="-",
                   help="CSV/TSV of 'user,item' per line ('-' = stdin)")
    p.add_argument("--out", default="-", help="output path ('-' = stdout)")
    p.add_argument("--hop", type=int, default=1)
    p.add_argument("--sample-ratio", type=float, default=1.0)
    p.add_argument("--max-nodes-per-hop", type=int, default=10000)
    p.add_argument("--use-features", action="store_true", default=False)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--aggr", default="mean",
                   choices=["mean", "sum", "relmean"])
    p.add_argument("--num-relations", type=int, default=0,
                   help="override model arity (transfer serving); 0 = "
                        "the dataset's class count")
    p.add_argument("--transfer", action="store_true", default=False,
                   help="transfer serving: bucket the target adjacency "
                        "into --num-relations classes (post_rating_map), "
                        "exactly like training's --transfer")
    p.add_argument("--multiply-by", type=float, default=1.0)
    p.add_argument("--standard-rating", action="store_true", default=False)
    p.add_argument("--ratio", type=float, default=1.0)
    p.add_argument("--data-seed", type=int, default=1234)
    p.add_argument("--reprocess", action="store_true", default=False,
                   help="rewrite the split pickle instead of reading it")
    p.add_argument("--compilation-cache-dir",
                   default=os.environ.get("IGMC_TPU_COMPILATION_CACHE", ""),
                   help="the JAX package's XLA compilation cache; accepted, "
                        "unused")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to score: the CUDA card (default; raises "
                        "without one) or the CPU")
    return p


def read_pairs(path: str):
    """Parse (user, item) index pairs: one pair per line, separated by
    comma, tab, or whitespace. Blank lines, '#' comments, and a single
    leading header row (e.g. 'user,item') are skipped."""
    fh = sys.stdin if path == "-" else open(path)
    us, vs = [], []
    header_ok = True  # at most one leading non-numeric (header) row
    try:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.replace(",", " ").replace("\t", " ").split()
            try:
                a, b = int(fields[0]), int(fields[1])
            except (IndexError, ValueError):
                if header_ok and not us:  # tolerate one CSV header row
                    header_ok = False
                    continue
                raise SystemExit(
                    f"{path}:{lineno}: expected 'user,item' integer pair, "
                    f"got {line!r}")
            us.append(a)
            vs.append(b)
    finally:
        if fh is not sys.stdin:  # never close the process's stdin
            fh.close()
    if not us:
        raise SystemExit(f"{path}: no (user, item) pairs found")
    return np.asarray(us, np.int64), np.asarray(vs, np.int64)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..device import resolve_device
    from ..models import IGMCConfig
    from ..serve import Predictor
    from .main import load_split, rating_maps, side_features

    device = resolve_device(args.device)
    if args.transfer and args.num_relations <= 0:
        raise SystemExit("--transfer needs --num-relations (the source "
                         "model's arity)")
    rating_map, post_rating_map = rating_maps(args)
    split = load_split(args, rating_map, post_rating_map)

    uf, vf, nf = side_features(args, split, verbose=False)
    num_relations = args.num_relations or len(split.class_values)
    cfg = IGMCConfig(
        num_features=2 * args.hop + 2, num_relations=num_relations,
        num_bases=4, side_features=args.use_features, n_side_features=nf,
        multiply_by=args.multiply_by, aggr=args.aggr)

    if args.ensemble:
        interval, span = ((5, 15) if args.data_name == "ml_1m"
                          else (10, 30))
    else:
        interval, span = 1, 0
    mnph = args.max_nodes_per_hop if args.max_nodes_per_hop > 0 else None
    pred = Predictor.from_results_dir(
        args.results_dir, split.adj_train, split.class_values, cfg,
        epochs=args.epochs, interval=interval, span=span,
        h=args.hop, sample_ratio=args.sample_ratio, max_nodes_per_hop=mnph,
        u_features=uf, v_features=vf, batch_size=args.batch_size,
        device=device)
    print(f"ensemble of {len(pred.params_list)} checkpoint(s) from "
          f"{args.results_dir}", file=sys.stderr)

    us, vs = read_pairs(args.pairs)
    scores = pred.predict(us, vs)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        for u, v, s in zip(us, vs, scores):
            out.write(f"{u},{v},{s:.6f}\n")
    finally:
        if out is not sys.stdout:  # never close the process's stdout
            out.close()


if __name__ == "__main__":
    main()
