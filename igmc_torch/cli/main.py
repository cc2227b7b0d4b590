"""The command line for experiments: the JAX package's flags, one device.

    python -m igmc_torch.cli.main --data-name ml_1m --testing --ensemble \
        [--device cuda|cpu] [...]

Port of igmc_tpu/cli/main.py: the same argparse surface and defaults
(plus `--device`, the counterpart of JAX's platform selection; default the
CUDA card, which must be present), rating_maps, the ml_1m split, static
datasets, the IGMC model, and main's batch-mode and dense-layout rules,
training, `--ensemble` and `--transfer`, with the same printed lines and
`log.txt` lines. `--flat-aggregate pallas` runs the flat layout through
the fused aggregate kernels.

Flags whose code is not ported yet exit with a message naming the flag:
`--parallel ep`, `--n-devices` > 1, `--dynamic-*`, `--use-features`,
`--dense-chunk`, `--compute-dtype bfloat16`, `--dense-strategy
adjacency`, `--visualize`, `--profile-dir`, `--extract-backend native`,
models other than igmc, the segment and blocked flat engines, and
datasets other than ml_1m. Datasets are held in memory: the JAX package's
`.npz` subgraph cache and split pickle are not ported, so `--reprocess`
and `--data-appendix` change nothing. `--compilation-cache-dir`,
`--conv-strategy` and `--ep-local-aggregate` are accepted and change
nothing here (the port compiles no XLA programs, and the other two
select engines of paths not ported).
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Inductive Graph-based Matrix Completion in PyTorch + CUDA")
    # general settings
    p.add_argument("--testing", action="store_true", default=False,
                   help="split all ratings into train/test (no val split)")
    p.add_argument("--no-train", action="store_true", default=False,
                   help="skip training; go straight to transfer/ensemble")
    p.add_argument("--debug", action="store_true", default=False,
                   help="use a small number of data for debugging")
    p.add_argument("--data-name", default="ml_100k", help="dataset name")
    p.add_argument("--data-appendix", default="",
                   help="appendix to dataset save-names (no dataset cache here)")
    p.add_argument("--save-appendix", default="",
                   help="appendix to result save-names")
    p.add_argument("--max-train-num", type=int, default=None)
    p.add_argument("--max-val-num", type=int, default=None)
    p.add_argument("--max-test-num", type=int, default=None)
    p.add_argument("--seed", type=int, default=1, metavar="S")
    p.add_argument("--data-seed", type=int, default=1234, metavar="S",
                   help="data shuffle seed (ml_1m)")
    p.add_argument("--reprocess", action="store_true", default=False,
                   help="reprocess data (there is no cache to reuse here)")
    p.add_argument("--dynamic-train", action="store_true", default=False)
    p.add_argument("--dynamic-test", action="store_true", default=False)
    p.add_argument("--dynamic-val", action="store_true", default=False)
    p.add_argument("--dynamic-dataset", action="store_true", default=False,
                   help="alias: all three --dynamic-* flags")
    p.add_argument("--keep-old", action="store_true", default=False)
    p.add_argument("--save-interval", type=int, default=10)
    # subgraph extraction settings
    p.add_argument("--hop", type=int, default=1)
    p.add_argument("--sample-ratio", type=float, default=1.0)
    p.add_argument("--max-nodes-per-hop", type=int, default=10000)
    p.add_argument("--use-features", action="store_true", default=False)
    # edge dropout settings
    p.add_argument("--adj-dropout", type=float, default=0.2)
    p.add_argument("--force-undirected", action="store_true", default=False)
    # optimization settings
    p.add_argument("--continue-from", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3, metavar="LR")
    p.add_argument("--lr-decay-step-size", type=int, default=50)
    p.add_argument("--lr-decay-factor", type=float, default=0.1)
    p.add_argument("--epochs", type=int, default=80, metavar="N")
    p.add_argument("--batch-size", type=int, default=50, metavar="N")
    p.add_argument("--test-freq", type=int, default=1, metavar="N")
    p.add_argument("--ARR", type=float, default=0.001,
                   help="adjacent-rating regularizer weight")
    # transfer / ensemble / visualization
    p.add_argument("--transfer", default="",
                   help="path with pretrained checkpoints to transfer from")
    p.add_argument("--num-relations", type=int, default=5)
    p.add_argument("--multiply-by", type=float, default=1)
    p.add_argument("--visualize", action="store_true", default=False)
    p.add_argument("--ensemble", action="store_true", default=False)
    p.add_argument("--standard-rating", action="store_true", default=False)
    # sparsity experiments
    p.add_argument("--ratio", type=float, default=1.0)
    # the JAX package's extensions
    p.add_argument("--model", default="igmc",
                   choices=["igmc", "gnn", "dgcnn", "dgcnn_rs"],
                   help="model family (igmc only so far)")
    p.add_argument("--num-bases", type=int, default=4, help="R-GCN basis count")
    p.add_argument("--aggr", default="mean", choices=["mean", "sum", "relmean"],
                   help="R-GCN aggregation (relmean: dense layout only)")
    p.add_argument("--n-devices", type=int, default=0,
                   help="data-parallel devices (0 or 1: one device)")
    p.add_argument("--ep-local-aggregate", default="segment",
                   choices=["segment", "blocked"],
                   help="per-chip aggregation under --parallel ep")
    p.add_argument("--parallel", default="auto", choices=["auto", "dp", "ep"],
                   help="multi-device strategy with --n-devices > 1")
    p.add_argument("--extract-backend", default="auto",
                   choices=["auto", "numpy", "native"],
                   help="subgraph extraction engine (numpy only so far)")
    p.add_argument("--profile-dir", default="",
                   help="profiler trace of one epoch (not ported yet)")
    p.add_argument("--compilation-cache-dir",
                   default=os.environ.get("IGMC_TPU_COMPILATION_CACHE", ""),
                   help="the JAX package's XLA compilation cache; accepted, "
                        "unused (the CUDA kernels build once per source "
                        "into igmc_torch/kernels/build/)")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="R-GCN trunk compute dtype (float32 only so far)")
    p.add_argument("--conv-strategy", default="auto",
                   choices=["auto", "dispatch", "basis-mix", "per-edge"],
                   help="relation transform of the flat segment engine")
    p.add_argument("--superbatch", type=int, default=8,
                   help="rows of graph ids per unit of the dense epoch plan "
                        "(the port takes one step per row)")
    p.add_argument("--batch-mode", default="auto",
                   choices=["auto", "flat", "dense"],
                   help="graph batch layout: 'dense' = per-graph node slots, "
                        "device-resident; 'flat' = disjoint edge list (needs "
                        "--flat-aggregate pallas here). auto: dense")
    p.add_argument("--flat-aggregate", default="auto",
                   choices=["auto", "segment", "blocked", "pallas"],
                   help="flat-layout R-GCN engine: 'pallas' = the fused "
                        "aggregate kernels (CUDA here); forces batch-mode flat")
    p.add_argument("--dense-strategy", default="auto",
                   choices=["auto", "edge", "adjacency"],
                   help="dense-layout aggregation (edge only so far). auto = edge")
    p.add_argument("--dense-layout", default="auto",
                   choices=["auto", "unified", "bipartite"],
                   help="dense slot layout: 'unified' = one n-row slot per "
                        "graph; 'bipartite' = users and items in separate "
                        "slot ranges. auto = bipartite when the median "
                        "training graph has >= 128 nodes, else unified")
    p.add_argument("--dense-buckets", type=int, default=3,
                   help="max dense slot shapes (batch-mode dense)")
    p.add_argument("--dense-chunk", type=int, default=0, metavar="N",
                   help="giant-batch training (not ported yet); 0 = off")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the CUDA card (default; raises "
                        "without one) or the CPU (plain PyTorch versions of "
                        "the kernels)")
    return p


def unported_flags(args) -> list:
    """The given flags whose code igmc_torch does not have yet."""
    checks = [
        (args.parallel == "ep", "--parallel ep"),
        (args.n_devices > 1, f"--n-devices {args.n_devices}"),
        (args.dynamic_train or args.dynamic_test or args.dynamic_val
         or args.dynamic_dataset, "--dynamic-*"),
        (args.use_features, "--use-features"),
        (args.dense_chunk != 0, "--dense-chunk"),
        (args.compute_dtype != "float32", f"--compute-dtype {args.compute_dtype}"),
        (args.dense_strategy == "adjacency", "--dense-strategy adjacency"),
        (args.visualize, "--visualize"),
        (bool(args.profile_dir), "--profile-dir"),
        (args.extract_backend == "native", "--extract-backend native"),
        (args.model != "igmc", f"--model {args.model}"),
        (args.flat_aggregate in ("segment", "blocked"),
         f"--flat-aggregate {args.flat_aggregate}"),
        (args.batch_mode == "flat" and args.flat_aggregate == "auto",
         "--batch-mode flat without --flat-aggregate pallas (the segment engine)"),
    ]
    return [flag for hit, flag in checks if hit]


def rating_maps(args):
    """rating_map (--standard-rating) and post_rating_map (transfer
    bucketing), as the JAX CLI builds them."""
    rating_map, post_rating_map = None, None
    if args.standard_rating:
        if args.data_name in ("flixster", "ml_10m"):  # 0.5, 1, ..., 5
            rating_map = {x: int(math.ceil(x))
                          for x in np.arange(0.5, 5.01, 0.5).tolist()}
        elif args.data_name == "yahoo_music":  # 1..100
            rating_map = {x: (x - 1) // 20 + 1 for x in range(1, 101)}
    if args.transfer:
        if args.data_name in ("flixster", "ml_10m"):
            post_rating_map = {
                x: int(i // (10 / args.num_relations))
                for i, x in enumerate(np.arange(0.5, 5.01, 0.5).tolist())}
        elif args.data_name == "yahoo_music":
            post_rating_map = {
                x: int(i // (100 / args.num_relations))
                for i, x in enumerate(np.arange(1, 101).tolist())}
        else:  # standard 1..5 ratings
            post_rating_map = {
                x: int(i // (5 / args.num_relations))
                for i, x in enumerate(np.arange(1, 6).tolist())}
    return rating_map, post_rating_map


def load_split(args, rating_map, post_rating_map):
    """The ml_1m random split; other datasets exit naming what is missing."""
    from ..data import create_trainvaltest_split

    if args.data_name != "ml_1m":
        raise SystemExit(
            f"--data-name {args.data_name}: igmc_torch loads ml_1m only; the "
            f"loaders of ml_100k, ml_10m, ml_25m and the Monti .mat datasets "
            f"(flixster, douban, yahoo_music) are not ported yet")
    return create_trainvaltest_split(args.data_name, args.data_seed, args.testing,
                                     True, rating_map, post_rating_map, args.ratio)


def build_datasets(args, split):
    """(train, val, test) static datasets, held in memory; in valmode the
    validation set is also the test set, as in the JAX CLI."""
    from ..batching import StaticGraphDataset
    from ..graphs import BipartiteCSR

    tr_u, tr_v = split.train_u_indices, split.train_v_indices
    va_u, va_v = split.val_u_indices, split.val_v_indices
    te_u, te_v = split.test_u_indices, split.test_v_indices
    tr_l, va_l, te_l = split.train_labels, split.val_labels, split.test_labels
    if args.debug:  # truncate to 1000 links
        nd = 1000
        tr_u, tr_v, tr_l = tr_u[:nd], tr_v[:nd], tr_l[:nd]
        va_u, va_v, va_l = va_u[:nd], va_v[:nd], va_l[:nd]
        te_u, te_v, te_l = te_u[:nd], te_v[:nd], te_l[:nd]
    print("#train: %d, #val: %d, #test: %d" % (len(tr_u), len(va_u), len(te_u)))

    A = BipartiteCSR(split.adj_train)
    mnph = args.max_nodes_per_hop if args.max_nodes_per_hop > 0 else None
    common = dict(h=args.hop, sample_ratio=args.sample_ratio,
                  max_nodes_per_hop=mnph, class_values=split.class_values)
    train_graphs = StaticGraphDataset(A, (tr_u, tr_v), tr_l,
                                      max_num=args.max_train_num, **common)
    test_graphs = StaticGraphDataset(A, (te_u, te_v), te_l,
                                     max_num=args.max_test_num, **common)
    val_graphs = None
    if not args.testing:
        val_graphs = StaticGraphDataset(A, (va_u, va_v), va_l,
                                        max_num=args.max_val_num, **common)
        test_graphs = val_graphs  # evaluate on val in valmode
    print("Used #train graphs: %d, #test graphs: %d"
          % (len(train_graphs), len(test_graphs)))
    return train_graphs, val_graphs, test_graphs


def build_model(args, split):
    """Full-width IGMC, initialised from a generator seeded with --seed."""
    import torch

    from ..models import IGMC, IGMCConfig

    if args.transfer:
        num_relations, multiply_by = args.num_relations, args.multiply_by
    else:
        num_relations, multiply_by = len(split.class_values), 1.0
    cfg = IGMCConfig(num_features=2 * args.hop + 2, latent_dim=(32, 32, 32, 32),
                     num_relations=num_relations, num_bases=args.num_bases,
                     adj_dropout=args.adj_dropout,
                     force_undirected=args.force_undirected,
                     multiply_by=multiply_by, aggr=args.aggr)
    model = IGMC(cfg, torch.Generator().manual_seed(args.seed))
    print(f"Total number of parameters is "
          f"{sum(p.numel() for p in model.parameters())}")
    return model


def choose_layouts(args, train_graphs):
    """(batch_mode, flat_aggregate, dense_layout) by the JAX CLI's rules,
    printing its `batch mode: ...` and `dense layout: ... (auto)` lines."""
    flat_aggregate = "pallas" if args.flat_aggregate == "pallas" else None
    batch_mode = args.batch_mode
    if flat_aggregate is not None:
        if batch_mode == "dense":
            raise SystemExit("--flat-aggregate conflicts with --batch-mode "
                             "dense (pick one layout)")
        batch_mode = "flat"
        print(f"batch mode: flat (--flat-aggregate {flat_aggregate})")
    elif batch_mode == "auto":
        batch_mode = "dense"
        print(f"batch mode: {batch_mode} (auto)")
    dense_layout = args.dense_layout
    if dense_layout == "bipartite" and batch_mode != "dense":
        raise SystemExit("--dense-layout bipartite needs the device-resident "
                         "dense path (batch-mode dense + static datasets)")
    if dense_layout == "auto":
        # bipartite when the median training graph has >= 128 nodes, the
        # JAX CLI's rule (ml_1m with --max-nodes-per-hop 100: bipartite)
        nc = train_graphs.node_counts()
        big = batch_mode == "dense" and len(nc) > 0 and float(np.median(nc)) >= 128
        dense_layout = "bipartite" if big else "unified"
        if batch_mode == "dense":
            print(f"dense layout: {dense_layout} (auto)")
    return batch_mode, flat_aggregate, dense_layout


def main(argv=None):
    args = build_parser().parse_args(argv)
    missing = unported_flags(args)
    if missing:
        raise SystemExit(f"{', '.join(missing)}: not ported to igmc_torch yet")
    from ..device import resolve_device
    from ..train import (load_checkpoint, resolve_checkpoint, test_once,
                         train_multiple_epochs)
    from ..utils import ResultsDir, make_logger, seed_everything

    device = resolve_device(args.device)
    seed_everything(args.seed)
    print(args)

    rating_map, post_rating_map = rating_maps(args)
    split = load_split(args, rating_map, post_rating_map)
    print("All ratings are:")
    print(split.class_values)

    res = ResultsDir("results", args.data_name, args.save_appendix, args.testing)
    res.record_cmd()
    if not args.keep_old and not args.transfer:
        res.snapshot_source()

    train_graphs, _, test_graphs = build_datasets(args, split)
    model = build_model(args, split)
    logger = make_logger(res, args.save_interval)
    batch_mode, flat_aggregate, dense_layout = choose_layouts(args, train_graphs)
    if args.n_devices == 1:
        print("--n-devices 1: single device, using the plain training path")
    if not args.no_train:
        train_multiple_epochs(
            train_graphs, test_graphs, model, epochs=args.epochs,
            batch_size=args.batch_size, lr=args.lr,
            lr_decay_factor=args.lr_decay_factor,
            lr_decay_step_size=args.lr_decay_step_size, weight_decay=0.0,
            ARR=args.ARR, test_freq=args.test_freq, logger=logger,
            continue_from=args.continue_from, res_dir=res.path, seed=args.seed,
            superbatch=args.superbatch, batch_mode=batch_mode,
            dense_buckets=args.dense_buckets, flat_aggregate=flat_aggregate,
            dense_layout=dense_layout, device=device)

    ckpt_dir = args.transfer if args.transfer else res.path
    eval_kw = dict(batch_mode=batch_mode, flat_aggregate=flat_aggregate,
                   dense_layout=dense_layout, device=device)
    if args.ensemble:
        if args.data_name == "ml_1m":
            start_epoch, end_epoch, interval = args.epochs - 15, args.epochs, 5
        else:
            start_epoch, end_epoch, interval = args.epochs - 30, args.epochs, 10
        checkpoints = [resolve_checkpoint(ckpt_dir, "model", x)
                       for x in range(start_epoch, end_epoch + 1, interval)]
        # ensemble whatever was saved in the range (--save-interval may skip
        # epochs of it)
        missing = [c for c in checkpoints if not os.path.isfile(c)]
        if missing:
            checkpoints = [c for c in checkpoints if os.path.isfile(c)]
            if not checkpoints:
                raise FileNotFoundError(
                    f"no checkpoints in ensemble range "
                    f"range({start_epoch}, {end_epoch + 1}, {interval}) under "
                    f"{ckpt_dir}; train with --save-interval <= {interval}")
            print(f"ensemble: {len(missing)} checkpoint(s) in the range were "
                  f"never saved (--save-interval?); using {len(checkpoints)}: "
                  + ", ".join(os.path.basename(c) for c in checkpoints))
        if args.transfer:
            epoch_info = "transfer {}, ensemble of range({}, {}, {})".format(
                args.transfer, start_epoch, end_epoch, interval)
        else:
            epoch_info = "ensemble of range({}, {}, {})".format(
                start_epoch, end_epoch, interval)
        rmse = test_once(test_graphs, model, args.batch_size, ensemble=True,
                         checkpoints=checkpoints, **eval_kw)
        print("Ensemble test rmse is: {:.6f}".format(rmse))
    elif args.transfer:
        params = load_checkpoint(resolve_checkpoint(ckpt_dir, "model", args.epochs))
        rmse = test_once(test_graphs, model, args.batch_size, params=params,
                         **eval_kw)
        epoch_info = "transfer {}, epochs {}".format(args.transfer, args.epochs)
        print("Test rmse is: {:.6f}".format(rmse))
    else:
        return  # plain training run: results already logged per epoch

    res.log_line("Epoch {}, train loss {:.4f}, test rmse {:.6f}".format(
        epoch_info, 0, rmse))


if __name__ == "__main__":
    main()
