"""The command line for experiments: the JAX package's flags.

    python -m igmc_torch.cli.main --data-name ml_1m --testing --ensemble \
        [--device cuda|cpu] [...]

Port of igmc_tpu/cli/main.py: the same argparse surface and defaults
(plus `--device`, the counterpart of JAX's platform selection; default the
CUDA card, which must be present), rating_maps, the Monti datasets'
split (flixster, douban, yahoo_music: MATLAB v7.3 files read without
h5py), the MovieLens splits (ml_100k's official u1.base / u1.test split,
the random split of ml_1m and ml_10m and ml_25m's time split, with the
split pickle `raw_data/<name>/[withfeatures_]split_seed<S>.pickle`), side
features (`--use-features`), the extraction engines (`--extract-backend
auto|numpy|native`), the datasets under
`data/<name><--data-appendix>/<testmode|valmode>/<train|val|test>`:
static ones with the JAX package's `.npz` subgraph cache, or extracted on
the fly per split (`--dynamic-train/-val/-test`, `--dynamic-dataset` for
all three; `--reprocess` removes the caches and rewrites the split
pickle), the model families (`--model igmc|gnn|dgcnn|dgcnn_rs`, on
either layout), and main's batch-mode and dense-layout rules, training,
`--ensemble` and `--transfer` (from `.pth` or the JAX package's `.ckpt`
checkpoints), `--profile-dir` (a torch.profiler trace of the second
epoch), with the same printed lines and `log.txt` lines,
and the main path's options: `--compute-dtype bfloat16`, `--dense-chunk N`
(giant batches, static data), `--dense-strategy adjacency` (unified
layout only). Dynamic data runs the dense layout host-collated (unified
slots). The flat layout runs every flat engine of the JAX CLI:
`--batch-mode flat` the segment engine (with `--conv-strategy`, every
family; static data device-resident), `--flat-aggregate blocked` the
blocked engine and `--flat-aggregate pallas` the fused aggregate kernels
(both IGMC only, and both force the flat layout); `--flat-aggregate
segment` and `auto` select no flat engine, so without `--batch-mode flat`
the dense layout runs, as in the JAX CLI.

Several devices: `--n-devices N` (N > 1) trains data-parallel and
`--parallel ep` edge-partitioned (`--ep-local-aggregate segment|blocked`),
dispatched as the JAX CLI does (`--parallel auto` is dp; the auto batch
mode is flat when --batch-size does not divide by N), with its exits on
`--parallel ep` with another model than igmc, with `--dense-chunk` or with
`--dense-layout`. The CLI starts its N ranks itself (parallel/mesh.py
spawn: one process per device, gloo on the CPU or when ranks share a card,
nccl when each has its own), or joins the group torchrun made
(`torchrun --nnodes H --nproc-per-node G -m igmc_torch.cli.main
--n-devices H*G ...`). Every rank reads the data (rank 0 first, so that
it alone writes the caches); rank 0 alone prints and writes log.txt and
the checkpoints. After data-parallel training the ensemble or transfer
evaluation runs on rank 0's device, as in the JAX CLI; after
edge-partitioned training it runs through test_once_ep on every rank.

`--visualize` loads `model_checkpoint<--epochs>` (of the results dir, or of
`--transfer`'s) after training and draws the best- and worst-predicted test
subgraphs into results/<run>/visualization_<data>_prediction.pdf
(train/visualize.py, no plotting library); with `--transfer` it also prints
`Transfer learning rmse is:`; then the run ends without an ensemble, as in
the JAX CLI (under `--parallel ep` it prints the JAX CLI's notice and goes
on). `--compilation-cache-dir` is accepted and changes nothing here (the
port compiles no XLA programs). Every flag of the JAX CLI is ported:
`unported_flags` returns [].
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import math
import os
import shutil

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
                   help="appendix to dataset save-names")
    p.add_argument("--save-appendix", default="",
                   help="appendix to result save-names")
    p.add_argument("--max-train-num", type=int, default=None)
    p.add_argument("--max-val-num", type=int, default=None)
    p.add_argument("--max-test-num", type=int, default=None)
    p.add_argument("--seed", type=int, default=1, metavar="S")
    p.add_argument("--data-seed", type=int, default=1234, metavar="S",
                   help="data shuffle seed (ml_1m, ml_10m)")
    p.add_argument("--reprocess", action="store_true", default=False,
                   help="reprocess data instead of using the caches")
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
                   help="model family: IGMC, or the GNN, DGCNN and DGCNN_RS "
                        "baselines (dense layout)")
    p.add_argument("--num-bases", type=int, default=4, help="R-GCN basis count")
    p.add_argument("--aggr", default="mean", choices=["mean", "sum", "relmean"],
                   help="R-GCN aggregation (relmean: not with --flat-aggregate "
                        "pallas)")
    p.add_argument("--n-devices", type=int, default=0,
                   help="data-parallel devices (0 or 1: one device)")
    p.add_argument("--ep-local-aggregate", default="segment",
                   choices=["segment", "blocked"],
                   help="per-chip aggregation under --parallel ep")
    p.add_argument("--parallel", default="auto", choices=["auto", "dp", "ep"],
                   help="multi-device strategy with --n-devices > 1")
    p.add_argument("--extract-backend", default="auto",
                   choices=["auto", "numpy", "native"],
                   help="subgraph extraction engine: the C++ engine "
                        "(native, built with g++ on first use), NumPy, or "
                        "auto = native if it builds, else numpy")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the second "
                        "training epoch into this directory")
    p.add_argument("--compilation-cache-dir",
                   default=os.environ.get("IGMC_TPU_COMPILATION_CACHE", ""),
                   help="the JAX package's XLA compilation cache; accepted, "
                        "unused (the CUDA kernels build once per source "
                        "into igmc_torch/kernels/build/)")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="dense R-GCN trunk compute dtype: bfloat16 messages "
                        "with float32 sums (the flat kernels stay float32)")
    p.add_argument("--conv-strategy", default="auto",
                   choices=["auto", "dispatch", "basis-mix", "per-edge"],
                   help="relation transform of the flat segment engine")
    p.add_argument("--superbatch", type=int, default=8,
                   help="rows of graph ids per unit of the dense epoch plan "
                        "(the port takes one step per row)")
    p.add_argument("--batch-mode", default="auto",
                   choices=["auto", "flat", "dense"],
                   help="graph batch layout: 'dense' = per-graph node slots, "
                        "device-resident; 'flat' = disjoint edge list. auto: "
                        "dense")
    p.add_argument("--flat-aggregate", default="auto",
                   choices=["auto", "segment", "blocked", "pallas"],
                   help="flat-layout R-GCN engine: 'blocked' = one-hot block "
                        "products over dst/src-blocked plans, 'pallas' = the "
                        "fused aggregate kernels (CUDA here), each forcing "
                        "batch-mode flat; 'segment' and auto = the segment "
                        "engine (gathers and index_add) under --batch-mode flat")
    p.add_argument("--dense-strategy", default="auto",
                   choices=["auto", "edge", "adjacency"],
                   help="dense-layout aggregation: 'edge' = per-edge gathers "
                        "and one scatter per layer; 'adjacency' = per-relation "
                        "[B, R, n, n] adjacencies built once per forward and "
                        "shared by all layers (unified layout only). auto = edge")
    p.add_argument("--dense-layout", default="auto",
                   choices=["auto", "unified", "bipartite"],
                   help="dense slot layout: 'unified' = one n-row slot per "
                        "graph; 'bipartite' = users and items in separate "
                        "slot ranges. auto = bipartite when the median "
                        "training graph has >= 128 nodes, else unified")
    p.add_argument("--dense-buckets", type=int, default=3,
                   help="max dense slot shapes (batch-mode dense)")
    p.add_argument("--dense-chunk", type=int, default=0, metavar="N",
                   help="giant-batch training (batch-mode dense, static data, "
                        "one device): ONE optimizer step per --batch-size "
                        "graphs, streamed in N-graph slices whose gradients "
                        "accumulate; eval in N-graph rows. 0 = off")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the CUDA card (default; raises "
                        "without one) or the CPU (plain PyTorch versions of "
                        "the kernels)")
    return p


def unported_flags(args) -> list:
    """The given flags whose code igmc_torch does not have yet: none, every
    flag of the JAX CLI is ported (main exits naming any that this lists)."""
    return []


def parallel_mode(args) -> str:
    """'dp' or 'ep' (--parallel auto is dp, as in the JAX CLI)."""
    return "dp" if args.parallel == "auto" else args.parallel


def check_ep(args) -> None:
    """The JAX CLI's exits under --parallel ep, in its order."""
    if args.model != "igmc":
        raise SystemExit("--parallel ep implements the IGMC model "
                         "(see parallel/ep.py); use --model igmc")
    if args.dense_chunk:
        raise SystemExit("--dense-chunk is the single-device "
                         "giant-batch path; under --parallel ep the "
                         "giant batch is already edge-partitioned "
                         "across devices — drop --dense-chunk")
    if args.dense_layout != "auto":
        raise SystemExit("--dense-layout applies to the dense batch "
                         "layout; --parallel ep uses the "
                         "edge-partitioned layout — drop "
                         "--dense-layout")


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
    """The Monti datasets' split (flixster, douban, yahoo_music), ml_100k's
    official split, or the random (ml_1m, ml_10m) or time (ml_25m) split."""
    from ..data import (MONTI_DATASETS, create_trainvaltest_split,
                        load_data_monti, load_official_trainvaltest_split)

    if args.data_name in MONTI_DATASETS:
        return load_data_monti(args.data_name, args.testing, rating_map,
                               post_rating_map)
    if args.data_name == "ml_100k":
        print("Using official MovieLens split u1.base/u1.test with 20% validation...")
        return load_official_trainvaltest_split(
            args.data_name, args.testing, rating_map, post_rating_map, args.ratio)
    prefix = "withfeatures_" if args.use_features else ""
    datasplit_path = os.path.join("raw_data", args.data_name,
                                  f"{prefix}split_seed{args.data_seed}.pickle")
    return create_trainvaltest_split(
        args.data_name, args.data_seed, args.testing, datasplit_path,
        not args.reprocess, True, rating_map, post_rating_map, args.ratio)


def side_features(args, split, verbose: bool = True):
    """(u_features, v_features, n_features): the split's feature matrices
    densified with --use-features, printing the JAX CLI's line when
    `verbose`; else (None, None, 0)."""
    if not args.use_features:
        return None, None, 0
    u_features = split.u_features.toarray()
    v_features = split.v_features.toarray()
    n_features = u_features.shape[1] + v_features.shape[1]
    if verbose:
        print("Number of user features {}, item features {}, total features {}"
              .format(u_features.shape[1], v_features.shape[1], n_features))
    return u_features, v_features, n_features


def build_datasets(args, split):
    """(train, val, test) datasets and the number of side features: each
    split static, with its `.npz` cache under
    data/<name><appendix>/<mode>/<split>, or dynamic by its --dynamic-*
    flag (--dynamic-dataset sets all three); --reprocess removes the
    caches first. In valmode the validation set is also the test set, as
    in the JAX CLI."""
    from ..batching import DynamicGraphDataset, StaticGraphDataset
    from ..graphs import BipartiteCSR

    if args.dynamic_dataset:
        args.dynamic_train = args.dynamic_test = args.dynamic_val = True
    u_features, v_features, n_features = side_features(args, split)
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

    mode = "testmode" if args.testing else "valmode"
    data_root = os.path.join("data", f"{args.data_name}{args.data_appendix}", mode)
    if args.reprocess:
        for sub in ("train", "val", "test"):
            shutil.rmtree(os.path.join(data_root, sub), ignore_errors=True)

    A = BipartiteCSR(split.adj_train)
    mnph = args.max_nodes_per_hop if args.max_nodes_per_hop > 0 else None
    common = dict(h=args.hop, sample_ratio=args.sample_ratio,
                  max_nodes_per_hop=mnph, u_features=u_features,
                  v_features=v_features, class_values=split.class_values,
                  backend=args.extract_backend)

    def make(dynamic, sub, links, labels, max_num):
        cls = DynamicGraphDataset if dynamic else StaticGraphDataset
        return cls(A, links, labels, max_num=max_num,
                   root=os.path.join(data_root, sub), **common)

    train_graphs = make(args.dynamic_train, "train", (tr_u, tr_v), tr_l,
                        args.max_train_num)
    test_graphs = make(args.dynamic_test, "test", (te_u, te_v), te_l,
                       args.max_test_num)
    val_graphs = None
    if not args.testing:
        val_graphs = make(args.dynamic_val, "val", (va_u, va_v), va_l,
                          args.max_val_num)
        test_graphs = val_graphs  # evaluate on val in valmode
    print("Used #train graphs: %d, #test graphs: %d"
          % (len(train_graphs), len(test_graphs)))
    return train_graphs, val_graphs, test_graphs, n_features


def build_model(args, split, n_features=0, train_graphs=None):
    """The --model family at the CLI's full width, initialised from a
    generator seeded with --seed: IGMC (4 R-GCN layers of 32), GNN (GCN
    layers 32, 32, 32, 1), DGCNN or DGCNN_RS (the same widths, GCN or
    R-GCN with 4 bases; SortPool k the 60th-percentile node count of the
    training graphs, or 30 for a dataset without node counts)."""
    import torch

    from ..models import (DGCNN, GNN, IGMC, DGCNNConfig, GNNConfig, IGMCConfig,
                          sortpool_k_from_dataset)

    num_features = 2 * args.hop + 2
    if args.transfer:
        num_relations, multiply_by = args.num_relations, args.multiply_by
    else:
        num_relations, multiply_by = len(split.class_values), 1.0
    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "igmc":
        cfg = IGMCConfig(num_features=num_features, latent_dim=(32, 32, 32, 32),
                         num_relations=num_relations, num_bases=args.num_bases,
                         adj_dropout=args.adj_dropout,
                         force_undirected=args.force_undirected,
                         side_features=args.use_features,
                         n_side_features=n_features,
                         multiply_by=multiply_by, aggr=args.aggr,
                         dense_strategy=args.dense_strategy,
                         compute_dtype=(None if args.compute_dtype == "float32"
                                        else args.compute_dtype),
                         conv_strategy=args.conv_strategy,
                         flat_aggregate=("segment" if args.flat_aggregate == "auto"
                                         else args.flat_aggregate))
        model = IGMC(cfg, gen)
    elif args.model == "gnn":
        model = GNN(GNNConfig(num_features=num_features,
                              adj_dropout=args.adj_dropout,
                              force_undirected=args.force_undirected), gen)
    else:  # dgcnn / dgcnn_rs
        k = 30
        if train_graphs is not None and hasattr(train_graphs, "node_counts"):
            nc = train_graphs.node_counts()
            if len(nc):
                k = sortpool_k_from_dataset(nc, 0.6)
        model = DGCNN(DGCNNConfig(num_features=num_features,
                                  latent_dim=(32, 32, 32, 1), k=k,
                                  adj_dropout=args.adj_dropout,
                                  force_undirected=args.force_undirected,
                                  relational=args.model == "dgcnn_rs",
                                  num_relations=num_relations, num_bases=4), gen)
    print(f"Total number of parameters is "
          f"{sum(p.numel() for p in model.parameters())}")
    return model


def dynamic_data(args) -> bool:
    return args.dynamic_train or args.dynamic_test or args.dynamic_val


def check_dense_chunk(args, batch_mode: str) -> None:
    """The JAX CLI's exits on --dense-chunk, in its order."""
    if not args.dense_chunk:
        return
    if args.dense_chunk < 1:
        raise SystemExit(f"--dense-chunk must be a positive graph "
                         f"count, got {args.dense_chunk}")
    if batch_mode != "dense":
        raise SystemExit("--dense-chunk needs the dense layout "
                         "(conflicts with --batch-mode flat / "
                         "--flat-aggregate)")
    if dynamic_data(args):
        raise SystemExit("--dense-chunk needs static (packed) datasets "
                         "— drop the --dynamic-* flags")
    if args.n_devices > 1:
        raise SystemExit("--dense-chunk is single-device; for "
                         "multi-chip giant batches use --parallel ep "
                         "or dense DP (--n-devices without "
                         "--dense-chunk)")
    if args.dense_chunk < args.batch_size and args.batch_size % args.dense_chunk:
        raise SystemExit(f"--dense-chunk ({args.dense_chunk}) must "
                         f"divide --batch-size ({args.batch_size})")


def choose_layouts(args, train_graphs):
    """(batch_mode, flat_aggregate, dense_layout) by the JAX CLI's rules,
    printing its `batch mode: ...` and `dense layout: ... (auto)` lines and
    exiting as it does on --dense-chunk, --dense-layout bipartite with
    dynamic data, --dense-strategy adjacency or a model other than igmc,
    and --flat-aggregate blocked or pallas with a model other than igmc.
    Dynamic data and the other families get the unified layout."""
    flat_aggregate = (None if args.flat_aggregate in ("auto", "segment")
                      else args.flat_aggregate)
    if flat_aggregate is not None and args.model != "igmc":
        raise SystemExit("--flat-aggregate blocked/pallas applies to the "
                         "R-GCN trunk; use --model igmc")
    batch_mode = args.batch_mode
    if flat_aggregate is not None:
        if batch_mode == "dense":
            raise SystemExit("--flat-aggregate conflicts with --batch-mode "
                             "dense (pick one layout)")
        batch_mode = "flat"
        print(f"batch mode: flat (--flat-aggregate {flat_aggregate})")
    elif batch_mode == "auto" and args.dense_chunk:
        batch_mode = "dense"
        print("batch mode: dense (--dense-chunk)")
    elif batch_mode == "auto":
        # data parallelism needs a batch that splits evenly over the
        # devices on the dense layout; else the flat one, as in the JAX CLI
        dp_ok = args.n_devices <= 1 or args.batch_size % args.n_devices == 0
        batch_mode = "dense" if dp_ok else "flat"
        print(f"batch mode: {batch_mode} (auto)")
    check_dense_chunk(args, batch_mode)
    adjacency = args.dense_strategy == "adjacency"
    static_data = not dynamic_data(args)
    dense_layout = args.dense_layout
    if dense_layout == "bipartite":
        if args.model != "igmc":
            raise SystemExit("--dense-layout bipartite applies to the "
                             "R-GCN trunk; use --model igmc")
        if batch_mode != "dense" or not static_data:
            raise SystemExit("--dense-layout bipartite needs the device-resident "
                             "dense path (batch-mode dense + static datasets)")
        if adjacency:
            raise SystemExit("--dense-strategy adjacency is unified-layout "
                             "only (models/igmc.py); drop it or use "
                             "--dense-layout unified")
    if dense_layout == "auto":
        # bipartite when the median training graph has >= 128 nodes, the
        # JAX CLI's rule (ml_1m with --max-nodes-per-hop 100: bipartite);
        # the adjacency strategy and the other families keep the unified
        # layout
        big = (batch_mode == "dense" and args.model == "igmc" and not adjacency
               and static_data and len(train_graphs) > 0
               and float(np.median(train_graphs.node_counts())) >= 128)
        dense_layout = "bipartite" if big else "unified"
        if batch_mode == "dense":
            print(f"dense layout: {dense_layout} (auto)")
    return batch_mode, flat_aggregate, dense_layout


def main(argv=None):
    args = build_parser().parse_args(argv)
    missing = unported_flags(args)
    if missing:
        raise SystemExit(f"{', '.join(missing)}: not ported to igmc_torch yet")
    if parallel_mode(args) == "ep":
        check_ep(args)
    from ..device import resolve_device

    resolve_device(args.device)       # raises without a card unless --device cpu
    if parallel_mode(args) == "ep" or args.n_devices > 1:
        from ..parallel import spawn

        spawn(_rank_main, max(args.n_devices, 1), args.device, args=(args,))
        return
    run(args)


def _rank_main(mesh, args) -> None:
    """One rank of a multi-device run: rank 0 prints, the others are
    silent."""
    if mesh.rank == 0:
        run(args, mesh)
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        run(args, mesh)


def run(args, mesh=None) -> None:
    """The CLI's work after parsing: on one device, or as one rank of
    `mesh` (parallel/mesh.py)."""
    from ..device import resolve_device
    from ..train import (load_checkpoint, resolve_checkpoint, test_once,
                         test_once_ep, train_multiple_epochs,
                         train_multiple_epochs_ep)
    from ..utils import ResultsDir, make_logger, seed_everything

    device = resolve_device(args.device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    seed_everything(args.seed)
    print(args)
    if not lead:
        mesh.barrier()      # rank 0 writes the split pickle and the caches first

    rating_map, post_rating_map = rating_maps(args)
    split = load_split(args, rating_map, post_rating_map)
    print("All ratings are:")
    print(split.class_values)

    res = ResultsDir("results", args.data_name, args.save_appendix, args.testing)
    if lead:
        res.record_cmd()
        if not args.keep_old and not args.transfer:
            res.snapshot_source()

    train_graphs, _, test_graphs, n_features = build_datasets(args, split)
    if lead and mesh is not None:
        mesh.barrier()
    model = build_model(args, split, n_features, train_graphs)
    logger = make_logger(res, args.save_interval)
    ckpt_dir = args.transfer if args.transfer else res.path

    if parallel_mode(args) == "ep":
        print(f"Edge-partitioned training over {mesh.size} devices")
        if not args.no_train:
            train_multiple_epochs_ep(
                train_graphs, test_graphs, model, mesh, epochs=args.epochs,
                batch_size=args.batch_size, lr=args.lr,
                lr_decay_factor=args.lr_decay_factor,
                lr_decay_step_size=args.lr_decay_step_size, weight_decay=0.0,
                ARR=args.ARR, test_freq=args.test_freq, logger=logger,
                continue_from=args.continue_from, res_dir=res.path,
                seed=args.seed, profile_dir=args.profile_dir or None,
                local_aggregate=args.ep_local_aggregate)
        if args.visualize:
            print("--visualize under --parallel ep: rerun without ep "
                  "(visualization evaluates per-subgraph on one device)")
        if args.ensemble:
            se, ee, iv = ensemble_range(args)
            checkpoints = [resolve_checkpoint(ckpt_dir, "model", x)
                           for x in range(se, ee + 1, iv)
                           if os.path.isfile(resolve_checkpoint(ckpt_dir, "model", x))]
            rmse = test_once_ep(test_graphs, model, args.batch_size, mesh,
                                ensemble=True, checkpoints=checkpoints)
            print("Ensemble test rmse is: {:.6f}".format(rmse))
            epoch_info = "ensemble of range({}, {}, {})".format(se, ee, iv)
        elif args.transfer:
            params = load_checkpoint(resolve_checkpoint(ckpt_dir, "model", args.epochs))
            rmse = test_once_ep(test_graphs, model, args.batch_size, mesh,
                                params=params)
            print("Test rmse is: {:.6f}".format(rmse))
            epoch_info = "transfer {}, epochs {}".format(args.transfer, args.epochs)
        else:
            return
        if lead:
            res.log_line("Epoch {}, train loss {:.4f}, test rmse {:.6f}".format(
                epoch_info, 0, rmse))
        return

    batch_mode, flat_aggregate, dense_layout = choose_layouts(args, train_graphs)
    if args.n_devices > 1:
        print(f"Data-parallel training over {args.n_devices} devices")
    elif args.n_devices == 1:
        print("--n-devices 1: single device, using the plain training path")
    if not args.no_train:
        train_multiple_epochs(
            train_graphs, test_graphs, model, epochs=args.epochs,
            batch_size=args.batch_size, lr=args.lr,
            lr_decay_factor=args.lr_decay_factor,
            lr_decay_step_size=args.lr_decay_step_size, weight_decay=0.0,
            ARR=args.ARR, test_freq=args.test_freq, logger=logger,
            continue_from=args.continue_from, res_dir=res.path, seed=args.seed,
            superbatch=args.superbatch, mesh=mesh, batch_mode=batch_mode,
            dense_buckets=args.dense_buckets, flat_aggregate=flat_aggregate,
            dense_chunk=args.dense_chunk, dense_layout=dense_layout,
            profile_dir=args.profile_dir or None, device=device)
    if not lead:
        return      # the evaluation below runs on one device, rank 0's

    if args.visualize:
        visualize_run(args, split, model, test_graphs, res, ckpt_dir, logger,
                      batch_mode, device)
        return      # no ensemble after --visualize, as in the JAX CLI

    eval_kw = dict(batch_mode=batch_mode, flat_aggregate=flat_aggregate,
                   dense_chunk=args.dense_chunk, dense_layout=dense_layout,
                   device=device)
    if args.ensemble:
        start_epoch, end_epoch, interval = ensemble_range(args)
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


def visualize_run(args, split, model, test_graphs, res, ckpt_dir, logger,
                  batch_mode: str, device) -> None:
    """--visualize: draw the test graphs' best and worst predictions of
    the checkpoint of epoch --epochs; with --transfer also evaluate it
    (test_once on the CLI's batch mode) and print the JAX CLI's line."""
    from ..train import load_checkpoint, resolve_checkpoint, test_once
    from ..train.visualize import visualize

    params = load_checkpoint(resolve_checkpoint(ckpt_dir, "model", args.epochs))
    trained = copy.deepcopy(model)
    trained.load_state_dict(params)
    visualize(trained, test_graphs, res.path, args.data_name, split.class_values,
              batch_size=args.batch_size, device=device)
    if args.transfer:
        rmse = test_once(test_graphs, model, args.batch_size, params=params,
                         logger=logger, batch_mode=batch_mode, device=device)
        print("Transfer learning rmse is: {:.6f}".format(rmse))


def ensemble_range(args):
    """(start, end, interval) of the ensemble's checkpoint epochs, the
    reference's: every 5 of the last 15 epochs for ml_1m, every 10 of the
    last 30 otherwise."""
    if args.data_name == "ml_1m":
        return args.epochs - 15, args.epochs, 5
    return args.epochs - 30, args.epochs, 10


if __name__ == "__main__":
    main()
