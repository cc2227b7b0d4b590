"""A closed loop of training passes, as train_multiple_epochs runs them.

The traffic file's parameters: `batch_mode` "dense" (device-resident,
`dense_train_epoch` with `make_dense_row_step` over a DeviceDataset and a
`DensePass.plan` per pass; `dense_layout` "auto" picks bipartite when the
median graph has 128 nodes or more, as the CLI does) or "flat" with
`flat_aggregate` "pallas" (`train_epoch` with `make_train_step` over a
BatchLoader that collates and plans on `prefetch` threads into pinned
memory); `superbatch`, `dense_buckets`; `warmup_steps` (flat) and
`traced_steps`, the steps of the warm-up and of the traced slice;
`compared_steps` (default 3), the steps the reference follows;
`extract_backend` (default the C++ engine). The batch size and the pool
(a number of training pairs fixed by the configuration's pool seed, or
null for every training pair) are the configuration's.

Set-up extracts the pool, builds the model from the run's weights, and
runs the start of pass 0 through the window's own call: its first
`compared_steps` steps are recorded (loss, the first gradient from Adam's
state, the parameters' change), and a dense warm-up then runs one step of
each bucket it has not met, a flat one runs on to `warmup_steps`. The
window then runs passes 1, 2, ... (order and noise from (seed, pass))
until `seconds` have passed, and ends on a synchronise. A traced run adds
the start of one more pass under the profiler after the window. Once the
program's state is freed the reference re-extracts the recorded steps'
graphs and follows the same steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..lib import counts, weights
from ..lib.cell import Context, Outcome
from ..lib.data import load_split, train_pool
from ..lib.trace import traced
from ..reference import compare
from ..reference import extract as rx
from ..reference import igmc as ri

K1, K2 = "rgcn_aggregate_fwd", "rgcn_aggregate_bwd"
COMPARED_STEPS = 3
EXTRACT_BACKEND = "native"


class FirstSteps:
    """Wraps the program's step function; records its first `k` steps."""

    def __init__(self, step, model, optimizer, k: int, ids_of):
        self.step, self.model, self.optimizer, self.k = step, model, optimizer, k
        self.ids_of = ids_of
        self.p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.ids, self.losses, self.grad, self.change = [], [], None, None

    def __call__(self, *args):
        out = self.step(*args)
        if len(self.losses) < self.k:
            self.ids.append(self.ids_of(*args))
            self.losses.append(float(out[0]))
            named = list(self.model.named_parameters())
            if self.grad is None:
                b1 = self.optimizer.param_groups[0]["betas"][0]
                # Adam's first moment after one step is (1 - b1) * gradient
                state = lambda p: self.optimizer.state.get(p, {}).get("exp_avg")
                self.grad = {n: (torch.zeros_like(p) if state(p) is None
                                 else state(p).detach() / (1 - b1)) for n, p in named}
            if len(self.losses) == self.k:
                self.change = {n: p.detach() - self.p0[n] for n, p in named}
        return out


def _config_model(config: dict, R: int, engine: str):
    """The program's IGMCConfig of the configuration. The program fixes
    lin1's width and the feature dropout (HIDDEN, FEATURE_DROPOUT), so a
    configuration that states others is refused rather than run at the
    program's."""
    from igmc_torch.models.igmc import FEATURE_DROPOUT, HIDDEN, IGMCConfig

    m = config["model"]
    if (m["hidden"], m["dropout"]) != (HIDDEN, FEATURE_DROPOUT):
        raise ValueError(f"the program runs hidden {HIDDEN} and dropout {FEATURE_DROPOUT}; "
                         f"the configuration states {m['hidden']} and {m['dropout']}")
    return IGMCConfig(num_features=m["num_features"], latent_dim=tuple(m["latent_dim"]),
                      num_relations=R, num_bases=m["num_bases"],
                      adj_dropout=m["adj_dropout"], aggr=m["aggr"],
                      compute_dtype=None if m["dtype"] == "float32" else m["dtype"],
                      flat_aggregate=engine)


def _plant(ctx: Context, step, optimizer, dense: bool):
    """Tests only: the timed path with one of the faults the check must
    catch ("frozen": the step leaves the state unchanged; "half_batch":
    the loss is the mean over the first half of each batch)."""
    if ctx.fault == "frozen":
        optimizer.step = lambda *a, **k: None
        return step
    if ctx.fault != "half_batch":
        return step

    def cut(batch):
        keep = torch.zeros_like(batch.graph_mask)
        keep[: keep.shape[0] // 2] = True
        return dataclasses.replace(batch, graph_mask=batch.graph_mask & keep)

    if dense:
        return lambda assemble, gids, noise: step(lambda g: cut(assemble(g)), gids, noise)
    return lambda batch, noise: step(cut(batch), noise)


def run(ctx: Context) -> Outcome:
    from igmc_torch.batching.dataset import BatchLoader, StaticGraphDataset
    from igmc_torch.batching.device_data import DeviceDataset
    from igmc_torch.kernels.rgcn_aggregate import rgcn_aggregate, rgcn_aggregate_bwd
    from igmc_torch.models.igmc import IGMC
    from igmc_torch.train.loop import (DensePass, dense_train_epoch, make_dense_row_step,
                                       make_optimizer, make_train_step, plan_buckets,
                                       train_epoch)

    cfg, prm, dev, spans = ctx.config, ctx.params, ctx.device, ctx.spans
    model_cfg, data_cfg = cfg["model"], cfg["data"]
    dense = prm["batch_mode"] == "dense"
    B, K = model_cfg["batch_size"], prm.get("compared_steps", COMPARED_STEPS)
    memo = {} if ctx.cache is None else ctx.cache
    key = ("train", ctx.cell, json.dumps(data_cfg, sort_keys=True))
    if key not in memo:
        split = load_split(cfg)
        pool = train_pool(split, data_cfg.get("train_pool"), data_cfg["pool_seed"])
        ds = StaticGraphDataset(split.adj, pool[:2], pool[2], h=model_cfg["hops"],
                                max_nodes_per_hop=data_cfg["max_nodes_per_hop"],
                                class_values=split.class_values,
                                backend=prm.get("extract_backend", EXTRACT_BACKEND),
                                progress=False)
        memo[key] = split, pool, ds
    split, (pu, pv, plab), ds = memo[key]
    ctx.stage("set-up: data and extraction")
    R = split.num_relations
    G = len(ds)
    if G < K * B:
        raise ValueError(f"a pool of {G} graphs holds fewer than the {K} compared steps of {B}")
    engine = "segment" if dense else prm["flat_aggregate"]
    members = weights.make_members(model_cfg, R, ctx.seed, 1, dev)
    init = members[0]
    model = IGMC(_config_model(cfg, R, engine), torch.Generator().manual_seed(0)).to(dev)
    model.load_state_dict(init)
    optimizer = make_optimizer(model.parameters(), model_cfg["lr"])
    ctx.stage("set-up: model and optimizer")
    order_seed = weights.sub_seed(ctx.seed, weights.ORDER)
    rng_of = lambda p: np.random.default_rng(np.random.SeedSequence([order_seed, p]))

    if dense:
        dd = DeviceDataset(ds.packed, dev)
        layout = prm["dense_layout"]
        if layout == "auto":
            layout = "bipartite" if np.median(ds.node_counts()) >= 128 else "unified"
        buckets = plan_buckets(ds, layout, prm["dense_buckets"])
        step = make_dense_row_step(model, optimizer, 0, model_cfg["arr"])
        ids_of = lambda assemble, gids, noise: gids.cpu().numpy()
    else:
        loader = BatchLoader(ds, B, shuffle=True, seed=order_seed,
                             prefetch=prm["prefetch"], batch_mode="flat",
                             pin_memory=dev.type == "cuda", flat_aggregate=engine)
        yielded = []
        step = make_train_step(model, optimizer, model_cfg["arr"])
        ids_of = lambda batch, noise: np.concatenate(
            [yielded[-1], np.full(B - len(yielded[-1]), -1)])

    step = spans.wrap("step", _plant(ctx, step, optimizer, dense))
    first = FirstSteps(step, model, optimizer, K, ids_of)

    def one_pass(p: int, step_fn, deadline=None, steps=None, warm=False):
        """Pass p; returns (graph ids, bucket) of its steps. A pass runs
        only its first `steps` steps (a dense warm-up: its first K and
        the first of every other bucket), and a flat one stops early at
        time `deadline`."""
        gen = weights.noise_generator(ctx.seed, p)
        if dense:
            with spans("plan"):
                tp = DensePass.plan(buckets, B, prm["superbatch"], dev, rng_of(p))
            if warm or steps:
                first_of = {}
                for i, bi in enumerate(tp.bucket_of):
                    first_of.setdefault(bi, i)
                keep = sorted(set(range(min(K if warm else steps, len(tp.bucket_of))))
                              | (set(first_of.values()) if warm else set()))
                tp = DensePass(tp.buckets, [tp.bucket_of[i] for i in keep],
                               tp.gids[torch.as_tensor(keep, device=tp.gids.device)])
            dense_train_epoch(step_fn, dd, tp, gen, G)
            return [(g, bi) for g, bi in zip(tp.gids.cpu().numpy(), tp.bucket_of)]
        loader.epoch = p
        # the loader's documented order of pass p, in batches of B
        order = np.random.default_rng(np.random.SeedSequence([order_seed, p])).permutation(G)
        rows = []

        def batches():
            for batch in spans.timed_iter("loader_wait", loader):
                yielded.append(order[len(rows) * B:(len(rows) + 1) * B])
                rows.append((yielded[-1], 0))
                yield batch
                if len(rows) == steps or (deadline and time.perf_counter() >= deadline):
                    return

        train_epoch(step_fn, batches(), gen, G, dev)
        return rows

    ctx.stage("set-up: device data, loader and plans")
    # warm-up through the window's own call, the compared steps first
    one_pass(0, first, steps=prm.get("warmup_steps"), warm=dense)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = ctx.since_start()
    ctx.stage("set-up: warm-up pass")

    spans.reset()
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    window_rows, passes, whole, pass_s = [], 0, [], []
    while time.perf_counter() < deadline or not passes:
        passes += 1
        t_pass = time.perf_counter()
        rows = one_pass(passes, step, deadline=deadline)
        pass_s.append(time.perf_counter() - t_pass)
        whole.append(len(rows) == len(loader) if not dense else True)
        window_rows += [(g, bi, passes) for g, bi in rows]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t_start
    graphs = sum(int((np.asarray(g) >= 0).sum()) for g, _, _ in window_rows)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    layer = {"kind": "train", "window_s": window_s,
             "host_wait_s": spans.seconds.get("plan" if dense else "loader_wait", 0.0)}
    if ctx.trace:
        p = ds.packed
        nodes, msgs, pairs = counts.graph_sizes(p.node_offsets, p.edge_offsets, p.src, p.dst,
                                                p.etype, R)
        per_step = lambda rows: counts.train_step_flops(
            *(np.array([a[np.asarray(g)[np.asarray(g) >= 0]].sum() for g, *_ in rows])
              for a in (nodes, msgs, pairs)),
            np.array([(np.asarray(g) >= 0).sum() for g, *_ in rows]), model_cfg, R)
        layer["flops"] = float(per_step(window_rows).sum())
        if dense:
            real = sum(int(msgs[g[g >= 0]].sum()) // 2 for g, _, _ in window_rows)
            slots = sum(B * buckets[bi].edge_slot for _, bi, _ in window_rows)
            layer["slot_fill"] = (real, slots)

    trace = None
    if ctx.trace:
        for attempt in range(2):
            k1, k2 = rgcn_aggregate.launches, rgcn_aggregate_bwd.launches
            box = {}
            trace = traced(lambda: box.setdefault("rows", one_pass(
                passes + 1 + attempt, step, steps=prm.get("traced_steps"))))
            k1, k2 = rgcn_aggregate.launches - k1, rgcn_aggregate_bwd.launches - k2
            if trace.count(K1) == k1 and trace.count(K2) == k2:
                break
            note = (f"trace {attempt + 1}: the profiler saw {trace.count(K1)} K1 and "
                    f"{trace.count(K2)} K2 launches of {k1} and {k2}")
            print(note, file=sys.stderr, flush=True)
        else:
            raise RuntimeError("the device trace lost kernel launches twice: " + note)
        layer["trace"] = trace
        if k1:
            layer["k1"], layer["k2"] = _kernel_bounds(loader.make_batch, box["rows"],
                                                      model_cfg, R)
        ctx.stage(f"traced pass: the profiler saw {trace.count(K1)} K1 and "
                  f"{trace.count(K2)} K2 launches; the program counted {k1} and {k2}")

    # the reference, once the program's state is freed
    prog = dict(losses=first.losses, grad={k: v.cpu() for k, v in first.grad.items()},
                change={k: v.cpu() for k, v in first.change.items()})
    step_ids = [np.asarray(i) for i in first.ids]
    del model, optimizer, first, step
    if dense:
        del dd
    else:
        del loader
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers, leaves = _compare(ctx, split, (pu, pv, plab), init, step_ids, prog, B)
    numbers["pass_gap"] = float(_pass_gap(window_rows, G, whole))
    ok, rows = compare.judge(numbers, ctx.cell)
    return Outcome(
        end_to_end={"setup_s": setup_s, "train_graphs_per_s": graphs / window_s},
        layer=layer, compared=rows, correct=ok,
        attempted=len(window_rows), failed=0, memory_peak_bytes=int(memory_peak),
        trace=trace, leaves=leaves,
        notes=[f"{passes} passes of {G} graphs, {len(window_rows)} steps in "
               f"{window_s:.3f} s; set-up {setup_s:.3f} s; a pass "
               f"{min(pass_s):.3f} / {float(np.median(pass_s)):.3f} / {max(pass_s):.3f} s "
               f"(min / median / max)"] + ctx.stage_notes())


def _pass_gap(rows, G: int, whole) -> int:
    """Graphs the window's passes missed or ran twice: 0 when every whole
    pass ran every graph of the pool once and a pass cut by the window's
    end ran none twice."""
    gap = 0
    for p, complete in enumerate(whole, start=1):
        ids = [np.asarray(g)[np.asarray(g) >= 0] for g, _, q in rows if q == p]
        seen = np.bincount(np.concatenate(ids), minlength=G)
        gap += int(np.abs(seen - 1).sum()) if complete else int(np.maximum(seen - 1, 0).sum())
    return gap


def _kernel_bounds(make_batch, rows, model: dict, R: int):
    """Summed K1 and K2 bounds (seconds) of the traced pass's launches: per
    step one launch per layer each, K2 without dx in layer 1. The plans are
    rebuilt by the loader's make_batch from the recorded graph ids
    (deterministic)."""
    b1 = b2 = 0.0
    nb = model["num_bases"]
    for idxs, _ in rows:
        batch = make_batch(idxs)
        n, r = batch.node_label.shape[0], batch.plan_rows
        fwd = tuple(t.numpy() for t in batch.aligned)
        bwd = tuple(t.numpy() for t in batch.aligned_t)
        cin = model["num_features"]
        for layer, cout in enumerate(model["latent_dim"]):
            b1 += counts.aggregate_bound(n, cin, cout, nb, R, fwd, r)["bound_s"]
            b2 += counts.aggregate_bwd_bound(n, cin, cout, nb, R, bwd, layer > 0, r)["bound_s"]
            cin = cout
    return b1, b2


def _compare(ctx: Context, split, pool, init, step_ids, prog, B):
    """The reference follows the recorded steps from the same weights."""
    model = ctx.config["model"]
    dev = ctx.device
    pu, pv, plab = pool
    A = rx.Adjacency(split.adj)
    cap = ctx.config["data"]["max_nodes_per_hop"]
    gen = weights.noise_generator(ctx.seed, 0)
    batches, noises = [], []
    if model["adj_dropout"] > 0:
        # the keys of edge dropout count stored edges over the whole pool
        every = rx.extract_links(A, pu, pv, np.arange(len(pu)), model["hops"], cap)
        first_edge = np.concatenate([[0], np.cumsum([len(g.src) for g in every])])
    for ids in step_ids:
        seed, keep = ri.draw_noise(gen, B, model)
        real = ids >= 0
        g = ids[real]
        graphs = rx.extract_links(A, pu[g], pv[g], g, model["hops"], cap)
        ys = split.class_values[plab[g]]
        eids = first_edge[g] if model["adj_dropout"] > 0 else None
        batches.append(ri.make_batch(graphs, ys, dev, eids))
        noises.append((seed, keep[torch.from_numpy(real)]))
    p64 = {k: v.double() for k, v in init.items()}
    ref = ri.train_steps(p64, model, batches, noises, float(np.float32(model["lr"])))
    if ctx.control == "tf32":
        # the control: the reference in TF32 put in the program's place
        with tf32():
            p32 = {k: v.float() for k, v in init.items()}
            ctl = ri.train_steps(p32, model, batches, noises, float(np.float32(model["lr"])))
        prog = dict(losses=ctl.losses, grad=ctl.first_grad, change=ctl.change)
    to_cpu = lambda d: {k: v.detach().double().cpu() for k, v in d.items()}
    ref = ri.TrainTrace(ref.losses, to_cpu(ref.first_grad), to_cpu(ref.change))
    change = to_cpu(prog["change"])
    return (compare.train_numbers(prog["losses"], to_cpu(prog["grad"]), change, ref),
            compare.worst_leaves(change, ref.change, ref.first_grad))


@contextlib.contextmanager
def tf32():
    """TF32 on for matrix products and convolutions; as it was after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
