"""The ranks of igmc_torch's multi-device tests: each function below runs in
one process of a torch.distributed group (igmc_torch.parallel.spawn, gloo
on the CPU), does every check of its test file at once and returns the
arrays the tests assert on. This module imports torch and igmc_torch only
(the ranks never import JAX); tests/test_torch_port_parallel.py and
tests/test_torch_port_ep.py compute the JAX and single-device sides and
compare."""

import numpy as np
import scipy.sparse as sp
import torch

from igmc_torch.batching import DynamicGraphDataset, StaticGraphDataset
from igmc_torch.batching.batch import collate, pad_ladder
from igmc_torch.batching.dense import plan_dense_buckets
from igmc_torch.batching.device_data import DeviceDataset, assemble_dense
from igmc_torch.graphs import BipartiteCSR, extract_many
from igmc_torch.models import IGMC, IGMCConfig, draw_noise
from igmc_torch.parallel import dp, ep
from igmc_torch.serve import Predictor
from igmc_torch.train import (checkpoint_path, make_dp_row_step, make_optimizer,
                              make_train_step, params_from_jax, test_once_ep,
                              train_multiple_epochs, train_multiple_epochs_ep)
from igmc_torch.utils import ResultsDir, make_logger

CV = np.arange(1.0, 6.0)


def rating_matrix(n: int, density: float, seed: int) -> np.ndarray:
    """A seeded n x n rating matrix (0 = no rating, else 1..5)."""
    rng = np.random.default_rng(seed)
    return ((rng.random((n, n)) < density).astype(np.float32)
            * rng.integers(1, 6, (n, n)).astype(np.float32))


def links(M: np.ndarray):
    us, vs = np.nonzero(M)
    return (us, vs), (M[us, vs] - 1).astype(np.int64)


def graphs_of(M: np.ndarray, n: int):
    """The first n pairs' enclosing subgraphs (h 1, NumPy engine)."""
    (us, vs), labels = links(M)
    return extract_many((us[:n], vs[:n]), labels[:n], BipartiteCSR(sp.csr_matrix(M)),
                        h=1, class_values=CV, backend="numpy")


def datasets(M: np.ndarray, n_train: int, n_test: int, dynamic: bool = False):
    """(train, test): the first n_train pairs and the n_test after them."""
    (us, vs), labels = links(M)
    cls = DynamicGraphDataset if dynamic else StaticGraphDataset
    A = sp.csr_matrix(M)
    part = lambda a, b: cls(A, (us[a:b], vs[a:b]), labels[a:b], h=1,
                            class_values=CV, backend="numpy")
    return part(0, n_train), part(n_train, n_train + n_test)


def model_of(cfg_kw: dict, jax_params) -> IGMC:
    model = IGMC(IGMCConfig(**cfg_kw), torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(jax_params))
    return model


def params_np(model) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def grads_np(model) -> dict:
    return {k: p.grad.detach().cpu().numpy().copy()
            for k, p in model.named_parameters()}


def _calls(mesh, fn):
    """fn()'s result and the collectives it issued, by name."""
    before = dict(mesh.calls)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in mesh.calls.items()
                 if v != before.get(k, 0)}


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def dp_checks(mesh, spec):
    torch.set_num_threads(1)
    D, r = mesh.size, mesh.rank
    cfg_kw, jp, M = spec["cfg"], spec["params"], spec["M"]
    out = {"rank": r}

    # 1. the flat DP step without dropout (eval-mode forward), against
    #    JAX's make_dp_train_step on a D-device mesh
    graphs = graphs_of(M, spec["n_step"])
    B = len(graphs)
    tn, te = sum(g.num_nodes for g in graphs), sum(g.num_edges for g in graphs)
    nl, el = pad_ladder(tn), pad_ladder(te, base=128)
    sub = dp.split_for_devices(graphs, D, B // D, nl, el)[r]
    model = model_of(cfg_kw, jp).eval()
    opt = make_optimizer(model.parameters(), 1e-3)
    (loss, n), calls = _calls(mesh, lambda: dp.make_dp_train_step(
        model, opt, mesh, spec["ARR"])(sub, None))
    out["flat_step"] = dict(loss=float(loss), n=float(n), grads=grads_np(model),
                            params=params_np(model), calls=calls)

    # make_dp_scan_train_step: one DP step per batch, in order
    runs = []
    for scan in (True, False):
        model = model_of(cfg_kw, jp).eval()
        opt = make_optimizer(model.parameters(), 1e-3)
        if scan:
            total, count = dp.make_dp_scan_train_step(model, opt, mesh, spec["ARR"])(
                [(sub, None), (sub, None)])
        else:
            step = dp.make_dp_train_step(model, opt, mesh, spec["ARR"])
            (l1, n1), (l2, n2) = step(sub, None), step(sub, None)
            total, count = l1 * n1 + l2 * n2, n1 + n2
        runs.append((float(total), float(count), params_np(model)))
    out["scan_step"] = runs

    # 2. the dense DP row step without dropout, against JAX's
    #    make_dense_device_train_step(mesh=)
    train, test = datasets(M, spec["n_train"], spec["n_test"])
    bucket = plan_dense_buckets(train.node_counts(), train.edge_counts() // 2, 1)[0]
    dd = DeviceDataset(train.packed, "cpu")
    assemble = lambda g: assemble_dense(dd, g, bucket.node_slot, bucket.edge_slot)
    row = torch.arange(spec["batch"], dtype=torch.int64)
    model = model_of(cfg_kw, jp).eval()
    opt = make_optimizer(model.parameters(), 1e-3)
    (loss, n), calls = _calls(mesh, lambda: make_dp_row_step(
        model, opt, mesh, spec["ARR"])(assemble, row, None))
    out["dense_step"] = dict(loss=float(loss), n=float(n), grads=grads_np(model),
                             params=params_np(model), calls=calls)

    # 3. dropout on: the DP step against the single-device step on the
    #    whole batch with the same noise, flat and dense
    gen = torch.Generator().manual_seed(11)
    noise = draw_noise(gen, spec["batch"])
    idx = np.arange(spec["batch"])
    whole_graphs = [train.get(int(i)) for i in idx]
    offs = train.packed.edge_offsets
    tn = sum(g.num_nodes for g in whole_graphs)
    te = sum(g.num_edges for g in whole_graphs)
    nl, el = pad_ladder(tn), pad_ladder(te, base=128)
    cases = {
        "flat": (lambda: collate(whole_graphs, spec["batch"], nl[-1], el[-1], gids=idx,
                                 edge_offsets=offs),
                 lambda: dp.split_for_devices(whole_graphs, D, spec["batch"] // D, nl,
                                              el, gids=idx, edge_offsets=offs)[r]),
        "dense": (lambda: assemble(row), None),
    }
    for name, (whole, part) in cases.items():
        single = model_of(cfg_kw | {"adj_dropout": 0.2}, jp).train()
        opt = make_optimizer(single.parameters(), 1e-3)
        loss1, n1 = make_train_step(single, opt, spec["ARR"])(whole(), noise)
        model = model_of(cfg_kw | {"adj_dropout": 0.2}, jp).train()
        opt = make_optimizer(model.parameters(), 1e-3)
        if part is None:
            loss, n = make_dp_row_step(model, opt, mesh, spec["ARR"])(assemble, row, noise)
        else:
            loss, n = dp.make_dp_train_step(model, opt, mesh, spec["ARR"])(
                part(), dp.rank_noise(mesh, noise, spec["batch"]))
        out[f"dropout_{name}"] = dict(
            loss=float(loss), single_loss=float(loss1), grads=grads_np(model),
            single_grads=grads_np(single), params=params_np(model),
            single_params=params_np(single))

    # 4. DP evaluation of the flat sub-batches
    model = model_of(cfg_kw, jp).eval()
    sse, cnt, preds = dp.make_dp_eval_step(model, mesh)(
        dp.split_for_devices(whole_graphs, D, spec["batch"] // D, nl, el)[r])
    with torch.no_grad():
        ref = model(collate(whole_graphs, spec["batch"], nl[-1], el[-1]))
    out["eval"] = dict(sse=float(sse), cnt=float(cnt), preds=preds.numpy(),
                       single_preds=ref.numpy())

    # 5. train_multiple_epochs(mesh=) on each layout
    out["train"] = {}
    for name, kw in spec["train_runs"].items():
        tr, te_ = datasets(M, spec["n_train"], spec["n_test"],
                           dynamic=kw.get("dynamic", False))
        run_kw = {k: v for k, v in kw.items() if k != "dynamic"}
        rmse, state = train_multiple_epochs(
            tr, te_, model_of(cfg_kw | {"adj_dropout": 0.2}, jp), epochs=2,
            batch_size=spec["batch"], lr=1e-2, lr_decay_factor=0.1,
            lr_decay_step_size=50, ARR=spec["ARR"], seed=1, mesh=mesh,
            prefetch=0, **run_kw)
        out["train"][name] = dict(rmse=rmse, params=params_np(state.model),
                                  epoch=state.epoch)

    # 6. data-parallel serving
    pred = Predictor(sp.csr_matrix(M), CV, IGMCConfig(**cfg_kw),
                     params=model_of(cfg_kw, jp).state_dict(), batch_size=spec["batch"],
                     backend="numpy", mesh=mesh)
    out["serve"] = pred.predict(*spec["pairs"])
    return out


# ---------------------------------------------------------------------------
# edge partitioning
# ---------------------------------------------------------------------------

def _no_feature_dropout(fn):
    """fn() with EP feature dropout turned off (for parity with a JAX step
    whose feature dropout is turned off alike)."""
    saved = ep.feature_dropout
    ep.feature_dropout = lambda h, keep, p: h
    try:
        return fn()
    finally:
        ep.feature_dropout = saved


def ep_checks(mesh, spec):
    torch.set_num_threads(1)
    D, r = mesh.size, mesh.rank
    cfg_kw = spec["cfg"]
    batch = spec["batch"]
    epb = ep.partition_batch(batch, D)
    shard = ep.ep_shard(epb, r, mesh.device)
    plans = ep.build_ep_blocked(epb).shard(r, mesh.device)
    out = {"rank": r, "fwd": {}, "fwd_blocked": {}, "step": {}}

    # 1. forward: segment and blocked local aggregates, every aggregation
    for aggr, jp in spec["params"].items():
        model = model_of(cfg_kw | {"aggr": aggr, "adj_dropout": 0.0}, jp).eval()
        with torch.no_grad():
            seg = ep.ep_forward(model, shard, mesh)
            blk = ep.ep_forward(model, shard, mesh, plans=plans)
        out["fwd"][aggr] = mesh.all_gather(seg).numpy()
        out["fwd_blocked"][aggr] = mesh.all_gather(blk).numpy()
    model = model_of(cfg_kw | {"adj_dropout": 0.0}, spec["params"]["mean"]).eval()
    sse, cnt, preds = ep.make_ep_eval_step(model, mesh)(shard)
    out["eval"] = dict(sse=float(sse), cnt=float(cnt), preds=preds.numpy())

    # 2. one train step per local aggregate: edge dropout on (the hash),
    #    feature dropout off, ARR
    jp = spec["params"]["mean"]
    for name, pl in (("segment", None), ("blocked", plans)):
        model = model_of(cfg_kw | {"adj_dropout": 0.2}, jp).train()
        opt = make_optimizer(model.parameters(), 1e-2)
        (loss, n), calls = _calls(mesh, lambda: _no_feature_dropout(
            lambda: ep.make_ep_train_step(model, opt, mesh, spec["ARR"])(
                shard, spec["step_seed"], pl)))
        out["step"][name] = dict(loss=float(loss), n=float(n), grads=grads_np(model),
                                 params=params_np(model), calls=calls)

    # 3. train_multiple_epochs_ep, its resume, and test_once_ep's ensemble
    M = spec["M"]
    train, test = datasets(M, spec["n_train"], spec["n_test"])
    res = ResultsDir(spec["work"], "ep", f"_{D}", True)
    kw = dict(epochs=2, batch_size=spec["ep_batch"], lr=1e-2, lr_decay_factor=0.1,
              lr_decay_step_size=50, ARR=spec["ARR"], seed=1)
    out["train"] = {}
    for agg in ("segment", "blocked"):
        infos = []
        log = make_logger(res, 1)

        def logger(info, state):
            infos.append(dict(info))
            log(info, state)

        model = model_of(cfg_kw | {"adj_dropout": 0.2}, jp)
        rmse, state = train_multiple_epochs_ep(
            train, test, model, mesh, logger=logger if agg == "segment" else None,
            local_aggregate=agg, **kw)
        out["train"][agg] = dict(rmse=rmse, params=params_np(state.model),
                                 losses=[h["train_loss"] for h in infos])
    rmse, state = train_multiple_epochs_ep(
        train, test, model_of(cfg_kw | {"adj_dropout": 0.2}, jp), mesh,
        continue_from=1, res_dir=res.path, **kw)
    out["resume"] = dict(rmse=rmse, params=params_np(state.model))
    ckpts = [checkpoint_path(res.path, "model", e) for e in (1, 2)]
    out["ensemble"] = test_once_ep(test, model_of(cfg_kw, jp), spec["ep_batch"], mesh,
                                   ensemble=True, checkpoints=ckpts)
    out["ckpts"] = ckpts
    return out
