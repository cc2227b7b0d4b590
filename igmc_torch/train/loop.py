"""Training and evaluation: masked MSE + ARR, Adam with step LR decay,
RMSE of one model or of a checkpoint ensemble.

Port of igmc_tpu/train/loop.py on one device, in two layouts:

  * dense (``batch_mode="dense"``, the JAX CLI's default for static data):
    the packed datasets live on the device (batching/device_data.py), the
    graphs are planned into size buckets (unified or bipartite slots), and
    each step assembles its DenseBatch on the device from a row of graph
    ids. plan_dense_epoch is the JAX package's, so for one (seed, epoch,
    superbatch) the port steps through the same batches in the same order:
    one optimizer step per live row of each [K, B] unit, where the JAX
    package scans the K rows in one dispatch.
  * flat (``batch_mode="flat"``): host-collated batches through the fused
    aggregate kernels, the JAX package's ``flat_aggregate="pallas"``.

The other flat engines, dense_chunk and meshes are not ported yet and
raise. Sums stay on the device across batches and steps, an epoch's graph
ids and noise masks are uploaded at once, and each epoch's train loss and
each RMSE cost one host sync.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..batching.dataset import BatchLoader
from ..batching.dense import plan_bipartite_buckets, plan_dense_buckets
from ..batching.device_data import DeviceDataset, assemble_dense, live_rows
from ..device import resolve_device
from ..models.igmc import arr_regularizer, draw_noise
from .checkpoints import checkpoint_path, load_checkpoint, load_optimizer_state


@dataclass
class TrainState:
    """The model and optimizer being trained, the last finished epoch, and
    per-epoch wall seconds with the host's share (flat: collation and
    planning; dense: the epoch plan)."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    epoch: int = 0
    history: List[dict] = field(default_factory=list)


def make_optimizer(params, lr: float, weight_decay: float = 0.0):
    """Adam, or AdamW when weight_decay > 0, as optax's adam / adamw
    (b1 0.9, b2 0.999, eps 1e-8 outside the square root; AdamW's decay
    lr * weight_decay * param on the pre-step parameter)."""
    opt = (torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
           if weight_decay > 0 else torch.optim.Adam(params, lr=lr))
    set_learning_rate(opt, lr)
    return opt


def set_learning_rate(optimizer, lr: float):
    """Set the learning rate between epochs, rounded to float32 as optax's
    injected hyperparameter is."""
    for group in optimizer.param_groups:
        group["lr"] = float(np.float32(lr))
    return optimizer


def get_learning_rate(optimizer) -> float:
    return optimizer.param_groups[0]["lr"]


def loss_fn(model, batch, noise, ARR: float):
    """Masked mean squared error over the batch's real graphs, plus
    ARR * arr_regularizer. Returns (loss, number of real graphs)."""
    preds = model(batch, noise)
    gmask = batch.graph_mask.float()
    n = gmask.sum().clamp_min(1.0)
    loss = (((preds - batch.y) ** 2) * gmask).sum() / n
    if ARR != 0.0:
        loss = loss + ARR * arr_regularizer(model)
    return loss, n


def make_train_step(model, optimizer, ARR: float = 0.0) -> Callable:
    """(batch, noise) -> (loss, n) as tensors on the batch's device, after
    one optimizer step on the loss's gradient."""

    def step(batch, noise):
        optimizer.zero_grad(set_to_none=True)
        loss, n = loss_fn(model, batch, noise, ARR)
        loss.backward()
        optimizer.step()
        return loss.detach(), n

    return step


class _Timed:
    """Iterates `loader`, adding the seconds spent producing its batches
    (host collation + planning) to `seconds`."""

    def __init__(self, loader):
        self.loader = loader
        self.seconds = 0.0

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.seconds += time.perf_counter() - t0
            if batch is None:
                return
            yield batch


def train_epoch(step_fn: Callable, loader, generator: torch.Generator,
                dataset_size: int, device) -> float:
    """One pass over the training data, one step per batch with noise from
    `generator` (draw_noise); returns sum(loss * n) / dataset_size. The sum
    stays on the device: the one float() at the end is the epoch's only
    host sync."""
    total = None
    for batch in loader:
        batch = batch.to(device)
        seed, keep = draw_noise(generator, batch.num_graphs)
        loss, n = step_fn(batch, (seed, keep.to(device)))
        total = loss * n if total is None else total + loss * n
    if total is None:
        return 0.0
    return float(total) / max(dataset_size, 1)


def _noise_generator(seed: int, epoch: int) -> torch.Generator:
    """The CPU generator of an epoch's training noise: a function of (seed,
    epoch) only, so a resumed run replays the noise of the epochs it runs."""
    ss = np.random.SeedSequence([seed, epoch, 1])
    return torch.Generator().manual_seed(int(ss.generate_state(1)[0]))


def make_eval_step(model: torch.nn.Module) -> Callable:
    """batch -> (squared-error sum, count, raw predictions), as tensors on
    the batch's device. `model` must be in eval mode."""

    @torch.no_grad()
    def step(batch):
        preds = model(batch)
        gmask = batch.graph_mask.float()
        sse = (((preds - batch.y) ** 2) * gmask).sum()
        return sse, gmask.sum(), preds

    return step


def eval_rmse(eval_fn: Callable, loader: BatchLoader, device) -> float:
    """RMSE over a loader; device-side accumulation, one host sync."""
    sse = cnt = None
    for batch in loader:
        s, c, _ = eval_fn(batch.to(device))
        sse = s if sse is None else sse + s
        cnt = c if cnt is None else cnt + c
    if sse is None:
        return 0.0
    return math.sqrt(float(sse) / max(float(cnt), 1.0))


def predict_all(eval_fn: Callable, loader: BatchLoader, device):
    """Raw predictions and targets of the real graphs, in loader order, as
    numpy arrays (fetched from the device once, at the end)."""
    preds, ys = [], []
    for batch in loader:
        batch = batch.to(device)
        _, _, p = eval_fn(batch)
        preds.append(p[batch.graph_mask])
        ys.append(batch.y[batch.graph_mask])
    if not preds:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    return torch.cat(preds).cpu().numpy(), torch.cat(ys).cpu().numpy()


def eval_rmse_ensemble(model: torch.nn.Module, checkpoints,
                       loader: BatchLoader, device) -> float:
    """Average raw predictions across checkpoints, then one RMSE. Each
    checkpoint is loaded into `model` in turn."""
    outs = []
    ys = None
    for ckpt in checkpoints:
        model.load_state_dict(load_checkpoint(ckpt))
        p, y = predict_all(make_eval_step(model), loader, device)
        outs.append(p)
        if ys is None:
            ys = y
    mean_pred = np.stack(outs, axis=1).mean(axis=1)
    return math.sqrt(float(np.mean((mean_pred - ys) ** 2)))


def plan_dense_epoch(buckets, batch_graphs: int, superbatch: int,
                     rng: Optional[np.random.Generator] = None):
    """Work units for one pass over dense buckets, as the JAX package plans
    them: a list of (bucket index, [K, B] int32 gid block), K =
    max(superbatch, 1), short blocks padded with -1 and each bucket's last
    unit with all-(-1) rows. With an rng, each bucket's graphs are shuffled
    and the units permuted; without one the order is fixed (evaluation)."""
    B = batch_graphs
    K = superbatch if superbatch > 1 else 1
    units = []
    for bi, bucket in enumerate(buckets):
        order = bucket.indices
        if rng is not None:
            order = rng.permutation(order)
        blocks = []
        for s in range(0, len(order), B):
            blk = order[s : s + B].astype(np.int32)
            if len(blk) < B:
                blk = np.concatenate([blk, np.full(B - len(blk), -1, np.int32)])
            blocks.append(blk)
        n_super = len(blocks) // K
        for i in range(n_super):
            units.append((bi, np.stack(blocks[i * K : (i + 1) * K])))
        rem = blocks[n_super * K:]
        if rem:
            rem = rem + [np.full(B, -1, np.int32)] * (K - len(rem))
            units.append((bi, np.stack(rem)))
    if rng is not None and len(units) > 1:
        units = [units[i] for i in rng.permutation(len(units))]
    return units


def plan_buckets(dataset, dense_layout: str, max_buckets: int = 3):
    """Dense size buckets of a static dataset: `dense_layout` 'unified'
    (plan_dense_buckets) or 'bipartite' (plan_bipartite_buckets)."""
    if dense_layout == "bipartite":
        nu = dataset.packed.num_u
        return plan_bipartite_buckets(nu, dataset.node_counts() - nu,
                                      dataset.edge_counts() // 2, max_buckets)
    if dense_layout == "unified":
        return plan_dense_buckets(dataset.node_counts(),
                                  dataset.edge_counts() // 2, max_buckets)
    raise ValueError(f"unknown dense_layout {dense_layout!r} (unified|bipartite)")


@dataclass
class DensePass:
    """One pass over a device-resident dataset: the live gid rows of a
    plan_dense_epoch plan in order, each row's bucket, and the rows as one
    [S, B] int64 tensor on the device (one upload per pass). All-(-1)
    padding rows, which trail their unit, are dropped."""
    buckets: list
    bucket_of: List[int]
    gids: torch.Tensor

    @classmethod
    def plan(cls, buckets, batch_graphs: int, superbatch: int, device,
             rng: Optional[np.random.Generator] = None) -> "DensePass":
        bucket_of, rows = [], [np.zeros((0, batch_graphs), np.int32)]
        for bi, blk in plan_dense_epoch(buckets, batch_graphs, superbatch, rng):
            live = live_rows(blk)
            bucket_of += [bi] * live
            rows.append(blk[:live])
        gids = torch.from_numpy(np.concatenate(rows).astype(np.int64))
        return cls(buckets, bucket_of, gids.to(device))

    def batches(self, dd: DeviceDataset):
        """The pass's DenseBatches, assembled on dd's device in order."""
        for i, bi in enumerate(self.bucket_of):
            b = self.buckets[bi]
            yield assemble_dense(dd, self.gids[i], b.node_slot, b.edge_slot,
                                 b.num_u_slot)


def dense_train_epoch(step_fn: Callable, dd: DeviceDataset, epoch: DensePass,
                      generator: torch.Generator, dataset_size: int) -> float:
    """One training pass, one step per live row with noise from
    `generator` (draw_noise, drawn for the whole pass first and uploaded
    at once); returns sum(loss * n) / dataset_size, one host sync."""
    noise = [draw_noise(generator, epoch.gids.shape[1]) for _ in epoch.bucket_of]
    if not noise:
        return 0.0
    keeps = torch.stack([keep for _, keep in noise]).to(dd.device)
    total = None
    for i, batch in enumerate(epoch.batches(dd)):
        loss, n = step_fn(batch, (noise[i][0], keeps[i]))
        total = loss * n if total is None else total + loss * n
    return float(total) / max(dataset_size, 1)


def dense_eval_rmse(eval_fn: Callable, dd: DeviceDataset, epoch: DensePass) -> float:
    """RMSE over a dense pass; device-side sums, one host sync."""
    sse = cnt = None
    for batch in epoch.batches(dd):
        s, c, _ = eval_fn(batch)
        sse = s if sse is None else sse + s
        cnt = c if cnt is None else cnt + c
    if sse is None:
        return 0.0
    return math.sqrt(float(sse) / max(float(cnt), 1.0))


def dense_predict_all(eval_fn: Callable, dd: DeviceDataset,
                      epoch: DensePass) -> np.ndarray:
    """Raw predictions in DATASET order from a dense pass, scattered back
    through each row's graph ids on the device and fetched once. Padding
    graphs write to a spare slot past the end."""
    G = len(dd)
    preds = torch.full((G + 1,), float("nan"), device=dd.device)
    for gids, batch in zip(epoch.gids, epoch.batches(dd)):
        _, _, p = eval_fn(batch)
        preds.index_copy_(0, torch.where(gids >= 0, gids, G), p)
    return preds[:G].cpu().numpy()


def _check_layout(batch_mode: str, flat_aggregate, dense_chunk: int, what: str):
    """Refuse an unknown batch_mode, and what is not ported: dense_chunk,
    and flat engines other than the fused aggregate (which None means)."""
    if batch_mode not in ("flat", "dense"):
        raise ValueError(f"unknown batch_mode {batch_mode!r} (flat|dense)")
    if dense_chunk:
        raise NotImplementedError(f"igmc_torch {what}: dense_chunk={dense_chunk} "
                                  f"is not ported")
    if batch_mode == "flat" and flat_aggregate not in (None, "pallas"):
        raise NotImplementedError(f"igmc_torch {what}: the flat layout runs the "
                                  f"fused aggregate (flat_aggregate='pallas') "
                                  f"only, not {flat_aggregate!r}")


def test_once(
    test_dataset,
    model: torch.nn.Module,
    batch_size: int,
    params: Optional[dict] = None,
    logger: Optional[Callable] = None,
    ensemble: bool = False,
    checkpoints=None,
    batch_mode: str = "flat",
    flat_aggregate: Optional[str] = None,
    dense_chunk: int = 0,
    dense_layout: str = "unified",
    device="cuda",
):
    """Evaluate once — `model` (or the state_dict `params` loaded into a
    copy of it), or with `ensemble` the prediction mean of `checkpoints`
    (`.pth` paths). Prints and returns the RMSE.

    `batch_mode` 'dense' evaluates on the device-resident dense layout
    (`dense_layout` 'unified' or 'bipartite', 3 size buckets), unless a
    `flat_aggregate` engine is named, which keeps the flat layout (and
    says so), as the JAX package does. The flat layout runs the fused
    aggregate. Runs on `device` (default "cuda"; raises without a CUDA
    device unless device="cpu"). The caller's model is not modified."""
    if batch_mode == "dense" and flat_aggregate is not None:
        print("test_once: dense eval unavailable — flat_aggregate overrides "
              "the layout; using the flat path")
        batch_mode = "flat"
    _check_layout(batch_mode, flat_aggregate, dense_chunk, "evaluation")
    dev = resolve_device(device)
    model = copy.deepcopy(model).to(dev).eval()
    if batch_mode == "dense":
        dd = DeviceDataset(test_dataset.packed, dev)
        epoch = DensePass.plan(plan_buckets(test_dataset, dense_layout),
                               batch_size, 8, dev)
        rmse_of = lambda m: dense_eval_rmse(make_eval_step(m), dd, epoch)
        preds_of = lambda m: dense_predict_all(make_eval_step(m), dd, epoch)
        ys = np.asarray(test_dataset.packed.y, np.float32)
    else:
        loader = BatchLoader(test_dataset, batch_size)
        rmse_of = lambda m: eval_rmse(make_eval_step(m), loader, dev)
    t_start = time.perf_counter()
    if ensemble and checkpoints:
        if batch_mode == "dense":
            outs = []
            for ckpt in checkpoints:
                model.load_state_dict(load_checkpoint(ckpt))
                outs.append(preds_of(model))
            mean_pred = np.stack(outs, axis=1).mean(axis=1)
            rmse = math.sqrt(float(np.mean((mean_pred - ys) ** 2)))
        else:
            rmse = eval_rmse_ensemble(model, checkpoints, loader, dev)
    else:
        if params is not None:
            model.load_state_dict(params)
        rmse = rmse_of(model)
    duration = time.perf_counter() - t_start
    print("Test Once RMSE: {:.6f}, Duration: {:.6f}".format(rmse, duration))
    if logger is not None:
        epoch_info = "test_once" if not ensemble else "ensemble"
        logger({"epoch": epoch_info, "train_loss": 0, "test_rmse": rmse}, None)
    return rmse


def train_multiple_epochs(
    train_dataset,
    test_dataset,
    model: torch.nn.Module,
    epochs: int,
    batch_size: int,
    lr: float,
    lr_decay_factor: float,
    lr_decay_step_size: int,
    weight_decay: float = 0.0,
    ARR: float = 0.0,
    test_freq: int = 1,
    logger: Optional[Callable] = None,
    continue_from: Optional[int] = None,
    res_dir: Optional[str] = None,
    seed: int = 1,
    superbatch: int = 8,
    mesh=None,
    batch_mode: str = "flat",
    dense_buckets: int = 3,
    flat_aggregate: Optional[str] = None,
    dense_chunk: int = 0,
    dense_layout: str = "unified",
    device="cuda",
):
    """Full training run of a copy of `model` (the caller's is not
    modified); returns (final test RMSE, TrainState).

    Per epoch: shuffle under the absolute epoch number
    (SeedSequence([seed, epoch])), one optimizer step per batch with fresh
    edge and feature dropout noise, the test RMSE every `test_freq` epochs
    (NaN otherwise), the learning rate times `lr_decay_factor` after every
    `lr_decay_step_size`-th epoch, then `logger(info, state)`.
    `continue_from` E reloads `model_checkpoint{E}.pth` and
    `optimizer_checkpoint{E}.pth` from `res_dir` and runs epochs E+1 to
    `epochs`.

    `batch_mode` 'dense' trains on the device-resident dense layout
    (`dense_layout` 'unified' or 'bipartite', at most `dense_buckets` size
    buckets, the epoch planned in [superbatch, batch_size] units); 'flat'
    on host-collated flat batches through the fused aggregate kernels
    (superbatch does not apply, as in the JAX package). Runs on `device`
    (default "cuda"; raises without a CUDA device unless device="cpu").
    dense_chunk, meshes and the other flat engines raise
    NotImplementedError."""
    _check_layout(batch_mode, flat_aggregate, dense_chunk, "training")
    if batch_mode == "dense" and flat_aggregate is not None:
        raise ValueError("flat_aggregate applies to batch_mode='flat'")
    if mesh is not None:
        raise NotImplementedError("igmc_torch training: mesh is not ported")
    dev = resolve_device(device)
    model = copy.deepcopy(model).to(dev)
    optimizer = make_optimizer(model.parameters(), lr, weight_decay)
    state = TrainState(model=model, optimizer=optimizer)
    step_fn = make_train_step(model, optimizer, ARR)
    eval_fn = make_eval_step(model)
    dense = batch_mode == "dense"
    if dense:
        K = max(superbatch, 1)
        dd_train = DeviceDataset(train_dataset.packed, dev)
        dd_test = DeviceDataset(test_dataset.packed, dev)
        tr_buckets = plan_buckets(train_dataset, dense_layout, dense_buckets)
        test_pass = DensePass.plan(
            plan_buckets(test_dataset, dense_layout, dense_buckets),
            batch_size, K, dev)
    else:
        train_loader = BatchLoader(train_dataset, batch_size, shuffle=True, seed=seed)
        test_loader = BatchLoader(test_dataset, batch_size)

    start_epoch = 1
    if continue_from is not None:
        model.load_state_dict(load_checkpoint(
            checkpoint_path(res_dir, "model", continue_from)))
        optimizer.load_state_dict(load_optimizer_state(
            checkpoint_path(res_dir, "optimizer", continue_from)))
        start_epoch = continue_from + 1
        epochs -= continue_from

    rmses = []
    t_start = time.perf_counter()
    for epoch in range(start_epoch, epochs + start_epoch):
        t_epoch = time.perf_counter()
        noise_gen = _noise_generator(seed, epoch)
        model.train()
        if dense:
            # the JAX package's epoch rng: the same buckets' permutations
            # and unit order for a given (seed, epoch)
            rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
            train_pass = DensePass.plan(tr_buckets, batch_size, K, dev, rng)
            host_seconds = time.perf_counter() - t_epoch
            train_loss = dense_train_epoch(step_fn, dd_train, train_pass,
                                           noise_gen, len(train_dataset))
        else:
            # shuffle under the ABSOLUTE epoch number, so a resumed run
            # replays the orders the uninterrupted run would have used
            train_loader.epoch = epoch
            timed_train, timed_test = _Timed(train_loader), _Timed(test_loader)
            train_loss = train_epoch(step_fn, timed_train, noise_gen,
                                     len(train_dataset), dev)
        model.eval()
        if epoch % test_freq != 0:
            rmses.append(float("nan"))
        elif dense:
            rmses.append(dense_eval_rmse(eval_fn, dd_test, test_pass))
        else:
            rmses.append(eval_rmse(eval_fn, timed_test, dev))
        if not dense:
            host_seconds = timed_train.seconds + timed_test.seconds
        state.epoch = epoch
        state.history.append({
            "epoch": epoch, "seconds": time.perf_counter() - t_epoch,
            "host_seconds": host_seconds})

        info = {"epoch": epoch, "train_loss": train_loss, "test_rmse": rmses[-1]}
        print("Epoch {}, train loss {:.6f}, test rmse {:.6f}".format(*info.values()))
        # manual step decay, as the PyTorch reference's train_eval.py does
        if epoch % lr_decay_step_size == 0:
            set_learning_rate(optimizer,
                              lr_decay_factor * get_learning_rate(optimizer))
        if logger is not None:
            logger(info, state)

    duration = time.perf_counter() - t_start
    print("Final Test RMSE: {:.6f}, Duration: {:.6f}".format(rmses[-1], duration))
    return rmses[-1], state
