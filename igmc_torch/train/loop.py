"""Training and evaluation: masked MSE + ARR, Adam with step LR decay,
RMSE of one model or of a checkpoint ensemble.

Port of igmc_tpu/train/loop.py on the flat layout with the fused aggregate
kernels — the JAX package's ``train_multiple_epochs(...,
flat_aggregate="pallas")`` on one device and ``test_once(...,
flat_aggregate="pallas")``, which its CLI runs for ``--ensemble`` and
``--transfer``. The other engines, the dense layout, superbatches and
meshes are not ported yet and raise.

Sums stay on the device across batches and steps; each epoch's train loss
and each RMSE cost one host sync.
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
from ..device import resolve_device
from ..models.igmc import arr_regularizer, draw_noise
from .checkpoints import checkpoint_path, load_checkpoint, load_optimizer_state


@dataclass
class TrainState:
    """The model and optimizer being trained, the last finished epoch, and
    per-epoch wall seconds with the host's share (collation + planning)."""
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


def test_once(
    test_dataset,
    model: torch.nn.Module,
    batch_size: int,
    params: Optional[dict] = None,
    logger: Optional[Callable] = None,
    ensemble: bool = False,
    checkpoints=None,
    flat_aggregate: str = "pallas",
    device="cuda",
):
    """Evaluate once — `model` (or the state_dict `params` loaded into a
    copy of it), or with `ensemble` the prediction mean of `checkpoints`
    (`.pth` paths). Prints and returns the RMSE.

    Runs on `device` (default "cuda"; raises without a CUDA device unless
    device="cpu"). Only the flat layout with the fused aggregate
    (`flat_aggregate="pallas"`) is ported. The caller's model is not
    modified."""
    if flat_aggregate != "pallas":
        raise NotImplementedError(
            f"igmc_torch evaluates with flat_aggregate='pallas' only, not "
            f"{flat_aggregate!r}")
    dev = resolve_device(device)
    model = copy.deepcopy(model).to(dev).eval()
    loader = BatchLoader(test_dataset, batch_size)
    t_start = time.perf_counter()
    if ensemble and checkpoints:
        rmse = eval_rmse_ensemble(model, checkpoints, loader, dev)
    else:
        if params is not None:
            model.load_state_dict(params)
        rmse = eval_rmse(make_eval_step(model), loader, dev)
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
    superbatch: int = 0,
    mesh=None,
    batch_mode: str = "flat",
    flat_aggregate: str = "pallas",
    dense_chunk: int = 0,
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

    Runs on `device` (default "cuda"; raises without a CUDA device unless
    device="cpu"). Only the flat layout with the fused aggregate on one
    device is ported; the rest raises NotImplementedError."""
    if flat_aggregate != "pallas":
        raise NotImplementedError(f"igmc_torch trains with flat_aggregate="
                                  f"'pallas' only, not {flat_aggregate!r}")
    for name, value, default in (("batch_mode", batch_mode, "flat"),
                                 ("mesh", mesh, None),
                                 ("dense_chunk", dense_chunk, 0)):
        if value != default:
            raise NotImplementedError(f"igmc_torch training: {name}={value!r} "
                                      f"is not ported")
    if superbatch > 1:
        raise NotImplementedError("igmc_torch training: superbatch > 1 is not "
                                  "ported (the pallas path runs one step per "
                                  "batch)")
    dev = resolve_device(device)
    model = copy.deepcopy(model).to(dev)
    optimizer = make_optimizer(model.parameters(), lr, weight_decay)
    state = TrainState(model=model, optimizer=optimizer)
    train_loader = BatchLoader(train_dataset, batch_size, shuffle=True, seed=seed)
    test_loader = BatchLoader(test_dataset, batch_size)
    step_fn = make_train_step(model, optimizer, ARR)
    eval_fn = make_eval_step(model)

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
        # shuffle under the ABSOLUTE epoch number, so a resumed run replays
        # the orders the uninterrupted run would have used
        train_loader.epoch = epoch
        timed_train, timed_test = _Timed(train_loader), _Timed(test_loader)
        model.train()
        train_loss = train_epoch(step_fn, timed_train,
                                 _noise_generator(seed, epoch),
                                 len(train_dataset), dev)
        model.eval()
        if epoch % test_freq == 0:
            rmses.append(eval_rmse(eval_fn, timed_test, dev))
        else:
            rmses.append(float("nan"))
        state.epoch = epoch
        state.history.append({
            "epoch": epoch, "seconds": time.perf_counter() - t_epoch,
            "host_seconds": timed_train.seconds + timed_test.seconds})

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
