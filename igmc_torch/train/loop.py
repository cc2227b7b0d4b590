"""Evaluation: RMSE of one model or of a checkpoint ensemble.

Port of the evaluation half of igmc_tpu/train/loop.py (make_eval_step,
eval_rmse, predict_all, eval_rmse_ensemble, test_once) on the flat layout
with the fused aggregate kernel — the JAX package's
``test_once(..., flat_aggregate="pallas")``, which its CLI runs for
``--ensemble`` and ``--transfer``. Training is not ported yet.

Sums stay on the device across batches; each RMSE costs one host sync.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..batching.dataset import BatchLoader
from ..device import resolve_device
from .checkpoints import load_checkpoint


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
