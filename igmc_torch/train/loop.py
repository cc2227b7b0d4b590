"""Training and evaluation: masked MSE + ARR, Adam with step LR decay,
RMSE of one model or of a checkpoint ensemble.

Port of igmc_tpu/train/loop.py for every model family (IGMC, GNN, DGCNN,
DGCNN_RS: `model(batch, noise)` -> [B] predictions, ARR over its R-GCN
layers). train_multiple_epochs and test_once pick one of two paths once
(_choose_path) from the layout (`batch_mode`), the flat engine
(`flat_aggregate`, as batching/batch.py flat_engine reads it), the data
(packed arrays or not), `superbatch` and `mesh`; train_multiple_epochs_ep
and test_once_ep run the third. Every path runs one epoch loop
(_run_epochs) and one evaluation tail (_evaluate):

  * device-resident (_ResidentPath): the packed datasets live on the
    device (batching/device_data.py) and each step assembles its batch
    there from a row of graph ids, one optimizer step per live row of
    each [K, B] unit (the JAX package scans the K rows in one dispatch).
    The dense layout (the JAX CLI's default for static data) plans the
    graphs into size buckets (unified or bipartite slots) with the JAX
    package's plan_dense_epoch, so for one (seed, epoch, superbatch) the
    port steps through the same batches in the same order; `dense_chunk`
    N streams each row in N-graph slices into one optimizer step (giant
    batches) and evaluates in N-graph rows. The flat segment engine runs
    here on packed data with superbatch > 1: the JAX package's
    plan_gid_epoch of SeedSequence([seed, epoch])'s permutation.
  * host-collated (_HostPath): BatchLoader extracts, collates and plans
    on its prefetch threads, one step per batch (the JAX package scans a
    superbatch of them, padded to the ladder maximum): dynamic data on
    the dense layout (unified slot batches), the flat segment engine on
    dynamic data or with superbatch <= 1, and the blocked and pallas
    engines (IGMC only) over their host-built plans.
  * edge-partitioned (_EdgePartitionedPath, parallel/ep.py): every batch
    is one giant disjoint batch-graph split over the mesh's ranks.
On the flat layout the model copy's cfg.flat_aggregate is set to the
engine the path runs (models/igmc.py set_flat_engine).

Several devices (`mesh`, parallel/mesh.py: one process per device over
torch.distributed; the JAX package's mesh branches): the dense layout runs
data-parallel device-resident (rank r assembles columns [r * B/D,
(r + 1) * B/D) of each gid row) or host-collated for dynamic data, the
flat layout host-collated on the segment engine (BatchLoader(n_devices=D,
rank=r)). The gradients are summed with one all_reduce per step
(parallel/dp.py); a rank takes its rows of the whole batch's noise, so a
DP step is the single-device step on the whole batch, dropout included.
Rank 0 alone prints, calls `logger` and so writes checkpoints; every rank
waits at a barrier before loading one and after the last epoch.

Sums stay on the device across batches and steps, an epoch's graph ids and
noise masks are uploaded at once (device-resident datasets), and each
epoch's train loss and each RMSE cost one host sync.
"""

from __future__ import annotations

import copy
import itertools
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..batching.batch import GraphBatch, planned_engine
from ..batching.dataset import BatchLoader
from ..batching.dense import plan_bipartite_buckets, plan_dense_buckets
from ..batching.device_data import (DeviceDataset, assemble_batch, assemble_dense,
                                   capacity_bound, live_rows, plan_gid_epoch)
from ..device import resolve_device
from ..models.igmc import arr_regularizer, draw_noise, set_flat_engine, slice_noise
from ..parallel.dp import make_dp_train_step, rank_columns, rank_noise
from ..utils import spans
from ..utils.progress import Heartbeat
from . import graphed
from .checkpoints import load_checkpoint, load_optimizer_state, resolve_checkpoint


@dataclass
class TrainState:
    """The model and optimizer being trained, the last finished epoch, and
    per-epoch wall seconds with the host's share (host-collated batches:
    the time spent waiting for them; device-resident: the epoch plan)."""
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
    one optimizer step on the loss's gradient. Spans train.forward (the
    loss), train.backward and train.optimizer (`optimizer.step()`; the
    `zero_grad` before the forward is in no span).

    An IGMC on the fused aggregate with its parameters on a card takes the
    graphed step (train/graphed.py): one CUDA graph per input shape, this
    eager step for each shape's first batch and for any other batch."""

    def step(batch, noise):
        optimizer.zero_grad(set_to_none=True)
        with spans.span("train.forward"):
            loss, n = loss_fn(model, batch, noise, ARR)
        with spans.span("train.backward"):
            loss.backward()
        with spans.span("train.optimizer"):
            optimizer.step()
        return loss.detach(), n

    if graphed.applies(model):
        return graphed.GraphedStep(model, optimizer, ARR, step, loss_fn)
    return step


def make_dense_row_step(model, optimizer, chunk: int = 0,
                        ARR: float = 0.0) -> Callable:
    """(assemble, gids, noise) -> (loss, n): one optimizer step on a dense
    row of graph ids `gids` [B], whose DenseBatch `assemble(gids)` builds.
    With `chunk` (0 < chunk < B) the row streams in slices
    (make_chunked_dense_train_step), else it is assembled whole
    (make_train_step)."""
    if chunk:
        return make_chunked_dense_train_step(model, optimizer, chunk, ARR)
    whole = make_train_step(model, optimizer, ARR)
    return lambda assemble, gids, noise: whole(assemble(gids), noise)


def make_dp_row_step(model, optimizer, mesh, ARR: float = 0.0) -> Callable:
    """make_dense_row_step's data-parallel form: (assemble, gids, noise)
    -> (loss, n) with `gids` and `noise` the whole row's; this rank
    assembles and runs its columns (rank_columns), the row's graph count
    is read off `gids`, and the gradients are summed over the ranks
    (make_dp_train_step)."""
    step = make_dp_train_step(model, optimizer, mesh, ARR)

    def row_step(assemble, gids, noise):
        cols = rank_columns(mesh, gids.shape[0])
        return step(assemble(gids[cols]), slice_noise(noise, cols.start, cols.stop),
                    n=(gids >= 0).sum().float())

    return row_step


def make_chunked_dense_train_step(model, optimizer, chunk: int,
                                  ARR: float = 0.0) -> Callable:
    """(assemble, gids, noise) -> (loss, n) for a giant-batch row: the row's
    graph ids `gids` [B] are cut into B / chunk slices; each slice is
    assembled (`assemble(gids_slice)` -> DenseBatch), run forward and
    backward with loss sse_slice / n_row, and freed before the next, the
    gradients accumulating; ARR's gradient is added once; then one
    optimizer step. The slices get their rows of feature_keep and the row's
    edge seed (slice_noise), so the step equals make_train_step's on the
    whole row, dropout included. Spans as make_train_step's, forward and
    backward once per slice and once more for the ARR term."""

    def step(assemble, gids, noise):
        optimizer.zero_grad(set_to_none=True)
        n = (gids >= 0).sum().float().clamp_min(1.0)
        sse = torch.zeros((), device=gids.device)
        for s in range(0, gids.shape[0], chunk):
            batch = assemble(gids[s:s + chunk])
            with spans.span("train.forward"):
                preds = model(batch, slice_noise(noise, s, s + chunk))
                part = (((preds - batch.y) ** 2) * batch.graph_mask.float()).sum()
            with spans.span("train.backward"):
                (part / n).backward()
            sse = sse + part.detach()
            del batch, preds, part
        loss = sse / n
        with spans.span("train.forward"):
            reg = ARR * arr_regularizer(model) if ARR != 0.0 else 0.0
        if torch.is_tensor(reg):        # GCN-only families carry no ARR term
            with spans.span("train.backward"):
                reg.backward()
            loss = loss + reg.detach()
        with spans.span("train.optimizer"):
            optimizer.step()
        return loss, n

    return step


class _Timed:
    """Iterates `loader`, adding the seconds the consumer waits for its
    batches (host extraction, collation and planning not hidden behind
    the steps) to `seconds`."""

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
                dataset_size: int, device, mesh=None) -> float:
    """One pass over the training data, one step per batch with noise from
    `generator` (draw_noise); returns sum(loss * n) / dataset_size. The sum
    stays on the device: the one float() at the end is the epoch's only
    host sync. With a `mesh` the loader yields this rank's sub-batches: the
    whole batch's noise is drawn and the rank takes its rows
    (rank_noise).

    Step i's spans (group i): train.fetch (waiting for the loader's
    batch), train.inputs (its upload and noise), then the step's own;
    counters train.steps, and batch.edges and batch.edge_slots (the host
    batch's real edges and edge slots)."""
    total = None
    D = 1 if mesh is None else mesh.size
    batches = iter(loader)
    for i in itertools.count():
        spans.set_group(i)
        with spans.span("train.fetch"):
            batch = next(batches, None)
        if batch is None:
            break
        with spans.span("train.inputs"):
            if spans.on:        # one thread: no torch reduction on the host
                spans.count("batch.edges", int(np.count_nonzero(batch.edge_mask.numpy())))
                spans.count("batch.edge_slots", batch.edge_mask.numel())
            batch = batch.to(device, non_blocking=True)
            noise = draw_noise(generator, batch.num_graphs * D)
            if mesh is not None:
                noise = rank_noise(mesh, noise, batch.num_graphs * D)
            noise = (noise[0], noise[1].to(device))
        loss, n = step_fn(batch, noise)
        spans.count("train.steps")
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


def _rmse(sse, cnt, mesh=None) -> float:
    """sqrt(sse / cnt) of device sums (0.0 for none); with a `mesh` the
    ranks' sums are all-reduced first."""
    if sse is None:
        return 0.0
    if mesh is not None:
        sse, cnt = mesh.all_reduce(torch.stack([sse, cnt]))
    return math.sqrt(float(sse) / max(float(cnt), 1.0))


def eval_rmse(eval_fn: Callable, loader: BatchLoader, device, mesh=None) -> float:
    """RMSE over a loader; device-side accumulation, one host sync (with a
    `mesh`, over every rank's sub-batches: one all_reduce at the end)."""
    sse = cnt = None
    for batch in loader:
        s, c, _ = eval_fn(batch.to(device, non_blocking=True))
        sse = s if sse is None else sse + s
        cnt = c if cnt is None else cnt + c
    return _rmse(sse, cnt, mesh)


def predict_all(eval_fn: Callable, loader: BatchLoader, device):
    """Raw predictions and targets of the real graphs, in loader order, as
    numpy arrays (fetched from the device once, at the end)."""
    preds, ys = [], []
    for batch in loader:
        batch = batch.to(device, non_blocking=True)
        _, _, p = eval_fn(batch)
        preds.append(p[batch.graph_mask])
        ys.append(batch.y[batch.graph_mask])
    if not preds:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    return torch.cat(preds).cpu().numpy(), torch.cat(ys).cpu().numpy()


def plan_dense_epoch(buckets, batch_graphs: int, superbatch: int,
                     rng: Optional[np.random.Generator] = None):
    """Work units for one pass over dense buckets, as the JAX package plans
    them: a list of (bucket index, [K, B] int32 gid block), K =
    max(superbatch, 1), short blocks padded with -1 and each bucket's last
    unit with all-(-1) rows. With an rng, each bucket's graphs are shuffled
    and the units permuted; without one the order is fixed (evaluation)."""
    units = []
    for bi, bucket in enumerate(buckets):
        order = bucket.indices
        if rng is not None:
            order = rng.permutation(order)
        units += [(bi, blk) for blk in plan_gid_epoch(order, batch_graphs, superbatch)]
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
    padding rows, which trail their unit, are dropped.

    `rel_caps` (plan_rel_caps over the dataset's graphs; the dataset built
    with DeviceDataset(rel_sort=R)) assembles every bucket's rows on the
    relation-slotted edge axis of sum(rel_caps) slots."""
    buckets: list
    bucket_of: List[int]
    gids: torch.Tensor

    @classmethod
    @spans.spanned("pass.plan")
    def plan(cls, buckets, batch_graphs: int, superbatch: int, device,
             rng: Optional[np.random.Generator] = None) -> "DensePass":
        bucket_of, rows = [], [np.zeros((0, batch_graphs), np.int32)]
        for bi, blk in plan_dense_epoch(buckets, batch_graphs, superbatch, rng):
            live = live_rows(blk)
            bucket_of += [bi] * live
            rows.append(blk[:live])
        gids = torch.from_numpy(np.concatenate(rows).astype(np.int64))
        return cls(buckets, bucket_of, gids.to(device))

    @spans.spanned("pass.assemble")
    def assemble(self, dd: DeviceDataset, bucket: int, gids: torch.Tensor,
                 rel_caps: Optional[tuple] = None):
        """The DenseBatch of graph ids `gids` in bucket `bucket`'s slots."""
        b = self.buckets[bucket]
        edge_slot = b.edge_slot if rel_caps is None else sum(rel_caps)
        return assemble_dense(dd, gids, b.node_slot, edge_slot, b.num_u_slot,
                              rel_caps)

    def batches(self, dd: DeviceDataset, rel_caps: Optional[tuple] = None,
                cols: slice = slice(None)):
        """The pass's DenseBatches, assembled on dd's device in order (of
        each row's graphs `cols` only)."""
        for i, bi in enumerate(self.bucket_of):
            yield self.assemble(dd, bi, self.gids[i][cols], rel_caps)


@dataclass
class FlatPass:
    """One pass over a device-resident dataset on the flat layout: the live
    gid rows of plan_gid_epoch in order as one [S, B] int64 tensor on the
    device, and the pads every row's GraphBatch is assembled in. It has
    DensePass's interface (one bucket), so dense_train_epoch,
    dense_eval_rmse and dense_predict_all take it."""
    node_pad: int
    edge_pad: int
    gids: torch.Tensor

    @classmethod
    @spans.spanned("pass.plan")
    def plan(cls, dataset, batch_graphs: int, superbatch: int, device,
             order: Optional[np.ndarray] = None) -> "FlatPass":
        """The pass over `dataset` (node_counts / edge_counts) in `order`
        (default: dataset order), pads from capacity_bound."""
        node_pad, edge_pad = capacity_bound(dataset.node_counts(),
                                            dataset.edge_counts(), batch_graphs)
        if order is None:
            order = np.arange(len(dataset), dtype=np.int64)
        rows = [np.zeros((0, batch_graphs), np.int32)]
        rows += [blk[:live_rows(blk)]
                 for blk in plan_gid_epoch(order, batch_graphs, superbatch)]
        gids = torch.from_numpy(np.concatenate(rows).astype(np.int64))
        return cls(node_pad, edge_pad, gids.to(device))

    @property
    def bucket_of(self) -> List[int]:
        return [0] * self.gids.shape[0]

    @spans.spanned("pass.assemble")
    def assemble(self, dd: DeviceDataset, bucket: int, gids: torch.Tensor,
                 rel_caps: Optional[tuple] = None) -> GraphBatch:
        """The GraphBatch of graph ids `gids` (`bucket` and `rel_caps` are
        DensePass's, unused)."""
        return assemble_batch(dd, gids, self.node_pad, self.edge_pad)

    def batches(self, dd: DeviceDataset, rel_caps: Optional[tuple] = None,
                cols: slice = slice(None)):
        for gids in self.gids:
            yield self.assemble(dd, 0, gids[cols])


def dense_train_epoch(step_fn: Callable, dd: DeviceDataset, epoch: DensePass,
                      generator: torch.Generator, dataset_size: int,
                      rel_caps: Optional[tuple] = None) -> float:
    """One training pass over a DensePass or FlatPass, one
    make_dense_row_step per live row with noise
    from `generator` (draw_noise, drawn for the whole pass first and
    uploaded at once); returns sum(loss * n) / dataset_size, one host
    sync. Spans: train.inputs (the pass's noise, group -1), then step i's
    own (group i); counter train.steps."""
    spans.set_group(-1)
    with spans.span("train.inputs"):
        noise = [draw_noise(generator, epoch.gids.shape[1]) for _ in epoch.bucket_of]
        if not noise:
            return 0.0
        keeps = torch.stack([keep for _, keep in noise]).to(dd.device)
    total = None
    for i, bi in enumerate(epoch.bucket_of):
        spans.set_group(i)
        assemble = lambda gids: epoch.assemble(dd, bi, gids, rel_caps)
        loss, n = step_fn(assemble, epoch.gids[i], (noise[i][0], keeps[i]))
        spans.count("train.steps")
        total = loss * n if total is None else total + loss * n
    return float(total) / max(dataset_size, 1)


def dense_eval_rmse(eval_fn: Callable, dd: DeviceDataset, epoch: DensePass,
                    rel_caps: Optional[tuple] = None, mesh=None) -> float:
    """RMSE over a DensePass or FlatPass; device-side sums, one host sync.
    With a `mesh` each rank evaluates its columns of every row and the sums
    are all-reduced once."""
    cols = slice(None) if mesh is None else rank_columns(mesh, epoch.gids.shape[1])
    sse = cnt = None
    for batch in epoch.batches(dd, rel_caps, cols):
        s, c, _ = eval_fn(batch)
        sse = s if sse is None else sse + s
        cnt = c if cnt is None else cnt + c
    return _rmse(sse, cnt, mesh)


def dense_predict_all(eval_fn: Callable, dd: DeviceDataset, epoch: DensePass,
                      rel_caps: Optional[tuple] = None) -> np.ndarray:
    """Raw predictions in DATASET order from a DensePass or FlatPass, scattered back
    through each row's graph ids on the device and fetched once. Padding
    graphs write to a spare slot past the end."""
    G = len(dd)
    preds = torch.full((G + 1,), float("nan"), device=dd.device)
    for gids, batch in zip(epoch.gids, epoch.batches(dd, rel_caps)):
        _, _, p = eval_fn(batch)
        preds.index_copy_(0, torch.where(gids >= 0, gids, G), p)
    return preds[:G].cpu().numpy()


def _ensemble_rmse(model: torch.nn.Module, checkpoints, predict: Callable) -> float:
    """RMSE of the mean raw prediction over `checkpoints`, each loaded
    into `model` in turn; `predict(model)` -> (predictions, targets) in
    one fixed order."""
    outs = []
    for ckpt in checkpoints:
        model.load_state_dict(load_checkpoint(ckpt))
        preds, ys = predict(model)
        outs.append(preds)
    mean_pred = np.stack(outs, axis=1).mean(axis=1)
    return math.sqrt(float(np.mean((mean_pred - ys) ** 2)))


def eval_rmse_ensemble(model: torch.nn.Module, checkpoints,
                       loader: BatchLoader, device) -> float:
    """Average raw predictions across checkpoints, then one RMSE. Each
    checkpoint is loaded into `model` in turn."""
    return _ensemble_rmse(model, checkpoints,
                          lambda m: predict_all(make_eval_step(m), loader, device))


class _ResidentPath:
    """Device-resident datasets: each training epoch a DensePass over the
    training set's size buckets (`dense` = (dense_layout, max buckets)) or,
    on the flat layout (`dense` None), a FlatPass, planned from the JAX
    package's epoch rng; the test set's pass planned once."""

    def __init__(self, train_dataset, test_dataset, batch_size: int, superbatch: int,
                 dense_chunk: int, dense, dev, mesh, seed: int):
        self.train_dataset, self.test_dataset = train_dataset, test_dataset
        self.dev, self.mesh, self.seed, self.chunk = dev, mesh, seed, dense_chunk
        K = max(superbatch, 1)
        if train_dataset is not None:
            self.dd_train = DeviceDataset(train_dataset.packed, dev)
        self.dd_test = DeviceDataset(test_dataset.packed, dev)
        if dense is None:
            self.test_pass = FlatPass.plan(test_dataset, batch_size, K, dev)
            self._plan = lambda rng: FlatPass.plan(
                train_dataset, batch_size, K, dev,
                rng.permutation(len(train_dataset)).astype(np.int64))
        else:
            buckets = (None if train_dataset is None
                       else plan_buckets(train_dataset, *dense))
            self.test_pass = DensePass.plan(plan_buckets(test_dataset, *dense),
                                            dense_chunk or batch_size, K, dev)
            self._plan = lambda rng: DensePass.plan(buckets, batch_size, K, dev, rng)

    def step(self, model, optimizer, ARR: float) -> Callable:
        if self.mesh is not None:
            return make_dp_row_step(model, optimizer, self.mesh, ARR)
        return make_dense_row_step(model, optimizer, self.chunk, ARR)

    def train(self, step_fn: Callable, epoch: int):
        """(train loss, seconds of the epoch's plan)."""
        t0 = time.perf_counter()
        # the JAX package's epoch rng: the same buckets' permutations and
        # unit order for a given (seed, epoch)
        epoch_pass = self._plan(np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])))
        host_seconds = time.perf_counter() - t0
        return dense_train_epoch(step_fn, self.dd_train, epoch_pass,
                                 _noise_generator(self.seed, epoch),
                                 len(self.train_dataset)), host_seconds

    def rmse(self, model):
        return dense_eval_rmse(make_eval_step(model), self.dd_test, self.test_pass,
                               mesh=self.mesh), 0.0

    def predict(self, model):
        return (dense_predict_all(make_eval_step(model), self.dd_test, self.test_pass),
                np.asarray(self.test_dataset.packed.y, np.float32))

    def suffix(self) -> str:
        return ""


class _HostPath:
    """Host-collated batches: a shuffled training BatchLoader and an
    ordered test one, both with `loader_kw`; the seconds spent waiting for
    their batches are the host's share."""

    def __init__(self, train_dataset, test_dataset, batch_size: int, loader_kw: dict,
                 dev, mesh, seed: int):
        self.dev, self.mesh, self.seed = dev, mesh, seed
        if train_dataset is not None:
            self.train_loader = BatchLoader(train_dataset, batch_size, shuffle=True,
                                            seed=seed, **loader_kw)
        self.test_loader = BatchLoader(test_dataset, batch_size, **loader_kw)

    def step(self, model, optimizer, ARR: float) -> Callable:
        if self.mesh is not None:
            return make_dp_train_step(model, optimizer, self.mesh, ARR)
        return make_train_step(model, optimizer, ARR)

    def train(self, step_fn: Callable, epoch: int):
        """(train loss, seconds waited for the training batches)."""
        # shuffle under the ABSOLUTE epoch number, so a resumed run
        # replays the orders the uninterrupted run would have used
        self.train_loader.epoch = epoch
        timed = _Timed(self.train_loader)
        return train_epoch(step_fn, timed, _noise_generator(self.seed, epoch),
                           len(self.train_loader.dataset), self.dev,
                           self.mesh), timed.seconds

    def rmse(self, model):
        timed = _Timed(self.test_loader)
        return eval_rmse(make_eval_step(model), timed, self.dev, self.mesh), timed.seconds

    def predict(self, model):
        return predict_all(make_eval_step(model), self.test_loader, self.dev)

    def suffix(self) -> str:
        n = self.train_loader.ladder_overflows
        return f" [ladder overflows: {n}]" if n else ""


def _ep_shards(dataset, batch_size: int, mesh, local_aggregate: str):
    """(shards, blocked plans or None, gid chunks) of a dataset's EP giant
    batches on this rank (build_ep_batches; with local_aggregate 'blocked'
    the blocked plans, aligned to one block-count shape)."""
    from ..parallel.ep import (build_ep_batches, build_ep_blocked, ep_shard,
                               max_ep_blocked_blocks, pad_ep_blocked)

    if local_aggregate not in ("segment", "blocked"):
        raise ValueError(f"unknown EP local_aggregate {local_aggregate!r}")
    eps, chunks = build_ep_batches(dataset, batch_size, mesh.size)
    plans = None
    if local_aggregate == "blocked":
        built = [build_ep_blocked(e) for e in eps]
        if len(built) > 1:
            targets = max_ep_blocked_blocks(built)
            built = [pad_ep_blocked(p, targets) for p in built]
        plans = [p.shard(mesh.rank, mesh.device) for p in built]
    return [ep_shard(e, mesh.rank, mesh.device) for e in eps], plans, chunks


class _EdgePartitionedPath:
    """EP giant batches (parallel/ep.py), collated and partitioned once:
    each epoch permutes the visit order, edge dropout is the hash stream of
    ep_step_seed (no noise generator), and the host's share is not timed."""

    def __init__(self, train_dataset, test_dataset, batch_size: int, mesh,
                 local_aggregate: str, seed: int = 1):
        self.train_dataset, self.test_dataset = train_dataset, test_dataset
        self.dev, self.mesh, self.seed = mesh.device, mesh, seed
        if train_dataset is not None:
            self.train_shards, self.train_plans, _ = _ep_shards(
                train_dataset, batch_size, mesh, local_aggregate)
        self.test_shards, self.test_plans, self.chunks = _ep_shards(
            test_dataset, batch_size, mesh, local_aggregate)
        self._ys = None

    def step(self, model, optimizer, ARR: float) -> Callable:
        from ..parallel.ep import make_ep_train_step

        return make_ep_train_step(model, optimizer, self.mesh, ARR)

    def train(self, step_fn: Callable, epoch: int):
        from ..parallel.ep import ep_train_epoch

        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        total = ep_train_epoch(step_fn, self.train_shards, self.seed, epoch, rng,
                               self.train_plans)
        return (0.0 if total is None
                else float(total) / max(len(self.train_dataset), 1)), 0.0

    def rmse(self, model):
        from ..parallel.ep import ep_eval_sums

        acc = ep_eval_sums(model, self.test_shards, self.mesh, self.test_plans)
        return (0.0 if acc is None else _rmse(*acc)), 0.0

    def predict(self, model):
        from ..parallel.ep import ep_predict_all

        ds = self.test_dataset
        if self._ys is None:
            self._ys = np.array([ds.get(i).y for i in range(len(ds))], np.float32)
        return ep_predict_all(model, self.test_shards, self.mesh, self.chunks,
                              len(ds), self.test_plans), self._ys

    def suffix(self) -> str:
        return ""


def _choose_path(train_dataset, test_dataset, model: torch.nn.Module,
                 batch_size: int, batch_mode: str, flat_aggregate, dense_chunk: int,
                 dense_layout: str, device, dense_buckets: int = 3,
                 superbatch: int = 8, mesh=None, seed: int = 1, prefetch: int = 2):
    """(path, model copy) of train_multiple_epochs, or of test_once when
    `train_dataset` is None, after their refusals in their order. The copy
    is on the path's device and, on the flat layout, set to the engine.
    A flat engine named on the dense layout is refused by training and
    moves test_once to the flat layout (it says so)."""
    training = train_dataset is not None
    if batch_mode not in ("flat", "dense"):
        raise ValueError(f"unknown batch_mode {batch_mode!r} (flat|dense)")
    planned = planned_engine(flat_aggregate)
    if batch_mode == "dense" and planned is not None:
        if training:
            raise ValueError("flat_aggregate applies to batch_mode='flat'")
        print("test_once: dense eval unavailable — flat_aggregate overrides "
              "the layout; using the flat path")
        batch_mode = "flat"
    if mesh is not None and planned is not None:
        raise ValueError("flat_aggregate is a single-device path")
    D = 1 if mesh is None else mesh.size
    # a dataset without packed arrays to keep on the device (dynamic data)
    # runs the dense layout host-collated, both sets then
    packed = all(hasattr(ds, "packed") for ds in (train_dataset, test_dataset)
                 if ds is not None)
    host_dense = batch_mode == "dense" and not packed
    if training:
        if mesh is not None and host_dense and batch_size % D:
            raise ValueError(f"dynamic dense DP needs batch_size ({batch_size}) "
                             f"divisible by the mesh size ({D})")
        if dense_chunk and (batch_mode != "dense" or host_dense):
            raise ValueError("dense_chunk needs batch_mode='dense' on static "
                             "(packed) datasets")
        if mesh is not None and batch_mode == "dense" and batch_size % D:
            raise ValueError(f"dense DP needs batch_size ({batch_size}) divisible "
                             f"by the mesh size ({D})")
        if mesh is not None and dense_chunk:
            raise ValueError("dense_chunk is single-device (use EP or dense-DP for "
                             "multi-chip giant batches)")
    if host_dense and dense_layout != "unified":
        raise ValueError(f"dense_layout={dense_layout!r} needs static (packed) "
                         f"datasets; host-collated dense batches are unified")
    if batch_mode != "dense" or dense_chunk >= batch_size:
        dense_chunk = 0  # nothing to stream
    elif training and dense_chunk and batch_size % dense_chunk:
        raise ValueError(f"dense_chunk ({dense_chunk}) must divide "
                         f"batch_size ({batch_size})")
    dev = resolve_device(device) if mesh is None else mesh.device
    model = copy.deepcopy(model).to(dev)
    if batch_mode == "flat":
        set_flat_engine(model, flat_aggregate)
    if packed and (batch_mode == "dense"
                   or (planned is None and superbatch > 1 and mesh is None)):
        dense = None if batch_mode == "flat" else (dense_layout, dense_buckets)
        return _ResidentPath(train_dataset, test_dataset, batch_size, superbatch,
                             dense_chunk, dense, dev, mesh, seed), model
    # the pallas engine's plans are chunked by the model's cfg.pallas_rows,
    # which its forward requires; the other engines keep the loader's
    geometry = dict(plan_rows=model.cfg.pallas_rows) if planned == "pallas" else {}
    loader_kw = dict(prefetch=prefetch, batch_mode=batch_mode,
                     pin_memory=dev.type == "cuda", flat_aggregate=planned,
                     n_devices=0 if mesh is None else D,
                     rank=0 if mesh is None else mesh.rank, **geometry)
    return _HostPath(train_dataset, test_dataset, batch_size, loader_kw, dev, mesh,
                     seed), model


def _start_profile(dev):
    """A running torch.profiler of CPU and, on a card, CUDA activity, and
    whether the program's spans were on before: they are switched on, so
    the trace carries their `igmc:` ranges (utils/spans.py)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof, spans.enable()


def _stop_profile(profiling, dev, profile_dir: str, epoch: int):
    """Stop the profiler of `_start_profile`, switch the spans back off
    unless they were on before, and write its Chrome trace into
    `profile_dir`."""
    prof, spans_were_on = profiling
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.stop()
    if not spans_were_on:
        spans.disable()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, f"epoch{epoch}.trace.json"))
    print(f"torch.profiler trace of epoch {epoch} written to {profile_dir}")


def _run_epochs(state: TrainState, path, step_fn: Callable, mesh, *, epochs: int,
                lr_decay_factor: float, lr_decay_step_size: int, test_freq: int,
                logger: Optional[Callable], continue_from: Optional[int],
                res_dir: Optional[str], profile_dir: Optional[str], progress: bool):
    """The epochs of every path; returns (final test RMSE, `state`).

    `continue_from` E reloads the model and optimizer checkpoints of epoch
    E from `res_dir` (after a barrier on a mesh) and runs epochs E+1 to
    `epochs`. Per epoch: the path's training pass with `step_fn` (the
    epoch's order and noise are functions of the absolute epoch number),
    the test RMSE every `test_freq` epochs (NaN otherwise), the history
    entry (wall seconds, the path's host seconds), the epoch line (and the
    path's suffix), the learning rate times `lr_decay_factor` after every
    `lr_decay_step_size`-th epoch, then `logger(info, state)` and the
    heartbeat. `profile_dir` traces the training pass of epoch start + 1.
    On a mesh rank 0 alone prints, logs and beats, and every rank waits at
    a barrier after the last epoch."""
    model, optimizer, dev = state.model, state.optimizer, path.dev
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    start_epoch = 1
    if continue_from is not None:
        if mesh is not None:
            mesh.barrier()
        model.load_state_dict(load_checkpoint(
            resolve_checkpoint(res_dir, "model", continue_from)))
        optimizer.load_state_dict(load_optimizer_state(
            resolve_checkpoint(res_dir, "optimizer", continue_from)))
        start_epoch = continue_from + 1
        epochs -= continue_from

    rmses = []
    t_start = time.perf_counter()
    beat = Heartbeat("epochs", epochs) if progress and lead else None
    for epoch in range(start_epoch, epochs + start_epoch):
        t_epoch = time.perf_counter()
        profiling = (_start_profile(dev) if profile_dir and epoch == start_epoch + 1
                     and lead else None)
        model.train()
        train_loss, host_seconds = path.train(step_fn, epoch)
        if profiling is not None:
            _stop_profile(profiling, dev, profile_dir, epoch)
        model.eval()
        if epoch % test_freq != 0:
            rmses.append(float("nan"))
        else:
            rmse, waited = path.rmse(model)
            rmses.append(rmse)
            host_seconds += waited
        state.epoch = epoch
        state.history.append({
            "epoch": epoch, "seconds": time.perf_counter() - t_epoch,
            "host_seconds": host_seconds})

        info = {"epoch": epoch, "train_loss": train_loss, "test_rmse": rmses[-1]}
        say("Epoch {}, train loss {:.6f}, test rmse {:.6f}".format(*info.values())
            + path.suffix())
        # manual step decay, as the PyTorch reference's train_eval.py does
        if epoch % lr_decay_step_size == 0:
            set_learning_rate(optimizer,
                              lr_decay_factor * get_learning_rate(optimizer))
        if logger is not None and lead:
            logger(info, state)
        if beat is not None:
            beat(epoch - start_epoch + 1)

    if mesh is not None:
        mesh.barrier()          # rank 0's checkpoints are written
    duration = time.perf_counter() - t_start
    say("Final Test RMSE: {:.6f}, Duration: {:.6f}".format(rmses[-1], duration))
    return rmses[-1], state


def _evaluate(path, model: torch.nn.Module, params: Optional[dict], ensemble: bool,
              checkpoints, logger: Optional[Callable], lead: bool = True) -> float:
    """test_once's tail on every path: the RMSE of `model` (`params`
    loaded first) or, with `ensemble`, of the prediction mean of
    `checkpoints`; with `lead`, printed and passed to `logger`."""
    t_start = time.perf_counter()
    if ensemble and checkpoints:
        rmse = _ensemble_rmse(model, checkpoints, path.predict)
    else:
        if params is not None:
            model.load_state_dict(params)
        rmse, _ = path.rmse(model)
    duration = time.perf_counter() - t_start
    if lead:
        print("Test Once RMSE: {:.6f}, Duration: {:.6f}".format(rmse, duration))
        if logger is not None:
            epoch_info = "test_once" if not ensemble else "ensemble"
            logger({"epoch": epoch_info, "train_loss": 0, "test_rmse": rmse}, None)
    return rmse


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
    (`.pth` or the JAX package's `.ckpt` paths). Prints and returns the
    RMSE.

    `batch_mode` 'dense' evaluates on the device-resident dense layout
    (`dense_layout` 'unified' or 'bipartite', 3 size buckets), or on
    host-collated unified batches for a dataset without packed arrays (a
    DynamicGraphDataset), in rows of `dense_chunk` graphs when that is
    below batch_size; unless a flat engine is named in `flat_aggregate`,
    which keeps the flat layout (and says so), as the JAX package does
    ('segment' and 'auto' name none there). The flat layout runs the engine
    `flat_aggregate` names (flat_engine): the segment engine on a packed
    dataset device-resident (FlatPass), on a dynamic one host-collated;
    blocked and pallas over host-built plans. Runs on `device` (default
    "cuda"; raises without a CUDA device unless device="cpu"). The
    caller's model is not modified."""
    path, model = _choose_path(None, test_dataset, model, batch_size, batch_mode,
                               flat_aggregate, dense_chunk, dense_layout, device)
    return _evaluate(path, model.eval(), params, ensemble, checkpoints, logger)


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
    profile_dir: Optional[str] = None,
    prefetch: int = 2,
    device="cuda",
    progress: bool = True,
):
    """Full training run of a copy of `model` (the caller's is not
    modified); returns (final test RMSE, TrainState).

    Per epoch: shuffle under the absolute epoch number
    (SeedSequence([seed, epoch])), one optimizer step per batch with fresh
    edge and feature dropout noise, the test RMSE every `test_freq` epochs
    (NaN otherwise), the learning rate times `lr_decay_factor` after every
    `lr_decay_step_size`-th epoch, then `logger(info, state)`.
    `continue_from` E reloads the model and optimizer checkpoints of epoch
    E from `res_dir` (a model `.ckpt` of the JAX package loads; its
    optimizer `.ckpt` is refused) and runs epochs E+1 to `epochs`.

    `batch_mode` 'dense' trains on the device-resident dense layout
    (`dense_layout` 'unified' or 'bipartite', at most `dense_buckets` size
    buckets, the epoch planned in [superbatch, batch_size] units), or, when
    a dataset has no packed arrays (DynamicGraphDataset), on host-collated
    unified batches (one step per batch; no superbatches); 'flat' through
    the engine `flat_aggregate` names (flat_engine; the module docstring
    says where each runs): the segment engine device-resident on packed
    datasets when superbatch > 1, else host-collated; blocked and pallas
    host-collated with their plans (superbatch does not apply, as in the
    JAX package). Host-collated batches are extracted, collated and
    planned `prefetch` batches ahead on the loader's threads (0: on this
    thread). `flat_aggregate` 'segment' and 'auto' name no flat engine on
    the dense layout. `dense_chunk` N
    (dense, static data only; N >= batch_size means off, else N must
    divide batch_size) takes each step over batch_size graphs streamed in
    N-graph slices and evaluates in N-graph rows. `profile_dir` writes a
    torch.profiler Chrome trace of the training pass of epoch start + 1
    there (the first epoch after the one that builds and warms up). Runs on
    `device` (default "cuda"; raises without a CUDA device unless
    device="cpu"). `progress` prints "epochs i/n" to stderr after an epoch,
    at most every 30 s (utils/progress.py; the JAX package shows a tqdm
    bar over the epochs).

    `mesh` (parallel/mesh.py, this process's rank; `device` is then the
    mesh's) trains data-parallel, as the module docstring says, with the
    JAX package's refusals: a flat engine other than the segment one,
    `dense_chunk`, and a batch_size that does not divide by the mesh size.
    The returned TrainState is the same on every rank."""
    path, model = _choose_path(train_dataset, test_dataset, model, batch_size,
                               batch_mode, flat_aggregate, dense_chunk, dense_layout,
                               device, dense_buckets=dense_buckets,
                               superbatch=superbatch, mesh=mesh, seed=seed,
                               prefetch=prefetch)
    optimizer = make_optimizer(model.parameters(), lr, weight_decay)
    return _run_epochs(TrainState(model=model, optimizer=optimizer), path,
                       path.step(model, optimizer, ARR), mesh, epochs=epochs,
                       lr_decay_factor=lr_decay_factor,
                       lr_decay_step_size=lr_decay_step_size, test_freq=test_freq,
                       logger=logger, continue_from=continue_from, res_dir=res_dir,
                       profile_dir=profile_dir, progress=progress)


def train_multiple_epochs_ep(
    train_dataset,
    test_dataset,
    model: torch.nn.Module,
    mesh,
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
    profile_dir: Optional[str] = None,
    local_aggregate: str = "segment",
    progress: bool = True,
):
    """Training under EDGE-PARTITIONED parallelism (parallel/ep.py): every
    batch of batch_size graphs is ONE giant disjoint batch-graph split over
    the mesh's ranks. The epochs of train_multiple_epochs (step LR decay,
    the RMSE every `test_freq` epochs, checkpoint and resume through
    `logger` and `continue_from`, the reference's log lines), with the EP
    data handling: the batches are collated and partitioned once (fixed
    membership; each epoch permutes the visit order), edge dropout is the
    hash stream of ep_step_seed, and the local aggregate is
    `local_aggregate` 'segment' or 'blocked'. `model` is an IGMC (a copy is
    trained, on the mesh's device). Rank 0 alone prints and calls
    `logger` and, with `progress`, train_multiple_epochs' heartbeat.
    Returns (final RMSE, TrainState), the same on every rank."""
    model = copy.deepcopy(model).to(mesh.device)
    optimizer = make_optimizer(model.parameters(), lr, weight_decay)
    path = _EdgePartitionedPath(train_dataset, test_dataset, batch_size, mesh,
                                local_aggregate, seed)
    return _run_epochs(TrainState(model=model, optimizer=optimizer), path,
                       path.step(model, optimizer, ARR), mesh, epochs=epochs,
                       lr_decay_factor=lr_decay_factor,
                       lr_decay_step_size=lr_decay_step_size, test_freq=test_freq,
                       logger=logger, continue_from=continue_from, res_dir=res_dir,
                       profile_dir=profile_dir, progress=progress)


def test_once_ep(
    test_dataset,
    model: torch.nn.Module,
    batch_size: int,
    mesh,
    params: Optional[dict] = None,
    logger: Optional[Callable] = None,
    ensemble: bool = False,
    checkpoints=None,
    local_aggregate: str = "segment",
):
    """test_once over EP giant batches on the mesh: `model` (or the
    state_dict `params` loaded into a copy), or with `ensemble` the
    prediction mean of `checkpoints`. Every rank returns the RMSE; rank 0
    alone prints it and calls `logger`."""
    path = _EdgePartitionedPath(None, test_dataset, batch_size, mesh, local_aggregate)
    model = copy.deepcopy(model).to(mesh.device).eval()
    return _evaluate(path, model, params, ensemble, checkpoints, logger,
                     lead=mesh.rank == 0)
