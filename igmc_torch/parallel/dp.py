"""Data parallelism: each rank runs its share of every batch, and the
gradients are summed with one all-reduce per step.

Port of igmc_tpu/parallel/dp.py. The JAX package splits each global batch
into D sub-batches, stacks them on a leading device axis sharded over
'data', vmaps the forward and lets GSPMD insert the gradient psum of the
global-mean loss. Here each rank is a process with its own sub-batch, so
nothing is stacked (`stack_batches` has no counterpart):

  * split_for_devices collates the D sub-batches in one shared bucket, as
    JAX's does (graph order kept: device d gets the d-th chunk; a short
    final batch's empty chunks get zero side-feature rows), and returns
    them as a list; BatchLoader(n_devices=D, rank=r) yields the r-th;
  * the loss is the GLOBAL mean: each rank's squared-error sum over the
    graph count n of the whole batch (all-reduced, or given by a caller
    that knows the whole batch). ARR's term is added on rank 0 alone, so
    its gradient is counted once in the sum. After the backward, every
    gradient and the rank's squared-error sum go into one flat bucket,
    summed with ONE all_reduce, and copied back; then the optimizer steps.
    Adam on identical summed gradients keeps every rank's parameters
    identical, and the step is the single-device step on the whole batch
    (at one rank, bit for bit);
  * noise: a rank takes its rows of the whole batch's draw (draw_noise of
    B graphs, the same generator on every rank), and the edge seed is
    shared, so the hash edge dropout on packed edge ids drops the edges the
    single-device step drops;
  * make_dp_eval_step all-reduces the squared-error sum and the count and
    all-gathers the predictions (dataset order within the batch);
  * make_dp_scan_train_step (the JAX package's K steps in one dispatch)
    runs one step per batch, the divergence the single-device superbatch
    already has.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..batching.batch import GraphBatch, bucket_for, collate
from ..models.igmc import arr_regularizer, slice_noise
from .mesh import Mesh


def split_for_devices(graphs, n_devices: int, per_device_graphs: int,
                      node_ladder, edge_ladder, gids=None,
                      edge_offsets=None) -> List[GraphBatch]:
    """The graphs collated into n_devices sub-batches of per_device_graphs,
    all in one (node_pad, edge_pad) bucket of the ladders: the d-th chunk
    of graphs is sub-batch d. `gids` / `edge_offsets` key each graph's
    edge ids as collate does."""
    B = per_device_graphs
    chunks = [list(graphs[d * B: (d + 1) * B]) for d in range(n_devices)]
    ids = [None if gids is None else np.asarray(gids)[d * B: (d + 1) * B]
           for d in range(n_devices)]
    need_n = max(1, max(sum(g.num_nodes for g in c) for c in chunks))
    need_e = max(1, max(sum(g.num_edges for g in c) for c in chunks))
    node_pad = bucket_for(need_n, node_ladder)
    edge_pad = bucket_for(need_e, edge_ladder)
    subs = [collate(c, B, node_pad, edge_pad, gids=i, edge_offsets=edge_offsets)
            for c, i in zip(chunks, ids)]
    dims = next(((s.u_feat.shape[1], s.v_feat.shape[1])
                 for s in subs if s.u_feat is not None), None)
    if dims is not None:
        for s in subs:
            if s.u_feat is None:
                s.u_feat = torch.zeros(B, dims[0])
                s.v_feat = torch.zeros(B, dims[1])
    return subs


def rank_columns(mesh: Mesh, n_graphs: int) -> slice:
    """This rank's graphs [r * B/D, (r + 1) * B/D) of a batch of n_graphs."""
    if n_graphs % mesh.size:
        raise ValueError(f"batch of {n_graphs} graphs does not split over "
                         f"{mesh.size} ranks")
    per = n_graphs // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def rank_noise(mesh: Mesh, noise, n_graphs: int):
    """This rank's share of a whole batch's training noise (slice_noise)."""
    cols = rank_columns(mesh, n_graphs)
    return slice_noise(noise, cols.start, cols.stop)


def summed_gradient_step(model, optimizer, mesh: Mesh, sse: torch.Tensor,
                         n: torch.Tensor, ARR: float = 0.0) -> torch.Tensor:
    """The optimizer step of a loss split over the ranks: this rank's part
    sse / n (+ ARR * arr_regularizer on rank 0 alone) is differentiated,
    every gradient and `sse` are summed over the ranks with ONE all_reduce
    of a flat bucket and copied back, and the optimizer steps. Returns the
    whole loss (the summed sse / n + the ARR term), the same on every
    rank. Call with zeroed gradients."""
    reg = None
    if ARR != 0.0:
        r = arr_regularizer(model)
        if torch.is_tensor(r):          # GCN-only families carry no ARR term
            reg = ARR * (r if mesh.rank == 0 else r.detach())
    loss = sse / n
    if reg is not None and mesh.rank == 0:
        loss = loss + reg
    loss.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    bucket = torch.cat([g.reshape(-1) for g in grads] + [sse.detach().reshape(1)])
    bucket = mesh.all_reduce(bucket)
    offset = 0
    for p in params:
        k = p.numel()
        p.grad = bucket[offset:offset + k].view_as(p).clone()
        offset += k
    optimizer.step()
    total = bucket[-1] / n
    return total if reg is None else total + reg.detach()


def make_dp_train_step(model, optimizer, mesh: Mesh, ARR: float = 0.0) -> Callable:
    """(batch, noise, n=None) -> (loss, n): one data-parallel optimizer
    step on this rank's sub-batch `batch` with its noise. `n` is the real
    graph count of the whole batch (a 0-d tensor); None all-reduces the
    ranks' counts. The returned loss is the whole batch's (the same on
    every rank)."""

    def step(batch, noise, n=None):
        optimizer.zero_grad(set_to_none=True)
        preds = model(batch, noise)
        gmask = batch.graph_mask.float()
        if n is None:
            n = mesh.all_reduce(gmask.sum().reshape(1))[0]
        n = n.float().clamp_min(1.0)
        sse = (((preds - batch.y) ** 2) * gmask).sum()
        return summed_gradient_step(model, optimizer, mesh, sse, n, ARR), n

    return step


def make_dp_scan_train_step(model, optimizer, mesh: Mesh, ARR: float = 0.0) -> Callable:
    """[(batch, noise), ...] -> (sum of loss * n, sum of n): one
    make_dp_train_step step per batch (the JAX package scans K of them in
    one dispatch)."""
    step = make_dp_train_step(model, optimizer, mesh, ARR)

    def steps(batches_and_noise: Sequence):
        total = count = None
        for batch, noise in batches_and_noise:
            loss, n = step(batch, noise)
            total = loss * n if total is None else total + loss * n
            count = n if count is None else count + n
        return total, count

    return steps


def make_dp_eval_step(model, mesh: Mesh) -> Callable:
    """batch -> (squared-error sum, count, predictions) of the whole batch:
    the sums all-reduced, the ranks' predictions all-gathered in rank
    order. `model` must be in eval mode."""

    @torch.no_grad()
    def step(batch):
        preds = model(batch)
        gmask = batch.graph_mask.float()
        sums = torch.stack([(((preds - batch.y) ** 2) * gmask).sum(), gmask.sum()])
        sums = mesh.all_reduce(sums)
        return sums[0], sums[1], mesh.all_gather(preds)

    return step
