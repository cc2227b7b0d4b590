"""The fused-aggregate training step as CUDA graphs, one per input shape.

make_train_step (train/loop.py) hands an IGMC on the fused aggregate
(`cfg.flat_aggregate == "pallas"`) whose parameters are on a card to
GraphedStep, and every other model to its eager step. A graph holds one
whole optimizer step: `zero_grad`, the loss (the 4 R-GCN layers through
K1, the head, masked MSE + ARR), `backward` (K2 in every layer) and
`optimizer.step()`. A step copies what the forward and backward read
into its graph's static buffers and replays the graph: the card runs the
same kernels, in float32 and in the same order, and the launching thread
no longer pays each step for hundreds of eager launches and autograd's
bookkeeping.

  * Key: the shapes of every input the step reads (node_pad, both plans'
    block counts, B; plan_rows), whether the model trains with edge
    dropout, and the optimizer's hyperparameters a capture bakes in (lr,
    weight decay, betas, eps). The first step of a key runs the eager
    step (a real step, and the warm-up); the next captures the key's
    graph and replays it at once; later ones replay. All graphs share
    one memory pool.
  * Invalidation: a capture records the data_ptr of every parameter and
    optimizer state tensor; when one differs at a later step (the
    optimizer's load_state_dict, a checkpoint resume), every graph is
    dropped and each key starts again with an eager step. A new lr (the
    CLI's decay) is a new key.
  * Adam: the caller's optimizer, with `capturable=True` set on its
    groups before the first capture and its step counts moved to the card
    in float64, so that its bias corrections, now computed on the device,
    are as exact as the eager Adam's Python floats (in float32,
    1 - 0.999 ** t keeps only ~5 significant digits: the first steps'
    updates would move by ~6e-6 of themselves); `optimizer.step()` is
    called by attribute inside the capture.
  * Edge dropout: the seed goes into a 0-d int64 buffer, which
    ops/dropout.py hash_edge_keep reads on the device.
  * Launch counters: a replay adds its graph's captured K1 and K2
    launches to `rgcn_aggregate.launches` / `rgcn_aggregate_bwd.launches`
    (a capture records launches without running them), so the counters
    count the kernels that ran.
  * Spans (utils/spans.py): `train.capture` around a capture step (the
    capture and its first replay), `train.replay` around a replay step's
    input copies and replay; an eager step keeps make_train_step's
    `train.forward`, `train.backward`, `train.optimizer`. Counters
    `train.eager_steps`, `train.graph_captures` and `train.graph_replays`
    count every step once.

The step returns (loss, n) as clones of the graph's outputs, so the
caller owns them; nothing in it waits for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..batching.batch import GraphBatch
from ..kernels.rgcn_aggregate import rgcn_aggregate, rgcn_aggregate_bwd
from ..models.igmc import IGMC
from ..utils import spans

# the batch fields the fused forward and the loss read, besides the plans
FIELDS = ("node_label", "node_mask", "target_u", "target_v", "y", "graph_mask")
SIDE_FIELDS = ("u_feat", "v_feat")
# the optimizer hyperparameters a capture bakes in
BAKED = ("lr", "weight_decay", "betas", "eps")


def applies(model) -> bool:
    """Whether make_train_step graphs `model`'s steps: an IGMC on the fused
    aggregate with its parameters on a card."""
    if not isinstance(model, IGMC) or model.cfg.flat_aggregate != "pallas":
        return False
    return next(model.parameters()).device.type == "cuda"


class _Graph(NamedTuple):
    """One key's captured step, its static inputs and outputs, and the K1
    and K2 launches it holds."""
    graph: torch.cuda.CUDAGraph
    batch: GraphBatch          # static buffers in the fields the step reads
    seed: torch.Tensor         # 0-d int64: the edge-dropout seed
    keep: torch.Tensor         # lin1's dropout mask
    loss: torch.Tensor
    n: torch.Tensor
    k1: int
    k2: int


class GraphedStep:
    """(batch, noise) -> (loss, n), as make_train_step's eager step `eager`
    computes them, through one CUDA graph per key (module docstring). A
    batch that is not a flat GraphBatch with both aligned plans goes to
    `eager` unchanged. `loss_fn(model, batch, noise, ARR)` is the loss
    the eager step differentiates."""

    def __init__(self, model, optimizer, ARR: float, eager: Callable,
                 loss_fn: Callable):
        self.model, self.optimizer, self.ARR = model, optimizer, ARR
        self.eager, self.loss_fn = eager, loss_fn
        self.fields = FIELDS + (SIDE_FIELDS if model.cfg.side_features else ())
        self.graphs = {}        # key -> _Graph, or None after the key's eager step
        self.pool = None
        self.pointers: Optional[Tuple[int, ...]] = None

    def __call__(self, batch, noise):
        if not (isinstance(batch, GraphBatch) and batch.aligned is not None
                and batch.aligned_t is not None):
            return self.eager(batch, noise)
        if self.pointers is not None and self._pointers() != self.pointers:
            self.graphs.clear()         # new parameter or state tensors
            self.pointers = None
        key = self._key(batch)
        if key not in self.graphs:
            self.graphs[key] = None
            spans.count("train.eager_steps")
            self._capturable(False)
            return self.eager(batch, noise)
        entry = self.graphs[key]
        if entry is None:
            self._capturable(True)
            with spans.span("train.capture"):
                entry = self.graphs[key] = self._capture(batch, noise)
                spans.count("train.graph_captures")
                return self._run(entry, batch, noise)
        with spans.span("train.replay"):
            spans.count("train.graph_replays")
            return self._run(entry, batch, noise)

    def _capturable(self, on: bool):
        """With `on`, capturable=True on every group; then the step counts
        of every capturable group on the card in float64 (a loaded
        state_dict may bring back float32 or CPU counts)."""
        for group in self.optimizer.param_groups:
            group["capturable"] = group["capturable"] or on
            if not group["capturable"]:
                continue
            for p in group["params"]:
                state = self.optimizer.state.get(p, {})
                step = state.get("step")
                if torch.is_tensor(step) and (step.device, step.dtype) != (p.device,
                                                                          torch.float64):
                    state["step"] = step.to(p.device, torch.float64)

    def _inputs(self, batch: GraphBatch):
        """The tensors of `batch` the step reads, in a fixed order."""
        return ([getattr(batch, f) for f in self.fields]
                + [t for t in batch.aligned + batch.aligned_t if t is not None])

    def _key(self, batch: GraphBatch):
        cfg = self.model.cfg
        return (tuple(tuple(t.shape) for t in self._inputs(batch)), batch.plan_rows,
                self.model.training, self.model.training and cfg.adj_dropout > 0,
                tuple(tuple(g.get(k) for k in BAKED) for g in self.optimizer.param_groups))

    def _pointers(self) -> Tuple[int, ...]:
        ptrs = [p.data_ptr() for p in self.model.parameters()]
        for state in self.optimizer.state.values():
            ptrs += [t.data_ptr() for t in state.values() if torch.is_tensor(t)]
        return tuple(ptrs)

    def _capture(self, batch: GraphBatch, noise) -> _Graph:
        """Capture one whole step over static copies of `batch` and `noise`.
        The launch counters are left as they were: the captured launches
        have not run yet."""
        static = {f: getattr(batch, f).clone() for f in self.fields}
        clone = lambda plan: tuple(None if t is None else t.clone() for t in plan)
        sbatch = dataclasses.replace(batch, aligned=clone(batch.aligned),
                                     aligned_t=clone(batch.aligned_t), **static)
        seed = torch.zeros((), dtype=torch.int64, device=noise[1].device)
        keep = noise[1].clone()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        launches = rgcn_aggregate.launches, rgcn_aggregate_bwd.launches
        graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's threads pin memory while this one captures
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            self.optimizer.zero_grad(set_to_none=True)
            loss, n = self.loss_fn(self.model, sbatch, (seed, keep), self.ARR)
            loss.backward()
            self.optimizer.step()
        k1 = rgcn_aggregate.launches - launches[0]
        k2 = rgcn_aggregate_bwd.launches - launches[1]
        rgcn_aggregate.launches, rgcn_aggregate_bwd.launches = launches
        self.pointers = self._pointers()
        return _Graph(graph, sbatch, seed, keep, loss.detach(), n, k1, k2)

    def _run(self, entry: _Graph, batch: GraphBatch, noise):
        """Copy the step's inputs into `entry`'s buffers and replay it."""
        for dst, src in zip(self._inputs(entry.batch), self._inputs(batch)):
            dst.copy_(src, non_blocking=True)
        entry.seed.fill_(noise[0])
        entry.keep.copy_(noise[1], non_blocking=True)
        entry.graph.replay()
        rgcn_aggregate.launches += entry.k1
        rgcn_aggregate_bwd.launches += entry.k2
        return entry.loss.clone(), entry.n.clone()
