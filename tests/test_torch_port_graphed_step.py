"""The graphed training step (igmc_torch/train/graphed.py).

On the CPU (tier-1): make_train_step stays eager for every engine and
layout (no graph, no capture counter, the eager step's spans), the hash
edge dropout gives the same keep bits for an int seed and a 0-d tensor
seed, and an optimizer checkpoint of capturable Adam resumes on the CPU.

On the card (marker `cuda`; without a card those tests skip): the graphed
step against the eager step over several shape keys, with and without
edge dropout; a new learning rate and the optimizer's load_state_dict
each capture anew; the K1 / K2 launch counters count replayed kernels;
the step counters add up to the steps; no step waits for the card. This
file imports nothing of JAX, so that it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_graphed_step.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from igmc_torch.batching import BatchLoader, StaticGraphDataset
from igmc_torch.batching.device_data import DeviceDataset
from igmc_torch.kernels.rgcn_aggregate import rgcn_aggregate, rgcn_aggregate_bwd
from igmc_torch.models import IGMC, IGMCConfig, draw_noise
from igmc_torch.ops.dropout import hash_edge_keep
from igmc_torch.train import (DensePass, make_dense_row_step, make_optimizer,
                              make_train_step, plan_buckets)
from igmc_torch.train import graphed
from igmc_torch.train.checkpoints import load_optimizer_state, save_optimizer_state
from igmc_torch.train.loop import dense_train_epoch, set_learning_rate, train_epoch
from igmc_torch.utils import spans

BATCH = 50
ARR = 0.001
CLASS_VALUES = np.arange(1.0, 6.0)
EAGER_SPANS = ("train.forward", "train.backward", "train.optimizer")
GRAPH_SPANS = ("train.capture", "train.replay")
COUNTERS = ("train.eager_steps", "train.graph_captures", "train.graph_replays")


@pytest.fixture(autouse=True)
def clean_spans():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture(scope="module")
def dataset():
    """140 pairs of a 60 x 70 rating matrix: 3 batches of 50 a pass, whose
    pallas batches fall in 3 shapes over 3 passes."""
    rng = np.random.default_rng(0)
    M = sp.random(60, 70, density=0.12, format="csr",
                  random_state=np.random.RandomState(0))
    M.data = rng.integers(1, 6, M.nnz).astype(np.float64)
    u, v = M.nonzero()
    n = 3 * BATCH - 10
    labels = (M[u[:n], v[:n]].A1 - 1).astype(np.int64)
    return StaticGraphDataset(M, (u[:n], v[:n]), labels, h=1,
                              class_values=CLASS_VALUES, backend="numpy",
                              progress=False)


def _model(engine, device="cpu", **kw):
    cfg = IGMCConfig(num_relations=5, num_bases=4, flat_aggregate=engine, **kw)
    return IGMC(cfg, torch.Generator().manual_seed(3)).to(device).train()


def _loader(dataset, engine):
    return BatchLoader(dataset, BATCH, shuffle=True, seed=5, prefetch=0,
                       flat_aggregate=None if engine == "segment" else engine)


# ---------------------------------------------------------------------------
# CPU: every engine keeps the eager step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["pallas", "segment", "blocked", "dense-row"])
def test_cpu_steps_stay_eager(dataset, engine):
    """On the CPU make_train_step (and make_dense_row_step) is the eager
    step: no GraphedStep, no capture, replay or eager-step counter, and
    the spans train.forward / backward / optimizer once a step."""
    model = _model("segment" if engine == "dense-row" else engine)
    opt = make_optimizer(model.parameters(), 1e-3)
    gen = torch.Generator().manual_seed(11)
    spans.enable()
    if engine == "dense-row":
        step = make_dense_row_step(model, opt, 0, ARR)
        dd = DeviceDataset(dataset.packed, torch.device("cpu"))
        rows = DensePass.plan(plan_buckets(dataset, "unified"), BATCH, 8, "cpu",
                              np.random.default_rng(2))
        loss = dense_train_epoch(step, dd, rows, gen, len(dataset))
        steps = len(rows.bucket_of)
    else:
        step = make_train_step(model, opt, ARR)
        assert not isinstance(step, graphed.GraphedStep)
        loss = train_epoch(step, _loader(dataset, engine), gen, len(dataset),
                           torch.device("cpu"))
        steps = 3
    snap = spans.snapshot()
    assert np.isfinite(loss)
    assert not graphed.applies(model)
    assert snap["counters"]["train.steps"] == steps
    for name in EAGER_SPANS:
        assert snap["spans"][name]["calls"] == steps, name
    for name in GRAPH_SPANS:
        assert name not in snap["spans"], name
    for name in COUNTERS:
        assert name not in snap["counters"], name
    assert all(g["capturable"] is False for g in opt.param_groups)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2, 2**32 - 1])
def test_hash_edge_keep_takes_a_tensor_seed(seed):
    """A 0-d int64 seed gives the int seed's keep bits, for keys below and
    above 2**32 (a dynamic dataset's dense keys carry a high word)."""
    rng = np.random.default_rng(seed % 1000)
    keys = torch.from_numpy(np.concatenate([
        rng.integers(0, 2**32, 2000), rng.integers(2**32, 2**40, 2000),
        [0, 2**32 - 1, 2**32, 2**33 + 5]]).astype(np.int64))
    for p in (0.2, 0.5):
        want = hash_edge_keep(seed, keys, p)
        got = hash_edge_keep(torch.tensor(seed, dtype=torch.int64), keys, p)
        assert torch.equal(got, want)
        assert 0 < int(want.sum()) < len(keys)


def test_capturable_optimizer_checkpoint_resumes_on_the_cpu(dataset, tmp_path):
    """The graphed step saves Adam with capturable groups; loaded back, the
    state resumes as a plain Adam on the CPU, with the same moments."""
    model = _model("pallas")
    opt = make_optimizer(model.parameters(), 1e-3)
    step = make_train_step(model, opt, ARR)
    gen = torch.Generator().manual_seed(11)
    train_epoch(step, _loader(dataset, "pallas"), gen, len(dataset), torch.device("cpu"))
    for g in opt.param_groups:
        g["capturable"] = True
    path = str(tmp_path / "optimizer_checkpoint1.pth")
    save_optimizer_state(path, opt)
    again = make_optimizer(model.parameters(), 1e-3)
    again.load_state_dict(load_optimizer_state(path))
    assert all(g["capturable"] is False for g in again.param_groups)
    for p in model.parameters():
        torch.testing.assert_close(again.state[p]["exp_avg"], opt.state[p]["exp_avg"],
                                   rtol=0, atol=0)
    train_epoch(make_train_step(model, again, ARR), _loader(dataset, "pallas"), gen,
                len(dataset), torch.device("cpu"))


# ---------------------------------------------------------------------------
# The card: graphed against eager
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and K1/K2 have no CPU mode")
    return torch.device("cuda")


def _card_batches(dataset, passes, dev):
    """Every training batch of `passes` passes on the card, with its noise."""
    loader = _loader(dataset, "pallas")
    gen = torch.Generator().manual_seed(11)
    out = []
    for p in range(passes):
        loader.epoch = p
        for batch in loader:
            seed, keep = draw_noise(gen, batch.num_graphs)
            out.append((batch.to(dev), (seed, keep.to(dev))))
    return out


class _Pair:
    """A graphed and an eager copy of one model and optimizer."""

    def __init__(self, dev, adj_dropout):
        self.models = [_model("pallas", dev, adj_dropout=adj_dropout) for _ in range(2)]
        self.opts = [make_optimizer(m.parameters(), 1e-3) for m in self.models]
        self.graphed = make_train_step(self.models[0], self.opts[0], ARR)
        assert isinstance(self.graphed, graphed.GraphedStep)
        self.eager = make_train_step(self.models[1], self.opts[1], ARR).eager

    def run(self, batches):
        """Both steps over `batches`; the K1 / K2 launches of each graphed step."""
        launches = []
        for batch, noise in batches:
            k = rgcn_aggregate.launches, rgcn_aggregate_bwd.launches
            lg, ng = self.graphed(batch, noise)
            launches.append((rgcn_aggregate.launches - k[0],
                             rgcn_aggregate_bwd.launches - k[1]))
            le, ne = self.eager(batch, noise)
            torch.testing.assert_close(lg, le, rtol=1e-5, atol=0)
            assert float(ng) == float(ne)
        self.assert_params_close()
        return launches

    def assert_params_close(self):
        for (name, pg), pe in zip(self.models[0].named_parameters(),
                                  self.models[1].parameters()):
            torch.testing.assert_close(pg, pe, rtol=1e-5, atol=1e-6, msg=name)

    def for_both(self, fn):
        for opt in self.opts:
            fn(opt)


@pytest.mark.cuda
@pytest.mark.parametrize("adj_dropout", [0.0, 0.2])
def test_graphed_step_matches_eager(dataset, adj_dropout):
    """12 steps over 3 shape keys, ARR on: the losses within rtol 1e-5 and
    the parameters within rtol 1e-5 / atol 1e-6 of the eager step's
    (atomics sum in a varying order); a key's first step is eager and its
    second a capture, every step is counted once, and every step,
    replayed or not, runs K1 and K2 once a layer."""
    dev = _card()
    batches = _card_batches(dataset, 4, dev)
    spans.enable()
    pair = _Pair(dev, adj_dropout)
    launches = pair.run(batches)
    c = spans.snapshot()["counters"]
    graphs = pair.graphed.graphs
    captured = sum(g is not None for g in graphs.values())
    assert captured >= 2 and c["train.graph_replays"] >= 4
    assert c["train.eager_steps"] == len(graphs)
    assert c["train.graph_captures"] == captured
    assert sum(c[name] for name in COUNTERS) == len(batches)
    assert launches == [(4, 4)] * len(batches)
    assert all(g["capturable"] for g in pair.opts[0].param_groups)


@pytest.mark.cuda
def test_graphed_step_captures_anew_after_lr_and_state_changes(dataset, tmp_path):
    """A new learning rate is a new key, and an optimizer state loaded from
    its checkpoint (load_state_dict, as a resume does) brings new state
    tensors, so every graph is dropped: each key then takes an eager step
    and a fresh capture, and the steps still match the eager step's."""
    dev = _card()
    batches = _card_batches(dataset, 4, dev)
    spans.enable()
    pair = _Pair(dev, 0.0)
    pair.run(batches)
    captures = spans.snapshot()["counters"]["train.graph_captures"]
    pair.for_both(lambda opt: set_learning_rate(opt, 1e-4))
    pair.run(batches[:6])
    after_lr = spans.snapshot()["counters"]["train.graph_captures"]
    assert after_lr > captures

    def reload(opt):
        path = str(tmp_path / f"optimizer_{id(opt)}.pth")
        save_optimizer_state(path, opt)
        opt.load_state_dict(load_optimizer_state(path))

    pair.for_both(reload)
    eager = spans.snapshot()["counters"]["train.eager_steps"]
    pair.run(batches[:6])
    c = spans.snapshot()["counters"]
    assert c["train.graph_captures"] > after_lr
    assert c["train.eager_steps"] > eager
    assert all(g["capturable"] for g in pair.opts[0].param_groups)


@pytest.mark.cuda
def test_graphed_step_never_waits_for_the_card(dataset):
    """An eager step, a capture and replays under the sync debug mode
    "error": no operation of the step synchronises with the host."""
    dev = _card()
    batches = _card_batches(dataset, 2, dev)
    model = _model("pallas", dev, adj_dropout=0.2)
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-3), ARR)
    # the kernels' build and first launch; the first capture moves Adam's
    # step counts to the card, once
    step(*batches[0])
    step(*batches[0])
    torch.cuda.synchronize()
    step.graphs.clear()
    step.pointers = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch, noise in batches:
            step(batch, noise)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
