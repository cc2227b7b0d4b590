"""IGMC, its loss and Adam, in plain PyTorch.

The model of Zhang & Chen (ICLR 2020), "Inductive Matrix Completion Based
on Graph Neural Networks", as its reference implementation builds it:
one-hot node labels (width 2h + 2), `len(latent_dim)` R-GCN layers (PyG
RGCNConv with basis decomposition W_r = sum_b att[r, b] basis[b], the mean
of the messages x_j W_r over both directions of every kept edge, plus
x_i root + bias) each followed by tanh, the target user's and target
item's states of every layer concatenated (user layers first), relu(lin1)
of width `hidden`, dropout `dropout` in training, lin2 to one output. The loss is the
mean squared error over the batch's graphs plus ARR times, for every
layer, ||W_{r+1} - W_r||^2 summed over adjacent rating levels.

Written per relation (one product x[src] @ W_r per relation and
direction), in any float dtype; it imports nothing of the program. The
noise of a training step is drawn here as the training loop draws it: an
int edge seed in [0, 2**31 - 1) and a [B, hidden] Bernoulli(1 - dropout) keep mask
from one CPU generator, in that order; edge dropout keeps an edge when a
hash of (edge seed, key) clears the drop probability, the key of stored
edge i of the pool's edge list being 2i forward and 2i + 1 reverse (the
hash is copied from igmc_torch/ops/dropout.py at commit
ead40f2a1b0deed656f1008c591755b35d83b708).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

_LOW32 = 0xFFFFFFFF


def param_specs(model: dict, num_relations: int):
    """[(name, shape, init bound)] of IGMC's parameters, in the order of
    the reference's state_dict: RGCNConv tensors U(+-1/sqrt(nb * Cin)),
    Linear tensors U(+-1/sqrt(fan_in))."""
    nb, latent = model["num_bases"], model["latent_dim"]
    specs, cin = [], model["num_features"]
    for i, cout in enumerate(latent):
        b = 1.0 / math.sqrt(nb * cin)
        specs += [(f"convs.{i}.basis", (nb, cin, cout), b),
                  (f"convs.{i}.att", (num_relations, nb), b),
                  (f"convs.{i}.root", (cin, cout), b),
                  (f"convs.{i}.bias", (cout,), b)]
        cin = cout
    fan, hidden = 2 * sum(latent), model["hidden"]
    specs += [("lin1.weight", (hidden, fan), 1 / math.sqrt(fan)),
              ("lin1.bias", (hidden,), 1 / math.sqrt(fan)),
              ("lin2.weight", (1, hidden), 1 / math.sqrt(hidden)),
              ("lin2.bias", (1,), 1 / math.sqrt(hidden))]
    return specs


@dataclass
class Batch:
    """Graphs concatenated: global node rows, stored (user -> item) edges."""
    node_label: torch.Tensor   # [N]
    src: torch.Tensor          # [M]
    dst: torch.Tensor          # [M]
    etype: torch.Tensor        # [M]
    edge_key: torch.Tensor     # [M] stored-edge id in the pool's edge list
    target_u: torch.Tensor     # [B]
    target_v: torch.Tensor     # [B]
    y: torch.Tensor            # [B]


def make_batch(graphs: Sequence, ys, device, edge_ids: Optional[Sequence] = None):
    """A Batch of reference graphs (reference/extract.py Graph) with their
    targets `ys`; `edge_ids[i]` is the id of graph i's first stored edge
    in the pool's edge list (for edge dropout)."""
    off, parts = 0, {k: [] for k in ("lab", "src", "dst", "et", "key", "tu", "tv")}
    for i, g in enumerate(graphs):
        n = len(g.node_label)
        parts["lab"].append(g.node_label)
        parts["src"].append(g.src + off)
        parts["dst"].append(g.dst + off)
        parts["et"].append(g.etype)
        first = 0 if edge_ids is None else int(edge_ids[i])
        parts["key"].append(first + np.arange(len(g.src)))
        parts["tu"].append(off)
        parts["tv"].append(off + g.num_u)
        off += n
    t = lambda a: torch.as_tensor(np.concatenate(a) if isinstance(a[0], np.ndarray)
                                  else np.array(a), dtype=torch.int64, device=device)
    return Batch(t(parts["lab"]), t(parts["src"]), t(parts["dst"]), t(parts["et"]),
                 t(parts["key"]), t(parts["tu"]), t(parts["tv"]),
                 torch.as_tensor(np.asarray(ys, np.float64), device=device))


def draw_noise(generator: torch.Generator, batch_size: int, model: dict):
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    keep = torch.rand(batch_size, model["hidden"], generator=generator) >= model["dropout"]
    return seed, keep


def hash_keep(seed: int, keys: torch.Tensor, p: float) -> torch.Tensor:
    k = keys.long()
    h = ((k & _LOW32) * 0x9E3779B9) & _LOW32
    h = (h + (int(seed) & _LOW32) + (k >> 32).clamp_min(0) * 0x27D4EB2F) & _LOW32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _LOW32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _LOW32
    h = h ^ (h >> 16)
    return h.double() * (1.0 / 4294967296.0) >= p


def relation_weights(p, i: int):
    att, basis = p[f"convs.{i}.att"], p[f"convs.{i}.basis"]
    nb, cin, cout = basis.shape
    return (att @ basis.reshape(nb, cin * cout)).reshape(-1, cin, cout)


def forward(p: dict, model: dict, b: Batch, feature_keep=None, edge_seed=None):
    """Predicted rating per graph. `feature_keep` [B, hidden] (training) turns
    on dropout after lin1; `edge_seed` with model['adj_dropout'] > 0 drops
    edges by the hash of each direction's key."""
    dt = p["lin1.weight"].dtype
    N = b.node_label.shape[0]
    x = torch.nn.functional.one_hot(b.node_label, model["num_features"]).to(dt)
    kf = kr = torch.ones_like(b.src, dtype=torch.bool)
    if edge_seed is not None and model["adj_dropout"] > 0:
        kf = hash_keep(edge_seed, 2 * b.edge_key, model["adj_dropout"])
        kr = hash_keep(edge_seed, 2 * b.edge_key + 1, model["adj_dropout"])
    deg = (torch.bincount(b.dst[kf], minlength=N)
           + torch.bincount(b.src[kr], minlength=N)).to(dt).clamp_min(1.0)
    rels = torch.unique(b.etype).tolist()
    states = []
    for i in range(len(model["latent_dim"])):
        W = relation_weights(p, i)
        agg = torch.zeros(N, W.shape[2], dtype=dt, device=x.device)
        for r in rels:
            of_r = b.etype == r
            f, rv = of_r & kf, of_r & kr
            agg = agg.index_add(0, b.dst[f], x[b.src[f]] @ W[r])
            agg = agg.index_add(0, b.src[rv], x[b.dst[rv]] @ W[r])
        x = torch.tanh(agg / deg[:, None] + x @ p[f"convs.{i}.root"]
                       + p[f"convs.{i}.bias"])
        states.append(x)
    s = torch.cat(states, dim=1)
    z = torch.cat([s[b.target_u], s[b.target_v]], dim=1)
    h = torch.relu(z @ p["lin1.weight"].T + p["lin1.bias"])
    if feature_keep is not None:
        keep = feature_keep.to(h.device)
        h = torch.where(keep, h / (1.0 - model["dropout"]), torch.zeros_like(h))
    return (h @ p["lin2.weight"].T + p["lin2.bias"])[:, 0] * model.get("multiply_by", 1.0)


def loss(p: dict, model: dict, b: Batch, feature_keep, edge_seed):
    pred = forward(p, model, b, feature_keep, edge_seed)
    mse = ((pred - b.y.to(pred.dtype)) ** 2).mean()
    reg = sum(((W[1:] - W[:-1]) ** 2).sum()
              for W in (relation_weights(p, i) for i in range(len(model["latent_dim"]))))
    return mse + model["arr"] * reg


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root), by hand."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = OrderedDict()
        for k, w in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            out[k] = w - self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps)
        return out


@dataclass
class TrainTrace:
    losses: List[float]
    first_grad: dict      # name -> tensor, the gradient of step 1
    change: dict          # name -> parameters after the steps minus before


def train_steps(p0: dict, model: dict, batches: Sequence[Batch], noises, lr: float):
    """Run len(batches) optimizer steps from parameters p0 (float tensors,
    the dtype the reference computes in); noises[i] = (edge seed, keep)."""
    params = OrderedDict((k, v.detach().clone()) for k, v in p0.items())
    opt = Adam(params, lr)
    losses, first = [], None
    for b, (seed, keep) in zip(batches, noises):
        leaves = OrderedDict((k, v.detach().requires_grad_(True)) for k, v in params.items())
        value = loss(leaves, model, b, keep, seed)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        losses.append(float(value.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        params = opt.step({k: v.detach() for k, v in leaves.items()}, grads)
    change = {k: params[k] - p0[k] for k in params}
    return TrainTrace(losses, first, change)
