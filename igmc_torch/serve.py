"""Serving: trained checkpoint(s) -> ratings for arbitrary (user, item) pairs.

Port of igmc_tpu/serve.py (Predictor). One call runs the inductive
pipeline

    extract enclosing subgraphs (C++ engine by default) -> pack ->
    device-resident dense batches -> ensemble forward -> ratings

with the training side's own machinery, so served scores are what
`test_once` computes for the same pairs on the dense unified layout:
`StaticGraphDataset`, `DeviceDataset` + `assemble_dense` over
`plan_dense_buckets` buckets and `plan_dense_epoch` rows, and
`load_checkpoint` (reference `.pth` files or the JAX package's `.ckpt`).

IGMC is inductive (no per-user embeddings), so the predictor scores pairs
whose histories it never saw, cold-start pairs included, and can serve a
different rating graph than the checkpoint was trained on (transfer
serving): pass that graph's adjacency and the checkpoint's
num_relations / multiply_by in cfg, as `--transfer` does.

Divergences by design from the JAX Predictor: the port compiles no
program per shape, so the packed tables are not padded to a capacity
ladder (`_cap` / `_pad_packed` keep XLA's cache keys steady there); the
members of an ensemble run one after another per batch on the card and
are averaged there. With a `mesh` (parallel/mesh.py, one process per
device) every rank scores its B/D graphs of each batch and one all_gather
at the end gives every rank the whole array (the JAX Predictor shards the
gid block's graph axis over 'data').
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .batching.dataset import StaticGraphDataset, _densify
from .batching.dense import DenseBucket, plan_dense_buckets
from .batching.device_data import DeviceDataset
from .device import resolve_device
from .graphs.csr import BipartiteCSR
from .graphs.native import resolve_backend
from .models.igmc import IGMC
from .train.checkpoints import load_checkpoint, resolve_checkpoint
from .parallel.dp import rank_columns
from .train.loop import DensePass


class Predictor:
    """Batched rating prediction from a training adjacency + checkpoints.

    Parameters
    ----------
    adj : scipy.sparse matrix (users x items), values = rating label + 1
        — the training adjacency convention of `SplitData.adj_train`.
    class_values : np.ndarray of the original rating values.
    cfg : IGMCConfig the checkpoints were trained with; its compute_dtype
        and dense_strategy apply, as in the JAX Predictor (serving runs the
        unified layout, so every strategy can serve).
    checkpoints : `.pth` or `.ckpt` paths; several = prediction-averaged
        ensemble, exactly like `--ensemble`.
    params : alternatively, one in-memory state_dict.
    h / sample_ratio / max_nodes_per_hop / backend : extraction settings
        (must match training for distribution-consistent inputs); backend
        "auto" (the C++ engine if it builds, else NumPy), "numpy" or
        "native".
    u_features / v_features : side-feature matrices when cfg.side_features.
    slot_ladder : optional list of (node_slot, edge_slot) pairs to bucket
        queries into; default derives the buckets of each call's subgraphs.
    mesh : a parallel.mesh.Mesh for data-parallel serving (every rank of
        the group calls predict with the same pairs); batch_size must divide
        by its size. The predictor then runs on the mesh's device.
    compilation_cache_dir : accepted and unused: the port compiles no
        programs per shape (its kernels build once per source).
    device : "cuda" (default; raises without a card) or "cpu"; ignored
        with a mesh.
    """

    def __init__(self, adj, class_values, cfg, checkpoints=None,
                 params=None, h: int = 1, sample_ratio: float = 1.0,
                 max_nodes_per_hop: Optional[int] = None,
                 u_features=None, v_features=None, backend: str = "auto",
                 batch_size: int = 50,
                 slot_ladder: Optional[Sequence] = None, mesh=None,
                 compilation_cache_dir: Optional[str] = None,
                 device="cuda"):
        if (checkpoints is None) == (params is None):
            raise ValueError("pass exactly one of checkpoints / params")
        self.mesh = mesh
        if mesh is not None and int(batch_size) % mesh.size:
            raise ValueError(
                f"batch_size ({int(batch_size)}) must divide by the mesh "
                f"size ({mesh.size})")
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.adj = adj.tocsr()
        self._csr = BipartiteCSR(self.adj)
        self.class_values = np.asarray(class_values)
        self.cfg = cfg
        self.h = h
        self.sample_ratio = sample_ratio
        self.max_nodes_per_hop = max_nodes_per_hop
        self.u_features = _densify(u_features)
        self.v_features = _densify(v_features)
        self.backend = backend
        self.engine = resolve_backend(backend)
        self.batch_size = int(batch_size)
        self.slot_ladder = ([(int(n), int(e)) for n, e in slot_ladder]
                            if slot_ladder else None)
        self.params_list = ([params] if params is not None
                            else [load_checkpoint(c) for c in checkpoints])
        self._members = []
        for sd in self.params_list:
            model = IGMC(cfg, torch.Generator().manual_seed(0))
            model.load_state_dict(sd)
            self._members.append(model.to(self.device).eval())

    @classmethod
    def from_results_dir(cls, res_dir: str, adj, class_values, cfg,
                         epochs: int, interval: int = 10, span: int = 30,
                         **kw):
        """Ensemble predictor from a results directory, using the CLI's
        checkpoint range convention: epochs-span .. epochs step interval
        (existing files only)."""
        cks = [resolve_checkpoint(res_dir, "model", e)
               for e in range(epochs - span, epochs + 1, interval)]
        cks = [c for c in cks if os.path.isfile(c)]
        if not cks:
            raise FileNotFoundError(f"no model checkpoints in {res_dir}")
        return cls(adj, class_values, cfg, checkpoints=cks, **kw)

    def _buckets(self, ds):
        nc, ec = ds.node_counts(), ds.edge_counts() // 2
        if self.slot_ladder is None:
            return plan_dense_buckets(nc, ec)
        buckets = []
        taken = np.zeros(len(nc), bool)
        for n_slot, e_slot in sorted(self.slot_ladder):
            sel = (~taken) & (nc <= n_slot) & (ec <= e_slot)
            buckets.append(DenseBucket(int(n_slot), int(e_slot),
                                       np.nonzero(sel)[0]))
            taken |= sel
        if not taken.all():
            n, e = int(nc[~taken].max()), int(ec[~taken].max())
            raise ValueError(
                f"slot_ladder too small: a query subgraph needs "
                f"({n} nodes, {e} fwd edges)")
        return [b for b in buckets if len(b.indices)]

    def _check_pairs(self, users, items):
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        if users.shape != items.shape or users.ndim != 1:
            raise ValueError("users/items must be equal-length 1-D")
        nu, nv = self.adj.shape
        if len(users) and (users.min() < 0 or users.max() >= nu
                           or items.min() < 0 or items.max() >= nv):
            bad = np.nonzero((users < 0) | (users >= nu)
                             | (items < 0) | (items >= nv))[0]
            raise ValueError(
                f"{len(bad)} pair(s) out of range for the {nu}x{nv} "
                f"adjacency (first bad index {int(bad[0])}: "
                f"({int(users[bad[0]])}, {int(items[bad[0]])}))")
        return users, items

    def subgraphs(self, users, items) -> StaticGraphDataset:
        """The pairs' enclosing subgraphs in the serving adjacency, packed
        (host extraction: the first half of `predict`)."""
        users, items = self._check_pairs(users, items)
        # dummy labels: y never feeds a prediction
        return StaticGraphDataset(
            self._csr, (users, items), np.zeros(len(users), np.int64),
            h=self.h, sample_ratio=self.sample_ratio,
            max_nodes_per_hop=self.max_nodes_per_hop,
            u_features=self.u_features, v_features=self.v_features,
            class_values=self.class_values, backend=self.engine,
            progress=False)  # serving hot path: no heartbeat

    @torch.no_grad()
    def score(self, ds: StaticGraphDataset) -> np.ndarray:
        """Ensemble-mean ratings of a packed dataset's graphs, in its order
        (the device half of `predict`): the tables are uploaded once, each
        batch is assembled on the card, every member scores it there and
        the mean is scattered into place; one fetch at the end. With a mesh
        each rank scores its columns of every row, and the rows' means are
        all-gathered once."""
        G = len(ds)
        if G == 0:
            return np.zeros(0, np.float32)
        dd = DeviceDataset(ds.packed, self.device)
        # rows of plan_dense_epoch's [K, B] blocks in order: K only pads
        # with all-(-1) rows, which a DensePass drops
        rows = DensePass.plan(self._buckets(ds), self.batch_size, 1, self.device)
        cols = (slice(None) if self.mesh is None
                else rank_columns(self.mesh, self.batch_size))
        means = [torch.stack([m(batch) for m in self._members]).mean(0)
                 for batch in rows.batches(dd, cols=cols)]
        if self.mesh is not None:
            # [D * S, B/D] in rank order -> [S, B]: row i is rank 0's
            # columns of row i, then rank 1's, ...
            S = len(means)
            every = self.mesh.all_gather(torch.stack(means))
            means = list(every.reshape(self.mesh.size, S, -1).transpose(0, 1)
                         .reshape(S, -1))
        preds = torch.full((G + 1,), float("nan"), device=self.device)
        for gids, mean in zip(rows.gids, means):
            preds.index_copy_(0, torch.where(gids >= 0, gids, G), mean)
        return preds[:G].cpu().numpy()

    def predict(self, users, items) -> np.ndarray:
        """Ratings for the pairs (users[i], items[i]); shape [n] float32.

        Pairs are scored from their h-hop enclosing subgraphs in the
        SERVING adjacency; an edge between the target pair itself is
        removed before message passing (as in training), so observed pairs
        are scored as if held out."""
        users, items = self._check_pairs(users, items)
        if len(users) == 0:
            return np.zeros(0, np.float32)
        return self.score(self.subgraphs(users, items))
