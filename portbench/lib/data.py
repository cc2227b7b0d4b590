"""The rating data of a configuration, made by the harness.

`ml1m_ratings` is a frozen copy of `synthesize_ratings` in
igmc_torch/data/synthetic.py at commit
ead40f2a1b0deed656f1008c591755b35d83b708 (the generator behind
raw_data_synth/ml_1m: the ML-1M schema at its published sizes), kept here
so that no later change to the program moves the data. Its output at
the configuration's sizes and ratings seed is frozen in
portbench/data/ml_1m/ratings.npz, which a run reads (`ratings_npz`)
instead of drawing a million ratings in every set-up (a test holds the
file to the generator). `yahoo_split` reads the frozen copy of
tests/torch_fixtures/monti/yahoo_music/training_test_dataset.npz (same
commit) under portbench/data/.

A `Split` holds what both the program and the reference are handed: the
training adjacency (users x items, value = rating label + 1, the
convention of the port's loaders), the rating levels, and the training
and held-out pairs with their labels.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(os.path.dirname(HERE), "data")


@dataclass
class Split:
    adj: sp.csr_matrix           # users x items, rating label + 1
    class_values: np.ndarray     # float64 rating levels
    train_u: np.ndarray          # int64
    train_v: np.ndarray
    train_label: np.ndarray      # int64 index into class_values
    test_u: np.ndarray
    test_v: np.ndarray
    test_label: np.ndarray

    @property
    def num_relations(self) -> int:
        return len(self.class_values)


def ml1m_ratings(n_users: int, n_movies: int, n_ratings: int, seed: int):
    """(u, m, r) arrays: power-law item popularity, lognormal user
    activity, ratings = clip(round(3 + quality_m + bias_u + noise), 1, 5).
    Pairs are unique per user."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_movies + 1) ** 0.8
    w = rng.permutation(w)
    w /= w.sum()
    act = np.exp(rng.normal(0.0, 1.0, n_users))
    act = np.maximum(5, act / act.sum() * n_ratings).astype(np.int64)
    act = np.minimum(act, n_movies)
    quality = rng.normal(0.0, 0.9, n_movies)
    bias = rng.normal(0.0, 0.4, n_users)

    us, ms = [], []
    for u in range(n_users):
        k = int(act[u])
        m = rng.choice(n_movies, size=k, replace=False, p=w)
        us.append(np.full(k, u, np.int64))
        ms.append(m.astype(np.int64))
    u = np.concatenate(us)
    m = np.concatenate(ms)
    noise = rng.normal(0.0, 0.7, len(u))
    r = np.clip(np.rint(3.0 + quality[m] + bias[u] + noise), 1, 5).astype(np.int64)
    return u, m, r


def _adjacency(u, v, label, shape) -> sp.csr_matrix:
    adj = sp.csr_matrix((label.astype(np.float64) + 1.0, (u, v)), shape=shape)
    adj.sort_indices()
    return adj


def _split(u, v, r, shape, test_share: float, split_seed: int) -> Split:
    """A random split of the ratings (u, v, r): `test_share` of them held
    out, the rest in the training adjacency."""
    class_values = np.unique(r).astype(np.float64)
    label = np.searchsorted(class_values, r).astype(np.int64)
    perm = np.random.default_rng(split_seed).permutation(len(u))
    n_test = int(round(test_share * len(u)))
    te, tr = perm[:n_test], perm[n_test:]
    return Split(_adjacency(u[tr], v[tr], label[tr], shape), class_values,
                 u[tr], v[tr], label[tr], u[te], v[te], label[te])


def frozen_ratings(data: dict):
    """(u, m, r) int64 arrays of the frozen ratings file `data['file']`."""
    with np.load(os.path.join(DATA_DIR, data["file"])) as z:
        return tuple(z[k].astype(np.int64) for k in ("user", "item", "rating"))


def ratings_split(data: dict) -> Split:
    """The frozen ratings (the ML-1M schema's, from the generator), split
    as the CLI's testing mode does (90 / 10)."""
    u, m, r = frozen_ratings(data)
    return _split(u, m, r, (data["num_users"], data["num_items"]),
                  data["test_share"], data["split_seed"])


def _coo(z, key):
    return (z[f"{key}.rows"].astype(np.int64), z[f"{key}.cols"].astype(np.int64),
            z[f"{key}.vals"])


def yahoo_split(data: dict) -> Split:
    """yahoo_music as the Monti loader reads it in testing mode: the
    Otraining pairs train, the Otest pairs are held out, the rating
    levels are the sorted distinct values of M."""
    path = os.path.join(DATA_DIR, data["file"])
    with np.load(path) as z:
        mu, mv, mr = _coo(z, "M")
        shape = tuple(int(s) for s in z["M.shape"])
        tru, trv, _ = _coo(z, "Otraining")
        teu, tev, _ = _coo(z, "Otest")
    rating = np.zeros(shape)
    rating[mu, mv] = mr
    class_values = np.unique(mr).astype(np.float64)
    lab = lambda u, v: np.searchsorted(class_values, rating[u, v]).astype(np.int64)
    tr_label, te_label = lab(tru, trv), lab(teu, tev)
    return Split(_adjacency(tru, trv, tr_label, shape), class_values,
                 tru, trv, tr_label, teu, tev, te_label)


SPLITS = {"ratings_npz": ratings_split, "monti_npz": yahoo_split}


def load_split(config: dict) -> Split:
    data = config["data"]
    return SPLITS[data["kind"]](data)


def train_pool(split: Split, pool, pool_seed: int):
    """The training pairs a training cell runs: the first `pool` of a
    permutation drawn from `pool_seed`, or every training pair (pool
    None). Fixed by the configuration, so every run seed trains on the
    same graphs in another order."""
    n = len(split.train_u)
    idx = (np.arange(n) if pool is None
           else np.sort(np.random.default_rng(pool_seed).permutation(n)[:pool]))
    return split.train_u[idx], split.train_v[idx], split.train_label[idx]
