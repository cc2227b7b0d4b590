"""Deterministic synthetic MovieLens generators in the real file schemas.

Port of igmc_tpu/data/synthetic.py: for the same (sizes, seed) the files
are byte for byte the JAX package's. `write_ml1m_format`,
`write_ml25m_format` and `write_ml100k_format` write ml_1m/, ml_25m/ and
ml_100k/ under a root that `IGMC_RAW_DATA` can point at, so the loaders,
splits and CLIs run end to end without the real (downloaded) datasets.

Ratings carry a planted low-rank signal (user bias + item quality +
noise), so a model that learns drives RMSE below the marginal std.
"""

from __future__ import annotations

import os

import numpy as np

_GENRES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
_AGES = [1, 18, 25, 35, 45, 50, 56]

_OCCUPATIONS_100K = [
    "administrator", "artist", "doctor", "educator", "engineer",
    "entertainment", "executive", "healthcare", "homemaker", "lawyer",
    "librarian", "marketing", "none", "other", "programmer", "retired",
    "salesman", "scientist", "student", "technician", "writer",
]


def synthesize_ratings(n_users: int, n_movies: int, n_ratings: int,
                       seed: int = 0):
    """(u, m, r) arrays: power-law item popularity, lognormal user
    activity, ratings = clip(round(3 + quality_m + bias_u + noise), 1, 5).
    Pairs are unique per user."""
    rng = np.random.default_rng(seed)
    # item popularity ~ zipf-ish
    w = 1.0 / np.arange(1, n_movies + 1) ** 0.8
    w = rng.permutation(w)
    w /= w.sum()
    # user activity: lognormal, floor 5, scaled to the requested total
    act = np.exp(rng.normal(0.0, 1.0, n_users))
    act = np.maximum(5, act / act.sum() * n_ratings).astype(np.int64)
    act = np.minimum(act, n_movies)
    # planted signal
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
    r = np.clip(np.rint(3.0 + quality[m] + bias[u] + noise), 1, 5
                ).astype(np.int64)
    return u, m, r


def write_ml1m_format(out_root: str, n_users: int = 6040,
                      n_movies: int = 3952, n_ratings: int = 1_000_209,
                      seed: int = 0) -> str:
    """Write ml_1m/{ratings,movies,users}.dat under `out_root`; returns the
    dataset dir. Deterministic in (sizes, seed)."""
    data_dir = os.path.join(out_root, "ml_1m")
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed + 1)
    u, m, r = synthesize_ratings(n_users, n_movies, n_ratings, seed)

    ts = rng.integers(956_700_000, 1_046_400_000, len(u))
    with open(os.path.join(data_dir, "ratings.dat"), "w") as f:
        f.writelines(f"{uu + 1}::{mm + 1}::{rr}::{tt}\n"
                     for uu, mm, rr, tt in zip(u, m, r, ts))

    with open(os.path.join(data_dir, "movies.dat"), "w",
              encoding="latin-1") as f:
        for mm in range(n_movies):
            k = int(rng.integers(1, 4))
            gs = rng.choice(len(_GENRES), size=k, replace=False)
            genre = "|".join(_GENRES[g] for g in sorted(gs))
            f.write(f"{mm + 1}::Synthetic Movie {mm + 1} (199"
                    f"{mm % 10})::{genre}\n")

    with open(os.path.join(data_dir, "users.dat"), "w") as f:
        for uu in range(n_users):
            gender = "MF"[int(rng.integers(0, 2))]
            age = _AGES[int(rng.integers(0, len(_AGES)))]
            occ = int(rng.integers(0, 21))
            zipc = f"{int(rng.integers(0, 100000)):05d}"
            f.write(f"{uu + 1}::{gender}::{age}::{occ}::{zipc}\n")
    return data_dir


def write_ml25m_format(out_root: str, n_users: int = 162_541,
                       n_movies: int = 59_047, n_ratings: int = 25_000_095,
                       seed: int = 0) -> str:
    """Write ml_25m/movielens25M.csv under `out_root` in the pre-processed
    schema the loader streams (data/loaders.py ml_25m branch): header
    `uid,iid,cid,time,rating`, rows sorted by time (the ml_25m split is
    time-ordered). Ratings are on the half-star 0.5..5.0 scale like the
    real ML-25M. Deterministic in (sizes, seed)."""
    data_dir = os.path.join(out_root, "ml_25m")
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed + 3)
    u, m, r = synthesize_ratings(n_users, n_movies, n_ratings, seed)
    # half-star scale: jitter the planted 1..5 integer signal by ±0.5
    r = np.clip(r.astype(np.float64) + 0.5 * rng.integers(-1, 2, len(u)),
                0.5, 5.0)
    ts = np.sort(rng.integers(789_652_000, 1_574_300_000, len(u)))
    with open(os.path.join(data_dir, "movielens25M.csv"), "w") as f:
        f.write("uid,iid,cid,time,rating\n")
        f.writelines(
            f"{uu + 1},{mm + 1},0,{tt},{rr:g}\n"
            for uu, mm, rr, tt in zip(u, m, r, ts))
    return data_dir


def write_ml100k_format(out_root: str, n_users: int = 943,
                        n_movies: int = 1682, n_ratings: int = 100_000,
                        seed: int = 0) -> str:
    """Write ml_100k/{u.data,u1.base,u1.test,u.item,u.user} under
    `out_root` in the real tab/pipe schema the loaders parse
    (data/loaders.py ml_100k branch, data/splits.py official split).
    u1.base/u1.test is the official-style 80/20 carve of u.data.
    Deterministic in (sizes, seed)."""
    data_dir = os.path.join(out_root, "ml_100k")
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed + 2)
    u, m, r = synthesize_ratings(n_users, n_movies, n_ratings, seed)
    ts = rng.integers(874_700_000, 893_300_000, len(u))

    lines = [f"{uu + 1}\t{mm + 1}\t{rr}\t{tt}\n"
             for uu, mm, rr, tt in zip(u, m, r, ts)]
    order = rng.permutation(len(lines))
    n_base = int(len(lines) * 0.8)
    with open(os.path.join(data_dir, "u.data"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(data_dir, "u1.base"), "w") as f:
        f.writelines(lines[i] for i in order[:n_base])
    with open(os.path.join(data_dir, "u1.test"), "w") as f:
        f.writelines(lines[i] for i in order[n_base:])

    with open(os.path.join(data_dir, "u.item"), "w",
              encoding="latin-1") as f:
        for mm in range(n_movies):
            flags = np.zeros(19, np.int64)
            flags[rng.integers(0, 19, rng.integers(1, 3))] = 1
            f.write(f"{mm + 1}|Synthetic Movie {mm + 1} (1995)|"
                    f"01-Jan-1995||http://example.com|"
                    + "|".join(map(str, flags)) + "\n")

    with open(os.path.join(data_dir, "u.user"), "w") as f:
        for uu in range(n_users):
            age = int(rng.integers(18, 70))
            gender = "MF"[int(rng.integers(0, 2))]
            occ = _OCCUPATIONS_100K[int(rng.integers(
                0, len(_OCCUPATIONS_100K)))]
            zipc = f"{int(rng.integers(0, 100000)):05d}"
            f.write(f"{uu + 1}|{age}|{gender}|{occ}|{zipc}\n")
    return data_dir
