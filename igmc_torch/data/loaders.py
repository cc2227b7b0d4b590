"""Raw MovieLens loaders with the CF-NADE shuffle, contiguous ids and side
features.

Port of igmc_tpu/data/loaders.py (raw_data_dir, map_data,
_cf_nade_shuffle, the four side-feature builders and load_data's ml_100k,
ml_1m, ml_10m and ml_25m branches), parsed with NumPy and the standard
library instead of pandas:

  * ml_100k: `u.data` (tab-separated), genres from `u.item` and age,
    gender and occupations from `u.user` (`|`-separated, latin-1);
  * ml_1m: `ratings.dat` (`::`-separated), sorted genres from
    `movies.dat` and per-column one-hots from `users.dat` (zip code
    included), in `np.unique` order;
  * ml_10m: `ratings.dat` (half-star ratings), no side features;
  * ml_25m: the preprocessed `movielens25M.csv` (header `uid,iid,...,
    rating`, sorted by time), read in chunks of ML25M_CHUNK_ROWS rows.

The raw data directory is `IGMC_RAW_DATA` when set, else `./raw_data`.
Nothing is downloaded: a missing file raises FileNotFoundError naming it.
"""

from __future__ import annotations

import os
import random
import re
import warnings

import numpy as np
import scipy.sparse as sp

# Rows per chunk of the ml_25m CSV read (tests shrink it to force several
# chunks on small fixtures).
ML25M_CHUNK_ROWS = 1_000_000

# what pandas' parser reads as an integer column
_INT = re.compile(r"^\s*[+-]?\d+\s*$")


def raw_data_dir() -> str:
    """Directory holding raw dataset folders (ml_1m/, ...): the
    `IGMC_RAW_DATA` environment variable if set, else ./raw_data."""
    return os.environ.get("IGMC_RAW_DATA") or os.path.join(os.getcwd(),
                                                           "raw_data")


def _require(path: str) -> str:
    if not os.path.isfile(path):
        name = os.path.basename(os.path.dirname(path))
        raise FileNotFoundError(
            f"{path} not found: place the {name} files there or set "
            f"IGMC_RAW_DATA to the directory that contains {name}/ "
            f"(nothing is downloaded)")
    return path


def map_data(data):
    """Remap ids to contiguous [0, N) by sorted original id.

    Returns (mapped_array, id_dict, n): the new id is the rank of the old
    id in sorted-unique order."""
    uniq, inv = np.unique(np.asarray(data), return_inverse=True)
    id_dict = {old: new for new, old in enumerate(uniq.tolist())}
    return inv.astype(np.int64), id_dict, len(uniq)


def _cf_nade_shuffle(data_array: np.ndarray, seed) -> np.ndarray:
    """Rows of `data_array` in CF-NADE's shuffled order.

    The reference shuffles a Python list of rows with
    ``random.seed(seed); random.shuffle(rows)``. The permutation
    random.shuffle draws depends only on the length and the seed, so
    shuffling ``list(range(n))`` with the same seed gives the identical
    order; a private random.Random leaves the global stream untouched."""
    perm = list(range(len(data_array)))
    random.Random(seed).shuffle(perm)
    return data_array[np.asarray(perm, dtype=np.int64)]


def _read_numeric(path: str, sep: str, ncols: int) -> np.ndarray:
    """A file of `ncols` numbers per line, split on `sep` or whitespace,
    as float64 [n, ncols] (the common dtype pandas gives such a table)."""
    with open(_require(path)) as f:
        text = f.read()
    if sep != " ":
        text = text.replace(sep, " ")
    with warnings.catch_warnings():
        # numpy warns, and stops, at the first field that is not a number
        warnings.simplefilter("error", DeprecationWarning)
        try:
            fields = np.fromstring(text, dtype=np.float64, sep=" ")
        except DeprecationWarning:
            fields = np.zeros(1)
    if fields.size % ncols:
        raise ValueError(f"{path}: expected {ncols} numeric fields per line")
    return fields.reshape(-1, ncols)


def _read_rows(path: str, sep: str):
    """Non-empty lines of a latin-1 text table, split on `sep`."""
    with open(_require(path), encoding="latin-1") as f:
        return [line.rstrip("\r\n").split(sep) for line in f
                if line.strip()]


def _column(values):
    """A column's values typed as pandas reads them: int if every value is
    an integer literal (zip codes "02139" -> 2139), else str."""
    if all(_INT.match(v) for v in values):
        return [int(v) for v in values]
    return list(values)


def _movie_genre_features_100k(data_dir, v_dict, num_items):
    """The 18 genre flags of u.item (the columns after "unknown")."""
    rows = _read_rows(os.path.join(data_dir, "u.item"), "|")
    movie_ids = _column([r[0] for r in rows])
    flags = [_column([r[c] for r in rows]) for c in range(6, 24)]
    v_features = np.zeros((num_items, len(flags)), dtype=np.float32)
    for i, movie_id in enumerate(movie_ids):
        if movie_id in v_dict:
            v_features[v_dict[movie_id], :] = [col[i] for col in flags]
    return v_features


def _user_features_100k(data_dir, u_dict, num_users, normalize_age=False):
    """Age (over the oldest user's with `normalize_age`), gender (M 0, F 1)
    and a one-hot of the sorted occupations, from u.user."""
    rows = _read_rows(os.path.join(data_dir, "u.user"), "|")
    user_ids = _column([r[0] for r in rows])
    ages = _column([r[1] for r in rows])
    occupation = sorted(set(r[3] for r in rows))
    gender_dict = {"M": 0.0, "F": 1.0}
    occupation_dict = {f: i for i, f in enumerate(occupation, start=2)}
    age_max = max(ages) if normalize_age else 1.0
    u_features = np.zeros((num_users, 2 + len(occupation_dict)), dtype=np.float32)
    for u_id, age, r in zip(user_ids, ages, rows):
        if u_id in u_dict:
            u_features[u_dict[u_id], 0] = age / float(age_max)
            u_features[u_dict[u_id], 1] = gender_dict[r[2]]
            u_features[u_dict[u_id], occupation_dict[r[3]]] = 1.0
    return u_features


def _movie_genre_features_1m(data_dir, v_dict, num_items, sep="::"):
    """A one-hot of the sorted genres of movies.dat."""
    rows = _read_rows(os.path.join(data_dir, "movies.dat"), sep)
    movie_ids = _column([r[0] for r in rows])
    genre_strs = [r[-1] for r in rows]
    genres = sorted(set(g for s in genre_strs for g in s.split("|")))
    genres_dict = {g: idx for idx, g in enumerate(genres)}
    v_features = np.zeros((num_items, len(genres)), dtype=np.float32)
    for movie_id, s in zip(movie_ids, genre_strs):
        if movie_id in v_dict:
            for g in s.split("|"):
                v_features[v_dict[movie_id], genres_dict[g]] = 1.0
    return v_features


def _user_features_1m(data_dir, u_dict, num_users, sep="::"):
    """One one-hot block per column of users.dat (gender, age, occupation,
    zip code), each in np.unique order of that column's values."""
    rows = _read_rows(os.path.join(data_dir, "users.dat"), sep)
    user_ids = _column([r[0] for r in rows])
    cols = [_column([r[c] for r in rows]) for c in range(1, 5)]
    cntr = 0
    feat_dicts = []
    for values in cols:
        d = {f: i for i, f in enumerate(np.unique(values).tolist(), start=cntr)}
        feat_dicts.append(d)
        cntr += len(d)
    u_features = np.zeros((num_users, cntr), dtype=np.float32)
    for i, u_id in enumerate(user_ids):
        if u_id in u_dict:
            for k, values in enumerate(cols):
                u_features[u_dict[u_id], feat_dicts[k][values[i]]] = 1.0
    return u_features


def _read_ml25m(path: str):
    """(uid, iid, rating) columns of movielens25M.csv, read in chunks of
    ML25M_CHUNK_ROWS lines, each narrowed to typed arrays at once."""
    u_parts, v_parts, r_parts = [], [], []
    with open(_require(path)) as f:
        header = f.readline().strip().split(",")
        cu, cv, cr = (header.index(c) for c in ("uid", "iid", "rating"))
        while True:
            lines = [line for _, line in zip(range(ML25M_CHUNK_ROWS), f)]
            rows = [line.strip().split(",") for line in lines if line.strip()]
            if rows:
                u_parts.append(np.array([r[cu] for r in rows], dtype=np.int64))
                v_parts.append(np.array([r[cv] for r in rows], dtype=np.int64))
                r_parts.append(np.array([r[cr] for r in rows], dtype=np.float32))
            if len(lines) < ML25M_CHUNK_ROWS:
                break
    if not u_parts:
        raise ValueError(f"{path}: no ratings")
    return (np.concatenate(u_parts), np.concatenate(v_parts),
            np.concatenate(r_parts))


def load_data(fname: str, seed: int = 1234, verbose: bool = True):
    """Load a MovieLens dataset; returns
    (num_users, num_items, u_nodes, v_nodes, ratings, u_features, v_features),
    the features as scipy CSR matrices (None for ml_10m and ml_25m).

    ml_100k keeps the reference's dtypes: v_nodes int32, ratings float64
    (the labels are built from them)."""
    u_features = v_features = None
    data_dir = os.path.join(raw_data_dir(), fname)

    if fname == "ml_100k":
        data = _cf_nade_shuffle(
            _read_numeric(os.path.join(data_dir, "u.data"), " ", 4), seed)
        u_nodes, u_dict, num_users = map_data(data[:, 0].astype(np.int32))
        v_nodes, v_dict, num_items = map_data(data[:, 1].astype(np.int32))
        u_nodes = u_nodes.astype(np.int64)
        v_nodes = v_nodes.astype(np.int32)
        ratings = data[:, 2].astype(np.float32).astype(np.float64)
        v_features = sp.csr_matrix(
            _movie_genre_features_100k(data_dir, v_dict, num_items))
        u_features = sp.csr_matrix(
            _user_features_100k(data_dir, u_dict, num_users, normalize_age=False))

    elif fname in ("ml_1m", "ml_10m"):
        data = _cf_nade_shuffle(
            _read_numeric(os.path.join(data_dir, "ratings.dat"), "::", 4), seed)
        u_nodes, u_dict, num_users = map_data(data[:, 0].astype(np.int64))
        v_nodes, v_dict, num_items = map_data(data[:, 1].astype(np.int64))
        ratings = data[:, 2].astype(np.float32)
        if fname == "ml_1m":
            v_features = sp.csr_matrix(
                _movie_genre_features_1m(data_dir, v_dict, num_items))
            u_features = sp.csr_matrix(
                _user_features_1m(data_dir, u_dict, num_users))

    elif fname == "ml_25m":
        us, vs, rs = _read_ml25m(os.path.join(data_dir, "movielens25M.csv"))
        u_nodes, _, num_users = map_data(us)
        v_nodes, _, num_items = map_data(vs)
        ratings = rs.astype(np.float32)

    else:
        raise ValueError("Dataset name not recognized: " + fname)

    if verbose:
        print("Number of users = %d" % num_users)
        print("Number of items = %d" % num_items)
        print("Number of links = %d" % ratings.shape[0])
        print("Fraction of positive links = %.4f"
              % (float(ratings.shape[0]) / (num_users * num_items),))
    return num_users, num_items, u_nodes, v_nodes, ratings, u_features, v_features
