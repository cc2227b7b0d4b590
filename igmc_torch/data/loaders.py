"""Raw MovieLens ratings loader with the CF-NADE shuffle and contiguous ids.

Port of igmc_tpu/data/loaders.py (raw_data_dir, map_data,
_cf_nade_shuffle and the ratings part of load_data's ml_1m branch),
parsed with NumPy instead of pandas. Side features (movies.dat,
users.dat) are not read yet: load_data returns None for both.

The raw data directory is `IGMC_RAW_DATA` when set, else `./raw_data`.
Nothing is downloaded: the files must be in place.
"""

from __future__ import annotations

import os
import random

import numpy as np


def raw_data_dir() -> str:
    """Directory holding raw dataset folders (ml_1m/, ...): the
    `IGMC_RAW_DATA` environment variable if set, else ./raw_data."""
    return os.environ.get("IGMC_RAW_DATA") or os.path.join(os.getcwd(),
                                                           "raw_data")


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


def _read_ml1m_ratings(path: str) -> np.ndarray:
    """ratings.dat (`user::movie::rating::timestamp` lines) as int64 [n, 4]."""
    with open(path, "rb") as f:
        raw = f.read()
    fields = np.array(raw.replace(b"::", b" ").split(), dtype=np.int64)
    if fields.size % 4:
        raise ValueError(f"{path}: expected 4 '::'-separated fields per line")
    return fields.reshape(-1, 4)


def load_data(fname: str, seed: int = 1234, verbose: bool = True):
    """Load a MovieLens dataset; returns
    (num_users, num_items, u_nodes, v_nodes, ratings, u_features, v_features).

    Only ml_1m's ratings are ported; u_features and v_features are None.
    """
    if fname != "ml_1m":
        raise NotImplementedError(
            f"igmc_torch loads ml_1m ratings only so far, not {fname!r}")
    path = os.path.join(raw_data_dir(), fname, "ratings.dat")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} not found: place the ml_1m files there or set "
            f"IGMC_RAW_DATA to the directory that contains ml_1m/")
    data_array = _cf_nade_shuffle(_read_ml1m_ratings(path), seed)
    u_nodes, _, num_users = map_data(data_array[:, 0])
    v_nodes, _, num_items = map_data(data_array[:, 1])
    ratings = data_array[:, 2].astype(np.float32)

    if verbose:
        print("Number of users = %d" % num_users)
        print("Number of items = %d" % num_items)
        print("Number of links = %d" % ratings.shape[0])
        print("Fraction of positive links = %.4f"
              % (float(ratings.shape[0]) / (num_users * num_items),))
    return num_users, num_items, u_nodes, v_nodes, ratings, None, None
