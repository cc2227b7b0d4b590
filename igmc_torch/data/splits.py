"""Train/val/test split construction and training-adjacency assembly.

Port of igmc_tpu/data/splits.py (SplitData, _adjacency_values,
_carve_and_build, load_data_monti, load_official_trainvaltest_split and
create_trainvaltest_split with the ml_25m time split and the split
pickle cache), keeping the conventions RMSE parity depends on:

  * `class_values` = sorted unique original ratings; labels index into it.
  * The training adjacency stores `label + 1` so 0 can mean "no rating".
  * `testing=True` folds the validation links into the training set.
  * `rating_map` rebuckets raw ratings before label construction;
    `post_rating_map` rebuckets only the adjacency edge types.
  * The Monti and official splits shuffle their training links with the
    stream of np.random.seed(42) (a private RandomState(42) here, which
    draws the same permutation and leaves the global stream alone).

The Monti datasets' MATLAB v7.3 files are read by data/matio.py, without
h5py.
"""

from __future__ import annotations

import os
import pickle as pkl
from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .loaders import (_movie_genre_features_100k, _movie_genre_features_1m,
                      _read_numeric, _require, _user_features_100k, _user_features_1m,
                      load_data, map_data, raw_data_dir)
from .matio import load_matlab_file

MONTI_DATASETS = ("flixster", "douban", "yahoo_music")


@dataclass
class SplitData:
    """All artifacts needed to build subgraph datasets for one experiment."""

    u_features: Optional[sp.csr_matrix]
    v_features: Optional[sp.csr_matrix]
    adj_train: sp.csr_matrix  # values are rating-label + 1 (0 = no rating)
    train_labels: np.ndarray
    train_u_indices: np.ndarray
    train_v_indices: np.ndarray
    val_labels: np.ndarray
    val_u_indices: np.ndarray
    val_v_indices: np.ndarray
    test_labels: np.ndarray
    test_u_indices: np.ndarray
    test_v_indices: np.ndarray
    class_values: np.ndarray  # original continuous ratings, sorted ascending


def _adjacency_values(labels_in_adj, class_values, post_rating_map):
    """Edge values for the training adjacency: label+1, optionally rebucketed."""
    if post_rating_map is None:
        return labels_in_adj.astype(np.float32) + 1.0
    return (
        np.array([post_rating_map[r] for r in class_values[labels_in_adj]]) + 1.0
    ).astype(np.float32)


def _carve_and_build(labels, idx_nonzero_train, pairs_nonzero_train,
                     idx_nonzero_test, pairs_nonzero_test,
                     num_train, num_val, num_test, testing,
                     class_values, post_rating_map, num_users, num_items):
    """The split tail of the Monti and official loaders: the seed-42
    shuffle of the training links, the validation carve, the testing-mode
    fold of the validation links, and the training adjacency (label + 1,
    optionally post_rating_map-rebucketed).

    Returns (train_labels, u_train, v_train, val_labels, u_val, v_val,
    test_labels, u_test, v_test, rating_mx_train)."""
    rand_idx = list(range(len(idx_nonzero_train)))
    np.random.RandomState(42).shuffle(rand_idx)
    idx_nonzero_train = idx_nonzero_train[rand_idx]
    pairs_nonzero_train = pairs_nonzero_train[rand_idx]

    idx_nonzero = np.concatenate([idx_nonzero_train, idx_nonzero_test], axis=0)
    pairs_nonzero = np.concatenate([pairs_nonzero_train, pairs_nonzero_test], axis=0)

    val_idx = idx_nonzero[0:num_val]
    train_idx = idx_nonzero[num_val : num_train + num_val]
    test_idx = idx_nonzero[num_train + num_val :]
    if len(test_idx) != num_test:
        raise ValueError(f"{len(test_idx)} test links, expected {num_test}")

    val_pairs_idx = pairs_nonzero[0:num_val]
    train_pairs_idx = pairs_nonzero[num_val : num_train + num_val]
    test_pairs_idx = pairs_nonzero[num_train + num_val :]

    u_test_idx, v_test_idx = test_pairs_idx.transpose()
    u_val_idx, v_val_idx = val_pairs_idx.transpose()
    u_train_idx, v_train_idx = train_pairs_idx.transpose()

    train_labels = labels[train_idx]
    val_labels = labels[val_idx]
    test_labels = labels[test_idx]

    if testing:
        u_train_idx = np.hstack([u_train_idx, u_val_idx])
        v_train_idx = np.hstack([v_train_idx, v_val_idx])
        train_labels = np.hstack([train_labels, val_labels])
        train_idx = np.hstack([train_idx, val_idx])

    rating_mx_train = np.zeros(num_users * num_items, dtype=np.float32)
    rating_mx_train[train_idx] = _adjacency_values(
        labels[train_idx], class_values, post_rating_map)
    rating_mx_train = sp.csr_matrix(rating_mx_train.reshape(num_users, num_items))

    return (train_labels, u_train_idx, v_train_idx,
            val_labels, u_val_idx, v_val_idx,
            test_labels, u_test_idx, v_test_idx, rating_mx_train)


def load_data_monti(
    dataset: str,
    testing: bool = False,
    rating_map=None,
    post_rating_map=None,
) -> SplitData:
    """flixster, douban or yahoo_music from
    <raw_data_dir()>/<dataset>/training_test_dataset.mat: the Otraining /
    Otest masks give the training and test links, and 20% of the training
    links (after the seed-42 shuffle) become validation. Side features are
    the datasets' graphs: W_users and W_movies (flixster), W_users and an
    identity (douban), an identity and W_tracks (yahoo_music)."""
    if dataset not in MONTI_DATASETS:
        raise ValueError(f"Unknown Monti dataset {dataset}")
    path_dataset = _require(os.path.join(raw_data_dir(), dataset,
                                         "training_test_dataset.mat"))

    M = load_matlab_file(path_dataset, "M")
    if rating_map is not None:
        M[np.where(M)] = [rating_map[x] for x in M[np.where(M)]]

    Otraining = load_matlab_file(path_dataset, "Otraining")
    Otest = load_matlab_file(path_dataset, "Otest")

    num_users, num_items = M.shape

    if dataset == "flixster":
        u_features = load_matlab_file(path_dataset, "W_users")
        v_features = load_matlab_file(path_dataset, "W_movies")
    elif dataset == "douban":
        u_features = load_matlab_file(path_dataset, "W_users")
        v_features = np.eye(num_items, dtype=np.float32)
    else:
        u_features = np.eye(num_users, dtype=np.float32)
        v_features = load_matlab_file(path_dataset, "W_tracks")

    u_nodes, v_nodes = np.where(M)
    ratings = M[np.where(M)].astype(np.float64)
    u_nodes = u_nodes.astype(np.int64)
    v_nodes = v_nodes.astype(np.int32)

    rating_dict = {r: i for i, r in enumerate(np.sort(np.unique(ratings)).tolist())}
    labels = np.full((num_users, num_items), -1, dtype=np.int32)
    labels[u_nodes, v_nodes] = np.array([rating_dict[r] for r in ratings])
    labels = labels.reshape(-1)

    num_train = np.where(Otraining)[0].shape[0]
    num_test = np.where(Otest)[0].shape[0]
    num_val = int(np.ceil(num_train * 0.2))
    num_train = num_train - num_val

    pairs_nonzero_train = np.stack(np.where(Otraining), axis=1)
    idx_nonzero_train = (pairs_nonzero_train[:, 0] * num_items
                         + pairs_nonzero_train[:, 1])
    pairs_nonzero_test = np.stack(np.where(Otest), axis=1)
    idx_nonzero_test = pairs_nonzero_test[:, 0] * num_items + pairs_nonzero_test[:, 1]

    class_values = np.sort(np.unique(ratings))

    (train_labels, u_train_idx, v_train_idx,
     val_labels, u_val_idx, v_val_idx,
     test_labels, u_test_idx, v_test_idx, rating_mx_train) = _carve_and_build(
        labels, idx_nonzero_train, pairs_nonzero_train,
        idx_nonzero_test, pairs_nonzero_test,
        num_train, num_val, num_test, testing,
        class_values, post_rating_map, num_users, num_items,
    )

    return SplitData(
        u_features=sp.csr_matrix(u_features),
        v_features=sp.csr_matrix(v_features),
        adj_train=rating_mx_train,
        train_labels=train_labels,
        train_u_indices=u_train_idx,
        train_v_indices=v_train_idx,
        val_labels=val_labels,
        val_u_indices=u_val_idx,
        val_v_indices=v_val_idx,
        test_labels=test_labels,
        test_u_indices=u_test_idx,
        test_v_indices=v_test_idx,
        class_values=class_values,
    )


def load_official_trainvaltest_split(
    dataset: str,
    testing: bool = False,
    rating_map=None,
    post_rating_map=None,
    ratio: float = 1.0,
) -> SplitData:
    """The official u1.base / u1.test split (ml_100k) with 20% of the
    training links as validation; `ratio` < 1 keeps the earliest training
    ratings by timestamp. Side features come with it (ml_100k's age
    normalised by the oldest user's)."""
    data_dir = os.path.join(raw_data_dir(), dataset)
    data_array_train = _read_numeric(os.path.join(data_dir, "u1.base"), " ", 4)
    data_array_test = _read_numeric(os.path.join(data_dir, "u1.test"), " ", 4)

    if ratio < 1.0:
        data_array_train = data_array_train[
            data_array_train[:, -1].argsort()[: int(ratio * len(data_array_train))]
        ]

    data_array = np.concatenate([data_array_train, data_array_test], axis=0)
    u_nodes_ratings = data_array[:, 0].astype(np.int32)
    v_nodes_ratings = data_array[:, 1].astype(np.int32)
    ratings = data_array[:, 2].astype(np.float32)
    if rating_map is not None:
        for i, x in enumerate(ratings):
            ratings[i] = rating_map[x]

    u_nodes_ratings, u_dict, num_users = map_data(u_nodes_ratings)
    v_nodes_ratings, v_dict, num_items = map_data(v_nodes_ratings)
    u_nodes = u_nodes_ratings.astype(np.int64)
    v_nodes = v_nodes_ratings.astype(np.int32)
    ratings = ratings.astype(np.float64)

    rating_dict = {r: i for i, r in enumerate(np.sort(np.unique(ratings)).tolist())}
    labels = np.full((num_users, num_items), -1, dtype=np.int32)
    labels[u_nodes, v_nodes] = np.array([rating_dict[r] for r in ratings])
    labels = labels.reshape(-1)

    num_train = data_array_train.shape[0]
    num_test = data_array_test.shape[0]
    num_val = int(np.ceil(num_train * 0.2))
    num_train = num_train - num_val

    pairs_nonzero = np.stack([u_nodes, v_nodes.astype(np.int64)], axis=1)
    idx_nonzero = pairs_nonzero[:, 0] * num_items + pairs_nonzero[:, 1]

    idx_nonzero_train = idx_nonzero[0 : num_train + num_val]
    idx_nonzero_test = idx_nonzero[num_train + num_val :]
    pairs_nonzero_train = pairs_nonzero[0 : num_train + num_val]
    pairs_nonzero_test = pairs_nonzero[num_train + num_val :]

    class_values = np.sort(np.unique(ratings))

    (train_labels, u_train_idx, v_train_idx,
     val_labels, u_val_idx, v_val_idx,
     test_labels, u_test_idx, v_test_idx, rating_mx_train) = _carve_and_build(
        labels, idx_nonzero_train, pairs_nonzero_train,
        idx_nonzero_test, pairs_nonzero_test,
        num_train, num_val, num_test, testing,
        class_values, post_rating_map, num_users, num_items,
    )

    if dataset == "ml_100k":
        v_features = _movie_genre_features_100k(data_dir, v_dict, num_items)
        u_features = _user_features_100k(data_dir, u_dict, num_users,
                                         normalize_age=True)
    elif dataset == "ml_1m":
        v_features = _movie_genre_features_1m(data_dir, v_dict, num_items)
        u_features = _user_features_1m(data_dir, u_dict, num_users)
    else:
        raise ValueError(f"Invalid dataset option {dataset}")

    return SplitData(
        u_features=sp.csr_matrix(u_features),
        v_features=sp.csr_matrix(v_features),
        adj_train=rating_mx_train,
        train_labels=train_labels,
        train_u_indices=u_train_idx,
        train_v_indices=v_train_idx,
        val_labels=val_labels,
        val_u_indices=u_val_idx,
        val_v_indices=v_val_idx,
        test_labels=test_labels,
        test_u_indices=u_test_idx,
        test_v_indices=v_test_idx,
        class_values=class_values,
    )


def create_trainvaltest_split(
    dataset: str,
    seed: int = 1234,
    testing: bool = False,
    datasplit_path: Optional[str] = None,
    datasplit_from_file: bool = False,
    verbose: bool = True,
    rating_map=None,
    post_rating_map=None,
    ratio: float = 1.0,
) -> SplitData:
    """Random split (ml_1m, ml_10m): the shuffled ratings are cut into
    train, validation (5% of the non-test part) and test (10%); ml_25m's
    time-ordered ratings are cut 70 / 10 / 20 in order.

    `datasplit_path` names the split pickle: the raw shuffled load
    [num_users, num_items, u_nodes, v_nodes, ratings, u_features,
    v_features] (numpy and scipy objects, so either package reads the
    other's), read instead of the raw files when it exists and
    `datasplit_from_file`, else written after loading."""
    if datasplit_from_file and datasplit_path and os.path.isfile(datasplit_path):
        print("Reading processed dataset from file...")
        with open(datasplit_path, "rb") as f:
            (num_users, num_items, u_nodes, v_nodes, ratings,
             u_features, v_features) = pkl.load(f)
        if verbose:
            print("Number of users = %d" % num_users)
            print("Number of items = %d" % num_items)
            print("Number of links = %d" % ratings.shape[0])
            print("Fraction of positive links = %.4f"
                  % (float(ratings.shape[0]) / (num_users * num_items),))
    else:
        (num_users, num_items, u_nodes, v_nodes, ratings,
         u_features, v_features) = load_data(dataset, seed=seed, verbose=verbose)
        if datasplit_path:
            os.makedirs(os.path.dirname(datasplit_path) or ".", exist_ok=True)
            with open(datasplit_path, "wb") as f:
                pkl.dump([num_users, num_items, u_nodes, v_nodes, ratings,
                          u_features, v_features], f)

    if rating_map is not None:
        for i, x in enumerate(ratings):
            ratings[i] = rating_map[x]

    if dataset == "ml_25m":
        print("Split dataset into train/val/test by time ...")
        num_train = int(ratings.shape[0] * 0.7)
        num_val = int(ratings.shape[0] * 0.8) - num_train
        num_test = ratings.shape[0] - num_train - num_val
    else:
        print("Using random dataset split ...")
        num_test = int(np.ceil(ratings.shape[0] * 0.1))
        num_val = int(np.ceil(ratings.shape[0] * 0.9 * 0.05))
        num_train = ratings.shape[0] - num_val - num_test

    pairs_nonzero = np.vstack([u_nodes, v_nodes]).transpose()

    train_pairs_idx = pairs_nonzero[0 : int(num_train * ratio)]
    val_pairs_idx = pairs_nonzero[num_train : num_train + num_val]
    test_pairs_idx = pairs_nonzero[num_train + num_val :]

    u_test_idx, v_test_idx = test_pairs_idx.transpose()
    u_val_idx, v_val_idx = val_pairs_idx.transpose()
    u_train_idx, v_train_idx = train_pairs_idx.transpose()

    # label = rank of the rating among the sorted unique ratings
    class_values = np.sort(np.unique(ratings))
    all_labels = np.searchsorted(class_values, ratings).astype(np.int32)
    train_labels = all_labels[0 : int(num_train * ratio)]
    val_labels = all_labels[num_train : num_train + num_val]
    test_labels = all_labels[num_train + num_val :]

    if testing:
        u_train_idx = np.hstack([u_train_idx, u_val_idx])
        v_train_idx = np.hstack([v_train_idx, v_val_idx])
        train_labels = np.hstack([train_labels, val_labels])

    data = _adjacency_values(train_labels, class_values, post_rating_map)
    rating_mx_train = sp.csr_matrix(
        (data, [u_train_idx, v_train_idx]),
        shape=[num_users, num_items], dtype=np.float32,
    )

    return SplitData(
        u_features=u_features,
        v_features=v_features,
        adj_train=rating_mx_train,
        train_labels=train_labels,
        train_u_indices=u_train_idx,
        train_v_indices=v_train_idx,
        val_labels=val_labels,
        val_u_indices=u_val_idx,
        val_v_indices=v_val_idx,
        test_labels=test_labels,
        test_u_indices=u_test_idx,
        test_v_indices=v_test_idx,
        class_values=class_values,
    )
