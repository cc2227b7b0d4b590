"""Train/val/test split construction and training-adjacency assembly.

Port of igmc_tpu/data/splits.py (SplitData, _adjacency_values and
create_trainvaltest_split, without its pickle cache), keeping the
conventions RMSE parity depends on:

  * `class_values` = sorted unique original ratings; labels index into it.
  * The training adjacency stores `label + 1` so 0 can mean "no rating".
  * `testing=True` folds the validation links into the training set.
  * `rating_map` rebuckets raw ratings before label construction;
    `post_rating_map` rebuckets only the adjacency edge types.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .loaders import load_data


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


def create_trainvaltest_split(
    dataset: str,
    seed: int = 1234,
    testing: bool = False,
    verbose: bool = True,
    rating_map=None,
    post_rating_map=None,
    ratio: float = 1.0,
) -> SplitData:
    """Random 80/10/10-style split (ml_1m): the shuffled ratings are cut
    into train, validation (5% of the non-test part) and test (10%)."""
    (num_users, num_items, u_nodes, v_nodes, ratings,
     u_features, v_features) = load_data(dataset, seed=seed, verbose=verbose)

    if rating_map is not None:
        for i, x in enumerate(ratings):
            ratings[i] = rating_map[x]

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
