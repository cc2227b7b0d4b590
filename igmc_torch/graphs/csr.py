"""Flat CSR/CSC views of the bipartite rating matrix for fast BFS extraction.

Port of igmc_tpu/graphs/csr.py. The raw CSR arrays (indptr/indices/data)
are kept for both orientations, and multi-row gathers are fully vectorized
with `np.repeat` arithmetic: no Python-level loop, no object arrays.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class BipartiteCSR:
    """Both orientations of a users x items rating matrix, as flat arrays.

    Values follow the reference convention: rating-label + 1 (0 = no edge).
    """

    __slots__ = (
        "num_users", "num_items",
        "u_indptr", "u_indices", "u_data",   # row-major: user -> (item, value)
        "v_indptr", "v_indices", "v_data",   # col-major: item -> (user, value)
    )

    def __init__(self, A: sp.csr_matrix):
        A = A.tocsr()
        Ac = A.tocsc()
        self.num_users, self.num_items = A.shape
        self.u_indptr = A.indptr.astype(np.int64)
        self.u_indices = A.indices.astype(np.int32)
        self.u_data = A.data.astype(np.float32)
        self.v_indptr = Ac.indptr.astype(np.int64)
        self.v_indices = Ac.indices.astype(np.int32)
        self.v_data = Ac.data.astype(np.float32)

    # -- vectorized multi-row gathers ------------------------------------

    @staticmethod
    def _gather(rows: np.ndarray, indptr: np.ndarray, arr: np.ndarray) -> np.ndarray:
        """Concatenate arr[indptr[r]:indptr[r+1]] for every r in rows, vectorized."""
        starts = indptr[rows]
        counts = indptr[rows + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, dtype=arr.dtype)
        # position within the output -> position within arr
        offs = np.repeat(np.cumsum(counts) - counts, counts)
        idx = np.repeat(starts, counts) + (np.arange(total, dtype=np.int64) - offs)
        return arr[idx]

    def user_neighbors(self, users: np.ndarray) -> np.ndarray:
        """All items adjacent to any of `users` (with multiplicity)."""
        return self._gather(users, self.u_indptr, self.u_indices)

    def item_neighbors(self, items: np.ndarray) -> np.ndarray:
        """All users adjacent to any of `items` (with multiplicity)."""
        return self._gather(items, self.v_indptr, self.v_indices)

    def user_rows(self, users: np.ndarray):
        """(repeated_local_row, item_col, value) triples of the selected rows.

        `repeated_local_row` indexes into `users` (0..len(users)-1).
        """
        starts = self.u_indptr[users]
        counts = (self.u_indptr[users + 1] - starts).astype(np.int64)
        cols = self._gather(users, self.u_indptr, self.u_indices)
        vals = self._gather(users, self.u_indptr, self.u_data)
        rows = np.repeat(np.arange(len(users), dtype=np.int32), counts)
        return rows, cols, vals
