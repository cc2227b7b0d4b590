"""Enclosing-subgraph extraction, written plainly in NumPy and Python.

The semantics of IGMC's extraction (Zhang & Chen, ICLR 2020) as the
port's C++ engine implements them (igmc_torch/native/extract.cpp at commit
ead40f2a1b0deed656f1008c591755b35d83b708): a 1..h-hop alternating walk
from the target (user, item); each hop's new users and new items in
ascending id order; a per-hop cap drawn without replacement by a partial
Fisher-Yates shuffle over that order from the link's own xoshiro256**
stream, the survivors sorted again; the target edge left out; node labels
2d for a user at hop d and 2d + 1 for an item; edge type = adjacency value
- 1. The stream of link i is keyed by (seed, stream id i), so the
reference draws the same nodes as the engine for the same link.

Edges are listed user row by user row, each row in the adjacency's
column order, as the engine lists them: the position of an edge in that
list is what the packed edge id of the program counts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

M64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15


def _splitmix(x: int):
    """(advanced state, output) of splitmix64."""
    x = (x + GOLDEN) & M64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return x, z ^ (z >> 31)


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & M64


class Xoshiro:
    """xoshiro256** with Lemire's unbiased bounded draw."""

    def __init__(self, seed: int):
        self.s = []
        for _ in range(4):
            seed, out = _splitmix(seed)
            self.s.append(out)

    def next(self) -> int:
        s = self.s
        result = (_rotl((s[1] * 5) & M64, 7) * 9) & M64
        t = (s[1] << 17) & M64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = _rotl(s[3], 45)
        return result

    def bounded(self, n: int) -> int:
        m = self.next() * n
        low = m & M64
        if low < n:
            t = ((1 << 64) - n) % n
            while low < t:
                m = self.next() * n
                low = m & M64
        return m >> 64


def link_stream(seed: int, stream_id: int) -> Xoshiro:
    x, s1 = _splitmix(seed & M64)
    _, start = _splitmix(s1 ^ ((stream_id * GOLDEN) & M64))
    return Xoshiro(start)


def _cap(fringe: np.ndarray, cap, rng: Xoshiro) -> np.ndarray:
    if cap is None or cap >= len(fringe):
        return fringe
    f = fringe.tolist()
    for i in range(cap):
        j = i + rng.bounded(len(f) - i)
        f[i], f[j] = f[j], f[i]
    return np.sort(np.array(f[:cap], dtype=np.int64))


@dataclass
class Graph:
    src: np.ndarray         # int64 [E] local user node
    dst: np.ndarray         # int64 [E] local item node (offset by num_u)
    etype: np.ndarray       # int64 [E]
    node_label: np.ndarray  # int64 [N]
    num_u: int


class Adjacency:
    """Both orientations of the training adjacency as CSR arrays."""

    def __init__(self, adj):
        a = adj.tocsr()
        a.sort_indices()
        c = a.tocsc()
        c.sort_indices()
        self.indptr, self.indices, self.data = a.indptr, a.indices, a.data
        self.cindptr, self.cindices = c.indptr, c.indices
        self.num_items = a.shape[1]

    def items_of(self, u):
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def users_of(self, v):
        return self.cindices[self.cindptr[v]:self.cindptr[v + 1]]


def extract(A: Adjacency, u: int, v: int, h: int, cap, rng: Xoshiro) -> Graph:
    users, items = [np.array([u])], [np.array([v])]
    u_dist, v_dist = [np.zeros(1, np.int64)], [np.zeros(1, np.int64)]
    seen_u, seen_v = np.array([u]), np.array([v])
    fu, fv = np.array([u]), np.array([v])
    for d in range(1, h + 1):
        reach_v = np.concatenate([A.items_of(x) for x in fu] + [np.zeros(0, np.int64)])
        reach_u = np.concatenate([A.users_of(y) for y in fv] + [np.zeros(0, np.int64)])
        nv = np.setdiff1d(reach_v.astype(np.int64), seen_v)
        nu = np.setdiff1d(reach_u.astype(np.int64), seen_u)
        seen_u, seen_v = np.union1d(seen_u, nu), np.union1d(seen_v, nv)
        nu = _cap(nu, cap, rng)
        nv = _cap(nv, cap, rng)
        if len(nu) == 0 and len(nv) == 0:
            break
        fu, fv = nu, nv
        users.append(nu)
        items.append(nv)
        u_dist.append(np.full(len(nu), d, np.int64))
        v_dist.append(np.full(len(nv), d, np.int64))
    users, items = np.concatenate(users), np.concatenate(items)
    nu_, nv_ = len(users), len(items)
    local_item = np.full(A.num_items, -1, np.int64)
    local_item[items] = np.arange(nv_)
    rows = [np.full(A.indptr[x + 1] - A.indptr[x], i, np.int64)
            for i, x in enumerate(users)]
    cols = np.concatenate([A.items_of(x) for x in users]).astype(np.int64)
    vals = np.concatenate([A.data[A.indptr[x]:A.indptr[x + 1]] for x in users])
    rows = np.concatenate(rows)
    j = local_item[cols]
    keep = (j >= 0) & ~((rows == 0) & (j == 0))
    label = np.concatenate([2 * np.concatenate(u_dist), 2 * np.concatenate(v_dist) + 1])
    return Graph(rows[keep], nu_ + j[keep], (vals[keep] - 1).astype(np.int64),
                 label, nu_)


def extract_links(A: Adjacency, us, vs, stream_ids, h: int, cap,
                  seed: int = 0):
    """The subgraph of each link (us[i], vs[i]) with stream stream_ids[i]."""
    return [extract(A, int(u), int(v), h, cap, link_stream(seed, int(s)))
            for u, v, s in zip(us, vs, stream_ids)]
