"""Enclosing-subgraph extraction with hop/side node labeling (NumPy engine).

Port of igmc_tpu/graphs/extract.py:

  * h-hop alternating BFS from the target (user, item) pair — user fringe
    expands through item columns, item fringe through user rows.
  * optional per-hop subsampling: `sample_ratio` < 1 keeps
    int(ratio * |fringe|) nodes; `max_nodes_per_hop` caps the fringe.
  * the target edge itself is removed from the subgraph.
  * node labels: user at hop d -> 2d, item at hop d -> 2d+1; the one-hot of
    this label (dimension 2h+2) is the node feature.
  * edge types are rating labels (adjacency stores label+1; we subtract 1).
  * y = class_values[label] — the original continuous rating.
  * optional side features: only the target user / target item rows.

`extract_many` runs this NumPy engine or the C++ engine
(graphs/native.py), as `backend` says: "numpy", "native" (raises if the
engine cannot be built or loaded) or "auto" (native if it builds, else
NumPy; the JAX package's default). The NumPy engine draws its subsampling
from a per-link stream keyed by SeedSequence([seed, stream id]), the C++
engine from its own per-link xoshiro stream: without subsampling both
give identical subgraphs, and when `max_nodes_per_hop` or `sample_ratio`
binds, each gives the JAX package's engine of the same name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .csr import BipartiteCSR


@dataclass
class Subgraph:
    """One enclosing subgraph in node-local coordinates.

    Edges are stored once in the forward (user -> item) direction;
    undirected doubling happens at batch construction.

    Node order: [target_user, hop-1 users, ..., target_item, hop-1 items, ...]
    with items offset by num_u, so node 0 is the target user and node num_u
    is the target item.
    """

    src: np.ndarray          # int32 [E] local user-node index
    dst: np.ndarray          # int32 [E] local item-node index (already offset by num_u)
    etype: np.ndarray        # int32 [E] rating label (0-based)
    node_label: np.ndarray   # int32 [N] hop/side label (user: 2d, item: 2d+1)
    num_u: int               # number of user nodes
    num_v: int               # number of item nodes
    y: float                 # regression target (original rating value)
    u_feat: Optional[np.ndarray] = None  # float32 [du] target-user side features
    v_feat: Optional[np.ndarray] = None  # float32 [dv] target-item side features

    @property
    def num_nodes(self) -> int:
        return self.num_u + self.num_v

    @property
    def num_edges(self) -> int:
        """Directed edge count after doubling (2x stored forward edges)."""
        return 2 * len(self.src)


def _subsample(fringe: np.ndarray, sample_ratio: float,
               max_nodes_per_hop: Optional[int], rng: np.random.Generator):
    if sample_ratio < 1.0:
        k = int(sample_ratio * len(fringe))
        fringe = rng.choice(fringe, size=k, replace=False) if k < len(fringe) else fringe
    if max_nodes_per_hop is not None and max_nodes_per_hop < len(fringe):
        fringe = rng.choice(fringe, size=max_nodes_per_hop, replace=False)
    return fringe


def extract_subgraph(
    u: int,
    v: int,
    A: BipartiteCSR,
    h: int = 1,
    sample_ratio: float = 1.0,
    max_nodes_per_hop: Optional[int] = None,
    u_features: Optional[np.ndarray] = None,
    v_features: Optional[np.ndarray] = None,
    class_values: Optional[np.ndarray] = None,
    label: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> Subgraph:
    """Extract the h-hop enclosing subgraph around the link (u, v)."""
    if rng is None:
        rng = np.random.default_rng(0)

    u_nodes = [np.array([u], dtype=np.int64)]
    v_nodes = [np.array([v], dtype=np.int64)]
    u_dist = [np.zeros(1, dtype=np.int32)]
    v_dist = [np.zeros(1, dtype=np.int32)]
    u_visited = {u}
    v_visited = {v}
    u_fringe = np.array([u], dtype=np.int64)
    v_fringe = np.array([v], dtype=np.int64)

    for dist in range(1, h + 1):
        # Alternating BFS: users reach items via rows, items reach users via cols.
        new_v = np.unique(A.user_neighbors(u_fringe)).astype(np.int64)
        new_u = np.unique(A.item_neighbors(v_fringe)).astype(np.int64)
        # Drop already-visited nodes.
        new_u = new_u[~np.isin(new_u, np.fromiter(u_visited, dtype=np.int64,
                                                  count=len(u_visited)))]
        new_v = new_v[~np.isin(new_v, np.fromiter(v_visited, dtype=np.int64,
                                                  count=len(v_visited)))]
        u_visited.update(new_u.tolist())
        v_visited.update(new_v.tolist())

        new_u = _subsample(new_u, sample_ratio, max_nodes_per_hop, rng)
        new_v = _subsample(new_v, sample_ratio, max_nodes_per_hop, rng)
        if len(new_u) == 0 and len(new_v) == 0:
            break
        u_fringe, v_fringe = new_u, new_v
        u_nodes.append(new_u)
        v_nodes.append(new_v)
        u_dist.append(np.full(len(new_u), dist, dtype=np.int32))
        v_dist.append(np.full(len(new_v), dist, dtype=np.int32))

    u_nodes = np.concatenate(u_nodes)
    v_nodes = np.concatenate(v_nodes)
    u_dist = np.concatenate(u_dist)
    v_dist = np.concatenate(v_dist)
    num_u, num_v = len(u_nodes), len(v_nodes)

    # Slice the bipartite submatrix A[u_nodes][:, v_nodes] in one vectorized
    # pass: gather all rows, then keep entries whose column is selected.
    rows, cols, vals = A.user_rows(u_nodes)
    col_map = np.full(A.num_items, -1, dtype=np.int32)
    col_map[v_nodes] = np.arange(num_v, dtype=np.int32)
    local_cols = col_map[cols]
    keep = local_cols >= 0
    src = rows[keep]
    dst = local_cols[keep]
    r = vals[keep]

    # Remove the target edge (local (0, 0)).
    keep = ~((src == 0) & (dst == 0))
    src, dst, r = src[keep], dst[keep], r[keep]

    etype = (r - 1.0).astype(np.int32)  # adjacency stores label + 1
    node_label = np.concatenate([u_dist * 2, v_dist * 2 + 1]).astype(np.int32)
    y = float(class_values[label]) if class_values is not None else float(label)
    u_feat, v_feat = side_features(u, v, u_features, v_features)

    return Subgraph(
        src=src.astype(np.int32),
        dst=(dst + num_u).astype(np.int32),
        etype=etype,
        node_label=node_label,
        num_u=num_u,
        num_v=num_v,
        y=y,
        u_feat=u_feat,
        v_feat=v_feat,
    )


def side_features(u: int, v: int, u_features, v_features):
    """The target user's and target item's feature rows as float32 vectors,
    or (None, None) unless both feature matrices are given."""
    if u_features is None or v_features is None:
        return None, None
    return (np.asarray(u_features[u]).reshape(-1).astype(np.float32),
            np.asarray(v_features[v]).reshape(-1).astype(np.float32))


NATIVE_SLICE = 65536     # links per C++ engine call (a heartbeat between)


def extract_many(
    links: Sequence[np.ndarray],
    labels: np.ndarray,
    A: BipartiteCSR,
    h: int = 1,
    sample_ratio: float = 1.0,
    max_nodes_per_hop: Optional[int] = None,
    u_features: Optional[np.ndarray] = None,
    v_features: Optional[np.ndarray] = None,
    class_values: Optional[np.ndarray] = None,
    seed: int = 0,
    backend: str = "auto",
    indices: Optional[np.ndarray] = None,
    progress: bool = False,
):
    """Extract enclosing subgraphs for every (u, v) link with the engine
    `backend` names ("auto", "numpy" or "native"; see the module doc).

    Deterministic: link i draws from the stream keyed by (seed, stream id),
    the stream id being `indices[i]` when given and i otherwise.
    `progress` prints "extracting subgraphs i/n" to stderr at most every
    30 s (utils/progress.py; the JAX package shows a tqdm bar), after each
    graph of the NumPy engine and each slice of NATIVE_SLICE links of the
    C++ engine."""
    from . import native
    from ..utils.progress import Heartbeat

    us, vs = links
    n = len(us)
    beat = Heartbeat("extracting subgraphs", n) if progress else None
    if native.resolve_backend(backend) == "native":
        ids = np.arange(n, dtype=np.int64) if indices is None else np.asarray(indices)
        labels = np.asarray(labels)
        out = []
        for s in range(0, n, NATIVE_SLICE):
            sl = slice(s, s + NATIVE_SLICE)
            out += native.extract_many_native(
                (us[sl], vs[sl]), labels[sl], A, h, sample_ratio,
                max_nodes_per_hop, u_features, v_features, class_values, seed,
                indices=ids[sl])
            if beat is not None:
                beat(len(out))
        return out
    out = []
    for i in range(n):
        sid = int(indices[i]) if indices is not None else i
        rng = np.random.default_rng(np.random.SeedSequence([seed, sid]))
        out.append(
            extract_subgraph(
                int(us[i]), int(vs[i]), A, h, sample_ratio, max_nodes_per_hop,
                u_features, v_features, class_values, int(labels[i]), rng,
            )
        )
        if beat is not None:
            beat(i + 1)
    return out
