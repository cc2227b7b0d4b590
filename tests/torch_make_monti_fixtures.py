"""Writes the Monti-shaped fixtures under tests/torch_fixtures/monti/.

    python tests/torch_make_monti_fixtures.py [OUT_ROOT]

flixster/, douban/ and yahoo_music/ each get a training_test_dataset.mat
written as MATLAB v7.3 writes one (through h5py, which the port itself
does not import) and a training_test_dataset.npz twin of its fields, which
a machine without h5py compares the port's HDF5 reader against. The
shapes are the published ones (Monti et al. 2017; IGMC, Zhang & Chen 2020,
Table 1): 3,000 users x 3,000 items each; flixster 26,173 ratings in
{0.5, 1, ..., 5}, douban 136,891 in {1, ..., 5}, yahoo_music 5,335 of 71
distinct values in 1..100. The ratings are split 90 / 10 into the Otraining
and Otest masks, and the side graphs (W_users, W_movies, W_tracks) are
symmetric 3,000 x 3,000 sparse matrices in which every node has at least
one neighbour. The data is drawn from a seed:

  * user and item activity weights are lognormal, with each dataset's
    spread chosen so that the median h=1 subgraph of a test pair has about
    as many nodes as the real dataset's (35 / 97 / 35 for flixster /
    douban / yahoo_music); the rated pairs are drawn from the product of
    the weights, without repeats;
  * a rating is a user bias plus an item quality plus noise, mapped onto
    the dataset's levels, so a model that learns beats the marginal;
  * the files follow MATLAB's layout: a 512-byte user block with MATLAB's
    text header, a MATLAB_class attribute on every variable; M, Otraining
    and Otest dense, stored transposed (MATLAB is column-major) in chunks
    of 768 x 768 (edge chunks at 3,000) with deflate; a sparse W as a
    group with a MATLAB_sparse attribute and datasets data (float64), ir
    and jc (uint64), chunked and deflated.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import scipy.sparse as sp

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_ROOT = os.path.join(HERE, "torch_fixtures", "monti")
FILE = "training_test_dataset"
SEED = 2017
N = 3000
CHUNK = (768, 768)
SPEC = {
    # n_ratings, rating levels, (user, item) lognormal sigma, side graphs
    "flixster": dict(n=26_173, levels=np.arange(1, 11) / 2.0, sigma=(1.02, 1.02),
                     graphs=("W_users", "W_movies")),
    "douban": dict(n=136_891, levels=np.arange(1.0, 6.0), sigma=(0.47, 0.47),
                   graphs=("W_users",)),
    "yahoo_music": dict(n=5_335, levels=None, sigma=(2.0, 2.0),
                        graphs=("W_tracks",)),
}
DATASETS = tuple(SPEC)


def _levels(name: str, rng) -> np.ndarray:
    levels = SPEC[name]["levels"]
    if levels is None:   # yahoo_music: 71 of the ratings 1..100
        levels = np.sort(rng.choice(np.arange(1.0, 101.0), 71, replace=False))
    return levels


def _pairs(n: int, sigma, rng):
    """n distinct (user, item) pairs drawn from lognormal activity weights."""
    wu = rng.lognormal(0.0, sigma[0], N)
    wv = rng.lognormal(0.0, sigma[1], N)
    pu, pv = wu / wu.sum(), wv / wv.sum()
    keys = np.zeros(0, np.int64)
    while keys.size < n:
        u = rng.choice(N, 2 * n, p=pu)
        v = rng.choice(N, 2 * n, p=pv)
        new = u.astype(np.int64) * N + v
        _, first = np.unique(np.concatenate([keys, new]), return_index=True)
        keys = np.concatenate([keys, new])[np.sort(first)]
    keys = keys[:n]
    return keys // N, keys % N


def _ratings(u, v, levels, rng) -> np.ndarray:
    """Each pair's rating: bias_u + quality_v + noise, cut into the levels
    by quantile so that every level occurs."""
    bias = rng.normal(0.0, 0.6, N)
    quality = rng.normal(0.0, 0.8, N)
    score = bias[u] + quality[v] + rng.normal(0.0, 0.7, u.size)
    # levels weighted towards the upper middle, as rating scales are
    w = np.exp(-0.5 * ((np.arange(levels.size) - 0.65 * (levels.size - 1))
                       / (0.3 * levels.size)) ** 2)
    cuts = np.quantile(score, np.cumsum(w / w.sum())[:-1])
    r = levels[np.searchsorted(cuts, score)]
    r[:levels.size] = levels       # every level present
    return r


def _side_graph(rng, k: int = 5) -> sp.csc_matrix:
    """A symmetric 0/1 graph: each node linked to k random others."""
    rows = np.repeat(np.arange(N), k)
    cols = (rows + rng.integers(1, N, rows.size)) % N
    a = sp.coo_matrix((np.ones(rows.size), (rows, cols)), shape=(N, N)).tocsr()
    a = ((a + a.T) > 0).astype(np.float64)
    return sp.csc_matrix(a)


def draw(name: str, seed: int = SEED) -> dict:
    """The fields of dataset `name` as MATLAB holds them: M, Otraining and
    Otest as float64 [users, items] arrays, side graphs as float64 CSC."""
    spec = SPEC[name]
    rng = np.random.default_rng([seed, DATASETS.index(name)])
    levels = _levels(name, rng)
    u, v = _pairs(spec["n"], spec["sigma"], rng)
    r = _ratings(u, v, levels, rng)
    test = np.zeros(u.size, bool)
    test[rng.permutation(u.size)[: u.size // 10]] = True
    M = np.zeros((N, N))
    M[u, v] = r
    Otraining = np.zeros((N, N))
    Otraining[u[~test], v[~test]] = 1.0
    Otest = np.zeros((N, N))
    Otest[u[test], v[test]] = 1.0
    fields = {"M": M, "Otraining": Otraining, "Otest": Otest}
    for g in spec["graphs"]:
        fields[g] = _side_graph(rng)
    return fields


def _user_block() -> bytes:
    text = (b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: "
            b"Mon Jan  1 00:00:00 2018 HDF5 schema 1.00 .")
    return text.ljust(116) + b" " * 8 + b"\x00\x02IM"


def write_mat(path: str, fields: dict) -> None:
    """`fields` as a MATLAB v7.3 file (h5py, the HDF5 1.8 default format)."""
    import h5py

    with h5py.File(path, "w", userblock_size=512, libver="earliest") as f:
        for name, value in fields.items():
            if sp.issparse(value):
                g = f.create_group(name)
                g.attrs["MATLAB_class"] = np.bytes_("double")
                g.attrs["MATLAB_sparse"] = np.uint64(value.shape[0])
                parts = {"data": value.data.astype(np.float64),
                         "ir": value.indices.astype(np.uint64),
                         "jc": value.indptr.astype(np.uint64)}
                for key, arr in parts.items():
                    g.create_dataset(key, data=arr, chunks=(min(4096, arr.size),),
                                     compression="gzip", compression_opts=3)
            else:
                d = f.create_dataset(name, data=value.T, chunks=CHUNK,
                                     compression="gzip", compression_opts=3)
                d.attrs["MATLAB_class"] = np.bytes_("double")
    with open(path, "r+b") as fh:
        fh.write(_user_block().ljust(512, b"\x00"))


def twin(fields: dict) -> dict:
    """The fields in a compact .npz form: a dense field's nonzeros
    (<name>.rows, .cols, .vals) and shape, a sparse field's CSC arrays
    (<name>.data, .indices, .indptr) and shape."""
    out = {}
    for name, value in fields.items():
        if sp.issparse(value):
            out.update({f"{name}.data": value.data, f"{name}.indices": value.indices,
                        f"{name}.indptr": value.indptr})
        else:
            rows, cols = np.nonzero(value)
            out.update({f"{name}.rows": rows.astype(np.int32),
                        f"{name}.cols": cols.astype(np.int32),
                        f"{name}.vals": value[rows, cols]})
        out[f"{name}.shape"] = np.asarray(value.shape)
    return out


def from_twin(npz) -> dict:
    """Fields back from a twin (what `twin` wrote), float64 like MATLAB's."""
    names = sorted({k.rsplit(".", 1)[0] for k in npz.keys()})
    fields = {}
    for name in names:
        shape = tuple(int(s) for s in npz[f"{name}.shape"])
        if f"{name}.data" in npz:
            fields[name] = sp.csc_matrix((npz[f"{name}.data"], npz[f"{name}.indices"],
                                          npz[f"{name}.indptr"]), shape=shape)
        else:
            dense = np.zeros(shape)
            dense[npz[f"{name}.rows"], npz[f"{name}.cols"]] = npz[f"{name}.vals"]
            fields[name] = dense
    return fields


def main(root: str = FIXTURE_ROOT) -> None:
    for name in DATASETS:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        fields = draw(name)
        write_mat(os.path.join(d, FILE + ".mat"), fields)
        np.savez_compressed(os.path.join(d, FILE + ".npz"), **twin(fields))
        sizes = ", ".join(f"{f} {os.path.getsize(os.path.join(d, f)):,} B"
                          for f in (FILE + ".mat", FILE + ".npz"))
        print(f"{name}: {int((fields['M'] != 0).sum()):,} ratings; {sizes}")


if __name__ == "__main__":
    main(*sys.argv[1:])
