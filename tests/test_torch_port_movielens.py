"""igmc_torch's MovieLens loaders and splits against the JAX package's, on
the fixtures of tests/test_movielens.py (its `_write` / `_ratings`
generators) and on the synthetic generators of igmc_tpu.data.synthetic:
load_data of ml_100k, ml_1m, ml_10m and ml_25m (ml_25m read in several
chunks), the official ml_100k split (with `ratio` < 1 and a rating_map),
and the random and time splits give every array of the JAX package's
exactly, side features included. The JAX loaders are only called on
datasets whose files are all present (they download what is missing)."""

import numpy as np
import pytest

from igmc_tpu.data import loaders as jax_loaders
from igmc_tpu.data import splits as jax_splits
from igmc_tpu.data.synthetic import (write_ml1m_format, write_ml25m_format,
                                     write_ml100k_format)
from test_movielens import N_ITEMS, N_USERS, _ratings, _write

from igmc_torch.data import loaders as port_loaders
from igmc_torch.data import splits as port_splits

SPLIT_FIELDS = ("u_features", "v_features", "adj_train",
                "train_labels", "train_u_indices", "train_v_indices",
                "val_labels", "val_u_indices", "val_v_indices",
                "test_labels", "test_u_indices", "test_v_indices",
                "class_values")


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """test_movielens.ml_root's four datasets, written by its generators;
    users.dat gains hyphenated zip codes, so that column is read as text."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("raw_data")
    rows = _ratings(rng, 80)
    d100k = root / "ml_100k"
    _write(str(d100k / "u.data"), ["\t".join(map(str, r)) for r in rows])
    _write(str(d100k / "u1.base"), ["\t".join(map(str, r)) for r in rows[:64]])
    _write(str(d100k / "u1.test"), ["\t".join(map(str, r)) for r in rows[64:]])
    genre_flags = lambda i: "|".join(
        str(int(b)) for b in np.eye(19, dtype=int)[i % 19])
    _write(str(d100k / "u.item"), [
        f"{i}|Movie {i} (1995)|01-Jan-1995||http://x|" + genre_flags(i)
        for i in range(1, N_ITEMS + 1)])
    occs = ["artist", "doctor", "engineer"]
    _write(str(d100k / "u.user"), [
        f"{u}|{20 + u}|{'MF'[u % 2]}|{occs[u % 3]}|90210"
        for u in range(1, N_USERS + 1)])

    d1m = root / "ml_1m"
    _write(str(d1m / "ratings.dat"), ["::".join(map(str, r))
                                      for r in _ratings(rng, 90)])
    genres = ["Action", "Comedy", "Drama"]
    _write(str(d1m / "movies.dat"), [
        f"{i}::Movie {i} (1995)::{genres[i % 3]}|{genres[(i + 1) % 3]}"
        for i in range(1, N_ITEMS + 1)])
    zips = ["90210", "02139", "55455-1234", "9021"]
    _write(str(d1m / "users.dat"), [
        f"{u}::{'MF'[u % 2]}::{18 + (u % 4) * 10}::{u % 5}::{zips[u % 4]}"
        for u in range(1, N_USERS + 1)])

    _write(str(root / "ml_10m" / "ratings.dat"),
           ["::".join(map(str, r)) for r in _ratings(rng, 70)])
    _write(str(root / "ml_25m" / "movielens25M.csv"),
           ["uid,iid,cid,time,rating"] +
           [f"{u},{v},0,{t},{r}" for (u, v, r, t) in _ratings(rng, 60)])
    return str(root)


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    """The synthetic generators' ml_100k, ml_1m (zero-padded zip codes,
    read as numbers) and half-star ml_25m."""
    root = tmp_path_factory.mktemp("synthetic")
    write_ml100k_format(str(root), n_users=150, n_movies=120, n_ratings=3000,
                        seed=1)
    write_ml1m_format(str(root), n_users=200, n_movies=150, n_ratings=4000,
                      seed=2)
    write_ml25m_format(str(root), n_users=200, n_movies=150, n_ratings=3000,
                       seed=3)
    return str(root)


def assert_same(got, want, what):
    if want is None:
        assert got is None, what
        return
    if hasattr(want, "toarray"):
        assert type(got) is type(want), what
        got, want = got.toarray(), want.toarray()
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def assert_split_same(got, want, what):
    for f in SPLIT_FIELDS:
        assert_same(getattr(got, f), getattr(want, f), (what, f))


@pytest.mark.parametrize("root,name", [
    ("fixture", "ml_100k"), ("fixture", "ml_1m"), ("fixture", "ml_10m"),
    ("fixture", "ml_25m"), ("synthetic", "ml_100k"), ("synthetic", "ml_1m"),
    ("synthetic", "ml_25m")])
def test_load_data_matches_jax(request, monkeypatch, root, name):
    monkeypatch.setenv("IGMC_RAW_DATA", request.getfixturevalue(f"{root}_root"))
    want = jax_loaders.load_data(name, seed=1234, verbose=False)
    got = port_loaders.load_data(name, seed=1234, verbose=False)
    assert got[:2] == want[:2]
    for i, (g, w) in enumerate(zip(got[2:], want[2:])):
        assert_same(g, w, (name, i + 2))
    if name in ("ml_100k", "ml_1m"):
        assert got[5] is not None and got[6].shape[0] == got[1]


@pytest.mark.parametrize("name", ["ml_1m", "ml_10m", "ml_25m"])
@pytest.mark.parametrize("kw", [
    {"testing": True},
    {"testing": False, "ratio": 0.5},
    {"testing": True, "rating_map": "standard", "post_rating_map": "transfer"},
])
def test_random_and_time_splits_match_jax(fixture_root, monkeypatch, name, kw):
    monkeypatch.setenv("IGMC_RAW_DATA", fixture_root)
    kw = dict(kw)
    if kw.get("rating_map") == "standard":
        # integer ratings rebucketed, and the adjacency into 2 relations
        kw["rating_map"] = {x: min(x + 1.0, 5.0) for x in (1.0, 2.0, 3.0, 4.0, 5.0)}
        kw["post_rating_map"] = {x: int(x > 3) for x in (2.0, 3.0, 4.0, 5.0)}
    want = jax_splits.create_trainvaltest_split(name, seed=7, verbose=False, **kw)
    got = port_splits.create_trainvaltest_split(name, seed=7, verbose=False, **kw)
    assert_split_same(got, want, name)


@pytest.mark.parametrize("root", ["fixture", "synthetic"])
@pytest.mark.parametrize("kw", [
    {"testing": True},
    {"testing": False},
    {"testing": True, "ratio": 0.5},
    {"testing": False, "ratio": 0.3,
     "rating_map": {1.0: 1.0, 2.0: 1.0, 3.0: 3.0, 4.0: 5.0, 5.0: 5.0}},
])
def test_official_split_matches_jax(request, monkeypatch, root, kw):
    """ml_100k's u1.base / u1.test split: the seed-42 carve, the testing
    fold, ratio's earliest-timestamp cut, and the features with the age
    over the oldest user's."""
    monkeypatch.setenv("IGMC_RAW_DATA", request.getfixturevalue(f"{root}_root"))
    want = jax_splits.load_official_trainvaltest_split("ml_100k", **kw)
    state = np.random.get_state()[1].copy()
    got = port_splits.load_official_trainvaltest_split("ml_100k", **kw)
    assert_split_same(got, want, "ml_100k")
    assert got.u_features[:, 0].max() <= 1.0            # normalised age
    # the seed-42 shuffle draws from a private stream
    np.testing.assert_array_equal(np.random.get_state()[1], state)


@pytest.mark.parametrize("chunk", [7, 997])
def test_ml25m_is_read_in_chunks(synthetic_root, monkeypatch, chunk):
    """ml_25m read in chunks of `chunk` rows equals the one-chunk read and
    the JAX package's chunked read; the time split takes the first 70% of
    the time-ordered ratings for training."""
    monkeypatch.setenv("IGMC_RAW_DATA", synthetic_root)
    monkeypatch.setattr(port_loaders, "ML25M_CHUNK_ROWS", 10**9)
    one = port_loaders.load_data("ml_25m", verbose=False)
    monkeypatch.setattr(port_loaders, "ML25M_CHUNK_ROWS", chunk)
    monkeypatch.setattr(jax_loaders, "ML25M_CHUNK_ROWS", chunk)
    many = port_loaders.load_data("ml_25m", verbose=False)
    want = jax_loaders.load_data("ml_25m", verbose=False)
    assert one[:2] == many[:2] == want[:2]
    for i in (2, 3, 4):
        assert_same(many[i], one[i], i)
        assert_same(many[i], want[i], i)
    assert len(np.unique(many[4])) > 5                  # half stars
    s = port_splits.create_trainvaltest_split("ml_25m", testing=False,
                                              verbose=False)
    n = len(many[4])
    assert len(s.train_labels) == int(n * 0.7)
    assert len(s.test_labels) == n - int(n * 0.8)


def test_missing_files_raise_naming_the_file(tmp_path, monkeypatch):
    monkeypatch.setenv("IGMC_RAW_DATA", str(tmp_path))
    for name, fname in (("ml_100k", "u.data"), ("ml_1m", "ratings.dat"),
                        ("ml_10m", "ratings.dat"),
                        ("ml_25m", "movielens25M.csv")):
        with pytest.raises(FileNotFoundError, match=f"{fname}.*IGMC_RAW_DATA"):
            port_loaders.load_data(name, verbose=False)
    with pytest.raises(FileNotFoundError, match="u1.base"):
        port_splits.load_official_trainvaltest_split("ml_100k")
    with pytest.raises(ValueError, match="not recognized"):
        port_loaders.load_data("flixster")
