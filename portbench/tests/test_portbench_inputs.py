"""The traffic and data generators are deterministic in their seeds."""

import json
import os

import numpy as np
import pytest
import torch

from portbench.lib import data, weights
from portbench.reference import igmc as ri
from portbench.traffic.rerank import request_set

from .conftest import ROOT


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_ratings_generator_is_deterministic_in_its_seed():
    a = data.ml1m_ratings(300, 200, 5000, seed=3)
    b = data.ml1m_ratings(300, 200, 5000, seed=3)
    c = data.ml1m_ratings(300, 200, 5000, seed=4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    u, m, r = a
    assert len(set(zip(u.tolist(), m.tolist()))) == len(u)     # unique per user
    assert r.min() >= 1 and r.max() <= 5


def test_frozen_ratings_are_the_generators():
    d = _config("igmc-ml1m")["data"]
    frozen = data.frozen_ratings(d)
    made = data.ml1m_ratings(d["num_users"], d["num_items"], d["num_ratings"],
                             d["ratings_seed"])
    assert all(np.array_equal(x, y) for x, y in zip(frozen, made))


def test_yahoo_split_is_the_fixture():
    s = data.load_split(_config("igmc-yahoo"))
    assert s.adj.shape == (3000, 3000) and s.num_relations == 71
    assert len(s.train_u) == 4802 and len(s.test_u) == 533
    t = data.load_split(_config("igmc-yahoo"))
    assert np.array_equal(s.train_label, t.train_label)


def _small_split():
    u, m, r = data.ml1m_ratings(200, 150, 3000, seed=1)
    return data._split(u, m, r, (200, 150), 0.1, 5)


def test_pool_and_request_set_are_deterministic():
    s = _small_split()
    a, b = data.train_pool(s, 100, 7), data.train_pool(s, 100, 7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], data.train_pool(s, 100, 8)[0])
    assert len(data.train_pool(s, None, 0)[0]) == len(s.train_u)
    c1, c2 = request_set(s, 6, 5, 11), request_set(s, 6, 5, 11)
    assert all(u1 == u2 and np.array_equal(i1, i2) for (u1, i1), (u2, i2) in zip(c1, c2))
    for u, items in c1:
        rated = set(s.adj[u].indices.tolist())
        assert len(set(items.tolist())) == 5 and not rated & set(items.tolist())


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**33])
def test_weights_and_noise_are_deterministic(seed):
    model = _config("igmc-ml1m")["model"]
    a = weights.make_members(model, 5, seed, 2, "cpu")
    b = weights.make_members(model, 5, seed, 2, "cpu")
    c = weights.make_members(model, 5, seed + 1, 2, "cpu")
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert not torch.equal(a[0]["lin1.weight"], c[0]["lin1.weight"])
    for name, shape, bound in ri.param_specs(model, 5):
        assert tuple(a[0][name].shape) == shape and a[0][name].abs().max() <= bound
    n1 = ri.draw_noise(weights.noise_generator(seed, 3), 50, model)
    n2 = ri.draw_noise(weights.noise_generator(seed, 3), 50, model)
    assert n1[0] == n2[0] and torch.equal(n1[1], n2[1])
