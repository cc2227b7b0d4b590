"""The stacked ensemble forward (models/stacked.py) on the CPU: one forward
of M members folded into member-as-channel weights gives the mean of the
members' own forwards to atol 1e-6, for M 1, 2 and 4, aggr mean, sum and
relmean, several slot shapes, the bipartite and relation-slotted layouts
and side features; Predictor.predict serves it and agrees with the
per-member loop on the same pairs, counting one serve.member_forwards a
row (the loop: M a row); the configurations it does not cover (bfloat16,
the adjacency strategy) keep the loop and agree with it."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from igmc_torch.batching import DeviceDataset, StaticGraphDataset, plan_rel_caps
from igmc_torch.batching.device_data import assemble_dense
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.models.stacked import StackedIGMC, stacks
from igmc_torch.serve import Predictor
from igmc_torch.train import DensePass, save_pth
from igmc_torch.utils import spans

torch.set_num_threads(1)

ATOL = 1e-6
SCALE = 4.0
ADJ_ATOL = 1e-5     # the adjacency strategy's einsums sum in another order
R = 5
CLASS_VALUES = np.arange(1.0, 6.0)
GIDS = [0, 3, 5, 7, 1, -1, 2, 4, 9, 11, 6, -1]


def rating_matrix(nu=60, nv=70, density=0.12, seed=0):
    rng = np.random.default_rng(seed)
    M = sp.random(nu, nv, density=density, format="csr",
                  random_state=np.random.RandomState(seed))
    M.data = rng.integers(1, 6, M.nnz).astype(np.float64)
    return M


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def dataset():
    M = rating_matrix()
    u, v = M.nonzero()
    labels = (M[u[:40], v[:40]].A1 - 1).astype(np.int64)
    return StaticGraphDataset(M, (u[:40], v[:40]), labels, h=1,
                              class_values=CLASS_VALUES, backend="numpy",
                              u_features=features(60, 3, 1),
                              v_features=features(70, 2, 2), progress=False)


def members(cfg, M, seed=0):
    """M eval-mode members, each parameter its init draw times SCALE, so
    that the states spread over tanh's range and ratings reach 0.6-5.7,
    a trained model's range. The fold's sums run in a member's order
    except inside GEMMs (the batched lin2 against nn.Linear's): <= 1
    float32 ulp of such ratings, 4.8e-7."""
    out = []
    for m in range(M):
        model = IGMC(cfg, torch.Generator().manual_seed(seed + m))
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(SCALE)
        out.append(model.eval())
    return out


def slots(ds, shape):
    """(node_slot, edge_slot, num_u_slot) of a named slot shape."""
    nc, ec, nu = ds.node_counts(), ds.edge_counts() // 2, ds.packed.num_u
    if shape == "tight":
        return int(nc.max()), int(ec.max()), None
    if shape == "padded":
        return int(nc.max()) + 13, int(ec.max()) + 40, None
    n_u = int(nu.max()) + 2
    return n_u + int((nc - nu).max()) + 3, int(ec.max()) + 5, n_u   # bipartite


def loop_mean(models, batch):
    return torch.stack([m(batch) for m in models]).mean(0)


@pytest.mark.parametrize("shape", ["tight", "padded", "bipartite"])
@pytest.mark.parametrize("aggr", ["mean", "sum", "relmean"])
@pytest.mark.parametrize("M", [1, 2, 4])
def test_stacked_forward_matches_the_member_loop(dataset, M, aggr, shape):
    cfg = IGMCConfig(num_relations=R, num_bases=4, aggr=aggr)
    models = members(cfg, M, seed=10 * M)
    n, e, nu = slots(dataset, shape)
    dd = DeviceDataset(dataset.packed, "cpu")
    batch = assemble_dense(dd, torch.tensor(GIDS), n, e, nu)
    with torch.no_grad():
        want = loop_mean(models, batch)
        got = StackedIGMC(models)(batch)
    assert got.shape == want.shape == (len(GIDS),)
    assert float(want.abs().max()) > 0.5        # not all near 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("bipartite", [False, True])
@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_stacked_forward_on_the_relation_slotted_layout(dataset, aggr, bipartite):
    cfg = IGMCConfig(num_relations=R, num_bases=4, aggr=aggr)
    models = members(cfg, 3, seed=7)
    caps = plan_rel_caps([dataset.get(i).etype for i in range(len(dataset))], R)
    n, _, nu = slots(dataset, "bipartite" if bipartite else "tight")
    dd = DeviceDataset(dataset.packed, "cpu", rel_sort=R)
    batch = assemble_dense(dd, torch.tensor(GIDS), n, sum(caps), nu, caps)
    with torch.no_grad():
        want = loop_mean(models, batch)
        got = StackedIGMC(models)(batch)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_stacked_forward_with_side_features(dataset):
    cfg = IGMCConfig(num_relations=R, num_bases=4, side_features=True,
                     n_side_features=5, multiply_by=2.5)
    models = members(cfg, 2, seed=3)
    n, e, _ = slots(dataset, "padded")
    batch = assemble_dense(DeviceDataset(dataset.packed, "cpu"), torch.tensor(GIDS),
                           n, e)
    with torch.no_grad():
        want = loop_mean(models, batch)
        got = StackedIGMC(models)(batch)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(compute_dtype="bfloat16"),
                                dict(dense_strategy="adjacency")])
def test_uncovered_configs_are_refused_by_the_fold(kw):
    cfg = IGMCConfig(num_relations=R, num_bases=4, **kw)
    assert not stacks(cfg)
    with pytest.raises(ValueError, match="float32 edge strategies"):
        StackedIGMC(members(cfg, 2))


def predictor(tmp_path, cfg, models, **kw):
    paths = []
    for i, m in enumerate(models):
        paths.append(str(tmp_path / f"model_{i}.pth"))
        save_pth(paths[-1], m.state_dict())
    return Predictor(rating_matrix(), CLASS_VALUES, cfg, checkpoints=paths,
                     batch_size=16, backend="numpy", device="cpu", **kw)


def pairs(n=70, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 60, n), rng.integers(0, 70, n)


def served(pred, users, items):
    """(scores, serve.member_forwards, rows) of one predict call."""
    rows = len(DensePass.plan(pred._buckets(pred.subgraphs(users, items)),
                              pred.batch_size, 1, "cpu").bucket_of)
    spans.reset()
    spans.enable()
    try:
        scores = pred.predict(users, items)
        forwards = spans.snapshot()["counters"]["serve.member_forwards"]
    finally:
        spans.disable()
        spans.reset()
    return scores, forwards, rows


@pytest.mark.parametrize("aggr", ["mean", "relmean"])
@pytest.mark.parametrize("M", [1, 4])
def test_predictor_serves_the_stacked_forward(tmp_path, M, aggr):
    """Predictor folds a covered config's members: one forward a row, the
    loop's scores on the same pairs."""
    cfg = IGMCConfig(num_relations=R, num_bases=4, aggr=aggr)
    pred = predictor(tmp_path, cfg, members(cfg, M, seed=5))
    assert pred._stacked is not None
    users, items = pairs()
    got, forwards, rows = served(pred, users, items)
    assert rows > 1 and forwards == rows
    loop = predictor(tmp_path, cfg, pred._members)
    loop._stacked = None                     # the per-member loop
    want, loop_forwards, _ = served(loop, users, items)
    assert loop_forwards == rows * M
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(compute_dtype="bfloat16"),
                                dict(dense_strategy="adjacency"),
                                dict(dense_strategy="adjacency", aggr="sum")])
def test_uncovered_configs_keep_the_member_loop(tmp_path, kw):
    """bfloat16 and the adjacency strategy run one forward per member, and
    serve the mean of the members' own Predictors; the float32 adjacency
    strategy computes the stacked edge form's function."""
    cfg = IGMCConfig(num_relations=R, num_bases=4, **kw)
    models = members(cfg, 2, seed=8)
    pred = predictor(tmp_path, cfg, models)
    assert pred._stacked is None
    users, items = pairs(seed=2)
    got, forwards, rows = served(pred, users, items)
    assert forwards == 2 * rows
    single = [predictor(tmp_path / str(i), cfg, [m]).predict(users, items)
              for i, m in enumerate(models)]
    want = torch.stack([torch.from_numpy(s) for s in single]).mean(0).numpy()
    np.testing.assert_array_equal(got, want)
    if "compute_dtype" not in kw:
        edge = dict(kw, dense_strategy="edge")
        stacked = predictor(tmp_path / "edge", IGMCConfig(num_relations=R, num_bases=4,
                                                          **edge), models)
        assert stacked._stacked is not None
        np.testing.assert_allclose(stacked.predict(users, items), got, rtol=0,
                                   atol=ADJ_ATOL)
