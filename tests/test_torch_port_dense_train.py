"""igmc_torch dense training and evaluation against the JAX package's dense
path on the CPU: a two-epoch trajectory from the same weights with JAX's
dropout masks fed in (both slot layouts), a resume from epoch 1's
checkpoints, and test_once (single model and checkpoint ensemble). The
noise is derived in JAX the way its dense step draws it — the key
fold_in(fold_in(PRNGKey(seed), epoch), i) of the i-th live row — and
handed to the port in its order, so both sides drop the same edges and
features."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStaticGraphDataset
from igmc_tpu.batching.dense import plan_bipartite_buckets as jax_plan_bipartite
from igmc_tpu.batching.dense import plan_dense_buckets as jax_plan_dense
from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
from igmc_tpu.data.synthetic import write_ml1m_format
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import igmc_forward, igmc_init
from igmc_tpu.ops.dropout import edge_dropout_dense as jax_edge_dropout_dense
from igmc_tpu.train.loop import plan_dense_epoch as jax_plan_dense_epoch
from igmc_tpu.train.loop import test_once as jax_test_once
from igmc_tpu.train.loop import train_multiple_epochs as jax_train_multiple_epochs
from igmc_tpu.train.torch_interop import save_reference_checkpoint

from igmc_torch.batching import StaticGraphDataset
from igmc_torch.data import create_trainvaltest_split
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.train import checkpoint_path, get_learning_rate, params_from_jax
from igmc_torch.train import test_once as port_test_once
from igmc_torch.train import loop as port_loop
from igmc_torch.train import train_multiple_epochs
from igmc_torch.utils import ResultsDir, make_logger

torch.set_num_threads(1)

N_TRAIN, N_TEST = 100, 60
BATCH = 20
HIDDEN = 128
SUPERBATCH = 2


def jax_cfg():
    return JaxIGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                         num_relations=5, num_bases=4)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(params):
    model = IGMC(IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                            num_relations=5, num_bases=4),
                 torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(to_numpy(params)))
    return model


def jax_fwd(p, b, key=None, training=False):
    return igmc_forward(p, b, jax_cfg(), key, training)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(JAX, port) datasets of 100 training and 60 held-out pairs of a 150 x
    120, 10,000-rating ml_1m fixture (h 1, at most 100 nodes per hop; the
    median graph has over 128 nodes, as ML-1M's does)."""
    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=150, n_movies=120, n_ratings=10000, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        ws = jax_split("ml_1m", seed=1234, testing=True, verbose=False)
        gs = create_trainvaltest_split("ml_1m", seed=1234, testing=True,
                                       verbose=False)
    out = {}
    for part, n in (("train", N_TRAIN), ("test", N_TEST)):
        links = (getattr(ws, f"{part}_u_indices"), getattr(ws, f"{part}_v_indices"))
        labels = getattr(ws, f"{part}_labels")
        out[part] = (
            JaxStaticGraphDataset(None, ws.adj_train, links, labels, h=1,
                                  max_nodes_per_hop=100,
                                  class_values=ws.class_values, max_num=n,
                                  backend="numpy", progress=False),
            StaticGraphDataset(gs.adj_train, links, labels, h=1,
                               max_nodes_per_hop=100,
                               class_values=gs.class_values, max_num=n))
    return out


def jax_buckets(ds, layout):
    if layout == "bipartite":
        nu = ds.packed.num_u
        return jax_plan_bipartite(nu, ds.node_counts() - nu, ds.edge_counts() // 2)
    return jax_plan_dense(ds.node_counts(), ds.edge_counts() // 2)


def jax_step_noise(data, layout, seed, epochs):
    """JAX's dense training masks of every live row of `epochs`, in order,
    as the port's noise ((keep_f, keep_r), feature_keep)."""
    buckets = jax_buckets(data["train"][0], layout)
    noise = []
    for e in epochs:
        rng = np.random.default_rng(np.random.SeedSequence([seed, e]))
        units = jax_plan_dense_epoch(buckets, BATCH, SUPERBATCH, rng)
        slots = [buckets[bi].edge_slot for bi, blk in units
                 for row in blk if (row >= 0).any()]
        epoch_key = jax.random.fold_in(jax.random.PRNGKey(seed), e)
        for i, edge_slot in enumerate(slots):
            key, k_edge = jax.random.split(jax.random.fold_in(epoch_key, i))
            keep_f, keep_r = jax_edge_dropout_dense(
                k_edge, jnp.ones((BATCH, edge_slot), bool), 0.2, False, True)
            _, k_drop = jax.random.split(key)
            keep = jax.random.bernoulli(k_drop, 0.5, (BATCH, HIDDEN))
            t = lambda a: torch.from_numpy(np.array(a))
            noise.append(((t(keep_f), t(keep_r)), t(keep)))
    return noise


def run_port(data, monkeypatch, params, noise, layout, **kw):
    """The port's dense train_multiple_epochs on the CPU, its draw_noise
    handing out `noise` in order; returns (rmse, state, infos)."""
    feed = iter(noise)
    monkeypatch.setattr(port_loop, "draw_noise", lambda gen, b: next(feed))
    infos = []
    logger = kw.pop("logger", None)

    def log(info, state):
        infos.append(dict(info))
        if logger is not None:
            logger(info, state)

    rmse, state = train_multiple_epochs(
        data["train"][1], data["test"][1], port_model(params), epochs=2,
        batch_size=BATCH, lr=1e-3, lr_decay_factor=0.1, lr_decay_step_size=1,
        ARR=0.001, seed=1, logger=log, superbatch=SUPERBATCH, batch_mode="dense",
        dense_layout=layout, device="cpu", **kw)
    assert next(feed, None) is None     # every step drew its noise
    return rmse, state, infos


@pytest.mark.parametrize("layout", ["unified", "bipartite"])
def test_dense_trajectory_matches_jax(data, monkeypatch, layout):
    """Two epochs (100 pairs, batch 20, superbatch 2, 3 buckets, ARR 0.001,
    LR decay after every epoch) from the same weights with JAX's masks:
    per-epoch train loss and test RMSE within 1e-4 relative of JAX's dense
    run, the final parameters within atol 2e-5 (an Adam step moves a
    parameter by at most about lr = 1e-3; float32 rounding of a dozen steps
    stays far below that)."""
    params = igmc_init(jax.random.PRNGKey(7), jax_cfg())
    want_infos = []
    _, want_state = jax_train_multiple_epochs(
        data["train"][0], data["test"][0], jax_fwd,
        jax.tree_util.tree_map(jnp.array, params), epochs=2, batch_size=BATCH,
        lr=1e-3, lr_decay_factor=0.1, lr_decay_step_size=1, ARR=0.001, seed=1,
        progress=False, superbatch=SUPERBATCH, batch_mode="dense",
        dense_layout=layout,
        logger=lambda info, state: want_infos.append(dict(info)))
    noise = jax_step_noise(data, layout, 1, (1, 2))
    assert len(noise) > 2 * len(jax_buckets(data["train"][0], layout))
    got_rmse, state, got_infos = run_port(data, monkeypatch, params, noise, layout)
    assert [i["epoch"] for i in got_infos] == [1, 2]
    for g, w in zip(got_infos, want_infos):
        for k in ("train_loss", "test_rmse"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert got_rmse == got_infos[-1]["test_rmse"]
    assert got_infos[1]["train_loss"] < got_infos[0]["train_loss"]
    want_params = params_from_jax(to_numpy(want_state.params))
    for name, p in state.model.state_dict().items():
        torch.testing.assert_close(p, want_params[name], rtol=0, atol=2e-5, msg=name)
    assert get_learning_rate(state.optimizer) == pytest.approx(1e-5, rel=1e-6)
    assert [h["epoch"] for h in state.history] == [1, 2]
    assert all(0 <= h["host_seconds"] <= h["seconds"] for h in state.history)


def test_dense_resume_equals_uninterrupted_run(data, monkeypatch, tmp_path):
    """A dense run resumed from epoch 1's checkpoints replays epoch 2 of the
    uninterrupted run exactly (same plan, noise, weights and Adam state)."""
    params = igmc_init(jax.random.PRNGKey(8), jax_cfg())
    res = ResultsDir(str(tmp_path), "ml_1m", "_dense", True)
    noise = jax_step_noise(data, "bipartite", 1, (1, 2))
    n1 = len(jax_step_noise(data, "bipartite", 1, (1,)))
    _, full, infos = run_port(data, monkeypatch, params, noise, "bipartite",
                              logger=make_logger(res, 1))
    _, resumed, rinfos = run_port(data, monkeypatch, params, noise[n1:],
                                  "bipartite", continue_from=1, res_dir=res.path)
    assert rinfos == infos[1:]
    for name, p in resumed.model.state_dict().items():
        torch.testing.assert_close(p, full.model.state_dict()[name], rtol=0, atol=0,
                                   msg=name)


@pytest.mark.parametrize("layout", ["unified", "bipartite"])
def test_dense_test_once_matches_jax(data, tmp_path, capsys, layout):
    """test_once on the dense layout, one model and a two-checkpoint
    ensemble (reference .pth files both packages read), against the JAX
    package's dense test_once: RMSE within 1e-5 relative."""
    ckpts = []
    for seed in (1, 2):
        p = igmc_init(jax.random.PRNGKey(seed), jax_cfg())
        ckpts.append(checkpoint_path(str(tmp_path), "model", seed))
        save_reference_checkpoint(ckpts[-1], p)
    template = igmc_init(jax.random.PRNGKey(0), jax_cfg())
    jds, pds = data["test"]
    kw = dict(batch_mode="dense", dense_layout=layout)
    for ens, extra in ((True, dict(ensemble=True, checkpoints=ckpts)), (False, {})):
        want = jax_test_once(jds, jax_fwd, template, BATCH, **extra, **kw)
        got = port_test_once(pds, port_model(template), BATCH, device="cpu", **extra, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"ensemble={ens}")
    # the ensemble averages raw predictions: not the mean of the RMSEs
    single = [port_test_once(pds, port_model(template), BATCH, device="cpu",
                        params=torch.load(c, weights_only=True), **kw) for c in ckpts]
    ens = port_test_once(pds, port_model(template), BATCH, device="cpu", ensemble=True,
                    checkpoints=ckpts, **kw)
    assert ens < max(single) and abs(ens - np.mean(single)) > 1e-6
    # a flat engine named with batch_mode dense keeps the flat layout, and says so
    capsys.readouterr()
    flat = port_test_once(pds, port_model(template), BATCH, device="cpu",
                     flat_aggregate="pallas", **kw)
    assert "using the flat path" in capsys.readouterr().out
    np.testing.assert_allclose(flat, got, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="segment"):
        port_test_once(pds, port_model(template), BATCH, device="cpu",
                       flat_aggregate="segment", **kw)
