"""igmc_torch training against the JAX package's flat-pallas training on
the CPU: the training forward with the same noise, one step's gradients,
a two-epoch trajectory, resuming, checkpoints and the log format. The
noise is derived in JAX the way igmc_forward draws it and handed to the
port, so both sides drop the same edges and features."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from igmc_tpu.batching.dataset import BatchLoader as JaxBatchLoader
from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStaticGraphDataset
from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
from igmc_tpu.data.synthetic import write_ml1m_format
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import arr_regularizer as jax_arr_regularizer
from igmc_tpu.models.igmc import igmc_forward, igmc_init
from igmc_tpu.train.loop import _make_loss_fn
from igmc_tpu.train.loop import train_multiple_epochs as jax_train_multiple_epochs
from igmc_tpu.train.torch_interop import load_reference_checkpoint
from igmc_tpu.utils.logging import ResultsDir as JaxResultsDir
from igmc_tpu.utils.logging import make_logger as jax_make_logger

from igmc_torch.batching import BatchLoader, StaticGraphDataset
from igmc_torch.data import create_trainvaltest_split
from igmc_torch.models import IGMC, IGMCConfig, arr_regularizer, draw_noise
from igmc_torch.train import (get_learning_rate, load_checkpoint,
                              load_optimizer_state, loss_fn, make_optimizer,
                              params_from_jax, set_learning_rate)
from igmc_torch.train import loop as port_loop
from igmc_torch.train import train_multiple_epochs
from igmc_torch.utils import ResultsDir, make_logger

torch.set_num_threads(1)

N_PAIRS = 100
BATCH = 50
HIDDEN = 128


def jax_cfg(**kw):
    return JaxIGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                         num_relations=5, num_bases=4, use_pallas=True,
                         flat_aggregate="pallas", **kw)


def port_cfg(**kw):
    return IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                      num_relations=5, num_bases=4, **kw)


def jax_fwd(cfg):
    return lambda p, b, key=None, training=False: igmc_forward(p, b, cfg, key,
                                                               training)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(params, **kw):
    model = IGMC(port_cfg(**kw), torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(to_numpy(params)))
    return model


def jax_noise(key, batch_size=BATCH):
    """The noise igmc_forward draws from `key` in training mode with
    adj_dropout > 0, as the port's (edge_seed, feature_keep)."""
    key, k_edge = jax.random.split(key)
    seed = jax.random.randint(k_edge, (), 0, jnp.iinfo(jnp.int32).max)
    key, k_drop = jax.random.split(key)
    keep = jax.random.bernoulli(k_drop, 0.5, (batch_size, HIDDEN))
    return int(seed), torch.from_numpy(np.array(keep))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(JAX, port) datasets of 100 training and 100 held-out pairs of a
    300 x 400, 8,000-rating ml_1m fixture (h 1, at most 100 nodes per hop)."""
    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=300, n_movies=400, n_ratings=8000,
                      seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        ws = jax_split("ml_1m", seed=1234, testing=True, verbose=False)
        gs = create_trainvaltest_split("ml_1m", seed=1234, testing=True,
                                       verbose=False)
    out = {}
    for part in ("train", "test"):
        links = (getattr(ws, f"{part}_u_indices"), getattr(ws, f"{part}_v_indices"))
        labels = getattr(ws, f"{part}_labels")
        out[part] = (
            JaxStaticGraphDataset(None, ws.adj_train, links, labels, h=1,
                                  max_nodes_per_hop=100,
                                  class_values=ws.class_values,
                                  max_num=N_PAIRS, backend="numpy",
                                  progress=False),
            StaticGraphDataset(gs.adj_train, links, labels, h=1,
                               max_nodes_per_hop=100,
                               class_values=gs.class_values, max_num=N_PAIRS))
    return out


def _first_training_batches(data, seed=3):
    want_ds, got_ds = data["train"]
    want = next(iter(JaxBatchLoader(want_ds, BATCH, shuffle=True, seed=seed,
                                    device_put=False, prefetch=0,
                                    flat_aggregate="pallas")))
    got = next(iter(BatchLoader(got_ds, BATCH, shuffle=True, seed=seed)))
    return want, got


@pytest.mark.parametrize("kw", [{}, {"force_undirected": True},
                                {"aggr": "sum", "adj_dropout": 0.4}])
def test_training_forward_matches_jax(data, kw):
    """Same weights, same shuffled batch, same noise: training-mode
    predictions agree to atol 1e-4 (float32, another summation order), and
    the ARR regularizer agrees to rtol 1e-5."""
    want_batch, got_batch = _first_training_batches(data)
    params = igmc_init(jax.random.PRNGKey(5), jax_cfg())
    key = jax.random.PRNGKey(11)
    want = np.asarray(igmc_forward(params, want_batch, jax_cfg(**kw), key, True))
    model = port_model(params, **kw).train()
    got = model(got_batch, jax_noise(key))
    assert got.shape == (BATCH,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
    # the dropout changed the predictions
    evaluated = np.asarray(igmc_forward(params, want_batch, jax_cfg(**kw), None,
                                        False))
    assert np.abs(evaluated - want).max() > 1e-3
    np.testing.assert_allclose(arr_regularizer(model).item(),
                               float(jax_arr_regularizer(params)), rtol=1e-5)


def test_training_forward_needs_noise_and_keys(data):
    _, got_batch = _first_training_batches(data)
    model = IGMC(port_cfg(), torch.Generator().manual_seed(0)).train()
    with pytest.raises(ValueError, match="noise"):
        model(got_batch)
    got_batch.aligned = got_batch.aligned[:6]
    with pytest.raises(ValueError, match="ukey"):
        model(got_batch, draw_noise(torch.Generator().manual_seed(0), BATCH))


def test_one_step_gradients_match_jax(data):
    """Loss and the gradient of every parameter against jax.value_and_grad
    of the JAX package's loss (_make_loss_fn, MSE + ARR 0.001) at the same
    weights, batch and noise: rtol 1e-4, atol 1e-4 of the parameter's
    largest gradient (float32 through four layers, other summation orders)."""
    want_batch, got_batch = _first_training_batches(data, seed=4)
    params = igmc_init(jax.random.PRNGKey(6), jax_cfg())
    key = jax.random.PRNGKey(12)
    (want_loss, want_n), grads = jax.value_and_grad(
        _make_loss_fn(jax_fwd(jax_cfg()), 0.001, True), has_aux=True)(
        params, want_batch, key)
    model = port_model(params).train()
    loss, n = loss_fn(model, got_batch, jax_noise(key), 0.001)
    loss.backward()
    assert float(n) == float(want_n) == BATCH
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_grads = params_from_jax(to_numpy(grads))
    got_grads = dict(model.named_parameters())
    assert list(got_grads) == list(want_grads)
    for name, w in want_grads.items():
        g = got_grads[name].grad
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()) + 1e-12,
                                   msg=name)


def test_optimizer_matches_optax_rates_and_decay():
    model = IGMC(port_cfg(), torch.Generator().manual_seed(0))
    adam = make_optimizer(model.parameters(), 1e-3)
    assert type(adam) is torch.optim.Adam
    group = adam.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert get_learning_rate(adam) == float(np.float32(1e-3))
    set_learning_rate(adam, 0.1 * get_learning_rate(adam))
    assert get_learning_rate(adam) == float(np.float32(0.1 * np.float32(1e-3)))
    adamw = make_optimizer(model.parameters(), 1e-3, weight_decay=0.01)
    assert type(adamw) is torch.optim.AdamW
    assert adamw.param_groups[0]["weight_decay"] == 0.01


def _noise_list(seed, epochs, steps):
    """JAX's per-step keys fold_in(fold_in(PRNGKey(seed), epoch), i), as
    the noise the port's draw_noise would hand out, in call order."""
    key = jax.random.PRNGKey(seed)
    return [jax_noise(jax.random.fold_in(jax.random.fold_in(key, e), i))
            for e in epochs for i in range(steps)]


def _run_port(data, monkeypatch, params, noise, **kw):
    """The port's train_multiple_epochs on the CPU, its draw_noise replaced
    by one that hands out `noise` in order; returns (rmse, state, infos)."""
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
        ARR=0.001, seed=1, logger=log, device="cpu", **kw)
    assert next(feed, None) is None     # every step drew its noise
    return rmse, state, infos


def test_trajectory_matches_jax(data, monkeypatch, capsys):
    """Two epochs of two steps (100 pairs, batch 50, ARR 0.001, LR decay
    after every epoch) from the same weights with the same noise: per-epoch
    train loss and test RMSE within 1e-4 relative of JAX's flat-pallas run,
    and the final parameters within atol 2e-5 (each Adam step moves a
    parameter by at most about lr = 1e-3; a gradient at rounding noise can
    flip its sign, which the float32 rounding of four steps keeps far
    below that)."""
    params = igmc_init(jax.random.PRNGKey(7), jax_cfg())
    want_infos = []
    # (the JAX step donates its parameters: hand it a copy)
    want_rmse, want_state = jax_train_multiple_epochs(
        data["train"][0], data["test"][0], jax_fwd(jax_cfg()),
        jax.tree_util.tree_map(jnp.array, params),
        epochs=2, batch_size=BATCH, lr=1e-3, lr_decay_factor=0.1,
        lr_decay_step_size=1, ARR=0.001, seed=1, progress=False,
        flat_aggregate="pallas",
        logger=lambda info, state: want_infos.append(dict(info)))
    want_out = capsys.readouterr().out
    got_rmse, state, got_infos = _run_port(
        data, monkeypatch, params, _noise_list(1, (1, 2), 2))
    got_out = capsys.readouterr().out
    assert [i["epoch"] for i in got_infos] == [1, 2]
    for g, w in zip(got_infos, want_infos):
        for k in ("train_loss", "test_rmse"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert got_rmse == got_infos[-1]["test_rmse"]
    assert got_infos[1]["train_loss"] < got_infos[0]["train_loss"]
    # the same lines on stdout, numbers aside
    strip = lambda out: [" ".join(w for w in line.split(",")[0].split()[:2])
                         for line in out.splitlines()
                         if line.startswith(("Epoch", "Final"))]
    assert strip(got_out) == strip(want_out) == ["Epoch 1", "Epoch 2",
                                                 "Final Test"]
    want_params = params_from_jax(to_numpy(want_state.params))
    for name, p in state.model.state_dict().items():
        torch.testing.assert_close(p, want_params[name], rtol=0, atol=2e-5,
                                   msg=name)
    assert state.epoch == 2 and [h["epoch"] for h in state.history] == [1, 2]
    assert get_learning_rate(state.optimizer) == pytest.approx(1e-5, rel=1e-6)


def test_resume_checkpoints_and_log_format(data, monkeypatch, tmp_path):
    """make_logger writes log.txt in JAX's format and .pth checkpoints that
    JAX loads; a run resumed from epoch 1's checkpoints equals the
    uninterrupted run exactly (same order, noise, weights and Adam state)."""
    params = igmc_init(jax.random.PRNGKey(8), jax_cfg())
    res = ResultsDir(str(tmp_path), "ml_1m", "_port", True)
    noise = _noise_list(2, (1, 2), 2)
    _, full, infos = _run_port(data, monkeypatch, params, noise,
                               logger=make_logger(res, 1))
    for e in (1, 2):
        for kind in ("model", "optimizer"):
            assert os.path.isfile(os.path.join(res.path, f"{kind}_checkpoint{e}.pth"))
    # the JAX package reads the port's model checkpoint
    back = load_reference_checkpoint(os.path.join(res.path, "model_checkpoint2.pth"),
                                     params)
    for name, v in params_from_jax(to_numpy(back)).items():
        torch.testing.assert_close(v, full.model.state_dict()[name], rtol=0, atol=0)
    # log.txt lines as the JAX package's logger writes them
    jres = JaxResultsDir(str(tmp_path), "ml_1m", "_jax", True)
    jlog = jax_make_logger(jres, 1)
    for info in infos:
        jlog(info, None)
    read = lambda d: open(os.path.join(d.path, "log.txt")).read()
    assert read(res) == read(jres) and read(res).count("\n") == 2
    opt = load_optimizer_state(os.path.join(res.path, "optimizer_checkpoint1.pth"))
    assert opt["param_groups"][0]["lr"] == float(np.float32(0.1 * np.float32(1e-3)))

    _, resumed, rinfos = _run_port(data, monkeypatch, params, noise[2:],
                                   continue_from=1, res_dir=res.path)
    assert rinfos == infos[1:]
    for name, p in resumed.model.state_dict().items():
        torch.testing.assert_close(p, full.model.state_dict()[name], rtol=0,
                                   atol=0, msg=name)
    sd = load_checkpoint(os.path.join(res.path, "model_checkpoint2.pth"))
    for name, p in sd.items():
        torch.testing.assert_close(p, full.model.state_dict()[name], rtol=0, atol=0)


def test_train_multiple_epochs_refuses_what_is_not_ported(data, monkeypatch):
    args = (data["train"][1], data["test"][1],
            IGMC(port_cfg(), torch.Generator().manual_seed(0)), 1, BATCH, 1e-3,
            0.1, 50)
    for kw, match in (({"flat_aggregate": "segment"}, "segment"),
                      ({"batch_mode": "dense", "dense_chunk": 10}, "dense_chunk"),
                      ({"mesh": object()}, "mesh"),
                      ({"batch_mode": "dense", "mesh": object()}, "mesh"),
                      ({"dense_chunk": 10}, "dense_chunk")):
        with pytest.raises(NotImplementedError, match=match):
            train_multiple_epochs(*args, device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_multiple_epochs(*args)        # default device: the card


def test_draw_noise_is_seeded_and_shaped():
    a = draw_noise(torch.Generator().manual_seed(3), 7)
    b = draw_noise(torch.Generator().manual_seed(3), 7)
    assert a[0] == b[0] and torch.equal(a[1], b[1])
    assert 0 <= a[0] < 2**31 - 1 and isinstance(a[0], int)
    assert a[1].shape == (7, HIDDEN) and a[1].dtype == torch.bool
