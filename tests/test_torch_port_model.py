"""igmc_torch IGMC evaluation against the JAX package: parameter interchange,
the flat forward with the fused aggregate (JAX: use_pallas, interpreted on
the CPU) and test_once end to end, single model and checkpoint ensemble."""

import os

import numpy as np
import pytest
import torch

import jax

from igmc_tpu.batching.dataset import BatchLoader as JaxBatchLoader
from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStaticGraphDataset
from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
from igmc_tpu.data.synthetic import write_ml1m_format
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import igmc_forward, igmc_init
from igmc_tpu.train.loop import test_once as jax_test_once
from igmc_tpu.train.torch_interop import (load_reference_checkpoint,
                                          save_reference_checkpoint,
                                          state_dict_from_params)

from igmc_torch.batching import BatchLoader, StaticGraphDataset
from igmc_torch.batching import dataset as port_dataset
from igmc_torch.data import create_trainvaltest_split
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.models import igmc as port_igmc
from igmc_torch.train import (checkpoint_path, load_checkpoint,
                              params_from_jax, resolve_checkpoint, save_pth)
from igmc_torch.train import test_once as port_test_once

torch.set_num_threads(1)

N_PAIRS = 100


def jax_cfg(aggr="mean", rows=256):
    return JaxIGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                         num_relations=5, num_bases=4, aggr=aggr,
                         use_pallas=True, flat_aggregate="pallas",
                         pallas_rows=rows)


def port_cfg(aggr="mean"):
    return IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                      num_relations=5, num_bases=4, aggr=aggr)


def jax_params(seed):
    return igmc_init(jax.random.PRNGKey(seed), jax_cfg())


def to_numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


def port_model(params, aggr="mean"):
    model = IGMC(port_cfg(aggr), torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(to_numpy(params)))
    return model.eval()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(JAX dataset, port dataset) of 100 held-out pairs of a 300 x 400,
    8,000-rating ml_1m fixture (h 1, at most 100 nodes per hop)."""
    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=300, n_movies=400, n_ratings=8000,
                      seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        ws = jax_split("ml_1m", seed=1234, testing=True, verbose=False)
        gs = create_trainvaltest_split("ml_1m", seed=1234, testing=True,
                                       verbose=False)
    want = JaxStaticGraphDataset(
        None, ws.adj_train, (ws.test_u_indices, ws.test_v_indices),
        ws.test_labels, h=1, max_nodes_per_hop=100,
        class_values=ws.class_values, max_num=N_PAIRS, backend="numpy",
        progress=False)
    got = StaticGraphDataset(
        gs.adj_train, (gs.test_u_indices, gs.test_v_indices), gs.test_labels,
        h=1, max_nodes_per_hop=100, class_values=gs.class_values,
        max_num=N_PAIRS)
    return want, got


def test_state_dict_names_and_shapes_match_reference_layout():
    model = IGMC(port_cfg(), torch.Generator().manual_seed(0))
    want = state_dict_from_params(jax_params(0))
    got = model.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k


def test_init_is_seeded_and_bounded():
    a = IGMC(port_cfg(), torch.Generator().manual_seed(1)).state_dict()
    b = IGMC(port_cfg(), torch.Generator().manual_seed(1)).state_dict()
    c = IGMC(port_cfg(), torch.Generator().manual_seed(2)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convs.0.basis"], c["convs.0.basis"])
    for i, cin in enumerate((4, 32, 32, 32)):
        bound = 1.0 / np.sqrt(4 * cin)
        for p in ("basis", "att", "root", "bias"):
            assert float(a[f"convs.{i}.{p}"].abs().max()) <= bound
    assert float(a["lin1.weight"].abs().max()) <= 1.0 / np.sqrt(256)
    assert float(a["lin2.weight"].abs().max()) <= 1.0 / np.sqrt(128)


def test_params_from_jax_equals_reference_export():
    """params_from_jax gives the tensors the JAX package exports as .pth."""
    p = jax_params(3)
    want = state_dict_from_params(p)
    got = params_from_jax(to_numpy(p))
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_pth_round_trip_between_packages(tmp_path):
    p = jax_params(4)
    path = checkpoint_path(str(tmp_path), "model", 7)
    assert path.endswith("model_checkpoint7.pth")
    save_pth(path, port_model(p).state_dict())
    back = load_reference_checkpoint(path, p)          # JAX reads the port's
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref_path = os.path.join(str(tmp_path), "ref.pth")
    save_reference_checkpoint(ref_path, p)             # the port reads JAX's
    sd = load_checkpoint(ref_path)
    for k, v in params_from_jax(to_numpy(p)).items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_resolve_checkpoint_and_ckpt_refusal(tmp_path):
    d = str(tmp_path)
    assert resolve_checkpoint(d, "model", 5) == os.path.join(d, "model_checkpoint5.pth")
    ckpt = os.path.join(d, "model_checkpoint5.ckpt")
    open(ckpt, "wb").close()
    assert resolve_checkpoint(d, "model", 5) == ckpt
    with pytest.raises(NotImplementedError, match="msgpack"):
        load_checkpoint(ckpt)
    save_pth(os.path.join(d, "model_checkpoint5.pth"),
             IGMC(port_cfg(), torch.Generator().manual_seed(0)).state_dict())
    assert resolve_checkpoint(d, "model", 5).endswith(".pth")


@pytest.mark.parametrize("aggr,rows,eblk", [("mean", 256, 1024),
                                            ("sum", 256, 1024),
                                            ("mean", 64, 256)])
def test_forward_matches_jax_pallas(data, monkeypatch, aggr, rows, eblk):
    """Same weights (carried by params_from_jax), same batch: predictions
    agree to atol 1e-4 (float32, another summation order)."""
    want_ds, got_ds = data
    # the port's plan geometry is module constants of the loader and model
    monkeypatch.setattr(port_dataset, "PLAN_ROWS", rows)
    monkeypatch.setattr(port_dataset, "PLAN_EBLK", eblk)
    monkeypatch.setattr(port_igmc, "PLAN_ROWS", rows)
    params = jax_params(5)
    cfg = jax_cfg(aggr, rows)
    want_batch = next(iter(JaxBatchLoader(
        want_ds, 50, device_put=False, prefetch=0, flat_aggregate="pallas",
        plan_rows=rows, plan_eblk=eblk)))
    want = np.asarray(igmc_forward(params, want_batch, cfg, None, False))
    got_batch = next(iter(BatchLoader(got_ds, 50)))
    assert got_batch.num_nodes % rows == 0
    with torch.no_grad():
        got = port_model(params, aggr)(got_batch)
    assert got.shape == (50,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_forward_refuses_training_mode_and_other_aggr(data):
    _, got_ds = data
    batch = next(iter(BatchLoader(got_ds, 10)))
    model = IGMC(port_cfg(), torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="eval"):
        model.train()(batch)
    relmean = IGMC(IGMCConfig(aggr="relmean"), torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="relmean"):
        relmean.eval()(batch)


def _jax_fwd(cfg):
    return lambda p, b, key=None, training=False: igmc_forward(p, b, cfg, key,
                                                               training)


def test_test_once_matches_jax(data, capsys):
    """One model over 100 held-out pairs: RMSE within 1e-5 of JAX's."""
    want_ds, got_ds = data
    params = jax_params(6)
    want = jax_test_once(want_ds, _jax_fwd(jax_cfg()), params, 50,
                         params=params, flat_aggregate="pallas")
    template = IGMC(port_cfg(), torch.Generator().manual_seed(0))
    got = port_test_once(got_ds, template, 50,
                         params=params_from_jax(to_numpy(params)),
                         device="cpu")
    assert abs(got - want) <= 1e-5, (got, want)
    assert "Test Once RMSE:" in capsys.readouterr().out
    # the caller's model is left as it was
    assert not torch.equal(template.state_dict()["lin2.bias"],
                           params_from_jax(to_numpy(params))["lin2.bias"])


def test_test_once_ensemble_matches_jax(data, tmp_path):
    """Prediction mean of two reference .pth checkpoints written by the JAX
    package: RMSE within 1e-5 of JAX's ensemble."""
    want_ds, got_ds = data
    ckpts = []
    for seed in (7, 8):
        ckpts.append(os.path.join(str(tmp_path), f"model_checkpoint{seed}.pth"))
        save_reference_checkpoint(ckpts[-1], jax_params(seed))
    want = jax_test_once(want_ds, _jax_fwd(jax_cfg()), jax_params(0), 50,
                         ensemble=True, checkpoints=ckpts,
                         flat_aggregate="pallas")
    logged = []
    got = port_test_once(got_ds, IGMC(port_cfg(), torch.Generator().manual_seed(0)),
                         50, ensemble=True, checkpoints=ckpts, device="cpu",
                         logger=lambda rec, _: logged.append(rec))
    assert abs(got - want) <= 1e-5, (got, want)
    assert logged == [{"epoch": "ensemble", "train_loss": 0, "test_rmse": got}]


def test_test_once_refuses_other_engines_and_missing_cuda(data, monkeypatch):
    _, got_ds = data
    model = IGMC(port_cfg(), torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="segment"):
        port_test_once(got_ds, model, 50, flat_aggregate="segment", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test_once(got_ds, model, 50)      # default device: the card
