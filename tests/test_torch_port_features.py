"""Side features in igmc_torch against the JAX package on the CPU, on a
small ML-1M-format fixture whose users.dat and movies.dat give one-hot
features (gender, age, occupation, zip code; genres): the target rows
through extraction (both engines), the packed tables, collate,
collate_dense and assemble_dense (both slot layouts) equal JAX's exactly;
IGMC with side features matches igmc_forward in eval mode on the flat
layout (the plain version of K1 against JAX's interpret-mode Pallas path)
and on both dense layouts; one training step's loss and gradients, lin1's
feature columns included, match jax.value_and_grad with JAX's dropout
noise injected."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from igmc_tpu.batching.batch import collate as jax_collate
from igmc_tpu.batching.dataset import BatchLoader as JaxBatchLoader
from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStaticGraphDataset
from igmc_tpu.batching.dense import collate_dense as jax_collate_dense
from igmc_tpu.batching.device_data import DeviceDataset as JaxDeviceDataset
from igmc_tpu.batching.device_data import assemble_dense as jax_assemble_dense
from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
from igmc_tpu.data.synthetic import write_ml1m_format
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import igmc_forward, igmc_init
from igmc_tpu.ops.dropout import edge_dropout_dense as jax_edge_dropout_dense
from igmc_tpu.train.loop import _make_loss_fn
from igmc_tpu.train.torch_interop import state_dict_from_params

from igmc_torch.batching import (BatchLoader, DeviceDataset, StaticGraphDataset,
                                 assemble_dense, collate, collate_dense,
                                 plan_bipartite_buckets, plan_dense_buckets)
from igmc_torch.data import create_trainvaltest_split
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.train import loss_fn

torch.set_num_threads(1)

N_PAIRS = 60
BATCH = 20
HIDDEN = 128
FEATURES = ("u_feat", "v_feat")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(JAX dataset, port dataset, n_side) of 60 training pairs of a
    150 x 120, 6,000-rating ml_1m fixture with its side features (h 1, at
    most 30 nodes per hop, the NumPy engine on both sides)."""
    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=150, n_movies=120, n_ratings=6000, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        ws = jax_split("ml_1m", seed=1234, testing=True, verbose=False)
        gs = create_trainvaltest_split("ml_1m", seed=1234, testing=True,
                                       verbose=False)
    uf, vf = ws.u_features.toarray(), ws.v_features.toarray()
    links = (ws.train_u_indices, ws.train_v_indices)
    common = dict(h=1, max_nodes_per_hop=30, max_num=N_PAIRS, backend="numpy")
    jds = JaxStaticGraphDataset(None, ws.adj_train, links, ws.train_labels,
                                u_features=uf, v_features=vf,
                                class_values=ws.class_values, progress=False,
                                **common)
    # the port takes its own split's sparse matrices and densifies them
    port_inputs = (gs.adj_train, links, gs.train_labels)
    port_kw = dict(u_features=gs.u_features, v_features=gs.v_features,
                   class_values=gs.class_values, **common)
    pds = StaticGraphDataset(*port_inputs, **port_kw)
    return jds, pds, uf.shape[1] + vf.shape[1], (port_inputs, port_kw)


def test_packed_features_match_jax(data):
    jds, pds, n_side, (inputs, kw) = data
    for f in FEATURES:
        got, want = getattr(pds.packed, f), getattr(jds.packed, f)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert pds.packed.u_feat.shape[1] + pds.packed.v_feat.shape[1] == n_side
    assert pds.packed.u_feat.sum(axis=1).min() == 4     # 4 one-hot columns
    for i in (0, 7, N_PAIRS - 1):
        g, w = pds.get(i), jds.get(i)
        for f in FEATURES:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    # the C++ engine carries the same target rows
    native = StaticGraphDataset(*inputs, **dict(kw, backend="native"))
    for f in FEATURES:
        np.testing.assert_array_equal(getattr(native.packed, f),
                                      getattr(jds.packed, f), err_msg=f)


def test_collate_matches_jax(data):
    jds, pds = data[:2]
    idx = list(range(5, 5 + BATCH - 3))
    gg, wg = [pds.get(i) for i in idx], [jds.get(i) for i in idx]
    n = sum(g.num_nodes for g in gg) + 8
    e = sum(g.num_edges for g in gg) + 16
    got, want = collate(gg, BATCH, n, e), jax_collate(wg, BATCH, n, e)
    for f in FEATURES:
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f))
    assert not got.u_feat[len(idx):].any()             # padding graphs: zeros
    moved = got.to("meta")
    assert moved.u_feat.device.type == moved.v_feat.device.type == "meta"


def _buckets(pds, bipartite):
    nu = pds.packed.num_u
    if bipartite:
        return plan_bipartite_buckets(nu, pds.node_counts() - nu,
                                      pds.edge_counts() // 2)
    return plan_dense_buckets(pds.node_counts(), pds.edge_counts() // 2)


@pytest.mark.parametrize("bipartite", [False, True])
def test_dense_collate_and_assembly_match_jax(data, bipartite):
    jds, pds = data[:2]
    dd = DeviceDataset(pds.packed, "cpu")
    jdd = JaxDeviceDataset(jds.packed, 8, 16, BATCH)
    for f in FEATURES:
        np.testing.assert_array_equal(getattr(dd, f).numpy(), np.asarray(getattr(jdd, f)))
    for b in _buckets(pds, bipartite):
        idx = b.indices[:BATCH]
        got = collate_dense([pds.get(int(i)) for i in idx], BATCH + 2, b.node_slot,
                            b.edge_slot, b.num_u_slot)
        want = jax_collate_dense([jds.get(int(i)) for i in idx], BATCH + 2,
                                 b.node_slot, b.edge_slot, b.num_u_slot)
        for f in FEATURES:
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f))
        gids = np.concatenate([idx[:3], [-1], idx[3:6], [-1]]).astype(np.int64)
        got = assemble_dense(dd, torch.from_numpy(gids), b.node_slot, b.edge_slot,
                             b.num_u_slot)
        want = jax_assemble_dense(jdd, jnp.asarray(gids, jnp.int32), b.node_slot,
                                  b.edge_slot, b.num_u_slot)
        for f in FEATURES:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
        assert not got.v_feat[gids < 0].any()


def jax_cfg(n_side, **kw):
    return JaxIGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                         num_relations=5, num_bases=4, side_features=True,
                         n_side_features=n_side, **kw)


def port_model(params, n_side):
    model = IGMC(IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                            num_relations=5, num_bases=4, side_features=True,
                            n_side_features=n_side, flat_aggregate="pallas"),
                 torch.Generator().manual_seed(0))
    assert model.lin1.weight.shape == (HIDDEN, 256 + n_side)
    model.load_state_dict(state_dict_from_params(params))
    return model


def _batches(data, layout, train):
    """(JAX batch, port batch) of the first BATCH graphs: flat (the
    aggregate kernel's plans, with the twin plan when `train`), or dense in
    the first bucket of the layout."""
    jds, pds = data[:2]
    if layout == "flat":
        kw = dict(shuffle=True, seed=2) if train else {}
        want = next(iter(JaxBatchLoader(jds, BATCH, device_put=False, prefetch=0,
                                        flat_aggregate="pallas", **kw)))
        got = next(iter(BatchLoader(pds, BATCH, flat_aggregate="pallas", **kw)))
        return want, got
    b = _buckets(pds, layout == "bipartite")[0]
    idx = b.indices[:BATCH]
    got = collate_dense([pds.get(int(i)) for i in idx], BATCH, b.node_slot,
                        b.edge_slot, b.num_u_slot)
    want = jax_collate_dense([jds.get(int(i)) for i in idx], BATCH, b.node_slot,
                             b.edge_slot, b.num_u_slot)
    return want, got


@pytest.mark.parametrize("layout", ["flat", "unified", "bipartite"])
def test_eval_forward_with_features_matches_jax(data, layout):
    n_side = data[2]
    params = igmc_init(jax.random.PRNGKey(3), jax_cfg(n_side))
    cfg = jax_cfg(n_side, use_pallas=layout == "flat",
                  flat_aggregate="pallas" if layout == "flat" else "segment")
    want_batch, got_batch = _batches(data, layout, train=False)
    want = np.asarray(igmc_forward(params, want_batch, cfg, None, False))
    with torch.no_grad():
        got = port_model(params, n_side).eval()(got_batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the features reach the prediction
    params0 = dict(params, lin1=dict(params["lin1"]))
    params0["lin1"]["weight"] = params["lin1"]["weight"].at[256:].set(0.0)
    assert np.abs(np.asarray(igmc_forward(params0, want_batch, cfg, None, False))
                  - want).max() > 1e-4


def _noise(key, layout, batch):
    """The noise igmc_forward draws from `key` in training mode, as the
    port's (edge noise, feature_keep)."""
    key, k_edge = jax.random.split(key)
    if layout == "flat":
        edge = int(jax.random.randint(k_edge, (), 0, jnp.iinfo(jnp.int32).max))
    else:
        keep_f, keep_r = jax_edge_dropout_dense(
            k_edge, jnp.ones(batch.edge_mask.shape, bool), 0.2, False, True)
        edge = (torch.from_numpy(np.array(keep_f)), torch.from_numpy(np.array(keep_r)))
    key, k_drop = jax.random.split(key)
    keep = jax.random.bernoulli(k_drop, 0.5, (batch.y.shape[0], HIDDEN))
    return edge, torch.from_numpy(np.array(keep))


@pytest.mark.parametrize("layout", ["flat", "unified", "bipartite"])
def test_training_step_gradients_with_features_match_jax(data, layout):
    """Loss to rtol 1e-5; every gradient, lin1's feature columns included,
    to rtol 1e-4 / atol 1e-4 of its largest entry."""
    n_side = data[2]
    params = igmc_init(jax.random.PRNGKey(6), jax_cfg(n_side))
    cfg = jax_cfg(n_side, use_pallas=layout == "flat",
                  flat_aggregate="pallas" if layout == "flat" else "segment")
    want_batch, got_batch = _batches(data, layout, train=True)
    key = jax.random.PRNGKey(21)
    fwd = lambda p, b, key=None, training=False: igmc_forward(p, b, cfg, key,
                                                              training)
    (want_loss, _), grads = jax.value_and_grad(
        _make_loss_fn(fwd, 0.001, True), has_aux=True)(params, want_batch, key)
    model = port_model(params, n_side).train()
    loss, _ = loss_fn(model, got_batch, _noise(key, layout, want_batch), 0.001)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_grads = state_dict_from_params(grads)
    for name, p in model.named_parameters():
        w = want_grads[name]
        torch.testing.assert_close(p.grad, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()) + 1e-12,
                                   msg=name)
    feature_cols = model.lin1.weight.grad[:, 256:]
    assert feature_cols.shape == (HIDDEN, n_side) and feature_cols.abs().max() > 0


def test_side_features_need_feature_rows(data):
    (adj, links, labels), _ = data[3]
    bare = StaticGraphDataset(adj, links, labels, h=1, max_num=4, backend="numpy")
    batch = next(iter(BatchLoader(bare, 4)))
    assert batch.u_feat is None and bare.packed.u_feat is None
    model = IGMC(IGMCConfig(side_features=True, n_side_features=data[2]),
                 torch.Generator().manual_seed(0)).eval()
    with pytest.raises(ValueError, match="u_feat"), torch.no_grad():
        model(batch)
