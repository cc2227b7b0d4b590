"""igmc_torch's dense R-GCN layer and dense IGMC forward against the JAX
package on the CPU: rgcn_dense_apply / rgcn_dense_bipartite_apply (forward
and the gradients of x, att, basis, root and bias) on
__graft_entry__._synthetic_dense_batch in both slot layouts, for aggr mean,
sum and relmean with distinct forward and reverse masks; the dense
igmc_forward in eval mode and in training mode with JAX's dropout masks
injected; ARR."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _synthetic_dense_batch
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import arr_regularizer as jax_arr_regularizer
from igmc_tpu.models.igmc import igmc_forward, igmc_init
from igmc_tpu.models.rgcn import (rgcn_dense_apply as jax_dense_apply,
                                  rgcn_dense_bipartite_apply as jax_bip_apply,
                                  rgcn_init)
from igmc_tpu.ops.dropout import edge_dropout_dense as jax_edge_dropout_dense

from igmc_torch.batching import DenseBatch
from igmc_torch.models import (IGMC, IGMCConfig, RGCNConv, arr_regularizer,
                               rgcn_dense_apply, rgcn_dense_bipartite_apply)
from igmc_torch.ops import edge_dropout_dense, hash_edge_keep
from igmc_torch.train import params_from_jax

torch.set_num_threads(1)

B, N_SLOT, E_SLOT, R = 8, 32, 64, 5
HIDDEN = 128
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def jax_batch(bipartite, seed=0):
    return _synthetic_dense_batch(num_graphs=B, node_slot=N_SLOT, edge_slot=E_SLOT,
                                  num_relations=R, seed=seed, bipartite=bipartite)


def to_port(jb) -> DenseBatch:
    t = lambda a: torch.from_numpy(np.asarray(a))
    return DenseBatch(node_label=t(jb.node_label), edge_src=t(jb.edge_src),
                      edge_dst=t(jb.edge_dst), edge_type=t(jb.edge_type),
                      node_mask=t(jb.node_mask), edge_mask=t(jb.edge_mask),
                      y=t(jb.y), graph_mask=t(jb.graph_mask), num_u=jb.num_u)


def grad_close(got, want, name):
    """rtol 1e-4, atol 1e-5 of the largest entry of the reference."""
    want = torch.from_numpy(np.array(want))
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()) + 1e-12, msg=name)


@pytest.mark.parametrize("aggr", ["mean", "sum", "relmean"])
@pytest.mark.parametrize("bipartite", [False, True])
@pytest.mark.parametrize("cin", [4, 32])
def test_dense_layer_and_gradients_match_jax(bipartite, aggr, cin):
    jb = jax_batch(bipartite, seed=cin)
    rng = np.random.default_rng(cin)
    params = jax.tree_util.tree_map(np.array,
                                    rgcn_init(jax.random.PRNGKey(cin), cin, 32, R, 4))
    x = rng.uniform(-1, 1, (B, N_SLOT, cin)).astype(np.float32)
    # distinct kept edges per direction
    mask_f = jb.edge_mask & (rng.random(jb.edge_mask.shape) < 0.8)
    mask_r = jb.edge_mask & (rng.random(jb.edge_mask.shape) < 0.8)
    cot = rng.uniform(-1, 1, (B, N_SLOT, 32)).astype(np.float32)
    edges = (jb.edge_src, jb.edge_dst, jb.edge_type)

    def jax_out(p, xx):
        if bipartite:
            return jax_bip_apply(p, xx, jb.num_u, *edges, mask_f, mask_r, aggr)
        return jax_dense_apply(p, xx, *edges, mask_f, mask_r, aggr)

    want = np.asarray(jax_out(params, x))
    want_grads = jax.grad(lambda p, xx: jnp.sum(jax_out(p, xx) * cot),
                          argnums=(0, 1))(params, x)

    conv = RGCNConv(cin, 32, R, 4, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in conv.named_parameters():
            p.copy_(torch.from_numpy(params[name]))
    xt = torch.from_numpy(x).requires_grad_()
    t = lambda a: torch.from_numpy(np.array(a))
    pe = tuple(t(a) for a in edges)
    if bipartite:
        got = rgcn_dense_bipartite_apply(conv, xt, jb.num_u, *pe, t(mask_f),
                                         t(mask_r), aggr)
    else:
        got = rgcn_dense_apply(conv, xt, *pe, t(mask_f), t(mask_r), aggr)
    assert got.shape == (B, N_SLOT, 32) and got.dtype == torch.float32
    torch.testing.assert_close(got.detach(), t(want), **FWD_TOL)
    got.backward(t(cot))
    grad_close(xt.grad, want_grads[1], "x")
    for name, p in conv.named_parameters():
        grad_close(p.grad, want_grads[0][name], name)


def test_dense_layer_refuses_what_is_not_ported():
    jb = to_port(jax_batch(False))
    conv = RGCNConv(4, 32, R, 4, torch.Generator().manual_seed(0))
    x = torch.zeros(B, N_SLOT, 4)
    args = (conv, x, jb.edge_src, jb.edge_dst, jb.edge_type, jb.edge_mask,
            jb.edge_mask)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        rgcn_dense_apply(*args, compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="edge-k"):
        rgcn_dense_apply(*args, per_basis=True)
    with pytest.raises(ValueError, match="aggr"):
        rgcn_dense_apply(*args, aggr="max")
    with pytest.raises(ValueError, match="num_u"):
        rgcn_dense_bipartite_apply(conv, x, N_SLOT, *args[2:])


def jax_cfg(**kw):
    return JaxIGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                         num_relations=R, num_bases=4, **kw)


def port_model(params, **kw):
    model = IGMC(IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                            num_relations=R, num_bases=4, **kw),
                 torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def jax_dense_noise(key, batch_size, edge_slot, p=0.2, force_undirected=False):
    """The masks _igmc_forward_dense draws from `key` in training mode, as
    the port's injected noise ((keep_f, keep_r), feature_keep)."""
    key, k_edge = jax.random.split(key)
    keep_f, keep_r = jax_edge_dropout_dense(
        k_edge, jnp.ones((batch_size, edge_slot), bool), p, force_undirected, True)
    key, k_drop = jax.random.split(key)
    keep = jax.random.bernoulli(k_drop, 0.5, (batch_size, HIDDEN))
    t = lambda a: torch.from_numpy(np.array(a))
    return (t(keep_f), t(keep_r)), t(keep)


@pytest.mark.parametrize("bipartite", [False, True])
@pytest.mark.parametrize("kw", [{}, {"aggr": "relmean"},
                                {"aggr": "sum", "force_undirected": True,
                                 "adj_dropout": 0.4, "multiply_by": 2.0}])
def test_dense_igmc_forward_matches_jax(bipartite, kw):
    """Eval predictions, and training predictions with JAX's edge and
    feature masks injected, agree to atol 1e-4 (float32 through four
    layers, another summation order); ARR agrees to rtol 1e-5."""
    jb = jax_batch(bipartite, seed=3)
    params = igmc_init(jax.random.PRNGKey(4), jax_cfg())
    model = port_model(params, **kw)
    batch = to_port(jb)
    want = np.asarray(igmc_forward(params, jb, jax_cfg(**kw), None, False))
    got = model.eval()(batch)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)

    key = jax.random.PRNGKey(9)
    want_t = np.asarray(igmc_forward(params, jb, jax_cfg(**kw), key, True))
    noise = jax_dense_noise(key, B, E_SLOT, kw.get("adj_dropout", 0.2),
                            kw.get("force_undirected", False))
    got_t = model.train()(batch, noise)
    np.testing.assert_allclose(got_t.detach().numpy(), want_t, rtol=0, atol=1e-4)
    assert np.abs(want_t - want).max() > 1e-3          # the dropout acted
    np.testing.assert_allclose(arr_regularizer(model).item(),
                               float(jax_arr_regularizer(params)), rtol=1e-5)


def test_dense_forward_hash_dropout_needs_edge_ids():
    batch = to_port(jax_batch(False))
    model = IGMC(IGMCConfig(), torch.Generator().manual_seed(0)).train()
    keep = torch.ones(B, HIDDEN, dtype=torch.bool)
    with pytest.raises(ValueError, match="noise"):
        model(batch)
    with pytest.raises(ValueError, match="edge ids"):
        model(batch, (7, keep))
    batch.edge_id = torch.arange(B * E_SLOT).reshape(B, E_SLOT)
    assert torch.isfinite(model(batch, (7, keep))).all()


@pytest.mark.parametrize("force_undirected", [False, True])
def test_edge_dropout_dense_keys(force_undirected):
    """Packed edge i is keyed 2i forward and 2i+1 reverse (or i in both
    directions with force_undirected); padded slots stay dropped."""
    edge_id = torch.arange(300, dtype=torch.int64).reshape(3, 100) * 7
    edge_mask = torch.rand(3, 100, generator=torch.Generator().manual_seed(1)) < 0.9
    mf, mr = edge_dropout_dense(edge_mask, edge_id, 12345, 0.3, force_undirected)
    kf = 1 if force_undirected else 2
    kr = 0 if force_undirected else 1
    assert torch.equal(mf, edge_mask & hash_edge_keep(12345, kf * edge_id, 0.3))
    assert torch.equal(mr, edge_mask & hash_edge_keep(12345, kf * edge_id + kr, 0.3))
    assert torch.equal(mf, mr) == force_undirected
    assert 0.6 < float(mf[edge_mask].float().mean()) < 0.8
    assert edge_dropout_dense(edge_mask, edge_id, 1, 0.0, False) == (edge_mask,
                                                                      edge_mask)
