"""igmc_torch's GNN, DGCNN and DGCNN_RS families against the JAX package
on the CPU, at the CLI's widths on small dense batches:

  * gcn_dense_apply (forward and the gradients of x, weight and bias) with
    distinct forward and reverse masks and padding rows;
  * dense_sort_pool bit for bit (ties, masked slots, k above and below the
    node slot), and its gradient;
  * each family's forward in eval mode and in training mode with JAX's
    dropout masks injected, and its parameter gradients, the weights
    carried over by params_from_jax; ARR; the reference's state_dict names
    (the JAX package's state_dict_from_params loads strictly);
  * sortpool_k_from_dataset;
  * the training loop for every family: the chunked giant-batch step equal
    to the whole-row step, and training on static (device-assembled) and
    dynamic (host-collated) data;
  * the port CLI with --model gnn, dgcnn and dgcnn_rs on the flixster
    fixture with --debug, beside the JAX CLI's printed lines, and the
    JAX CLI's refusals for the families.

DGCNN's SortPool ranks nodes by a float32 channel that the two packages
agree on only to about 1e-7, so two nodes whose keys are closer than that
could swap rows between them. The forward comparisons use inputs whose
last-channel keys are either equal (equal inputs: the same in both
packages, and a stable sort keeps slot order) or more than KEY_GAP apart
(TIE_FREE_SEED); each test asserts that of its inputs before comparing.
At random weights such near-ties are common (48 of 49 seeds of the test
batch have one), so dense_sort_pool itself is held bit for bit on the
same input, ties included.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _synthetic_dense_batch
from igmc_tpu.cli.main import main as jax_main
from igmc_tpu.models.igmc import DGCNNConfig as JaxDGCNNConfig
from igmc_tpu.models.igmc import GNNConfig as JaxGNNConfig
from igmc_tpu.models.igmc import _gcn_trunk_dense
from igmc_tpu.models.igmc import arr_regularizer as jax_arr_regularizer
from igmc_tpu.models.igmc import (dgcnn_forward, dgcnn_init, gnn_forward, gnn_init,
                                  sortpool_k_from_dataset as jax_sortpool_k)
from igmc_tpu.models.rgcn import gcn_dense_apply as jax_gcn_dense_apply
from igmc_tpu.models.rgcn import gcn_init, rgcn_dense_apply as jax_rgcn_dense_apply
from igmc_tpu.ops.dropout import edge_dropout_dense as jax_edge_dropout_dense
from igmc_tpu.ops.sort_pool import dense_sort_pool as jax_dense_sort_pool
from igmc_tpu.train.torch_interop import state_dict_from_params

from igmc_torch.batching import DenseBatch, DynamicGraphDataset, StaticGraphDataset
from igmc_torch.cli.main import main as port_main
from igmc_torch.data import load_data_monti
from igmc_torch.graphs import BipartiteCSR
from igmc_torch.models import (DGCNN, GNN, DGCNNConfig, GCNConv, GNNConfig,
                               arr_regularizer, draw_noise, gcn_dense_apply,
                               sortpool_k_from_dataset)
from igmc_torch.ops import dense_sort_pool
from igmc_torch.train import (DensePass, make_dense_row_step, make_optimizer,
                              params_from_jax, plan_buckets, train_multiple_epochs)
from igmc_torch.batching.device_data import DeviceDataset

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "monti")
B, N_SLOT, E_SLOT, R = 8, 32, 64, 5
HIDDEN = 128
KEY_GAP = 1e-5
# varied_batch's seed for the family comparisons: of seeds 11-59 it is the
# one whose DGCNN and DGCNN_RS keys (eval and training, PRNGKey(5) weights)
# have no gap in (0, KEY_GAP]; assert_key_gaps checks it in the test
TIE_FREE_SEED = 39
FWD_ATOL = 1e-4
FAMILIES = ("gnn", "dgcnn", "dgcnn_rs")
FLIXSTER_R = 10                 # the flixster fixture's rating levels


def varied_batch(seed: int):
    """_synthetic_dense_batch with graphs of different sizes: graph b keeps
    its first n_b node rows and the edges between them."""
    jb = _synthetic_dense_batch(num_graphs=B, node_slot=N_SLOT, edge_slot=E_SLOT,
                                num_relations=R, seed=seed)
    rng = np.random.default_rng(seed)
    sizes = rng.integers(6, N_SLOT + 1, B)
    sizes[0] = 4                                     # fewer nodes than any k
    keep_nodes = np.arange(N_SLOT)[None, :] < sizes[:, None]
    jb.node_mask = jb.node_mask & keep_nodes
    inside = (np.take_along_axis(jb.node_mask, jb.edge_src, 1)
              & np.take_along_axis(jb.node_mask, jb.edge_dst, 1))
    jb.edge_mask = jb.edge_mask & inside
    return jb


def to_port(jb) -> DenseBatch:
    t = lambda a: torch.from_numpy(np.asarray(a))
    return DenseBatch(node_label=t(jb.node_label), edge_src=t(jb.edge_src),
                      edge_dst=t(jb.edge_dst), edge_type=t(jb.edge_type),
                      node_mask=t(jb.node_mask), edge_mask=t(jb.edge_mask),
                      y=t(jb.y), graph_mask=t(jb.graph_mask), num_u=jb.num_u)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def grad_close(got, want, name):
    """rtol 1e-4, atol 1e-4 of the largest entry of the reference."""
    want = torch.from_numpy(np.array(want))
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()) + 1e-12, msg=name)


def jax_dense_noise(key, p=0.2):
    """The masks every family's dense forward draws from `key` in training
    mode (edge dropout first, then lin1's feature dropout), as the port's
    injected noise ((keep_f, keep_r), feature_keep)."""
    key, k_edge = jax.random.split(key)
    keep_f, keep_r = jax_edge_dropout_dense(
        k_edge, jnp.ones((B, E_SLOT), bool), p, False, True)
    key, k_drop = jax.random.split(key)
    keep = jax.random.bernoulli(k_drop, 0.5, (B, HIDDEN))
    t = lambda a: torch.from_numpy(np.array(a))
    return (t(keep_f), t(keep_r)), t(keep)


def assert_key_gaps(keys, node_mask):
    """Per graph, the valid nodes' keys are equal or more than KEY_GAP
    apart, so their rank order cannot differ between the packages."""
    for b in range(keys.shape[0]):
        k = np.sort(keys[b][node_mask[b]])
        gaps = np.diff(k)
        assert np.all((gaps == 0) | (gaps > KEY_GAP)), (b, gaps[(gaps > 0)].min())


# -- the layers -----------------------------------------------------------------

@pytest.mark.parametrize("cin", [4, 32])
def test_gcn_dense_layer_and_gradients_match_jax(cin):
    jb = varied_batch(cin)
    rng = np.random.default_rng(cin)
    params = to_numpy(gcn_init(jax.random.PRNGKey(cin), cin, 32))
    params["bias"] = rng.uniform(-0.5, 0.5, 32).astype(np.float32)
    x = rng.uniform(-1, 1, (B, N_SLOT, cin)).astype(np.float32)
    mask_f = jb.edge_mask & (rng.random(jb.edge_mask.shape) < 0.8)
    mask_r = jb.edge_mask & (rng.random(jb.edge_mask.shape) < 0.8)
    cot = rng.uniform(-1, 1, (B, N_SLOT, 32)).astype(np.float32)

    def jax_out(p, xx):
        return jax_gcn_dense_apply(p, xx, jb.edge_src, jb.edge_dst, mask_f, mask_r,
                                   jb.node_mask)

    want = np.asarray(jax_out(params, x))
    want_grads = jax.grad(lambda p, xx: jnp.sum(jax_out(p, xx) * cot),
                          argnums=(0, 1))(params, x)
    conv = GCNConv(cin, 32, torch.Generator().manual_seed(0))
    assert float(conv.bias.detach().abs().max()) == 0.0
    with torch.no_grad():
        for name, p in conv.named_parameters():
            p.copy_(torch.from_numpy(params[name]))
    t = lambda a: torch.from_numpy(np.array(a))
    xt = t(x).requires_grad_()
    got = gcn_dense_apply(conv, xt, t(jb.edge_src), t(jb.edge_dst), t(mask_f),
                          t(mask_r), t(jb.node_mask))
    assert got.shape == (B, N_SLOT, 32) and got.dtype == torch.float32
    torch.testing.assert_close(got.detach(), t(want), rtol=1e-5, atol=1e-5)
    got.backward(t(cot))
    grad_close(xt.grad, want_grads[1], "x")
    for name, p in conv.named_parameters():
        grad_close(p.grad, want_grads[0][name], name)


@pytest.mark.parametrize("k", [1, 10, 24, 40])
def test_dense_sort_pool_matches_jax_bit_for_bit(k):
    """Ties (keys drawn from a few values, equal rows), masked slots whose
    keys are larger than every valid one, and k above the node slot (zero
    padding): the same bits as JAX's; the gradient is the gather's."""
    rng = np.random.default_rng(k)
    n, D = 24, 5
    x = rng.normal(size=(B, n, D)).astype(np.float32)
    x[..., -1] = rng.choice(np.float32([-1.5, 0.0, 0.25, 2.0]), (B, n))
    x[:, 3] = x[:, 7]                                       # whole equal rows
    node_mask = rng.random((B, n)) < 0.75
    node_mask[0, 5:] = False                                # a graph of <= 5 nodes
    x[~node_mask, -1] = 9.0                                 # masked: never first
    want = np.asarray(jax_dense_sort_pool(jnp.asarray(x), jnp.asarray(node_mask), k))
    xt = torch.from_numpy(x).requires_grad_()
    got = dense_sort_pool(xt, torch.from_numpy(node_mask), k)
    assert got.shape == (B, k * D) and got.dtype == torch.float32
    assert np.array_equal(got.detach().numpy(), want)
    cot = rng.normal(size=(B, k * D)).astype(np.float32)
    want_g = jax.grad(lambda xx: jnp.sum(jax_dense_sort_pool(
        xx, jnp.asarray(node_mask), k) * cot))(jnp.asarray(x))
    got.backward(torch.from_numpy(cot))
    assert np.array_equal(xt.grad.numpy(), np.asarray(want_g))


def test_sortpool_k_from_dataset_matches_jax():
    rng = np.random.default_rng(0)
    for counts in (rng.integers(2, 200, 1000), [3, 4, 5], [50],
                   rng.integers(10, 40, 7)):
        for frac in (0.1, 0.6, 1.0):
            assert sortpool_k_from_dataset(counts, frac) == jax_sortpool_k(counts, frac)


# -- the families ---------------------------------------------------------------

def jax_family(name: str, k: int = 20):
    """(JAX config, init, forward) of a family at the CLI's widths."""
    if name == "gnn":
        return JaxGNNConfig(num_features=4), gnn_init, gnn_forward
    cfg = JaxDGCNNConfig(num_features=4, latent_dim=(32, 32, 32, 1), k=k,
                         relational=name == "dgcnn_rs", num_relations=R, num_bases=4)
    return cfg, dgcnn_init, dgcnn_forward


def port_family(name: str, params, k: int = 20, num_relations: int = R):
    gen = torch.Generator().manual_seed(0)
    if name == "gnn":
        model = GNN(GNNConfig(num_features=4), gen)
    else:
        model = DGCNN(DGCNNConfig(num_features=4, latent_dim=(32, 32, 32, 1), k=k,
                                  relational=name == "dgcnn_rs",
                                  num_relations=num_relations, num_bases=4), gen)
    if params is not None:
        model.load_state_dict(params_from_jax(to_numpy(params)))
    return model


def jax_sort_keys(name, params, jb, cfg, key, training):
    """The last channel of the trunk's states that DGCNN's SortPool ranks."""
    if name == "dgcnn_rs":
        mask_f = mask_r = jb.edge_mask
        if training:
            _, k_edge = jax.random.split(key)
            mask_f, mask_r = jax_edge_dropout_dense(k_edge, jb.edge_mask, 0.2,
                                                    False, True)
        x = jax.nn.one_hot(jb.node_label, 4) * jb.node_mask[..., None]
        for conv in params["convs"]:
            x = jnp.tanh(jax_rgcn_dense_apply(conv, x, jb.edge_src, jb.edge_dst,
                                              jb.edge_type, mask_f, mask_r))
        return np.asarray(x[..., -1])
    states, _ = _gcn_trunk_dense(params["convs"], jb, cfg, key, training)
    return np.asarray(states[..., -1])


@pytest.mark.parametrize("name", FAMILIES)
def test_family_forward_and_gradients_match_jax(name):
    """Eval predictions, and training predictions with JAX's edge and
    feature masks injected, agree to atol FWD_ATOL; every parameter
    gradient of the training loss to 1e-4 of its largest entry; ARR to
    rtol 1e-5 (0 for the GCN families)."""
    jb = varied_batch(TIE_FREE_SEED)
    cfg, init, forward = jax_family(name)
    params = init(jax.random.PRNGKey(5), cfg)
    model = port_family(name, params)
    batch = to_port(jb)
    key = jax.random.PRNGKey(9)
    if name != "gnn":
        for k_, training in ((None, False), (key, True)):
            assert_key_gaps(jax_sort_keys(name, params, jb, cfg, k_, training),
                            jb.node_mask)

    want = np.asarray(forward(params, jb, cfg, None, False))
    got = model.eval()(batch)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=FWD_ATOL)

    want_t = np.asarray(forward(params, jb, cfg, key, True))
    noise = jax_dense_noise(key)
    got_t = model.train()(batch, noise)
    np.testing.assert_allclose(got_t.detach().numpy(), want_t, rtol=0, atol=FWD_ATOL)
    assert np.abs(want_t - want).max() > 1e-3          # the dropout acted

    y = np.asarray(jb.y)
    jax_loss = lambda p: (jnp.mean((forward(p, jb, cfg, key, True) - y) ** 2)
                          + 0.001 * jax_arr_regularizer(p))
    want_grads = jax.grad(jax_loss)(params)
    model.zero_grad()
    loss = (((model(batch, noise) - batch.y) ** 2).mean()
            + 0.001 * arr_regularizer(model))
    loss.backward()
    want_sd = params_from_jax(to_numpy(want_grads))
    for pname, p in model.named_parameters():
        grad_close(p.grad, want_sd[pname], pname)
    want_arr = float(jax_arr_regularizer(params))
    np.testing.assert_allclose(float(arr_regularizer(model)), want_arr, rtol=1e-5)
    assert (want_arr > 0) == (name == "dgcnn_rs")


@pytest.mark.parametrize("name", FAMILIES)
def test_family_state_dict_names_are_the_references(name):
    """The JAX package's reference state_dict (state_dict_from_params)
    loads strictly into the port's module, and params_from_jax gives the
    same tensors; the parameter count is JAX's."""
    cfg, init, _ = jax_family(name, k=30)
    params = init(jax.random.PRNGKey(2), cfg)
    model = port_family(name, None, k=30)
    ref = state_dict_from_params(params)
    model.load_state_dict(ref, strict=True)
    ours = params_from_jax(to_numpy(params))
    assert set(ours) == set(model.state_dict())
    for k_, v in ours.items():
        assert torch.equal(v, ref[k_]), k_
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_families_refuse_flat_batches_and_need_noise_in_training():
    """Flat batches, refused until the segment engine was ported, are taken
    (test_flat_family_forward_and_gradients_match_jax); training mode
    without noise is refused on either layout, as is a relation-slotted
    dense batch."""
    import dataclasses

    model = port_family("dgcnn", None)
    with pytest.raises(ValueError, match="noise"):
        model.train()(to_port(varied_batch(1)))
    with pytest.raises(ValueError, match="noise"):
        model.train()(flat_batch(varied_batch(1)))
    with pytest.raises(NotImplementedError, match="relation-slotted"):
        model.eval()(dataclasses.replace(to_port(varied_batch(1)), rel_caps=(64,)))


def flat_batch(jb):
    """The flat GraphBatch of the same graphs as the dense batch `jb`:
    each graph's valid node rows in slot order, its forward edges, then
    their reverses; targets at slot rows 0 and 1."""
    from igmc_torch.batching.batch import GraphBatch

    node_mask, edge_mask = np.asarray(jb.node_mask), np.asarray(jb.edge_mask)
    rows = np.cumsum(node_mask.reshape(-1)) - 1            # slot -> flat row
    nb, n = node_mask.shape
    base = np.arange(nb)[:, None] * n
    src = rows[(base + np.asarray(jb.edge_src))[edge_mask]]
    dst = rows[(base + np.asarray(jb.edge_dst))[edge_mask]]
    etype = np.asarray(jb.edge_type)[edge_mask]
    ne, nn = len(src), int(node_mask.sum())
    t = lambda a, dt=np.int32: torch.from_numpy(np.ascontiguousarray(a).astype(dt))
    return GraphBatch(
        node_label=t(np.asarray(jb.node_label)[node_mask]),
        edge_src=t(np.concatenate([src, dst])), edge_dst=t(np.concatenate([dst, src])),
        edge_type=t(np.concatenate([etype, etype])),
        edge_canon=t(np.concatenate([np.arange(ne), np.arange(ne)])),
        node2graph=t(np.nonzero(node_mask)[0]), node_mask=torch.ones(nn, dtype=torch.bool),
        edge_mask=torch.ones(2 * ne, dtype=torch.bool), y=t(jb.y, np.float32),
        graph_mask=t(jb.graph_mask, bool), target_u=t(rows[np.arange(nb) * n]),
        target_v=t(rows[np.arange(nb) * n + 1]),
        edge_id=t(np.concatenate([np.arange(ne), np.arange(ne)]), np.int64))


@pytest.mark.parametrize("name", FAMILIES)
def test_flat_family_forward_and_gradients_match_jax(name):
    """The flat forms (segment engine, masked_segment_sum / global_sort_pool
    readouts) of the tie-free batch's graphs: eval predictions equal the
    JAX package's flat forward and the port's dense forward to atol
    FWD_ATOL; training with JAX's [E] edge mask and feature mask injected
    to atol FWD_ATOL, and every gradient to 1e-4 of its largest entry."""
    from igmc_tpu.batching.batch import GraphBatch as JaxGraphBatch

    jb = varied_batch(TIE_FREE_SEED)
    cfg, init, forward = jax_family(name)
    params = init(jax.random.PRNGKey(5), cfg)
    model = port_family(name, params)
    fb = flat_batch(jb)
    jfb = JaxGraphBatch(**{f: (None if getattr(fb, f) is None
                               else np.asarray(getattr(fb, f).numpy()))
                           for f in ("node_label", "edge_src", "edge_dst", "edge_type",
                                     "edge_canon", "node2graph", "node_mask",
                                     "edge_mask", "y", "graph_mask", "target_u",
                                     "target_v")})
    want = np.asarray(forward(params, jfb, cfg, None, False))
    with torch.no_grad():
        got = model.eval()(fb)
        dense = model.eval()(to_port(jb))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(dense.numpy(), want, rtol=0, atol=FWD_ATOL)

    key = jax.random.PRNGKey(9)
    k, k_edge = jax.random.split(key)
    keep_e = t_(jax.random.bernoulli(k_edge, 0.8, (fb.num_edges,)))
    _, k_drop = jax.random.split(k)
    noise = (keep_e, t_(jax.random.bernoulli(k_drop, 0.5, (B, HIDDEN))))
    y = np.asarray(jb.y)
    jax_loss = lambda p: (jnp.mean((forward(p, jfb, cfg, key, True) - y) ** 2)
                          + 0.001 * jax_arr_regularizer(p))
    want_t = np.asarray(forward(params, jfb, cfg, key, True))
    want_grads = jax.grad(jax_loss)(params)
    model.train()
    got_t = model(fb, noise)
    np.testing.assert_allclose(got_t.detach().numpy(), want_t, rtol=0, atol=FWD_ATOL)
    model.zero_grad()
    loss = (((model(fb, noise) - fb.y) ** 2).mean() + 0.001 * arr_regularizer(model))
    loss.backward()
    want_sd = params_from_jax(to_numpy(want_grads))
    for pname, p in model.named_parameters():
        grad_close(p.grad, want_sd[pname], pname)


def t_(a):
    return torch.from_numpy(np.array(a))


# -- the training loop ------------------------------------------------------------

@pytest.fixture(scope="module")
def flixster_sets():
    """Static and dynamic datasets of the flixster fixture's first links."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", FIXTURES)
        split = load_data_monti("flixster", testing=True)
    A = BipartiteCSR(split.adj_train)
    assert len(split.class_values) == FLIXSTER_R
    kw = dict(h=1, class_values=split.class_values, backend="numpy")
    tr = ((split.train_u_indices[:120], split.train_v_indices[:120]),
          split.train_labels[:120])
    te = ((split.test_u_indices[:60], split.test_v_indices[:60]),
          split.test_labels[:60])
    return {kind: tuple(cls(A, *s, **kw) for s in (tr, te))
            for kind, cls in (("static", StaticGraphDataset),
                              ("dynamic", DynamicGraphDataset))}


def family_model(name, k=20, num_relations=R):
    return port_family(name, None, k=k, num_relations=num_relations)


@pytest.mark.parametrize("name", FAMILIES)
def test_chunked_row_step_equals_whole_row_step(name, flixster_sets):
    """--dense-chunk for every family: a row of 40 graphs streamed in
    slices of 10 gives the whole row's loss and gradients (dropout on)."""
    train, _ = flixster_sets["static"]
    dd = DeviceDataset(train.packed, torch.device("cpu"))
    epoch = DensePass.plan(plan_buckets(train, "unified"), 40, 1, torch.device("cpu"))
    row, bi = epoch.gids[0], epoch.bucket_of[0]
    assemble = lambda g: epoch.assemble(dd, bi, g)
    noise = draw_noise(torch.Generator().manual_seed(3), 40)
    grads, losses = [], []
    for chunk in (0, 10):
        model = family_model(name).train()
        opt = make_optimizer(model.parameters(), 0.0)
        loss, _ = make_dense_row_step(model, opt, chunk, 0.001)(assemble, row, noise)
        losses.append(float(loss))
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()) + 1e-12, msg=k)


@pytest.mark.parametrize("name,kind", [("gnn", "static"), ("dgcnn", "dynamic"),
                                       ("dgcnn_rs", "static"), ("dgcnn_rs", "dynamic")])
def test_families_train_on_static_and_dynamic_data(name, kind, flixster_sets):
    """train_multiple_epochs on the device-assembled (static) and the
    host-collated (dynamic) dense path, and on the flat layout's segment
    engine (refused until it was ported; static: device-resident, dynamic:
    the loader): finite losses and RMSEs; the blocked engine is IGMC's
    only and raises ValueError for the families."""
    train, test = flixster_sets[kind]
    model = family_model(name, num_relations=FLIXSTER_R)
    kw = dict(lr=1e-3, lr_decay_factor=0.1, lr_decay_step_size=50, ARR=0.001,
              prefetch=0, device="cpu")
    rmse, state = train_multiple_epochs(train, test, model, epochs=2, batch_size=30,
                                        batch_mode="dense", **kw)
    assert np.isfinite(rmse) and state.epoch == 2
    rmse, state = train_multiple_epochs(train, test, model, epochs=1, batch_size=30,
                                        batch_mode="flat", **kw)
    assert np.isfinite(rmse) and state.epoch == 1
    with pytest.raises(ValueError, match="R-GCN trunk of IGMC"):
        train_multiple_epochs(train, test, model, epochs=1, batch_size=30,
                              batch_mode="flat", flat_aggregate="blocked", **kw)


# -- the CLI --------------------------------------------------------------------

PRINTED = re.compile(r"^(#train|Used #train|All ratings|Total number of parameters|"
                     r"batch mode|dense layout)")


def cli_lines(which, argv, cwd, monkeypatch, capsys):
    monkeypatch.setenv("IGMC_RAW_DATA", FIXTURES)
    os.makedirs(cwd, exist_ok=True)
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    if which == "jax":
        jax_main(argv)
    else:
        port_main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name,flags,mode", [
    ("gnn", [], "auto"),
    ("dgcnn_rs", [], "auto"),
    ("dgcnn", ["--dense-chunk", "10"], "--dense-chunk"),
])
def test_cli_trains_a_family_on_flixster(name, flags, mode, tmp_path, monkeypatch,
                                         capsys):
    """The port CLI trains --model <name> for 2 epochs on the flixster
    fixture with --debug (DGCNN in giant batches of 50 streamed in slices
    of 10): the JAX CLI's printed set-up lines (links, parameters, layout),
    and a log.txt of two epoch lines with finite RMSEs."""
    argv = ["--data-name", "flixster", "--testing", "--debug", "--model", name,
            "--max-train-num", "300", "--max-test-num", "100"] + flags
    want = [l for l in cli_lines("jax", argv + ["--no-train"], str(tmp_path / "jax"),
                                 monkeypatch, capsys) if PRINTED.match(l)]
    got = cli_lines("port", argv + ["--epochs", "2", "--save-interval", "1"],
                    str(tmp_path / "port"), monkeypatch, capsys)
    assert [l for l in got if PRINTED.match(l)] == want
    assert f"batch mode: dense ({mode})" in want
    assert "dense layout: unified (auto)" in want
    log = (tmp_path / "port" / "results" / "flixster_testmode" / "log.txt"
           ).read_text().splitlines()
    assert len(log) == 2
    rmses = [float(l.split()[-1]) for l in log]
    assert all(np.isfinite(rmses))


@pytest.mark.parametrize("flags,message", [
    (["--flat-aggregate", "pallas"], "applies to the R-GCN trunk"),
    (["--dense-layout", "bipartite"], "applies to the R-GCN trunk"),
])
@pytest.mark.parametrize("name", ["gnn", "dgcnn"])
def test_cli_refuses_what_jax_refuses_for_the_families(name, flags, message, tmp_path,
                                                       monkeypatch, capsys):
    argv = ["--data-name", "flixster", "--testing", "--debug", "--model", name,
            "--no-train", "--max-train-num", "40", "--max-test-num", "20"] + flags
    for which in ("jax", "port"):
        with pytest.raises(SystemExit, match=message):
            cli_lines(which, argv, str(tmp_path / which), monkeypatch, capsys)
