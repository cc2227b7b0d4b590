"""The main path's options in igmc_torch against the JAX package on the CPU:
compute_dtype bfloat16, the edge-k, relation-slotted and adjacency dense
strategies (each layer's forward and gradients, then the dense IGMC
forward), the relation-slotted collate and device assembly, the flat
forward's float32 under a bfloat16 config, and the CLI flags
--compute-dtype, --dense-chunk, --dense-strategy and --flat-aggregate
segment against the JAX CLI's lines and exits.

Tolerances: float32 against JAX as tests/test_dense.py holds its own
strategies, forward rtol / atol 1e-5, gradients rtol 1e-4 / atol 1e-5 of
the largest entry. bfloat16 against JAX's bfloat16: the port's forward
rounds where JAX's rounds, so the two agree to float32 summation order
(measured: at most 8.9e-08 absolute over these cases; BF16_FWD_TOL allows
1.5e-07). The gradients do not: XLA's transposed einsums round the
backward's bfloat16 cotangents (per edge, per relation) at other points
than torch's autograd does, each rounding worth up to a bfloat16 ulp
(2**-8 of the value), so BF16_GRAD_ATOL is twice the worst difference
measured (5.5e-03 of the largest entry, att on the relation-slotted
layer). bfloat16 against float32 within the port: JAX's own bounds,
0.05 unified (tests/test_dense.py) and 2e-2 bipartite
(tests/test_dense_bipartite.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _synthetic_dense_batch
from igmc_tpu.models import rgcn as jax_rgcn
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import igmc_forward, igmc_init

from igmc_torch.batching import DenseBatch
from igmc_torch.models import (IGMC, IGMCConfig, RGCNConv, build_dense_adj,
                               dense_adj_degrees, rgcn_dense_adj_apply,
                               rgcn_dense_apply, rgcn_dense_bipartite_apply,
                               rgcn_dense_relslot_apply)
from igmc_torch.train import params_from_jax

torch.set_num_threads(1)

B, N_SLOT, E_SLOT, R, NB = 8, 32, 64, 5, 4
HIDDEN = 128
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_FWD_TOL = dict(rtol=0, atol=1.5e-7)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5           # atol: of the largest entry
BF16_GRAD_ATOL = 1.1e-2                      # of the largest entry


def t(a):
    return torch.from_numpy(np.array(a))


def jax_dtype(cd):
    return None if cd is None else jnp.dtype(cd)


def jax_batch(bipartite=False, relslot=False, seed=0):
    return _synthetic_dense_batch(num_graphs=B, node_slot=N_SLOT, edge_slot=E_SLOT,
                                  num_relations=R, seed=seed, bipartite=bipartite,
                                  relslot=relslot)


def to_port(jb) -> DenseBatch:
    return DenseBatch(node_label=t(jb.node_label), edge_src=t(jb.edge_src),
                      edge_dst=t(jb.edge_dst), edge_type=t(jb.edge_type),
                      node_mask=t(jb.node_mask), edge_mask=t(jb.edge_mask),
                      y=t(jb.y), graph_mask=t(jb.graph_mask), num_u=jb.num_u,
                      rel_caps=jb.rel_caps)


def layer_case(cin, seed, jb):
    """(JAX layer params as numpy, the port's RGCNConv holding them, x,
    distinct forward / reverse keep masks, the output cotangent)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        np.array, jax_rgcn.rgcn_init(jax.random.PRNGKey(seed), cin, 32, R, NB))
    conv = RGCNConv(cin, 32, R, NB, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in conv.named_parameters():
            p.copy_(torch.from_numpy(params[name]))
    x = rng.uniform(-1, 1, (B, N_SLOT, cin)).astype(np.float32)
    mask_f = jb.edge_mask & (rng.random(jb.edge_mask.shape) < 0.8)
    mask_r = jb.edge_mask & (rng.random(jb.edge_mask.shape) < 0.8)
    cot = rng.uniform(-1, 1, (B, N_SLOT, 32)).astype(np.float32)
    return params, conv, x, mask_f, mask_r, cot


def check_layer(jax_fn, port_fn, params, conv, x, cot, cd):
    """jax_fn(params, x) and port_fn(x_tensor): forward and the gradients
    of x and of every parameter, at the float32 or bfloat16 tolerances."""
    want = np.asarray(jax_fn(params, x))
    want_grads = jax.grad(lambda p, xx: jnp.sum(jax_fn(p, xx) * cot),
                          argnums=(0, 1))(params, x)
    xt = t(x).requires_grad_()
    got = port_fn(xt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got.detach(), t(want),
                               **(FWD_TOL if cd is None else BF16_FWD_TOL))
    got.backward(t(cot))
    atol = GRAD_ATOL if cd is None else BF16_GRAD_ATOL
    for name, g, w in [("x", xt.grad, want_grads[1])] + [
            (k, p.grad, want_grads[0][k]) for k, p in conv.named_parameters()]:
        w = t(w)
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL,
                                   atol=atol * float(w.abs().max()) + 1e-12, msg=name)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("aggr", ["mean", "sum", "relmean"])
@pytest.mark.parametrize("bipartite", [False, True])
def test_edge_layer_in_each_dtype_matches_jax(bipartite, aggr, cd):
    """rgcn_dense_apply / rgcn_dense_bipartite_apply in float32 and
    bfloat16 (Cin 32: the inner layers' width)."""
    jb = jax_batch(bipartite, seed=3)
    params, conv, x, mf, mr, cot = layer_case(32, 3, jb)
    edges = (jb.edge_src, jb.edge_dst, jb.edge_type)
    pe = tuple(t(a) for a in edges)
    if bipartite:
        jfn = lambda p, xx: jax_rgcn.rgcn_dense_bipartite_apply(
            p, xx, jb.num_u, *edges, mf, mr, aggr, jax_dtype(cd))
        pfn = lambda xx: rgcn_dense_bipartite_apply(conv, xx, jb.num_u, *pe, t(mf),
                                                    t(mr), aggr, cd)
    else:
        jfn = lambda p, xx: jax_rgcn.rgcn_dense_apply(p, xx, *edges, mf, mr, aggr,
                                                      jax_dtype(cd))
        pfn = lambda xx: rgcn_dense_apply(conv, xx, *pe, t(mf), t(mr), aggr, cd)
    check_layer(jfn, pfn, params, conv, x, cot, cd)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("cin", [4, 32])
def test_edge_k_layer_matches_jax(cin, cd):
    """per_basis (dense_strategy 'edge-k') against JAX's per-basis
    scatters, at the one-hot width 4 and at 32."""
    jb = jax_batch(seed=cin)
    params, conv, x, mf, mr, cot = layer_case(cin, cin, jb)
    edges = (jb.edge_src, jb.edge_dst, jb.edge_type)
    jfn = lambda p, xx: jax_rgcn.rgcn_dense_apply(p, xx, *edges, mf, mr, "mean",
                                                  jax_dtype(cd), per_basis=True)
    pfn = lambda xx: rgcn_dense_apply(conv, xx, *(t(a) for a in edges), t(mf),
                                      t(mr), "mean", cd, per_basis=True)
    check_layer(jfn, pfn, params, conv, x, cot, cd)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("aggr", ["mean", "sum"])
@pytest.mark.parametrize("bipartite", [False, True])
def test_relslot_layer_matches_jax(bipartite, aggr, cd):
    """rgcn_dense_relslot_apply on __graft_entry__'s relation-slotted batch
    (capacities from the JAX planner), unified and bipartite."""
    jb = jax_batch(bipartite, relslot=True, seed=5)
    params, conv, x, mf, mr, cot = layer_case(32, 5, jb)
    caps = jb.rel_caps
    jfn = lambda p, xx: jax_rgcn.rgcn_dense_relslot_apply(
        p, xx, jb.edge_src, jb.edge_dst, caps, mf, mr, aggr, jax_dtype(cd),
        num_u=jb.num_u)
    pfn = lambda xx: rgcn_dense_relslot_apply(conv, xx, t(jb.edge_src), t(jb.edge_dst),
                                              caps, t(mf), t(mr), aggr, cd,
                                              num_u=jb.num_u)
    check_layer(jfn, pfn, params, conv, x, cot, cd)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("aggr", ["mean", "sum"])
@pytest.mark.parametrize("tied", [True, False])
def test_adjacency_layer_matches_jax(tied, aggr, cd):
    """build_dense_adj, dense_adj_degrees and rgcn_dense_adj_apply: the
    adjacencies and degrees equal JAX's exactly; the layer, with one
    adjacency for both directions (tied) or one per direction, to the
    tolerances."""
    jb = jax_batch(seed=7)
    params, conv, x, mf, mr, cot = layer_case(32, 7, jb)
    if tied:
        mr = mf
    edges = (jb.edge_src, jb.edge_dst, jb.edge_type)
    pe = tuple(t(a) for a in edges)
    ja_f = jax_rgcn.build_dense_adj(*edges, mf, R, N_SLOT, jax_dtype(cd))
    ja_r = None if tied else jax_rgcn.build_dense_adj(*edges, mr, R, N_SLOT,
                                                      jax_dtype(cd))
    pa_f = build_dense_adj(*pe, t(mf), R, N_SLOT, cd)
    pa_r = None if tied else build_dense_adj(*pe, t(mr), R, N_SLOT, cd)
    assert pa_f.dtype == (torch.float32 if cd is None else torch.bfloat16)
    assert torch.equal(pa_f.float(), t(np.asarray(ja_f, np.float32)))
    j_inv = np.asarray(jax_rgcn.dense_adj_degrees(ja_f, ja_r))
    p_inv = dense_adj_degrees(pa_f, pa_r)
    assert torch.equal(p_inv, t(j_inv))
    jinv = j_inv if aggr == "mean" else None
    pinv = p_inv if aggr == "mean" else None
    jfn = lambda p, xx: jax_rgcn.rgcn_dense_adj_apply(p, xx, ja_f, ja_r, aggr,
                                                      jax_dtype(cd), jinv)
    pfn = lambda xx: rgcn_dense_adj_apply(conv, xx, pa_f, pa_r, aggr, cd, pinv)
    check_layer(jfn, pfn, params, conv, x, cot, cd)


def jax_cfg(**kw):
    return JaxIGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                         num_relations=R, num_bases=NB, **kw)


def port_model(params, **kw):
    model = IGMC(IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                            num_relations=R, num_bases=NB, **kw),
                 torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def jax_dense_noise(key, edge_slot, p=0.2):
    """The masks JAX's dense training forward draws from `key`, as the
    port's injected noise ((keep_f, keep_r), feature_keep)."""
    from igmc_tpu.ops.dropout import edge_dropout_dense as jax_edge_dropout_dense

    key, k_edge = jax.random.split(key)
    keep_f, keep_r = jax_edge_dropout_dense(
        k_edge, jnp.ones((B, edge_slot), bool), p, False, True)
    key, k_drop = jax.random.split(key)
    keep = jax.random.bernoulli(k_drop, 0.5, (B, HIDDEN))
    return (t(keep_f), t(keep_r)), t(keep)


STRATEGIES = [  # (layout of the batch, dense_strategy)
    ("unified", "edge"), ("bipartite", "edge"), ("unified", "edge-k"),
    ("unified", "adjacency"), ("relslot", "auto"), ("relslot-bipartite", "auto")]


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("layout,strategy", STRATEGIES)
def test_dense_forward_by_strategy_matches_jax(layout, strategy, cd):
    """The dense IGMC forward with each strategy and dtype against JAX's,
    in eval mode and in training mode with JAX's masks injected (atol 1e-4
    through four layers, as tests/test_torch_port_dense.py holds the edge
    strategy); bfloat16 within JAX's own bounds of the port's float32."""
    jb = jax_batch("bipartite" in layout, layout.startswith("relslot"), seed=11)
    params = igmc_init(jax.random.PRNGKey(12), jax_cfg())
    kw = dict(dense_strategy=strategy, compute_dtype=cd)
    model = port_model(params, **kw)
    batch = to_port(jb)
    want = np.asarray(igmc_forward(params, jb, jax_cfg(**kw), None, False))
    got = model.eval()(batch).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    key = jax.random.PRNGKey(13)
    want_t = np.asarray(igmc_forward(params, jb, jax_cfg(**kw), key, True))
    got_t = model.train()(batch, jax_dense_noise(key, jb.edge_slot))
    np.testing.assert_allclose(got_t.detach().numpy(), want_t, rtol=0, atol=1e-4)
    if cd is not None:
        f32 = port_model(params, dense_strategy=strategy).eval()(batch)
        band = 0.05 if layout == "unified" else 2e-2
        np.testing.assert_allclose(got, f32.detach().numpy(), rtol=band, atol=band)


@pytest.mark.parametrize("layout", ["bipartite", "relslot"])
def test_adjacency_is_unified_only(layout):
    """As in JAX: the adjacency strategy on a bipartite or relation-slotted
    batch raises NotImplementedError; relmean on a relation-slotted one
    raises ValueError naming relslot."""
    jb = jax_batch(layout == "bipartite", layout == "relslot")
    params = igmc_init(jax.random.PRNGKey(0), jax_cfg())
    with pytest.raises(NotImplementedError, match="unified-layout only"):
        port_model(params, dense_strategy="adjacency").eval()(to_port(jb))
    if layout == "relslot":
        with pytest.raises(ValueError, match="relslot"):
            port_model(params, aggr="relmean").eval()(to_port(jb))


# ---------------------------------------------------------------------------
# the relation-slotted layout's data path, on a small synthetic ML-1M
# ---------------------------------------------------------------------------

DATA_FIELDS = ("node_label", "edge_src", "edge_dst", "edge_type", "node_mask",
               "edge_mask", "y", "graph_mask")
DATA_PAIRS, DATA_BATCH = 60, 8


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(JAX, port) static datasets of 60 training pairs of a 150 x 120,
    10,000-rating ml_1m fixture (h 1, at most 100 nodes per hop)."""
    from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStaticGraphDataset
    from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
    from igmc_tpu.data.synthetic import write_ml1m_format

    from igmc_torch.batching import StaticGraphDataset
    from igmc_torch.data import create_trainvaltest_split

    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=150, n_movies=120, n_ratings=10000, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        ws = jax_split("ml_1m", seed=1234, testing=True, verbose=False)
        gs = create_trainvaltest_split("ml_1m", seed=1234, testing=True,
                                       verbose=False)
    links = (ws.train_u_indices, ws.train_v_indices)
    return (JaxStaticGraphDataset(None, ws.adj_train, links, ws.train_labels, h=1,
                                  max_nodes_per_hop=100,
                                  class_values=ws.class_values, max_num=DATA_PAIRS,
                                  backend="numpy", progress=False),
            StaticGraphDataset(gs.adj_train, links, gs.train_labels, h=1,
                               max_nodes_per_hop=100, class_values=gs.class_values,
                               max_num=DATA_PAIRS, backend="numpy"))


def etypes_of(ds):
    return [ds.get(i).etype for i in range(len(ds))]


def slots_of(pds, bipartite):
    """(node_slot, num_u_slot) holding every graph, as test_dense_bipartite
    sizes them."""
    nu = pds.packed.num_u
    if bipartite:
        n_u = int(nu.max()) + 2
        return n_u + int((pds.node_counts() - nu).max()) + 3, n_u
    return int(pds.node_counts().max()) + 2, None


def test_plan_rel_caps_has_no_minimum_for_absent_relations(datasets):
    """The port's capacities equal JAX's for every relation some graph has;
    a relation no graph has gets 0 where JAX gives 8 (the reference's
    minimum capacity, a known defect not copied)."""
    from igmc_tpu.batching.dense import plan_rel_caps as jax_plan_rel_caps

    from igmc_torch.batching import plan_rel_caps

    ets = etypes_of(datasets[1])
    got, want = plan_rel_caps(ets, R + 1), jax_plan_rel_caps(ets, R + 1)
    counts = np.max([np.bincount(e, minlength=R + 1) for e in ets], axis=0)
    assert counts[R] == 0 and counts[:R].min() > 0
    assert got[:R] == want[:R] and all(c % 8 == 0 and c >= n
                                       for c, n in zip(got, counts))
    assert (got[R], want[R]) == (0, 8)


@pytest.mark.parametrize("bipartite", [False, True])
def test_collate_relslot_matches_jax(datasets, bipartite):
    """collate_dense(rel_caps=) equals JAX's array by array for the same
    graphs and capacities (the port's, from plan_rel_caps)."""
    from igmc_tpu.batching.dense import collate_dense as jax_collate_dense

    from igmc_torch.batching import collate_dense, plan_rel_caps

    jds, pds = datasets
    caps = plan_rel_caps(etypes_of(pds), R)
    n, nu = slots_of(pds, bipartite)
    idx = range(DATA_BATCH - 2)             # two padding graphs
    got = collate_dense([pds.get(i) for i in idx], DATA_BATCH, n, sum(caps), nu, caps)
    want = jax_collate_dense([jds.get(i) for i in idx], DATA_BATCH, n, sum(caps),
                             nu, caps)
    assert got.rel_caps == tuple(caps) == want.rel_caps and got.num_u == want.num_u
    for f in DATA_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    r = int(pds.get(0).etype[0])            # no room for graph 0's relation r
    small = list(caps)
    small[(r + 1) % R] += small[r]
    small[r] = 0
    with pytest.raises(ValueError, match=f"relation-{r} edges > capacity 0"):
        collate_dense([pds.get(0)], 1, n, sum(caps), nu, tuple(small))


@pytest.mark.parametrize("bipartite", [False, True])
def test_assemble_relslot_matches_collate_and_jax(datasets, bipartite):
    """assemble_dense(rel_caps=) on DeviceDataset(rel_sort=R) equals the
    port's relation-slotted collate and JAX's relation-slotted assembly
    array by array (padding graphs included); each edge_id is the edge's
    packed index from before the sort; and because dense dropout keys on
    it, a training forward with the same noise predicts the same on the
    relation-slotted layout as on the plain one."""
    from igmc_tpu.batching.device_data import DeviceDataset as JaxDeviceDataset
    from igmc_tpu.batching.device_data import assemble_dense as jax_assemble_dense

    from igmc_torch.batching import (DeviceDataset, assemble_dense, collate_dense,
                                     plan_rel_caps)
    from igmc_torch.models import draw_noise

    jds, pds = datasets
    caps = plan_rel_caps(etypes_of(pds), R)
    n, nu = slots_of(pds, bipartite)
    gids = np.array([0, 3, 5, 7, 1, -1, 2, 4])
    dd = DeviceDataset(pds.packed, "cpu", rel_sort=R)
    got = assemble_dense(dd, torch.from_numpy(gids), n, sum(caps), nu, caps)
    jdd = JaxDeviceDataset(jds.packed, 8, 16, len(gids), rel_sort=R)
    want = jax_assemble_dense(jdd, jnp.asarray(gids, jnp.int32), n, sum(caps), nu, caps)
    host = collate_dense([pds.get(int(i)) for i in gids[gids >= 0]], len(gids), n,
                         sum(caps), nu, caps)
    live = gids >= 0
    for f in DATA_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f).numpy()[live],
                                      getattr(host, f).numpy()[:live.sum()], err_msg=f)
    assert got.rel_caps == tuple(caps)
    # edge_id: the packed index before the relation sort
    packed, em = pds.packed, got.edge_mask.numpy()
    ids = got.edge_id.numpy()
    for b, g in enumerate(gids):
        if g < 0:
            continue
        lo, hi = packed.edge_offsets[g], packed.edge_offsets[g + 1]
        assert sorted(ids[b][em[b]].tolist()) == list(range(lo, hi))
    np.testing.assert_array_equal(packed.etype[ids[em]], got.edge_type.numpy()[em])
    # the same edges drop on both layouts
    plain = assemble_dense(DeviceDataset(pds.packed, "cpu"), torch.from_numpy(gids),
                           n, int(pds.edge_counts().max()) // 2, nu)
    model = IGMC(IGMCConfig(num_relations=R, adj_dropout=0.4),
                 torch.Generator().manual_seed(2)).train()
    noise = draw_noise(torch.Generator().manual_seed(3), len(gids))
    torch.testing.assert_close(model(got, noise), model(plain, noise), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="rel_sort"):
        assemble_dense(DeviceDataset(pds.packed, "cpu"), torch.from_numpy(gids), n,
                       sum(caps), nu, caps)


@pytest.mark.parametrize("bipartite", [False, True])
def test_relslot_dense_pass_trains_and_evaluates_like_the_plain_layout(
        datasets, bipartite):
    """A DensePass over rel-sorted data with rel_caps (every bucket's rows
    on sum(rel_caps) edge slots): one training pass and the evaluation
    equal the plain layout's, dropout on (the same noise, the same edges)."""
    from igmc_torch.batching import DeviceDataset, plan_rel_caps
    from igmc_torch.train import (DensePass, dense_eval_rmse, dense_predict_all,
                                  dense_train_epoch, make_dense_row_step,
                                  make_eval_step, make_optimizer, plan_buckets)

    pds = datasets[1]
    caps = plan_rel_caps(etypes_of(pds), R)
    layout = "bipartite" if bipartite else "unified"
    epoch = DensePass.plan(plan_buckets(pds, layout), DATA_BATCH, 2, "cpu",
                           np.random.default_rng(5))
    out = {}
    for tag, dd, rc in (("plain", DeviceDataset(pds.packed, "cpu"), None),
                        ("relslot", DeviceDataset(pds.packed, "cpu", rel_sort=R),
                         caps)):
        model = IGMC(IGMCConfig(num_relations=R), torch.Generator().manual_seed(4))
        step = make_dense_row_step(model.train(),
                                   make_optimizer(model.parameters(), 1e-2), 0, 0.001)
        loss = dense_train_epoch(step, dd, epoch, torch.Generator().manual_seed(6),
                                 len(pds), rc)
        eval_fn = make_eval_step(model.eval())
        out[tag] = (loss, dense_eval_rmse(eval_fn, dd, epoch, rc),
                    dense_predict_all(eval_fn, dd, epoch, rc))
    np.testing.assert_allclose(out["relslot"][:2], out["plain"][:2], rtol=1e-5)
    np.testing.assert_allclose(out["relslot"][2], out["plain"][2], rtol=0, atol=1e-4)


def test_flat_forward_ignores_compute_dtype(datasets):
    """The flat layout's fused aggregate computes in float32 under a
    bfloat16 config, as JAX's does: the same predictions, bit for bit."""
    from igmc_torch.batching import BatchLoader

    batch = next(iter(BatchLoader(datasets[1], DATA_BATCH, flat_aggregate="pallas")))
    preds = []
    for cd in (None, "bfloat16"):
        model = IGMC(IGMCConfig(num_relations=R, compute_dtype=cd,
                                flat_aggregate="pallas"),
                     torch.Generator().manual_seed(1)).eval()
        with torch.no_grad():
            preds.append(model(batch))
    assert torch.equal(preds[0], preds[1])


@pytest.mark.parametrize("cd,strategy", [("bfloat16", "auto"), (None, "edge-k"),
                                         (None, "adjacency"), ("bfloat16", "adjacency")])
def test_predictor_with_options_matches_jax(cd, strategy):
    """Predictor serves a config's compute_dtype and dense_strategy as the
    JAX Predictor does (unified slots, NumPy extraction on both sides):
    atol 1e-5 in float32, 1e-4 in bfloat16 (the forward's bound above)."""
    import scipy.sparse as sp

    from igmc_tpu.serve import Predictor as JaxPredictor
    from igmc_tpu.train.torch_interop import state_dict_from_params

    from igmc_torch.serve import Predictor

    rng = np.random.default_rng(0)
    M = sp.random(50, 60, density=0.12, format="csr",
                  random_state=np.random.RandomState(0))
    M.data = rng.integers(1, 6, M.nnz).astype(np.float64)
    us, vs = rng.integers(0, 50, 30), rng.integers(0, 60, 30)
    kw = dict(dense_strategy=strategy, compute_dtype=cd)
    params = igmc_init(jax.random.PRNGKey(2), jax_cfg(**kw))
    common = dict(batch_size=8, backend="numpy")
    want = JaxPredictor(M, np.arange(1.0, 6.0), jax_cfg(**kw), params=params,
                        **common).predict(us, vs)
    got = Predictor(M, np.arange(1.0, 6.0),
                    IGMCConfig(num_features=4, num_relations=R, num_bases=NB, **kw),
                    params=state_dict_from_params(params), device="cpu",
                    **common).predict(us, vs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if cd is None else 1e-4)


# ---------------------------------------------------------------------------
# the CLI flags against the JAX CLI (tests/test_torch_port_cli.py's fixture)
# ---------------------------------------------------------------------------

from test_torch_port_cli import BASE, LAYOUT_LINE, LOG_LINE, raw, run  # noqa: E402,F401


@pytest.mark.parametrize("flags", [
    ["--compute-dtype", "bfloat16"],
    ["--dense-chunk", "5"],
    ["--dense-strategy", "adjacency"],
    ["--flat-aggregate", "segment"],
    ["--compute-dtype", "bfloat16", "--dense-chunk", "5", "--dense-strategy",
     "adjacency", "--flat-aggregate", "segment"],
])
def test_option_flags_run_with_the_jax_cli_lines(raw, tmp_path, monkeypatch,
                                                capsys, flags):
    """Each option prints the JAX CLI's batch-mode and layout lines (JAX
    run with --no-train), then the port trains one epoch with it,
    checkpoints and ensembles: log.txt in the JAX format with finite
    RMSEs."""
    argv = BASE + ["--max-train-num", "60", "--max-test-num", "20"] + flags
    want = [l for l in run("jax", argv + ["--no-train"], raw, str(tmp_path / "jax"),
                           monkeypatch, capsys) if LAYOUT_LINE.match(l)]
    got = [l for l in run("port", argv + ["--ensemble", "--epochs", "1",
                                          "--save-interval", "1"], raw,
                          str(tmp_path / "port"), monkeypatch, capsys)
           if LAYOUT_LINE.match(l)]
    assert got == want and len(want) == 2
    log = (tmp_path / "port" / "results" / "ml_1m_testmode" / "log.txt"
           ).read_text().splitlines()
    assert len(log) == 2 and log[1].startswith("Epoch ensemble of range(-14, 1, 5),")
    for line in log:
        m = LOG_LINE.match(line)
        assert m and np.isfinite(float(m.group(2))), line


@pytest.mark.parametrize("flags", [
    ["--dense-chunk", "-1"],
    ["--dense-chunk", "7"],                       # does not divide 25
    ["--flat-aggregate", "pallas", "--dense-chunk", "5"],
    ["--dense-layout", "bipartite", "--dense-strategy", "adjacency"],
])
def test_option_exits_match_jax(raw, tmp_path, monkeypatch, capsys, flags):
    """The JAX CLI's exits on --dense-chunk and on adjacency with the
    bipartite layout, word for word, before any training."""
    argv = BASE + ["--max-train-num", "30", "--max-test-num", "10"] + flags
    said = []
    for which in ("jax", "port"):
        with pytest.raises(SystemExit) as e:
            run(which, argv, raw, str(tmp_path / which), monkeypatch, capsys)
        said.append(str(e.value))
    assert said[0] == said[1] and said[0].startswith("--dense-")
