"""igmc_torch's flat segment engine against the JAX package's on the CPU:
the segment reductions, rgcn_apply (every strategy and aggregation, float32
and bfloat16) and gcn_apply with their gradients, edge_dropout with JAX's
mask injected, global_sort_pool, the flat IGMC forward in evaluation and in
training (with side features, for relmean), assemble_batch and the flat
epoch plan, and train_multiple_epochs / test_once on the flat layout
(device-resident and loader paths). Inputs are made from numpy seeds; each
assert states its tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from igmc_tpu.batching.dataset import BatchLoader as JaxBatchLoader
from igmc_tpu.batching.dataset import DynamicGraphDataset as JaxDynamicGraphDataset
from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStaticGraphDataset
from igmc_tpu.batching.device_data import DeviceDataset as JaxDeviceDataset
from igmc_tpu.batching.device_data import assemble_batch as jax_assemble_batch
from igmc_tpu.batching.device_data import capacity_bound as jax_capacity_bound
from igmc_tpu.batching.device_data import live_rows as jax_live_rows
from igmc_tpu.batching.device_data import plan_gid_epoch as jax_plan_gid_epoch
from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
from igmc_tpu.data.synthetic import write_ml1m_format
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import igmc_forward, igmc_init
from igmc_tpu.models.rgcn import gcn_apply as jax_gcn_apply
from igmc_tpu.models.rgcn import gcn_init
from igmc_tpu.models.rgcn import rgcn_apply as jax_rgcn_apply
from igmc_tpu.models.rgcn import rgcn_init
from igmc_tpu.ops.dropout import edge_dropout as jax_edge_dropout
from igmc_tpu.ops.segment import masked_segment_mean as jax_masked_segment_mean
from igmc_tpu.ops.sort_pool import global_sort_pool as jax_global_sort_pool
from igmc_tpu.train.loop import _make_loss_fn
from igmc_tpu.train.loop import test_once as jax_test_once
from igmc_tpu.train.loop import train_multiple_epochs as jax_train_multiple_epochs

from igmc_torch.batching import (BatchLoader, DeviceDataset, DynamicGraphDataset,
                                 StaticGraphDataset, assemble_batch, capacity_bound,
                                 live_rows, plan_gid_epoch)
from igmc_torch.data import create_trainvaltest_split
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.models.rgcn import GCNConv, RGCNConv, gcn_apply, rgcn_apply
from igmc_torch.ops import (edge_dropout, flat_edge_keep, global_sort_pool,
                            masked_segment_mean, masked_segment_sum, segment_sum)
from igmc_torch.train import FlatPass, loss_fn, params_from_jax
from igmc_torch.train import loop as port_loop
from igmc_torch.train import test_once as port_test_once
from igmc_torch.train import train_multiple_epochs

torch.set_num_threads(1)

N_PAIRS = 100
BATCH = 50
HIDDEN = 128
STRATEGIES = ("dispatch", "basis-mix", "per-edge", "auto")
AGGRS = ("mean", "sum", "relmean")
F32_RTOL = 1e-5
# bfloat16: the two packages round the same values at the same points and
# sum in float32 in another order; measured at most 1.7e-7 of the largest
# entry at these shapes (every strategy and aggr), held to one bfloat16 ulp
# of it
BF16_ULP = 2.0 ** -7


def t(a):
    return torch.from_numpy(np.array(a))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def grad_close(got, want, name, rtol=1e-4):
    """rtol / atol `rtol` of the reference's largest entry."""
    want = t(want)
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * float(want.abs().max()) + 1e-12, msg=name)


def edge_list(seed, N=60, E=300, R=5):
    """Random padded edge list: 20% of edges masked, 10 nodes with no
    incoming edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N - 10, E).astype(np.int32)
    typ = rng.integers(0, R, E).astype(np.int32)
    mask = rng.random(E) < 0.8
    return src, dst, typ, mask


def rgcn_pair(cin, cout, R=5, nb=4, seed=0):
    p = rgcn_init(jax.random.PRNGKey(seed), cin, cout, R, nb)
    conv = RGCNConv(cin, cout, R, nb, torch.Generator().manual_seed(0))
    conv.load_state_dict({k: t(v) for k, v in p.items()})
    return p, conv


# -- the reductions and layers ---------------------------------------------------

def test_masked_segment_mean_on_empty_segments():
    """Rows with no unmasked entry get exactly 0; others the mean of their
    unmasked entries, equal to JAX's to rtol 1e-6; segment_sum and
    masked_segment_sum are its parts."""
    rng = np.random.default_rng(1)
    data = rng.standard_normal((40, 3)).astype(np.float32)
    seg = rng.integers(0, 6, 40).astype(np.int32)
    mask = rng.random(40) < 0.7
    mask[seg == 2] = False                       # segment 2: all masked
    got = masked_segment_mean(t(data), t(seg), t(mask), 9)      # 6, 7, 8: empty
    want = np.asarray(jax_masked_segment_mean(data, seg, mask, 9))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert torch.equal(got[[2, 6, 7, 8]], torch.zeros(4, 3))
    s = masked_segment_sum(t(data), t(seg), t(mask), 9)
    np.testing.assert_allclose(s[0].numpy(), data[(seg == 0) & mask].sum(0), rtol=1e-6)
    assert torch.equal(segment_sum(t(mask).float(), t(seg), 9)[2], torch.tensor(0.0))


@pytest.mark.parametrize("aggr", AGGRS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_rgcn_apply_and_gradients_match_jax(strategy, aggr):
    """float32: the layer's output, and jax.grad of a weighted sum against
    autograd for x, basis, att, root and bias, to rtol F32_RTOL (atol
    F32_RTOL of each largest entry; measured 3.2e-7)."""
    src, dst, typ, mask = edge_list(2)
    x = np.random.default_rng(3).standard_normal((60, 8)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal((60, 6)).astype(np.float32)
    p, conv = rgcn_pair(8, 6)
    f = lambda pp, xx: jnp.vdot(jax_rgcn_apply(pp, xx, src, dst, typ, mask, 60,
                                               strategy, aggr), w)
    want = np.asarray(jax_rgcn_apply(p, x, src, dst, typ, mask, 60, strategy, aggr))
    gp, gx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    tx = t(x).requires_grad_()
    got = rgcn_apply(conv, tx, t(src), t(dst), t(typ), t(mask), 60, strategy, aggr)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())
    (got * t(w)).sum().backward()
    grad_close(tx.grad, gx, "x", F32_RTOL)
    for name, param in conv.named_parameters():
        grad_close(param.grad, gp[name], name, F32_RTOL)


@pytest.mark.parametrize("aggr", AGGRS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_rgcn_apply_bfloat16_matches_jax(strategy, aggr):
    """compute_dtype bfloat16: within one bfloat16 ulp (2**-7) of the
    largest entry of JAX's bfloat16 output, and within 2**-5 of it of the
    float32 output (the rounding acted, and only as far as bfloat16)."""
    src, dst, typ, mask = edge_list(5)
    x = np.random.default_rng(6).standard_normal((60, 32)).astype(np.float32)
    p, conv = rgcn_pair(32, 32, seed=1)
    want = np.asarray(jax_rgcn_apply(p, x, src, dst, typ, mask, 60, strategy, aggr,
                                     jnp.bfloat16))
    with torch.no_grad():
        got = rgcn_apply(conv, t(x), t(src), t(dst), t(typ), t(mask), 60, strategy,
                         aggr, "bfloat16").numpy()
        f32 = rgcn_apply(conv, t(x), t(src), t(dst), t(typ), t(mask), 60, strategy,
                         aggr).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_ULP * scale
    assert 0 < np.abs(got - f32).max() <= 2.0 ** -5 * scale


@pytest.mark.parametrize("strategy,E,R,want", [("auto", 300, 5, "dispatch"),
                                               ("auto", 300, 71, "basis-mix"),
                                               ("per-edge", 300, 71, "per-edge")])
def test_conv_strategy_auto_rule(strategy, E, R, want):
    """auto = dispatch when E >= N * R // 4, else basis-mix (N 60)."""
    from igmc_torch.models.rgcn import conv_strategy_for

    assert conv_strategy_for(strategy, E, 60, R) == want
    with pytest.raises(ValueError, match="conv_strategy"):
        conv_strategy_for("edge", E, 60, R)


def test_gcn_apply_and_gradients_match_jax():
    """The GCN layer (self-loops, symmetric norm over real edges and
    nodes; 10 padding nodes): output and gradients to rtol F32_RTOL (atol
    F32_RTOL of each largest entry)."""
    src, dst, _, mask = edge_list(7)
    node_mask = np.arange(60) < 50
    x = np.random.default_rng(8).standard_normal((60, 8)).astype(np.float32)
    w = np.random.default_rng(9).standard_normal((60, 6)).astype(np.float32)
    p = gcn_init(jax.random.PRNGKey(2), 8, 6)
    p = {"weight": p["weight"], "bias": jnp.linspace(-0.1, 0.1, 6)}
    conv = GCNConv(8, 6, torch.Generator().manual_seed(0))
    conv.load_state_dict({k: t(v) for k, v in p.items()})
    f = lambda pp, xx: jnp.vdot(jax_gcn_apply(pp, xx, src, dst, mask, node_mask, 60), w)
    want = np.asarray(jax_gcn_apply(p, x, src, dst, mask, node_mask, 60))
    gp, gx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    tx = t(x).requires_grad_()
    got = gcn_apply(conv, tx, t(src), t(dst), t(mask), t(node_mask), 60)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())
    (got * t(w)).sum().backward()
    grad_close(tx.grad, gx, "x", F32_RTOL)
    for name, param in conv.named_parameters():
        grad_close(param.grad, gp[name], name, F32_RTOL)


@pytest.mark.parametrize("force_undirected", [False, True])
def test_edge_dropout_with_jax_mask_injected(force_undirected):
    """edge_dropout fed the Bernoulli mask JAX's edge_dropout draws from a
    key gives JAX's edge mask exactly (with force_undirected each reverse
    edge takes its forward copy's decision)."""
    E = 400
    rng = np.random.default_rng(10)
    edge_mask = rng.random(E) < 0.9
    canon = np.concatenate([np.arange(E // 2), np.arange(E // 2)]).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_edge_dropout(key, edge_mask, canon, 0.3, force_undirected))
    keep = t(jax.random.bernoulli(key, 0.7, (E,)))
    got = edge_dropout(t(edge_mask), t(canon), keep, force_undirected)
    assert np.array_equal(got.numpy(), want)
    if force_undirected:
        both = t(edge_mask[: E // 2] & edge_mask[E // 2:])
        assert torch.equal(got[: E // 2][both], got[E // 2:][both])


def test_flat_edge_keep_keys_directions_like_the_dense_layout():
    """A forward edge (src < dst) is keyed 2 * id and its reverse 2 * id + 1,
    so the two directions drop independently; with force_undirected both
    take key id and drop together."""
    from igmc_torch.ops import hash_edge_keep

    eid = torch.arange(1000, dtype=torch.int64).repeat(2)
    src = torch.cat([torch.zeros(1000), torch.ones(1000)]).int()
    dst = 1 - src
    keep = flat_edge_keep(3, eid, src, dst, 0.5, False)
    assert torch.equal(keep[:1000], hash_edge_keep(3, 2 * eid[:1000], 0.5))
    assert torch.equal(keep[1000:], hash_edge_keep(3, 2 * eid[:1000] + 1, 0.5))
    assert not torch.equal(keep[:1000], keep[1000:])
    tied = flat_edge_keep(3, eid, src, dst, 0.5, True)
    assert torch.equal(tied[:1000], tied[1000:])


@pytest.mark.parametrize("k", [3, 12])
def test_global_sort_pool_matches_jax_bit_for_bit(k):
    """Tie-free keys over 5 graphs of varied sizes (graph 3 empty), padded
    rows between them: bit for bit, graphs of fewer than k nodes
    zero-padded."""
    rng = np.random.default_rng(12)
    n2g = np.repeat(np.arange(5), [6, 2, 9, 0, 7]).astype(np.int32)
    N = 30
    node2graph = np.concatenate([n2g, np.zeros(N - len(n2g), np.int32)])
    node_mask = np.arange(N) < len(n2g)
    x = rng.standard_normal((N, 4)).astype(np.float32)
    x[:, -1] = rng.permutation(N).astype(np.float32) / N        # distinct keys
    want = np.asarray(jax_global_sort_pool(x, node2graph, node_mask, 5, k))
    got = global_sort_pool(t(x), t(node2graph), t(node_mask), 5, k)
    assert got.shape == (5, k * 4)
    assert np.array_equal(got.numpy(), want)


# -- the flat IGMC forward --------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(JAX, port) static and dynamic datasets of 100 training and 100
    held-out pairs of a 300 x 400, 8,000-rating ml_1m fixture (h 1, at most
    100 nodes per hop)."""
    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=300, n_movies=400, n_ratings=8000, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        ws = jax_split("ml_1m", seed=1234, testing=True, verbose=False)
        gs = create_trainvaltest_split("ml_1m", seed=1234, testing=True, verbose=False)
    out = {}
    for part in ("train", "test"):
        links = (getattr(ws, f"{part}_u_indices"), getattr(ws, f"{part}_v_indices"))
        labels = getattr(ws, f"{part}_labels")
        kw = dict(h=1, max_nodes_per_hop=100, max_num=N_PAIRS, backend="numpy")
        out[part] = (JaxStaticGraphDataset(None, ws.adj_train, links, labels,
                                           class_values=ws.class_values,
                                           progress=False, **kw),
                     StaticGraphDataset(gs.adj_train, links, labels,
                                        class_values=gs.class_values, **kw))
        out[f"{part}_dynamic"] = (
            JaxDynamicGraphDataset(None, ws.adj_train, links, labels,
                                   class_values=ws.class_values, **kw),
            DynamicGraphDataset(gs.adj_train, links, labels,
                                class_values=gs.class_values, **kw))
    return out


def jax_cfg(**kw):
    return JaxIGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32), num_relations=5,
                         num_bases=4, **kw)


def port_model(params, **kw):
    model = IGMC(IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                            num_relations=5, num_bases=4, **kw),
                 torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(to_numpy(params)))
    return model


def jax_fwd(cfg):
    return lambda p, b, key=None, training=False: igmc_forward(p, b, cfg, key, training)


def first_batches(data, part="train", seed=3, with_features=0):
    """The first shuffled training batch of each package (host collate),
    with `with_features` random side-feature columns per side."""
    want_ds, got_ds = data[part]
    jb = next(iter(JaxBatchLoader(want_ds, BATCH, shuffle=True, seed=seed,
                                  device_put=False, prefetch=0)))
    pb = next(iter(BatchLoader(got_ds, BATCH, shuffle=True, seed=seed, prefetch=0)))
    if with_features:
        rng = np.random.default_rng(13)
        uf = rng.random((BATCH, with_features)).astype(np.float32)
        vf = rng.random((BATCH, with_features)).astype(np.float32)
        jb.u_feat, jb.v_feat = uf, vf
        pb.u_feat, pb.v_feat = t(uf), t(vf)
    return jb, pb


def jax_segment_noise(key, num_edges, p=0.2):
    """The masks the JAX segment forward draws from `key` in training mode:
    ([E] edge keep, feature keep), as the port's injected noise."""
    key, k_edge = jax.random.split(key)
    keep_e = jax.random.bernoulli(k_edge, 1.0 - p, (num_edges,))
    key, k_drop = jax.random.split(key)
    keep_f = jax.random.bernoulli(k_drop, 0.5, (BATCH, HIDDEN))
    return t(keep_e), t(keep_f)


def test_flat_batches_equal_jax(data):
    """BatchLoader's flat batch (no plan: the segment engine) equals the JAX
    loader's field by field; it carries edge_id and no plans."""
    jb, pb = first_batches(data)
    for f in ("node_label", "edge_src", "edge_dst", "edge_type", "edge_canon",
              "node2graph", "node_mask", "edge_mask", "y", "graph_mask",
              "target_u", "target_v"):
        assert np.array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f))), f
    assert pb.aligned is None and pb.blocked is None and pb.edge_id is not None


@pytest.mark.parametrize("kw", [{}, {"aggr": "relmean"}, {"aggr": "sum"},
                                {"conv_strategy": "per-edge", "force_undirected": True},
                                {"side_features": True, "n_side_features": 6}])
def test_flat_forward_and_gradients_match_jax(data, kw):
    """The segment forward of one ML-1M batch: eval predictions to atol
    1e-5, training predictions with JAX's edge and feature masks injected
    to atol 1e-5, the training loss (ARR 0.001) to rtol 1e-5 and every
    gradient to 1e-4 of its largest entry."""
    feats = kw.get("n_side_features", 0) // 2
    jb, pb = first_batches(data, with_features=feats)
    cfg = jax_cfg(**kw)
    params = igmc_init(jax.random.PRNGKey(5), cfg)
    model = port_model(params, **kw)
    want = np.asarray(igmc_forward(params, jb, cfg, None, False))
    with torch.no_grad():
        got = model.eval()(pb)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    key = jax.random.PRNGKey(9)
    noise = jax_segment_noise(key, pb.num_edges)
    want_t = np.asarray(igmc_forward(params, jb, cfg, key, True))
    with torch.no_grad():
        got_t = model.train()(pb, noise)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0, atol=1e-5)
    assert np.abs(want_t - want).max() > 1e-3            # the dropout acted

    (want_loss, _), want_grads = jax.value_and_grad(
        _make_loss_fn(jax_fwd(cfg), 0.001, True), has_aux=True)(params, jb, key)
    loss, _ = loss_fn(model, pb, noise, 0.001)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_sd = params_from_jax(to_numpy(want_grads))
    for name, p in model.named_parameters():
        grad_close(p.grad, want_sd[name], name)


def test_flat_forward_refuses_what_it_lacks(data):
    """Training mode without noise, a hash dropout without edge ids, an
    unknown engine and the blocked / pallas engines without their plans
    raise."""
    _, pb = first_batches(data)
    model = port_model(igmc_init(jax.random.PRNGKey(0), jax_cfg()))
    with pytest.raises(ValueError, match="eval"):
        model.train()(pb)
    pb.edge_id = None
    with pytest.raises(ValueError, match="packed edge ids"):
        model.train()(pb, (7, torch.ones(BATCH, HIDDEN, dtype=torch.bool)))
    for engine, match in (("blocked", "blocked plans"), ("pallas", "aligned"),
                          ("fused", "unknown flat_aggregate")):
        bad = IGMC(IGMCConfig(flat_aggregate=engine), torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match=match):
            bad.eval()(pb)


# -- the device-resident flat path --------------------------------------------------

def test_assemble_batch_equals_jax_field_by_field(data):
    """assemble_batch of one gid row (two padding ids) equals the JAX
    package's assemble_batch at the same pads, field by field, side
    features included; capacity_bound equals JAX's."""
    want_ds, got_ds = data["train"]
    nc, ec = got_ds.node_counts(), got_ds.edge_counts()
    pads = capacity_bound(nc, ec, 20)
    assert pads == jax_capacity_bound(nc, ec, 20)
    gids = np.concatenate([np.arange(7, 25), [-1, -1]]).astype(np.int32)
    packed_j, packed_p = want_ds.packed, got_ds.packed
    u_feat = np.random.default_rng(14).random((len(packed_p), 3)).astype(np.float32)
    v_feat = np.full((len(packed_p), 2), 0.5, np.float32)
    for packed in (packed_j, packed_p):
        packed.u_feat, packed.v_feat = u_feat, v_feat
    try:
        jdd = JaxDeviceDataset(packed_j, pads[0], pads[1], 20)
        want = jax_assemble_batch(jdd, jnp.asarray(gids))
        got = assemble_batch(DeviceDataset(packed_p, "cpu"), t(gids).long(), *pads)
    finally:
        for packed in (packed_j, packed_p):
            packed.u_feat = packed.v_feat = None
    for f in ("node_label", "edge_src", "edge_dst", "edge_type", "edge_canon",
              "node2graph", "node_mask", "edge_mask", "y", "graph_mask",
              "target_u", "target_v", "u_feat", "v_feat"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    ef = pads[1] // 2
    real = got.edge_mask[:ef]
    first = int(packed_p.edge_offsets[7])
    assert torch.equal(got.edge_id[:ef][real],
                       torch.arange(first, first + int(real.sum())))
    assert torch.equal(got.edge_id[ef:], got.edge_id[:ef])


def test_device_and_host_batches_drop_the_same_edges(data):
    """The same graphs assembled on the device and collated on the host
    (static and dynamic datasets) give the same training predictions under
    one hash seed: both carry each edge's packed id (rtol 1e-5)."""
    _, got_ds = data["train"]
    _, dyn_ds = data["train_dynamic"]
    model = port_model(igmc_init(jax.random.PRNGKey(6), jax_cfg())).train()
    gids = np.arange(30, 30 + BATCH)
    pads = capacity_bound(got_ds.node_counts(), got_ds.edge_counts(), BATCH)
    dev = assemble_batch(DeviceDataset(got_ds.packed, "cpu"), torch.from_numpy(gids),
                         *pads)
    host = BatchLoader(got_ds, BATCH, prefetch=0).make_batch(gids)
    keep = torch.ones(BATCH, HIDDEN, dtype=torch.bool)
    with torch.no_grad():
        a = model(dev, (1234, keep))
        b = model(host, (1234, keep))
        c = model(host, (4321, keep))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert (a - c).abs().max() > 1e-4                    # the seed matters
    dyn = BatchLoader(dyn_ds, BATCH, prefetch=0).make_batch(gids)
    assert dyn.edge_id.max() >= 30 * (1 << 31)           # dynamic keys
    assert torch.equal(dyn.edge_mask, host.edge_mask)


def test_flat_epoch_plan_equals_jax(data):
    """plan_gid_epoch and live_rows equal JAX's; a FlatPass holds the live
    rows of the epoch's permutation (SeedSequence([seed, epoch])) in JAX's
    order."""
    _, got_ds = data["train"]
    order = np.random.default_rng(np.random.SeedSequence([1, 2])).permutation(
        len(got_ds)).astype(np.int64)
    jdd = JaxDeviceDataset(got_ds.packed, 8, 16, 30)
    want, rest = jax_plan_gid_epoch(jdd, order, 3)
    got = plan_gid_epoch(order, 30, 3)
    assert rest == [] and len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert np.array_equal(a, b) and a.dtype == b.dtype
        assert live_rows(a) == jax_live_rows(b)
    fp = FlatPass.plan(got_ds, 30, 3, "cpu", order)
    rows = np.concatenate([b[:jax_live_rows(b)] for b in want])
    assert np.array_equal(fp.gids.numpy(), rows) and len(fp.bucket_of) == 4
    assert (fp.node_pad, fp.edge_pad) == capacity_bound(got_ds.node_counts(),
                                                        got_ds.edge_counts(), 30)


def _jax_feature_noise(seed, epochs, steps):
    """The feature masks JAX's training draws per step with adj_dropout 0:
    step i of epoch e splits fold_in(fold_in(PRNGKey(seed), e), i) once."""
    key = jax.random.PRNGKey(seed)
    out = []
    for e in epochs:
        for i in range(steps):
            kk = jax.random.fold_in(jax.random.fold_in(key, e), i)
            _, k_drop = jax.random.split(kk)
            out.append((0, t(jax.random.bernoulli(k_drop, 0.5, (BATCH, HIDDEN)))))
    return out


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_flat_training_trajectory_matches_jax(data, monkeypatch, kind):
    """Two epochs of train_multiple_epochs(batch_mode="flat") with edge
    dropout off, from the same weights with JAX's feature masks: the static
    datasets run device-resident in both packages (the epoch's gid rows of
    SeedSequence([seed, epoch])), the dynamic ones through the loaders; per
    epoch, train loss within 1e-4 relative and test RMSE within 1e-4 of
    JAX's."""
    sfx = "" if kind == "static" else "_dynamic"
    (jtr, ptr), (jte, pte) = data["train" + sfx], data["test" + sfx]
    cfg = jax_cfg(adj_dropout=0.0)
    params = igmc_init(jax.random.PRNGKey(7), cfg)
    common = dict(epochs=2, batch_size=BATCH, lr=1e-3, lr_decay_factor=0.1,
                  lr_decay_step_size=1, ARR=0.001, seed=1)
    want = []
    jax_train_multiple_epochs(jtr, jte, jax_fwd(cfg),
                              jax.tree_util.tree_map(jnp.array, params),
                              progress=False, logger=lambda i, s: want.append(dict(i)),
                              **common)
    feed = iter(_jax_feature_noise(1, (1, 2), N_PAIRS // BATCH))
    monkeypatch.setattr(port_loop, "draw_noise", lambda gen, b: next(feed))
    planned = []
    plan = port_loop.FlatPass.plan.__func__
    monkeypatch.setattr(port_loop.FlatPass, "plan", classmethod(
        lambda cls, *a, **kw: planned.append(plan(cls, *a, **kw)) or planned[-1]))
    got = []
    train_multiple_epochs(ptr, pte, port_model(params, adj_dropout=0.0), device="cpu",
                          batch_mode="flat", logger=lambda i, s: got.append(dict(i)),
                          **common)
    assert next(feed, None) is None
    assert bool(planned) == (kind == "static")           # device-resident
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(g["test_rmse"], w["test_rmse"], rtol=0, atol=1e-4)
    assert len(got) == 2


def test_test_once_flat_matches_jax(data):
    """test_once(batch_mode="flat") on the segment engine: one model
    (static: device-resident; dynamic: the loader) and a two-checkpoint
    ensemble, RMSE within 1e-5 of JAX's flat test_once."""
    import os
    import tempfile

    from igmc_tpu.train.torch_interop import save_reference_checkpoint

    (jte, pte), (_, pdyn) = data["test"], data["test_dynamic"]
    cfg = jax_cfg()
    params = igmc_init(jax.random.PRNGKey(8), cfg)
    want = jax_test_once(jte, jax_fwd(cfg), params, BATCH, params=params)
    for ds in (pte, pdyn):
        got = port_test_once(ds, port_model(params), BATCH, device="cpu")
        assert abs(got - want) <= 1e-5, (got, want)
    with tempfile.TemporaryDirectory() as d:
        ckpts = []
        for seed in (1, 2):
            ckpts.append(os.path.join(d, f"model_checkpoint{seed}.pth"))
            save_reference_checkpoint(ckpts[-1], igmc_init(jax.random.PRNGKey(seed), cfg))
        want = jax_test_once(jte, jax_fwd(cfg), params, BATCH, ensemble=True,
                             checkpoints=ckpts)
        got = port_test_once(pte, port_model(params), BATCH, ensemble=True,
                             checkpoints=ckpts, device="cpu", flat_aggregate="auto")
    assert abs(got - want) <= 1e-5, (got, want)
