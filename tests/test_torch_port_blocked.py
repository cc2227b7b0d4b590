"""igmc_torch's blocked flat engine against the JAX package's on the CPU:
the NumPy plans equal JAX's arrays, the hash dropout masks equal JAX's bit
for bit, blocked_rgcn_aggregate's forward and backward against JAX's
custom_vjp and against the port's segment engine (the skewed-degree case
of tests/test_blocked.py included), the blocked IGMC forward (mean, sum,
relmean; training with the hash dropout), BatchLoader(flat_aggregate=
"blocked") and training through it. Inputs are made from numpy seeds; each
assert states its tolerance."""

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
from igmc_tpu.models.igmc import igmc_forward, igmc_init
from igmc_tpu.models.rgcn import rgcn_init
from igmc_tpu.ops import blocked as jb

from igmc_torch.batching import BatchLoader, StaticGraphDataset
from igmc_torch.data import create_trainvaltest_split
from igmc_torch.kernels.rgcn_aggregate import plan_capacity_blocks
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.models.rgcn import RGCNConv, rgcn_apply
from igmc_torch.ops import blocked as pb
from igmc_torch.train import loss_fn, params_from_jax, train_multiple_epochs
from torch_plan_checks import assert_blocked_plans_equal as assert_plans_equal

torch.set_num_threads(1)

N_PAIRS = 100
BATCH = 50
HIDDEN = 128


def t(a):
    return torch.from_numpy(np.array(a))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def grad_close(got, want, name, rtol=1e-4):
    """rtol / atol `rtol` of the reference's largest entry."""
    want = t(want)
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * float(want.abs().max()) + 1e-12, msg=name)


def flat_edges(seed, N=300, n_fwd=700, R=5, hubs=0):
    """A flat edge list of forward pairs and their reverses (edge_canon
    ties them), every 7th edge masked; with `hubs`, half the forward
    edges land on that many hub nodes."""
    rng = np.random.default_rng(seed)
    fs = rng.integers(0, N, n_fwd)
    fd = rng.integers(0, N, n_fwd)
    if hubs:
        fd = np.where(rng.random(n_fwd) < 0.5, rng.integers(0, hubs, n_fwd), fd)
    src = np.concatenate([fs, fd]).astype(np.int32)
    dst = np.concatenate([fd, fs]).astype(np.int32)
    typ = np.tile(rng.integers(0, R, n_fwd), 2).astype(np.int32)
    canon = np.tile(np.arange(n_fwd), 2).astype(np.int32)
    mask = np.ones(2 * n_fwd, bool)
    mask[::7] = False
    return src, dst, typ, mask, canon


GEOMETRY = dict(rows=128, eblk=64, group=4)


def plans(edges, N=300, **kw):
    g = dict(GEOMETRY, **kw)
    return (jb.plan_blocked_edges(*edges, N, device_put=False, **g),
            pb.plan_blocked_edges(*edges, N, **g))


@pytest.mark.parametrize("num_blocks", [None, 64])
def test_plans_equal_jax_arrays(num_blocks):
    """plan_blocked_edges (both plans, every field, dtype included) and
    pad_plan_blocks equal the JAX package's arrays."""
    J, P = plans(flat_edges(1), num_blocks=num_blocks)
    assert_plans_equal(J, P)
    J2 = jb.pad_plan_blocks(J.fwd, 80, 3, 4)
    P2 = pb.pad_plan_blocks(pb.BlockedPlan(*(a.numpy() for a in P.fwd)), 80, 3, 4)
    for a, b in zip(J2, P2):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("force_undirected", [False, True])
def test_dropout_masks_equal_jax_bit_for_bit(force_undirected):
    """dropout_masks of one seed equal JAX's for both plans, and both plans
    keep the same directed edges (same key, same decision)."""
    J, P = plans(flat_edges(2))
    for seed in (0, 12345, 2**31 - 2):
        want = jb.dropout_masks(J, 0.3, force_undirected, jnp.uint32(seed))
        got = pb.dropout_masks(P, 0.3, force_undirected, seed)
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b.numpy())
        key = P.fwd.pair if force_undirected else P.fwd.ukey
        kept_f = set(key[got[0] > 0].tolist())
        key_b = P.bwd.pair if force_undirected else P.bwd.ukey
        assert kept_f == set(key_b[got[1] > 0].tolist())


def aggregate_case(edges, N=300, cin=8, cout=6, R=5, nb=4, seed=3, **kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, cin)).astype(np.float32)
    att = rng.standard_normal((R, nb)).astype(np.float32)
    basis = rng.standard_normal((nb, cin, cout)).astype(np.float32)
    g = rng.standard_normal((N, cout)).astype(np.float32)
    J, P = plans(edges, N, **kw)
    return x, att, basis, g, J, P


@pytest.mark.parametrize("dropout", [False, True])
def test_aggregate_forward_and_backward_match_jax(dropout):
    """blocked_rgcn_aggregate against JAX's custom_vjp on the same plans and
    masks: the sums to rtol 1e-5 (atol 1e-5 of the largest entry), and dx,
    datt, dbasis of a weighted sum to 1e-4 of each largest entry; under
    bfloat16 the forward to one bfloat16 ulp (2**-7) of the largest entry."""
    x, att, basis, g, J, P = aggregate_case(flat_edges(3))
    jm = (jb.dropout_masks(J, 0.2, False, jnp.uint32(77)) if dropout
          else (J.fwd.mask, J.bwd.mask))
    pm = (pb.dropout_masks(P, 0.2, False, 77) if dropout else (P.fwd.mask, P.bwd.mask))
    for cd in (None, jnp.bfloat16):
        f = lambda xx, a, b: jb.blocked_rgcn_aggregate(xx, a, b, J, jm, J.rows, 300,
                                                       J.group, None, None, cd)
        want = np.asarray(f(jnp.asarray(x), jnp.asarray(att), jnp.asarray(basis)))
        grads = jax.grad(lambda *a: jnp.vdot(f(*a), g), argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(att), jnp.asarray(basis))
        tx, ta, tb = (t(v).requires_grad_() for v in (x, att, basis))
        got = pb.blocked_rgcn_aggregate(tx, ta, tb, P, pm,
                                        None if cd is None else torch.bfloat16)
        scale = np.abs(want).max()
        if cd is None:
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                       atol=1e-5 * scale)
        else:
            assert np.abs(got.detach().numpy() - want).max() <= 2.0 ** -7 * scale
        (got * t(g)).sum().backward()
        for name, v, w in zip(("dx", "datt", "dbasis"), (tx, ta, tb), grads):
            grad_close(v.grad, w, name)


@pytest.mark.parametrize("aggr", ["mean", "sum", "relmean"])
def test_aggregate_equals_the_segment_engine(aggr):
    """The blocked engine (mean: the sums over blocked_degree; relmean: the
    relmean_weights of blocked_rel_counts) computes rgcn_apply's aggregate:
    rgcn_apply minus its x @ root + bias, to rtol 1e-5, and the same
    gradients for x, att and basis to 1e-4 of each largest entry."""
    src, dst, typ, mask, canon = flat_edges(4)
    x, att, basis, g, _, P = aggregate_case((src, dst, typ, mask, canon))
    conv = RGCNConv(8, 6, 5, 4, torch.Generator().manual_seed(0))
    conv.load_state_dict({"basis": t(basis), "att": t(att), "root": torch.zeros(8, 6),
                          "bias": torch.zeros(6)})
    tx = t(x).requires_grad_()
    want = rgcn_apply(conv, tx, t(src), t(dst), t(typ), t(mask), 300, "basis-mix", aggr)
    (want * t(g)).sum().backward()
    want_grads = [v.grad.clone() for v in (tx, conv.att, conv.basis)]
    masks = (P.fwd.mask, P.bwd.mask)
    if aggr == "relmean":
        cnt = pb.blocked_rel_counts(P.fwd, masks[0], 5, P.rows, 300)
        cinv = (1.0 / cnt.clamp_min(1.0)).reshape(-1)
        masks = (pb.relmean_weights(cinv, P.fwd, masks[0], 5, P.rows, True),
                 pb.relmean_weights(cinv, P.bwd, masks[1], 5, P.rows, False))
    tx2, ta, tb = (t(v).requires_grad_() for v in (x, att, basis))
    got = pb.blocked_rgcn_aggregate(tx2, ta, tb, P, masks)
    if aggr == "mean":
        deg = pb.blocked_degree(P.fwd, masks[0], P.rows, 300)
        np.testing.assert_array_equal(deg.numpy(), np.bincount(dst[mask], minlength=300))
        got = got / deg.clamp_min(1.0)[:, None]
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.detach().abs().max()))
    (got * t(g)).sum().backward()
    for name, v, w in zip(("dx", "datt", "dbasis"), (tx2, ta, tb), want_grads):
        grad_close(v.grad, w.numpy(), name)


def test_blocked_skewed_degrees():
    """tests/test_blocked.py's power-law case: half of 3,000 edges land on
    4 hub nodes, so heavy rows span several blocks of one chunk (rows 64,
    eblk 256, group 4); the forward equals JAX's to rtol / atol 1e-4 and
    the segment oracle's (rgcn_apply's sum) to the same."""
    N, R, C, ne, E = 256, 5, 8, 3000, 4096
    rng = np.random.default_rng(11)
    dst = np.where(rng.random(ne) < 0.5, rng.integers(0, 4, ne),
                   rng.integers(0, N, ne)).astype(np.int32)
    src = rng.integers(0, N, ne).astype(np.int32)
    et = rng.integers(0, R, ne).astype(np.int32)
    es, ed, ety = (np.zeros(E, np.int32) for _ in range(3))
    ec, em = np.arange(E, dtype=np.int32), np.zeros(E, bool)
    es[:ne], ed[:ne], ety[:ne], em[:ne] = src, dst, et, True
    p = rgcn_init(jax.random.PRNGKey(0), C, C, R, 4)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (N, C)))
    J = jb.plan_blocked_edges(es, ed, ety, em, ec, N, rows=64, eblk=256, group=4,
                              device_put=False)
    P = pb.plan_blocked_edges(es, ed, ety, em, ec, N, rows=64, eblk=256, group=4)
    assert_plans_equal(J, P)
    assert int((P.fwd.chunk == 0).sum()) > 1              # a chunk of several blocks
    want = np.asarray(jb.blocked_rgcn_aggregate(jnp.asarray(x), p["att"], p["basis"], J,
                                                (J.fwd.mask, J.bwd.mask), 64, N, 4))
    got = pb.blocked_rgcn_aggregate(t(x), t(p["att"]), t(p["basis"]), P,
                                    (P.fwd.mask, P.bwd.mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    conv = RGCNConv(C, C, R, 4, torch.Generator().manual_seed(0))
    conv.load_state_dict({k: t(v) for k, v in p.items()})
    with torch.no_grad():
        oracle = (rgcn_apply(conv, t(x), t(es), t(ed), t(ety), t(em), N, "per-edge",
                             "sum") - t(x) @ conv.root - conv.bias)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-4, atol=1e-4)


# -- the blocked IGMC forward and the loader ---------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(JAX, port) datasets of 100 training and 100 held-out pairs of a
    300 x 400, 8,000-rating ml_1m fixture (h 1, at most 100 nodes per hop)."""
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
    return out


def blocked_batches(data):
    want_ds, got_ds = data["train"]
    jbatch = next(iter(JaxBatchLoader(want_ds, BATCH, shuffle=True, seed=3,
                                      device_put=False, prefetch=0,
                                      flat_aggregate="blocked")))
    pbatch = next(iter(BatchLoader(got_ds, BATCH, shuffle=True, seed=3, prefetch=0,
                                   flat_aggregate="blocked")))
    return jbatch, pbatch


def test_loader_attaches_jax_blocked_plans(data):
    """BatchLoader(flat_aggregate="blocked") attaches JAX's plans, sized by
    plan_capacity_blocks, to a batch equal to JAX's (no aligned plans, the
    node pad not rounded to the kernel's rows)."""
    jbatch, pbatch = blocked_batches(data)
    assert_plans_equal(jbatch.blocked, pbatch.blocked)
    nb = plan_capacity_blocks(pbatch.num_nodes, pbatch.num_edges)
    assert pbatch.blocked.fwd.gather.shape[0] == -(-nb // 8) * 8
    assert pbatch.aligned is None
    assert np.array_equal(pbatch.edge_src.numpy(), np.asarray(jbatch.edge_src))
    moved = pbatch.to("cpu")
    assert_plans_equal(jbatch.blocked, moved.blocked)


@pytest.mark.parametrize("aggr", ["mean", "sum", "relmean"])
def test_blocked_forward_and_gradients_match_jax(data, aggr):
    """flat_aggregate="blocked": eval predictions to atol 1e-5; training
    (hash dropout of JAX's seed, JAX's feature mask) predictions to atol
    1e-5, the loss (ARR 0.001) to rtol 1e-5 and every gradient to 1e-4 of
    its largest entry; the blocked and segment engines agree in eval to
    atol 1e-5."""
    jbatch, pbatch = blocked_batches(data)
    cfg = JaxIGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32), num_relations=5,
                        num_bases=4, aggr=aggr, flat_aggregate="blocked")
    params = igmc_init(jax.random.PRNGKey(5), cfg)
    model = IGMC(IGMCConfig(aggr=aggr, flat_aggregate="blocked"),
                 torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(to_numpy(params)))
    want = np.asarray(igmc_forward(params, jbatch, cfg, None, False))
    with torch.no_grad():
        got = model.eval()(pbatch)
        seg = IGMC(IGMCConfig(aggr=aggr), torch.Generator().manual_seed(0))
        seg.load_state_dict(model.state_dict())
        via_segment = seg.eval()(pbatch)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(via_segment.numpy(), want, rtol=0, atol=1e-5)

    key = jax.random.PRNGKey(9)
    key2, k_edge = jax.random.split(key)
    seed = int(jax.random.randint(k_edge, (), 0, jnp.iinfo(jnp.int32).max))
    _, k_drop = jax.random.split(key2)
    noise = (seed, t(jax.random.bernoulli(k_drop, 0.5, (BATCH, HIDDEN))))
    from igmc_tpu.train.loop import _make_loss_fn

    fwd = lambda p, b, key=None, training=False: igmc_forward(p, b, cfg, key, training)
    (want_loss, _), want_grads = jax.value_and_grad(
        _make_loss_fn(fwd, 0.001, True), has_aux=True)(params, jbatch, key)
    want_t = np.asarray(igmc_forward(params, jbatch, cfg, key, True))
    model.train()
    with torch.no_grad():
        np.testing.assert_allclose(model(pbatch, noise).numpy(), want_t, rtol=0,
                                   atol=1e-5)
    assert np.abs(want_t - want).max() > 1e-3            # the dropout acted
    loss, _ = loss_fn(model, pbatch, noise, 0.001)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_sd = params_from_jax(to_numpy(want_grads))
    for name, p in model.named_parameters():
        grad_close(p.grad, want_sd[name], name)


def test_training_through_the_blocked_engine(data):
    """train_multiple_epochs(flat_aggregate="blocked") trains 2 epochs (the
    loader attaches the plans; finite, falling losses) and test_once over
    the blocked engine equals the segment engine's RMSE to 1e-5."""
    (_, tr), (_, te) = data["train"], data["test"]
    model = IGMC(IGMCConfig(), torch.Generator().manual_seed(1))
    infos = []
    rmse, state = train_multiple_epochs(
        tr, te, model, epochs=2, batch_size=BATCH, lr=5e-3, lr_decay_factor=0.1,
        lr_decay_step_size=50, ARR=0.001, seed=1, batch_mode="flat",
        flat_aggregate="blocked", device="cpu", logger=lambda i, s: infos.append(i))
    assert state.model.cfg.flat_aggregate == "blocked"
    assert model.cfg.flat_aggregate == "segment"         # the caller's is as it was
    assert np.isfinite(rmse) and infos[1]["train_loss"] < infos[0]["train_loss"]
    from igmc_torch.train import test_once

    a = test_once(te, state.model, BATCH, flat_aggregate="blocked", device="cpu")
    b = test_once(te, state.model, BATCH, flat_aggregate="segment", device="cpu")
    assert abs(a - b) <= 1e-5 and abs(a - rmse) <= 1e-5
