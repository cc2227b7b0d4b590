"""igmc_torch's edge-partitioned (EP) giant batches against the JAX
package's parallel/ep.py on the CPU: the host arrays (partition_batch,
pad_ep_batch, build_ep_batches, build_ep_blocked, pad_ep_blocked,
comm_stats, the dropout keys) equal JAX's bit for bit at D = 2 and 4; then
the port runs as D gloo ranks (one spawn per world size, module-scoped;
tests/_torch_parallel_ranks.py ep_checks) and its forward (mean, sum,
relmean; segment and blocked local aggregates), its eval step, one train
step per local aggregate (edge dropout on, feature dropout off in both
packages, ARR 0.001), train_multiple_epochs_ep with its resume and
test_once_ep's ensemble are held against JAX's make_ep_forward and
make_ep_train_step on a D-device mesh and against the port's own
single-device flat path. Tolerances are stated per test."""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import igmc_tpu.parallel.ep as jep
from igmc_tpu.batching import collate as jax_collate
from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStatic
from igmc_tpu.graphs import BipartiteCSR as JaxCSR
from igmc_tpu.graphs import extract_many as jax_extract
from igmc_tpu.models import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models import igmc_init
from igmc_tpu.models.igmc import arr_regularizer as jax_arr
from igmc_tpu.parallel import make_mesh
from igmc_tpu.train.loop import make_optimizer as jax_make_optimizer

import _torch_parallel_ranks as ranks
from igmc_torch.batching.batch import collate
from igmc_torch.ops.dropout import hash_edge_keep
from igmc_torch.parallel import ep, spawn
from igmc_torch.train import test_once as port_test_once

torch.set_num_threads(1)

CFG = dict(num_features=4, latent_dim=(8, 8), num_relations=5, num_bases=2)
AGGRS = ("mean", "sum", "relmean")
ARR = 0.001
STEP_SEED = 7
FWD_TOL = 2e-5            # JAX's own EP-vs-flat bound (tests/test_ep.py)
GRAD_TOL = 1e-4           # of the largest entry, as chip_smoke phase 7
LOSS_RTOL = 1e-5
# parameters after one Adam step: JAX's DP-vs-flat bound (tests/test_parallel.py)
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-6


def jax_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, igmc_init(jax.random.PRNGKey(seed), JaxIGMCConfig(**CFG)))


def batches(seed=0, n=16, node_pad=512, edge_pad=4096):
    """(JAX, port) flat batches of the same n subgraphs (tests/test_ep.py's
    make_batch)."""
    M = ranks.rating_matrix(40, 0.35, seed)
    (us, vs), labels = ranks.links(M)
    jg = jax_extract((us[:n], vs[:n]), labels[:n], JaxCSR(sp.csr_matrix(M)), h=1,
                     class_values=ranks.CV, backend="numpy")
    return (jax_collate(jg, n, node_pad, edge_pad),
            collate(ranks.graphs_of(M, n), n, node_pad, edge_pad))


def assert_ep_equal(got, want):
    for f in ("node_label", "node_mask", "intra_src", "intra_dst", "intra_type",
              "intra_pair", "intra_mask", "bnd_src", "bnd_dst", "bnd_type",
              "bnd_pair", "bnd_mask", "send_idx", "tgt_send_idx", "y", "graph_mask",
              "target_u", "target_v", "u_feat", "v_feat"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
        assert a.dtype == np.asarray(b).dtype, f


def assert_plans_equal(got, want):
    for g, w in zip((got.i_fwd, got.i_bwd, got.b_fwd, got.b_bwd),
                    (want.i_fwd, want.i_bwd, want.b_fwd, want.b_bwd)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert (got.rows, got.group, got.Nl, got.halo_rows) == (
        want.rows, want.group, want.Nl, want.halo_rows)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("seed", [0, 5])
def test_partition_and_pad_equal_jax(D, seed):
    """partition_batch, pad_ep_batch to larger caps and comm_stats: the JAX
    package's arrays and dict, bit for bit (the two collates agree first)."""
    jb, pb = batches(seed)
    for f in ("edge_src", "edge_dst", "edge_type", "edge_canon", "edge_mask",
              "target_u", "target_v", "graph_mask", "node_label"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)))
    got, want = ep.partition_batch(pb, D), jep.partition_batch(jb, D)
    assert_ep_equal(got, want)
    assert ep.ep_batch_caps(got) == tuple(jep.ep_batch_caps(want))
    caps = ep.EPCaps(*(c + 8 for c in ep.ep_batch_caps(got)))
    assert_ep_equal(ep.pad_ep_batch(got, caps),
                    jep.pad_ep_batch(want, jep.EPCaps(*caps)))
    for kw in ({}, dict(feature_width=16, n_layers=2, readout_width=None)):
        assert ep.comm_stats(got, **kw) == jep.comm_stats(want, **kw)


@pytest.mark.parametrize("D", [2, 4])
def test_build_ep_batches_and_blocked_plans_equal_jax(D):
    """build_ep_batches (one shape, fixed membership, gid chunks),
    build_ep_blocked and pad_ep_blocked: JAX's arrays bit for bit."""
    M = ranks.rating_matrix(25, 0.4, 3)
    (us, vs), labels = ranks.links(M)
    n = 44
    jds = JaxStatic(None, sp.csr_matrix(M), (us[:n], vs[:n]), labels[:n], h=1,
                    class_values=ranks.CV, backend="numpy", progress=False)
    pds, _ = ranks.datasets(M, n, 0)
    want, want_chunks = jep.build_ep_batches(jds, 16, D, device_put=False)
    got, chunks = ep.build_ep_batches(pds, 16, D)
    assert len(got) == len(want) == 3
    for g, w, c, wc in zip(got, want, chunks, want_chunks):
        assert_ep_equal(g, w)
        np.testing.assert_array_equal(c, wc)
        gp, wp = ep.build_ep_blocked(g), jep.build_ep_blocked(w, device_put=False)
        assert_plans_equal(gp, wp)
        assert ep.ep_blocked_blocks(gp) == jep.ep_blocked_blocks(wp)
    gps = [ep.build_ep_blocked(g) for g in got]
    wps = [jep.build_ep_blocked(w, device_put=False) for w in want]
    targets = ep.max_ep_blocked_blocks(gps)
    assert targets == jep.max_ep_blocked_blocks(wps)
    targets = tuple(t + 8 for t in targets)
    for g, w in zip(gps, wps):
        assert_plans_equal(ep.pad_ep_blocked(g, targets), jep.pad_ep_blocked(w, targets))


@pytest.mark.parametrize("force_undirected", [False, True])
def test_dropout_keys_and_hash_equal_jax(force_undirected):
    """dropout_key_ids + hash_edge_keep: JAX's keep decisions bit for bit
    (pair ids and global destinations over their whole int32 range)."""
    rng = np.random.default_rng(0)
    pair = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    gdst = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    for seed in (0, 1, 2**32 - 1, 123456789):
        want = jep.hash_edge_keep(jnp.uint32(seed), jep.dropout_key_ids(
            force_undirected, jnp.asarray(pair), jnp.asarray(gdst)), 0.2)
        keys = ep.dropout_key_ids(force_undirected, torch.from_numpy(pair),
                                  torch.from_numpy(gdst))
        np.testing.assert_array_equal(
            np.asarray(jep.dropout_key_ids(force_undirected, jnp.asarray(pair),
                                           jnp.asarray(gdst))).astype(np.int64),
            keys.numpy())
        np.testing.assert_array_equal(hash_edge_keep(seed, keys, 0.2).numpy(),
                                      np.asarray(want))
    assert ep.ep_step_seed(1, 2, 3) == int(jep.ep_step_seed(1, 2, 3))


# ---------------------------------------------------------------------------
# the port as D gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"D{d}")
def run(request, tmp_path_factory):
    """Every rank's ep_checks results at world size D, and D."""
    D = request.param
    _, pb = batches(0)
    spec = dict(cfg=CFG, batch=pb, params={a: jax_params(0) for a in AGGRS},
                ARR=ARR, step_seed=STEP_SEED, M=ranks.rating_matrix(25, 0.4, 3),
                n_train=48, n_test=16, ep_batch=16,
                work=str(tmp_path_factory.mktemp(f"ep{D}")))
    return spawn(ranks.ep_checks, D, "cpu", args=(spec,), timeout=300), D


def jax_batch_mesh(D):
    jb, _ = batches(0)
    return jb, jax.device_put(jep.partition_batch(jb, D)), make_mesh(n_data=D)


def port_flat_preds(aggr):
    _, pb = batches(0)
    model = ranks.model_of(CFG | {"aggr": aggr, "adj_dropout": 0.0}, jax_params(0)).eval()
    with torch.no_grad():
        return model(pb).numpy()


@pytest.mark.parametrize("aggr", AGGRS)
def test_ep_forward_matches_jax_and_flat(run, aggr):
    """The EP forward's predictions (gathered over the ranks) equal JAX's
    make_ep_forward on a D-device mesh and the port's single-device flat
    forward, rtol / atol 2e-5; the blocked local aggregate equals the
    segment one to the same bound."""
    results, D = run
    jb, jep_batch, mesh = jax_batch_mesh(D)
    cfg = JaxIGMCConfig(**CFG, aggr=aggr, adj_dropout=0.0)
    fwd = jep.make_ep_forward(cfg, mesh)
    want = np.asarray(jax.jit(lambda p, e: fwd(p, e, jnp.uint32(0), training=False))(
        jax.tree_util.tree_map(jnp.asarray, jax_params(0)), jep_batch)).reshape(-1)
    flat = port_flat_preds(aggr)
    for r in results:
        np.testing.assert_allclose(r["fwd"][aggr], want, rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(r["fwd"][aggr], flat, rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(r["fwd_blocked"][aggr], r["fwd"][aggr],
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_ep_eval_step_sums_and_gathers(run):
    """make_ep_eval_step: the all-reduced squared-error sum and count and
    the gathered predictions of the whole batch, against the flat
    forward (rtol 2e-5), the same on every rank."""
    results, _ = run
    _, pb = batches(0)
    flat = port_flat_preds("mean")
    mask = pb.graph_mask.numpy()
    sse = float((((flat - pb.y.numpy()) ** 2) * mask).sum())
    for r in results:
        assert r["eval"]["cnt"] == mask.sum()
        np.testing.assert_allclose(r["eval"]["sse"], sse, rtol=FWD_TOL)
        np.testing.assert_allclose(r["eval"]["preds"], flat, rtol=FWD_TOL, atol=FWD_TOL)


def max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's EP train step (edge dropout 0.2 on, feature dropout patched
    out) at D = 2 and 4: loss, gradients (jax.grad of its loss) and
    parameters after the Adam step."""
    out = {}
    saved = jep.feature_dropout
    jep.feature_dropout = lambda k, h, p, training: h
    try:
        for D in (2, 4):
            _, e, mesh = jax_batch_mesh(D)
            cfg = JaxIGMCConfig(**CFG, adj_dropout=0.2)
            p0 = jax.tree_util.tree_map(jnp.asarray, jax_params(0))
            opt = jax_make_optimizer(1e-2)
            fwd = jep.make_ep_forward(cfg, mesh)

            def loss_fn(p):
                preds = fwd(p, e, jnp.uint32(STEP_SEED), training=True)
                gm = e.graph_mask.astype(jnp.float32)
                return (jnp.sum(((preds - e.y) ** 2) * gm) / jnp.maximum(gm.sum(), 1.0)
                        + ARR * jax_arr(p))

            grads = jax.jit(jax.grad(loss_fn))(p0)
            step, _, _ = jep.make_ep_train_step(cfg, opt, ARR, mesh)
            params, _, loss, _ = step(jax.tree_util.tree_map(jnp.copy, p0), opt.init(p0),
                                      e, jnp.uint32(STEP_SEED))
            out[D] = dict(loss=float(loss), grads=jax.tree_util.tree_map(np.asarray, grads),
                          params=jax.tree_util.tree_map(np.asarray, params))
    finally:
        jep.feature_dropout = saved
    return out


@pytest.mark.parametrize("local_aggregate", ["segment", "blocked"])
def test_ep_train_step_matches_jax(run, jax_steps, local_aggregate):
    """One EP train step with edge dropout 0.2 (the hash of the step seed
    and the EP keys, JAX's bit for bit), feature dropout off in both
    packages, ARR 0.001, Adam lr 1e-2, per local aggregate: the loss
    (rtol 1e-5), every gradient (1e-4 of its largest entry) and the
    parameters after the step (rtol 5e-4 / atol 5e-6) equal JAX's; the step
    issues one all_reduce, and 2L + 1 exchanges (L + 1 forward, L backward:
    the one-hot input needs no gradient)."""
    from igmc_torch.train import params_from_jax

    results, D = run
    want = jax_steps[D]
    wg, wp = params_from_jax(want["grads"]), params_from_jax(want["params"])
    L = len(CFG["latent_dim"])
    for r in results:
        got = r["step"][local_aggregate]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        for k, g in got["grads"].items():
            assert max_rel(g, wg[k].numpy()) < GRAD_TOL, k
        for k, v in got["params"].items():
            np.testing.assert_allclose(v, wp[k].numpy(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)
        assert got["calls"] == {"all_reduce": 1, "all_to_all": 2 * L + 1}


def test_ep_training_decreases_resumes_and_agrees_across_ranks(run):
    """train_multiple_epochs_ep for 2 epochs (edge and feature dropout on):
    the train loss falls; a resume from epoch 1's checkpoints ends where
    the uninterrupted run did (RMSE 1e-6, parameters atol 1e-6); the blocked
    local aggregate trains to the segment one's RMSE (1e-5); and every
    rank's parameters are identical bit for bit."""
    results, _ = run
    r0 = results[0]
    losses = r0["train"]["segment"]["losses"]
    assert len(losses) == 2 and losses[1] < losses[0]
    seg = r0["train"]["segment"]
    assert abs(r0["resume"]["rmse"] - seg["rmse"]) < 1e-6
    for k, v in r0["resume"]["params"].items():
        np.testing.assert_allclose(v, seg["params"][k], rtol=0, atol=1e-6)
    assert abs(r0["train"]["blocked"]["rmse"] - seg["rmse"]) < 1e-5
    for r in results[1:]:
        for agg in ("segment", "blocked"):
            for k, v in r["train"][agg]["params"].items():
                np.testing.assert_array_equal(v, r0["train"][agg]["params"][k])
        assert r["train"]["segment"]["rmse"] == seg["rmse"]


def test_test_once_ep_ensemble_matches_single_device(run):
    """test_once_ep(ensemble=True) over the two checkpoints the EP run
    wrote equals the port's single-device flat test_once ensemble of the
    same checkpoints (1e-5), on every rank."""
    results, _ = run
    M = ranks.rating_matrix(25, 0.4, 3)
    _, test = ranks.datasets(M, 48, 16)
    want = port_test_once(test, ranks.model_of(CFG, jax_params(0)), 16, ensemble=True,
                     checkpoints=results[0]["ckpts"], batch_mode="flat", device="cpu")
    assert all(os.path.isfile(c) for c in results[0]["ckpts"])
    for r in results:
        assert abs(r["ensemble"] - want) < 1e-5
