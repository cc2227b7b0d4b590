"""igmc_torch's data parallelism, multi-host feeding and data-parallel
serving against the JAX package's parallel/dp.py, parallel/multihost.py
and train/loop.py mesh branches on the CPU. Host side, in this process:
process_shard_indices, capacity_ladders, dynamic_capacity_ladders, Subset
and split_for_devices equal JAX's; BatchLoader(n_devices, rank) yields
split_for_devices' sub-batch; the JAX package's refusals. Then the port
runs as D gloo ranks (one spawn per world size, module-scoped;
tests/_torch_parallel_ranks.py dp_checks): the flat DP step and the dense
DP row step without dropout against JAX's make_dp_train_step and
make_dense_device_train_step(mesh=) on a D-device mesh; the DP steps with
dropout on against the port's single-device step on the whole batch; DP
evaluation; train_multiple_epochs(mesh=) on the dense, flat and dynamic
dense layouts against the single-device runs; Predictor(mesh=) against
Predictor. Tolerances are stated per test."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

import igmc_tpu.parallel.dp as jdp
import igmc_tpu.parallel.multihost as jmh
from igmc_tpu.batching import pad_ladder as jax_pad_ladder
from igmc_tpu.batching.dataset import DynamicGraphDataset as JaxDynamic
from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStatic
from igmc_tpu.batching.dense import plan_dense_buckets as jax_plan_dense
from igmc_tpu.batching.device_data import DeviceDataset as JaxDeviceDataset
from igmc_tpu.graphs import BipartiteCSR as JaxCSR
from igmc_tpu.graphs import extract_many as jax_extract
from igmc_tpu.models import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models import igmc_forward, igmc_init
from igmc_tpu.parallel import batch_sharding, make_mesh, replicated_sharding
from igmc_tpu.train.loop import make_dense_device_train_step
from igmc_tpu.train.loop import make_optimizer as jax_make_optimizer

import _torch_parallel_ranks as ranks
from igmc_torch.batching import BatchLoader
from igmc_torch.models import IGMCConfig
from igmc_torch.parallel import Mesh, multihost, spawn, split_for_devices
from igmc_torch.serve import Predictor
from igmc_torch.train import params_from_jax, train_multiple_epochs

torch.set_num_threads(1)

CFG = dict(num_features=4, latent_dim=(8, 8), num_relations=5, num_bases=2)
ARR = 0.001
BATCH = 8
N_TRAIN, N_TEST, N_STEP = 48, 16, 16
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # of the largest entry, as chip_smoke phase 7
# parameters after one Adam step: JAX's DP-vs-flat bound (tests/test_parallel.py)
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-6
RMSE_TOL = 1e-5
TRAIN_RUNS = {"dense": dict(batch_mode="dense"), "flat": dict(batch_mode="flat"),
              "dynamic": dict(batch_mode="dense", dynamic=True)}
GRAPH_FIELDS = ("node_label", "edge_src", "edge_dst", "edge_type", "edge_canon",
                "node2graph", "node_mask", "edge_mask", "y", "graph_mask",
                "target_u", "target_v", "u_feat", "v_feat")


def M_():
    return ranks.rating_matrix(25, 0.4, 3)


def jax_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, igmc_init(jax.random.PRNGKey(seed), JaxIGMCConfig(**CFG)))


def jax_graphs(M, n, **kw):
    (us, vs), labels = ranks.links(M)
    return jax_extract((us[:n], vs[:n]), labels[:n], JaxCSR(sp.csr_matrix(M)), h=1,
                       class_values=ranks.CV, backend="numpy", **kw)


def max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,size", [(10, 1), (10, 3), (17, 4), (64, 8), (5, 8)])
def test_process_shard_indices_equal_jax(n, size):
    """Every rank's shard equals JAX's: ceil(n / size) indices each, the
    permutation wrapped around to pad."""
    for rank in range(size):
        for seed in (0, 7):
            got = multihost.process_shard_indices(n, rank, size, seed)
            np.testing.assert_array_equal(
                got, jmh.process_shard_indices(n, rank, size, seed))
            assert len(got) == -(-n // size)


def test_capacity_ladders_and_subset_equal_jax():
    """capacity_ladders (static) and dynamic_capacity_ladders (dynamic, a
    margin) equal JAX's; Subset remaps indices and exposes counts only
    when the wrapped dataset has them."""
    M = M_()
    (us, vs), labels = ranks.links(M)
    A = sp.csr_matrix(M)
    kw = dict(h=1, class_values=ranks.CV, backend="numpy")
    j_static = JaxStatic(None, A, (us, vs), labels, progress=False, **kw)
    j_dyn = JaxDynamic(None, A, (us, vs), labels, **kw)
    p_static, _ = ranks.datasets(M, len(us), 0)
    p_dyn, _ = ranks.datasets(M, len(us), 0, dynamic=True)
    for b in (4, 8, 50):
        assert multihost.capacity_ladders(p_static, b) == jmh.capacity_ladders(j_static, b)
        for margin in (1.0, 1.3):
            assert (multihost.dynamic_capacity_ladders(p_dyn, b, 16, margin)
                    == jmh.dynamic_capacity_ladders(j_dyn, b, 16, margin))
    # explicit ladders pin every batch's pads (the multi-host recipe)
    nl, el = multihost.capacity_ladders(p_static, 8)
    for batch in BatchLoader(p_static, 8, shuffle=True, prefetch=0, node_ladder=nl,
                             edge_ladder=el):
        assert (batch.num_nodes, batch.num_edges) == (nl[0], el[0])
    with pytest.raises(ValueError, match="both node_ladder and edge_ladder"):
        BatchLoader(p_static, 8, node_ladder=nl)
    idx = multihost.process_shard_indices(len(us), 1, 3)
    sub, jsub = multihost.Subset(p_static, idx), jmh.Subset(j_static, idx)
    np.testing.assert_array_equal(sub.node_counts(), jsub.node_counts())
    np.testing.assert_array_equal(sub.get(2).node_label, jsub.get(2).node_label)
    assert not hasattr(multihost.Subset(p_dyn, idx), "node_counts")
    assert len(sub.get_many(np.arange(3))) == 3


def jax_stacked(graphs, D, per, nl, el):
    return jdp.split_for_devices(graphs, D, per, nl, el)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("short", [False, True])
def test_split_for_devices_equals_jax_per_device(D, short):
    """split_for_devices' sub-batch d equals row d of JAX's stacked batch
    (one shared bucket; a short batch's empty chunks carry zero side-feature
    rows)."""
    M = M_()
    n = 5 if short else 16
    rng = np.random.default_rng(1)
    uf, vf = rng.random((25, 3)).astype(np.float32), rng.random((25, 2)).astype(np.float32)
    (us, vs), labels = ranks.links(M)
    from igmc_torch.graphs import BipartiteCSR, extract_many

    pg = extract_many((us[:n], vs[:n]), labels[:n], BipartiteCSR(sp.csr_matrix(M)),
                      h=1, class_values=ranks.CV, backend="numpy",
                      u_features=uf, v_features=vf)
    jg = jax_graphs(M, n, u_features=uf, v_features=vf)
    per = 16 // D
    nl, el = jax_pad_ladder(200), jax_pad_ladder(2000, base=128)
    want = jax_stacked(jg, D, per, nl, el)
    got = split_for_devices(pg, D, per, nl, el)
    assert len(got) == D
    for d, sub in enumerate(got):
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(sub, f).numpy(),
                                          np.asarray(getattr(want, f))[d], err_msg=f)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("batch_mode", ["flat", "dense"])
def test_dp_loader_yields_the_rank_sub_batch(D, batch_mode):
    """BatchLoader(n_devices=D, rank=r) yields, per global batch, the r-th
    split_for_devices sub-batch (flat, edge ids keyed on the packed
    offsets) or graphs [r * B/D, (r + 1) * B/D) of the whole DenseBatch
    (dense), in the shuffled order of the single-device loader."""
    train, _ = ranks.datasets(M_(), N_TRAIN, 0)
    whole = BatchLoader(train, BATCH, shuffle=True, seed=3, prefetch=0,
                        batch_mode=batch_mode)
    whole_batches = list(whole)
    per = BATCH // D
    for r in range(D):
        part = BatchLoader(train, BATCH, shuffle=True, seed=3, prefetch=0,
                           batch_mode=batch_mode, n_devices=D, rank=r)
        got = list(part)
        assert len(got) == len(whole_batches)
        whole.epoch = 0             # the pass whole_batches came from
        order = whole._order()
        for i, (b, w) in enumerate(zip(got, whole_batches)):
            if batch_mode == "dense":
                want = w.graphs(r * per, (r + 1) * per)
                for f in ("node_label", "edge_src", "edge_dst", "edge_mask", "y",
                          "graph_mask", "edge_id"):
                    np.testing.assert_array_equal(getattr(b, f), getattr(want, f))
            else:
                idxs = order[i * BATCH:(i + 1) * BATCH]
                want = split_for_devices([train.get(int(i)) for i in idxs], D, per, whole.node_ladder,
                                         whole.edge_ladder, gids=idxs,
                                         edge_offsets=train.packed.edge_offsets)[r]
                for f in GRAPH_FIELDS[:-2] + ("edge_id",):
                    np.testing.assert_array_equal(getattr(b, f), getattr(want, f))
    with pytest.raises(ValueError, match="batch_size 8 must divide by n_devices 3"):
        BatchLoader(train, BATCH, n_devices=3)


def test_mesh_refusals_match_jax():
    """The JAX package's refusals under a mesh, in its words (raised before
    any collective): a flat engine other than the segment one, dense_chunk,
    a batch_size that does not divide by the mesh size (dense, dynamic
    dense, flat), and a Predictor whose batch does not."""
    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    M = M_()
    train, test = ranks.datasets(M, 16, 8)
    dtrain, dtest = ranks.datasets(M, 16, 8, dynamic=True)
    model = ranks.model_of(CFG, jax_params(0))
    kw = dict(epochs=1, lr=1e-3, lr_decay_factor=0.1, lr_decay_step_size=50,
              mesh=mesh, device="cpu")
    cases = [
        (dict(batch_size=8, batch_mode="flat", flat_aggregate="blocked"),
         (train, test), "flat_aggregate is a single-device path"),
        (dict(batch_size=8, batch_mode="dense", dense_chunk=4), (train, test),
         r"dense_chunk is single-device \(use EP or dense-DP"),
        (dict(batch_size=7, batch_mode="dense"), (train, test),
         r"dense DP needs batch_size \(7\) divisible by the mesh size \(2\)"),
        (dict(batch_size=7, batch_mode="dense"), (dtrain, dtest),
         r"dynamic dense DP needs batch_size \(7\) divisible by the mesh size \(2\)"),
        (dict(batch_size=7, batch_mode="flat"), (train, test),
         "batch_size 7 must divide by n_devices 2"),
    ]
    for args, (tr, te), msg in cases:
        with pytest.raises(ValueError, match=msg):
            train_multiple_epochs(tr, te, model, **args, **kw)
    with pytest.raises(ValueError, match=r"batch_size \(7\) must divide by the mesh size \(2\)"):
        Predictor(sp.csr_matrix(M), ranks.CV, IGMCConfig(**CFG),
                  params=model.state_dict(), batch_size=7, mesh=mesh)


# ---------------------------------------------------------------------------
# the port as D gloo ranks
# ---------------------------------------------------------------------------

def pairs():
    rng = np.random.default_rng(4)
    return rng.integers(0, 25, 37), rng.integers(0, 25, 37)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"D{d}")
def run(request):
    """Every rank's dp_checks results at world size D, and D."""
    D = request.param
    spec = dict(cfg=CFG, params=jax_params(0), M=M_(), n_step=N_STEP, ARR=ARR,
                n_train=N_TRAIN, n_test=N_TEST, batch=BATCH, train_runs=TRAIN_RUNS,
                pairs=pairs())
    return spawn(ranks.dp_checks, D, "cpu", args=(spec,), timeout=300), D


def jax_fwd(p, b, key=None, training=False):
    return igmc_forward(p, b, JaxIGMCConfig(**CFG), key, training=False)


def check_step(got, loss, grads, params):
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    gw, pw = params_from_jax(grads), params_from_jax(params)
    for k, g in got["grads"].items():
        assert max_rel(g, gw[k].numpy()) < GRAD_TOL, k
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, pw[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_flat_dp_step_matches_jax(run):
    """The flat DP step (eval-mode forward: no dropout; ARR 0.001; Adam lr
    1e-3) on D ranks against JAX's make_dp_train_step on a D-device mesh:
    loss rtol 1e-5, gradients (jax.grad of JAX's DP loss) 1e-4 of the
    largest entry, parameters after the step rtol 5e-4 / atol 5e-6; the
    step issues two all_reduces (the graph count, the gradient bucket)."""
    results, D = run
    graphs = jax_graphs(M_(), N_STEP)
    tn, te = sum(g.num_nodes for g in graphs), sum(g.num_edges for g in graphs)
    stacked = jdp.split_for_devices(graphs, D, N_STEP // D, jax_pad_ladder(tn),
                                    jax_pad_ladder(te, base=128))
    mesh = make_mesh(n_data=D)
    bshd, pshd = batch_sharding(mesh), replicated_sharding(mesh)
    p0 = jax.tree_util.tree_map(jnp.asarray, jax_params(0))
    opt = jax_make_optimizer(1e-3)
    batch = jax.device_put(stacked, bshd)
    key = jax.random.PRNGKey(0)
    loss_fn = jdp._dp_loss_fn(jax_fwd, ARR)
    grads = jax.grad(lambda p: loss_fn(p, batch, key)[0])(p0)
    step = jdp.make_dp_train_step(jax_fwd, opt, ARR, mesh, bshd, pshd)
    params, _, loss, _ = step(jax.device_put(jax.tree_util.tree_map(jnp.copy, p0), pshd),
                              jax.device_put(opt.init(p0), pshd), batch, key)
    for r in results:
        got = r["flat_step"]
        check_step(got, float(loss), jax.tree_util.tree_map(np.asarray, grads),
                   jax.tree_util.tree_map(np.asarray, params))
        assert got["calls"] == {"all_reduce": 2}


def test_dp_scan_step_is_one_step_per_batch(run):
    """make_dp_scan_train_step over two batches equals two make_dp_train_step
    calls: the same sum of loss * n, count and parameters, bit for bit."""
    results, _ = run
    for r in results:
        (t1, c1, p1), (t2, c2, p2) = r["scan_step"]
        assert (t1, c1) == (t2, c2) and c1 == 2 * N_STEP
        for k, v in p1.items():
            np.testing.assert_array_equal(v, p2[k])


def test_dense_dp_step_matches_jax(run):
    """The dense DP row step (each rank its columns of the gid row; no
    dropout; ARR 0.001; Adam lr 1e-3) against JAX's
    make_dense_device_train_step(mesh=) on a D-device mesh: loss rtol 1e-5,
    parameters after the step rtol 5e-4 / atol 5e-6, gradients 1e-4 of the
    largest entry against jax.grad of the same row loss; the step issues ONE
    all_reduce (the row's graph count is read off the row)."""
    from igmc_tpu.batching.device_data import assemble_dense
    from igmc_tpu.models.igmc import arr_regularizer

    results, D = run
    M = M_()
    (us, vs), labels = ranks.links(M)
    jds = JaxStatic(None, sp.csr_matrix(M), (us[:N_TRAIN], vs[:N_TRAIN]),
                    labels[:N_TRAIN], h=1, class_values=ranks.CV, backend="numpy",
                    progress=False)
    bucket = jax_plan_dense(jds.node_counts(), jds.edge_counts() // 2, 1)[0]
    mesh = make_mesh(n_data=D)
    repl = NamedSharding(mesh, PartitionSpec())
    dd = JaxDeviceDataset(jds.packed, 8, 16, BATCH, sharding=repl)
    p0 = jax.tree_util.tree_map(jnp.asarray, jax_params(0))
    opt = jax_make_optimizer(1e-3)
    gids = jnp.arange(BATCH, dtype=jnp.int32)

    def row_loss(p):
        b = assemble_dense(dd, gids, bucket.node_slot, bucket.edge_slot)
        gm = b.graph_mask.astype(jnp.float32)
        return (jnp.sum(((jax_fwd(p, b) - b.y) ** 2) * gm) / jnp.maximum(gm.sum(), 1.0)
                + ARR * arr_regularizer(p))

    grads = jax.tree_util.tree_map(np.asarray, jax.grad(row_loss)(p0))
    step = make_dense_device_train_step(jax_fwd, opt, bucket.node_slot,
                                        bucket.edge_slot, ARR, mesh=mesh)
    params, _, loss_acc, n = step(jax.tree_util.tree_map(jnp.copy, p0), opt.init(p0),
                                  jnp.zeros((), jnp.float32), dd, gids[None],
                                  jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32))
    for r in results:
        got = r["dense_step"]
        assert got["n"] == float(n) == BATCH
        check_step(got, float(loss_acc) / float(n), grads,
                   jax.tree_util.tree_map(np.asarray, params))
        assert got["calls"] == {"all_reduce": 1}


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_dp_step_with_dropout_equals_single_device(run, layout):
    """With edge dropout 0.2 and feature dropout on, each rank taking its
    rows of the whole batch's noise: the DP step's loss (rtol 1e-5), summed
    gradients (1e-4 of the largest entry) and parameters after the Adam step
    (rtol 5e-4 / atol 5e-6) equal the port's single-device step on the whole
    batch with the same noise."""
    results, _ = run
    for r in results:
        got = r[f"dropout_{layout}"]
        np.testing.assert_allclose(got["loss"], got["single_loss"], rtol=LOSS_RTOL)
        for k, g in got["grads"].items():
            assert max_rel(g, got["single_grads"][k]) < GRAD_TOL, k
        for k, v in got["params"].items():
            np.testing.assert_allclose(v, got["single_params"][k], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)


def test_dp_eval_step(run):
    """make_dp_eval_step: the count and the squared-error sum of the whole
    batch (rtol 1e-5) and the gathered predictions equal to the
    single-device forward (atol 1e-5), on every rank."""
    results, _ = run
    for r in results:
        e = r["eval"]
        assert e["cnt"] == BATCH
        np.testing.assert_allclose(e["preds"], e["single_preds"], rtol=0, atol=1e-5)
        train, _ = ranks.datasets(M_(), N_TRAIN, 0)
        y = train.packed.y[:BATCH].astype(np.float32)
        np.testing.assert_allclose(e["sse"], float(((e["single_preds"] - y) ** 2).sum()),
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def single_runs():
    """The single-device train_multiple_epochs run of each layout."""
    out = {}
    for name, kw in TRAIN_RUNS.items():
        tr, te = ranks.datasets(M_(), N_TRAIN, N_TEST, dynamic=kw.get("dynamic", False))
        run_kw = {k: v for k, v in kw.items() if k != "dynamic"}
        rmse, state = train_multiple_epochs(
            tr, te, ranks.model_of(CFG | {"adj_dropout": 0.2}, jax_params(0)), epochs=2,
            batch_size=BATCH, lr=1e-2, lr_decay_factor=0.1, lr_decay_step_size=50,
            ARR=ARR, seed=1, prefetch=0, device="cpu", **run_kw)
        out[name] = dict(rmse=rmse, params=ranks.params_np(state.model))
    return out


@pytest.mark.parametrize("layout", list(TRAIN_RUNS))
def test_train_multiple_epochs_dp_equals_single_device(run, single_runs, layout):
    """train_multiple_epochs(mesh=) for 2 epochs (edge and feature dropout
    on, ARR 0.001, Adam lr 1e-2) on the dense layout device-resident, the
    flat layout host-collated and the dynamic dense layout host-collated:
    the final RMSE equals the single-device run's to 1e-5, and every rank's
    parameters are identical bit for bit."""
    results, _ = run
    want = single_runs[layout]
    r0 = results[0]["train"][layout]
    assert r0["epoch"] == 2
    assert abs(r0["rmse"] - want["rmse"]) < RMSE_TOL, (r0["rmse"], want["rmse"])
    for r in results[1:]:
        got = r["train"][layout]
        assert got["rmse"] == r0["rmse"]
        for k, v in got["params"].items():
            np.testing.assert_array_equal(v, r0["params"][k])


def test_predictor_mesh_equals_predictor(run):
    """Predictor(mesh=) returns every pair's score on every rank, equal to
    the single-device Predictor's to 1e-5."""
    results, _ = run
    M = M_()
    want = Predictor(sp.csr_matrix(M), ranks.CV, IGMCConfig(**CFG),
                     params=ranks.model_of(CFG, jax_params(0)).state_dict(),
                     batch_size=BATCH, backend="numpy", device="cpu").predict(*pairs())
    for r in results:
        assert r["serve"].shape == want.shape
        np.testing.assert_allclose(r["serve"], want, rtol=0, atol=1e-5)
