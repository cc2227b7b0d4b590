"""Giant-batch dense training (dense_chunk) and the F1 repair in igmc_torch
against the JAX package on the CPU: the chunked forward and the chunked
device train step against JAX's with dropout off (tests/test_dense.py
holds JAX's own chunked step to loss rel 1e-5 and parameters atol 5e-5 of
the unchunked one, and so do these), the port's chunked step against its
own unchunked step with dropout on (dense dropout is keyed on packed edge
ids, so the slices drop the same edges as the whole row: JAX assigns
per-slice dropout streams instead), train_multiple_epochs(dense_chunk=)
against JAX's unchunked trajectory with its masks fed in, and
flat_aggregate 'segment' running the dense layout in training and in
test_once, as in JAX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _synthetic_dense_batch
from igmc_tpu.batching.dense import plan_bipartite_buckets as jax_plan_bipartite
from igmc_tpu.batching.dense import plan_dense_buckets as jax_plan_dense
from igmc_tpu.batching.device_data import DeviceDataset as JaxDeviceDataset
from igmc_tpu.batching.device_data import assemble_dense as jax_assemble_dense
from igmc_tpu.models import igmc_forward_dense_chunked as jax_forward_chunked
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import arr_regularizer as jax_arr_regularizer
from igmc_tpu.models.igmc import igmc_forward, igmc_init
from igmc_tpu.train.loop import make_chunked_dense_device_train_step
from igmc_tpu.train.loop import make_optimizer as jax_make_optimizer
from igmc_tpu.train.loop import test_once as jax_test_once
from igmc_tpu.train.loop import train_multiple_epochs as jax_train_multiple_epochs

from igmc_torch.batching import DenseBatch, DeviceDataset, assemble_dense
from igmc_torch.models import (IGMC, IGMCConfig, chunk_dense_batch, draw_noise,
                               igmc_forward_dense_chunked)
from igmc_torch.train import (make_dense_row_step, make_optimizer, params_from_jax,
                              plan_buckets)
from igmc_torch.train import test_once as port_test_once
from igmc_torch.train import train_multiple_epochs

from test_torch_port_dense_train import (BATCH, SUPERBATCH, data, jax_cfg,  # noqa: F401
                                         jax_fwd, jax_step_noise, port_model,
                                         run_port, to_numpy)

torch.set_num_threads(1)

LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5
GRAD_RTOL = 1e-5      # and atol GRAD_RTOL of the gradient's largest entry


def t(a):
    return torch.from_numpy(np.array(a))


def grads_of(model):
    """The model's parameter gradients, by state_dict name. Both dense
    steps zero them at their start, so after a step they are that step's."""
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def assert_grads_close(got, want):
    """Every gradient within GRAD_RTOL, and atol GRAD_RTOL of its largest
    entry: a loss scaled wrongly before the backward (Adam's step hides it
    from the parameters) fails here."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(w.abs().max()), msg=k)


def synthetic_port_batch(num_graphs):
    jb = _synthetic_dense_batch(num_graphs=num_graphs, node_slot=16, edge_slot=32,
                                num_relations=5)
    batch = DenseBatch(node_label=t(jb.node_label), edge_src=t(jb.edge_src),
                       edge_dst=t(jb.edge_dst), edge_type=t(jb.edge_type),
                       node_mask=t(jb.node_mask), edge_mask=t(jb.edge_mask),
                       y=t(jb.y), graph_mask=t(jb.graph_mask),
                       edge_id=torch.arange(num_graphs * 32).reshape(num_graphs, 32))
    return jb, batch


@pytest.mark.parametrize("chunk", [12, 48])
def test_chunked_forward_matches_jax_and_the_whole_batch(chunk):
    """igmc_forward_dense_chunked: against JAX's with dropout off (atol
    1e-4 through four layers), and equal to the port's one forward over
    the whole batch in eval mode and, with the same hash-dropout noise, in
    training mode."""
    jb, batch = synthetic_port_batch(48)
    jcfg = JaxIGMCConfig(num_relations=5, num_bases=4, adj_dropout=0.0)
    params = igmc_init(jax.random.PRNGKey(0), jcfg)
    model = IGMC(IGMCConfig(num_relations=5), torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(to_numpy(params)))
    want = np.asarray(jax_forward_chunked(params, jb, jcfg, chunk))
    with torch.no_grad():
        got = igmc_forward_dense_chunked(model.eval(), batch, chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
        torch.testing.assert_close(got, model(batch), rtol=1e-6, atol=1e-6)
        noise = draw_noise(torch.Generator().manual_seed(1), 48)
        model.train()
        torch.testing.assert_close(igmc_forward_dense_chunked(model, batch, chunk, noise),
                                   model(batch, noise), rtol=1e-6, atol=1e-6)


def test_chunk_must_divide_the_batch():
    _, batch = synthetic_port_batch(48)
    assert [b.num_graphs for b in chunk_dense_batch(batch, 16)] == [16, 16, 16]
    with pytest.raises(ValueError, match="num_graphs 48 % chunk 13"):
        chunk_dense_batch(batch, 13)


def jax_det_fwd(cfg):
    """A deterministic JAX forward (the training flag ignored), as
    tests/test_dense.py's chunked-step test uses."""
    return lambda p, b, key=None, training=False: igmc_forward(p, b, cfg, None, False)


@pytest.mark.parametrize("layout", ["unified", "bipartite"])
def test_chunked_device_step_matches_jax(data, layout):
    """make_chunked_dense_train_step against JAX's
    make_chunked_dense_device_train_step on one [3, 16] gid block (a
    half-full row, a full row, an all-(-1) row JAX steps over), chunk 4,
    dropout off (the port's model in eval mode): the same loss sum and
    count, parameters within atol 5e-5, and the first row's gradients
    those of jax.grad of JAX's row loss (GRAD_RTOL); the port's unchunked
    step agrees too."""
    jds, pds = data["train"]
    B, chunk = 16, 4
    jplan = jax_plan_bipartite if layout == "bipartite" else jax_plan_dense
    if layout == "bipartite":
        nu = jds.packed.num_u
        jb = jplan(nu, jds.node_counts() - nu, jds.edge_counts() // 2, max_buckets=1)[0]
    else:
        jb = jplan(jds.node_counts(), jds.edge_counts() // 2, max_buckets=1)[0]
    pb = plan_buckets(pds, layout, max_buckets=1)[0]
    assert (jb.node_slot, jb.edge_slot, jb.num_u_slot) == (
        pb.node_slot, pb.edge_slot, pb.num_u_slot)
    blk = np.full((3, B), -1, np.int32)
    blk[0, :B - 5] = np.arange(B - 5)
    blk[1] = np.arange(B, 2 * B)
    cfg = jax_cfg()
    jdd = JaxDeviceDataset(jds.packed, 8, 16, B)

    def row_loss(params):
        batch = jax_assemble_dense(jdd, jnp.asarray(blk[0]), jb.node_slot,
                                   jb.edge_slot, jb.num_u_slot)
        preds = igmc_forward(params, batch, cfg, None, False)
        gmask = batch.graph_mask.astype(jnp.float32)
        sse = jnp.sum(((preds - batch.y) ** 2) * gmask)
        return sse / jnp.maximum(gmask.sum(), 1.0) + 0.001 * jax_arr_regularizer(params)

    opt = jax_make_optimizer(1e-2)
    jstep = make_chunked_dense_device_train_step(
        jax_det_fwd(cfg), opt, jb.node_slot, jb.edge_slot, chunk, ARR=0.001,
        num_u_slot=jb.num_u_slot)
    p0 = to_numpy(igmc_init(jax.random.PRNGKey(3), cfg))
    want_grads = params_from_jax(to_numpy(
        jax.grad(row_loss)(jax.tree_util.tree_map(jnp.array, p0))))
    pj = jax.tree_util.tree_map(jnp.array, p0)   # the step donates its inputs
    p, _, loss_sum, n = jstep(pj, opt.init(pj), np.zeros((), np.float32), jdd,
                              jnp.asarray(blk), jax.random.PRNGKey(4), jnp.int32(0))
    want = params_from_jax(to_numpy(p))

    dd = DeviceDataset(pds.packed, "cpu")
    assemble = lambda gids: assemble_dense(dd, gids, pb.node_slot, pb.edge_slot,
                                           pb.num_u_slot)
    keep = torch.ones(B, 128, dtype=torch.bool)    # unused in eval mode
    for c in (chunk, 0):
        model = port_model(p0).eval()
        step = make_dense_row_step(model, make_optimizer(model.parameters(), 1e-2),
                                   c, 0.001)
        total, count = 0.0, 0.0
        for i, row in enumerate(torch.from_numpy(blk[:2].astype(np.int64))):
            loss, nn = step(assemble, row, (7, keep))
            total, count = total + float(loss * nn), count + float(nn)
            if i == 0:
                assert_grads_close(grads_of(model), want_grads)
        assert count == float(n) == (B - 5) + B
        assert total == pytest.approx(float(loss_sum), rel=LOSS_RTOL)
        for name, v in model.state_dict().items():
            torch.testing.assert_close(v, want[name], rtol=0, atol=PARAM_ATOL, msg=name)


@pytest.mark.parametrize("force_undirected", [False, True])
def test_chunked_step_equals_unchunked_with_dropout(data, force_undirected):
    """With hash edge dropout and feature dropout on, two chunked steps
    (chunk 5 of 20) equal two whole-row steps from the same weights and
    noise: loss rel 1e-5, each step's gradients GRAD_RTOL, parameters atol
    5e-5."""
    pds = data["train"][1]
    b = plan_buckets(pds, "bipartite")[-1]
    dd = DeviceDataset(pds.packed, "cpu")
    assemble = lambda gids: assemble_dense(dd, gids, b.node_slot, b.edge_slot,
                                           b.num_u_slot)
    rows = torch.from_numpy(np.resize(b.indices, (2, 20)).astype(np.int64))
    noise_gen = torch.Generator().manual_seed(8)
    noises = [draw_noise(noise_gen, 20) for _ in rows]
    out = {}
    for chunk in (5, 0):
        model = IGMC(IGMCConfig(force_undirected=force_undirected),
                     torch.Generator().manual_seed(2)).train()
        step = make_dense_row_step(model, make_optimizer(model.parameters(), 1e-2),
                                   chunk, 0.001)
        losses, grads = [], []
        for r, nz in zip(rows, noises):
            losses.append(step(assemble, r, nz)[0].item())
            grads.append(grads_of(model))
        out[chunk] = (losses, model.state_dict(), grads)
    np.testing.assert_allclose(out[5][0], out[0][0], rtol=LOSS_RTOL)
    for got, want in zip(out[5][2], out[0][2]):
        assert_grads_close(got, want)
    for name, v in out[5][1].items():
        torch.testing.assert_close(v, out[0][1][name], rtol=0, atol=PARAM_ATOL, msg=name)


@pytest.mark.parametrize("layout", ["unified", "bipartite"])
def test_dense_chunk_training_matches_jax_unchunked(data, monkeypatch, layout):
    """train_multiple_epochs(dense_chunk=5) over batches of 20, fed JAX's
    masks of its UNCHUNKED dense run: the same per-epoch loss and RMSE
    (rel 1e-4, as the unchunked port is held) and final parameters (atol
    2e-5) as JAX's unchunked run. Evaluation in rows of 5 gives the same
    RMSE as rows of 20."""
    params = igmc_init(jax.random.PRNGKey(7), jax_cfg())
    want_infos = []
    _, want_state = jax_train_multiple_epochs(
        data["train"][0], data["test"][0], jax_fwd,
        jax.tree_util.tree_map(jnp.array, params), epochs=2, batch_size=BATCH,
        lr=1e-3, lr_decay_factor=0.1, lr_decay_step_size=1, ARR=0.001, seed=1,
        progress=False, superbatch=SUPERBATCH, batch_mode="dense",
        dense_layout=layout, logger=lambda info, state: want_infos.append(dict(info)))
    noise = jax_step_noise(data, layout, 1, (1, 2))
    _, state, got_infos = run_port(data, monkeypatch, params, noise, layout,
                                   dense_chunk=5)
    for g, w in zip(got_infos, want_infos):
        for k in ("train_loss", "test_rmse"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    want_params = params_from_jax(to_numpy(want_state.params))
    for name, p in state.model.state_dict().items():
        torch.testing.assert_close(p, want_params[name], rtol=0, atol=2e-5, msg=name)


def test_dense_chunk_rules(data):
    """JAX's rules: a chunk >= batch_size means no chunking (the same run,
    bit for bit); one that does not divide batch_size raises; dense_chunk
    off the dense layout raises."""
    pds_train, pds_test = data["train"][1], data["test"][1]
    kw = dict(epochs=1, batch_size=BATCH, lr=1e-3, lr_decay_factor=0.1,
              lr_decay_step_size=50, ARR=0.001, seed=3, batch_mode="dense",
              dense_layout="unified", device="cpu")
    model = IGMC(IGMCConfig(), torch.Generator().manual_seed(1))
    runs = [train_multiple_epochs(pds_train, pds_test, model, dense_chunk=c, **kw)
            for c in (0, BATCH, 2 * BATCH)]
    for rmse, state in runs[1:]:
        assert rmse == runs[0][0]
        for name, v in state.model.state_dict().items():
            assert torch.equal(v, runs[0][1].model.state_dict()[name]), name
    with pytest.raises(ValueError, match=r"dense_chunk \(7\) must divide batch_size \(20\)"):
        train_multiple_epochs(pds_train, pds_test, model, dense_chunk=7, **kw)
    with pytest.raises(ValueError, match="dense_chunk needs batch_mode='dense'"):
        train_multiple_epochs(pds_train, pds_test, model, dense_chunk=5,
                              **dict(kw, batch_mode="flat", dense_layout="unified"))


@pytest.mark.parametrize("layout", ["unified", "bipartite"])
def test_segment_trains_dense_like_jax(data, monkeypatch, layout):
    """F1: train_multiple_epochs(batch_mode='dense', flat_aggregate=
    'segment') trains on the dense layout, as JAX's does: the same
    trajectory as JAX's run with the same arguments (its masks fed in)."""
    params = igmc_init(jax.random.PRNGKey(9), jax_cfg())
    want_infos = []
    jax_train_multiple_epochs(
        data["train"][0], data["test"][0], jax_fwd,
        jax.tree_util.tree_map(jnp.array, params), epochs=2, batch_size=BATCH,
        lr=1e-3, lr_decay_factor=0.1, lr_decay_step_size=1, ARR=0.001, seed=1,
        progress=False, superbatch=SUPERBATCH, batch_mode="dense",
        flat_aggregate="segment", dense_layout=layout,
        logger=lambda info, state: want_infos.append(dict(info)))
    noise = jax_step_noise(data, layout, 1, (1, 2))
    _, _, got_infos = run_port(data, monkeypatch, params, noise, layout,
                               flat_aggregate="segment")
    assert len(got_infos) == len(want_infos) == 2
    for g, w in zip(got_infos, want_infos):
        for k in ("train_loss", "test_rmse"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("kw", [{"flat_aggregate": "segment"},
                                {"flat_aggregate": "auto"},
                                {"dense_chunk": 7}])
@pytest.mark.parametrize("layout", ["unified", "bipartite"])
def test_test_once_options_match_jax(data, capsys, layout, kw):
    """test_once on the dense layout with flat_aggregate 'segment' or
    'auto' (F1: no flat engine, so dense, as in JAX) or with dense_chunk
    (rows of 7 graphs): the RMSE of JAX's test_once with the same
    arguments, within 1e-5 relative, and no switch to the flat path."""
    params = igmc_init(jax.random.PRNGKey(5), jax_cfg())
    jds, pds = data["test"]
    want = jax_test_once(jds, jax_fwd, params, BATCH, params=params,
                         batch_mode="dense", dense_layout=layout, **kw)
    capsys.readouterr()
    got = port_test_once(pds, port_model(params), BATCH, device="cpu",
                         batch_mode="dense", dense_layout=layout, **kw)
    assert "using the flat path" not in capsys.readouterr().out
    np.testing.assert_allclose(got, want, rtol=1e-5)
