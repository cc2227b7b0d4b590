"""igmc_torch's fused aggregate at every shape the JAX package's Pallas
kernels take, on the CPU: more than 8 bases, widths past 32, output chunks
of 64 and 128 rows and blocks of any size (not a multiple of 4 included).

The port's plain K1 / K2 (what the wrappers run on CPU tensors) against
rgcn_aggregate_pallas / rgcn_aggregate_pallas_train (Pallas in interpret
mode), the CUDA wrappers' pre-launch checks accepting those shapes, the
loader's plan geometry (BatchLoader plan_rows / plan_eblk) against JAX's
plans, and the whole IGMC with num_bases 16 and pallas_rows 128 against
JAX's igmc_forward(use_pallas=True). The CUDA kernels at these shapes are
tested in test_torch_port_cuda.py on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from igmc_tpu.batching.dataset import BatchLoader as JaxBatchLoader
from igmc_tpu.batching.dataset import StaticGraphDataset as JaxStaticGraphDataset
from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
from igmc_tpu.data.synthetic import write_ml1m_format
from igmc_tpu.kernels.rgcn_aggregate import (
    block_align_edges as jax_block_align_edges,
    block_align_edges_transposed as jax_block_align_edges_transposed,
    rgcn_aggregate_pallas, rgcn_aggregate_pallas_train,
)
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import igmc_forward, igmc_init
from igmc_tpu.train.loop import _make_loss_fn

from igmc_torch.batching import BatchLoader, StaticGraphDataset
from igmc_torch.data import create_trainvaltest_split
from igmc_torch.kernels.rgcn_aggregate import (
    _check_cuda_inputs, block_align_edges, block_align_edges_transposed,
    rgcn_aggregate,
)
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.train import loss_fn, params_from_jax
from torch_plan_checks import assert_blocked_plans_equal, assert_plan_matches_jax

torch.set_num_threads(1)

# name: (N, E, R, B, Cin, Cout, rows, eblk, hot row). chip_smoke phase 24's
# shapes cut to N 512 and E 3,000 (R kept), and an eblk that is not a
# multiple of 4 with a row whose edges span several blocks
SHAPES = {
    "b16_r71": (512, 3000, 71, 16, 32, 32, 256, 1024, False),
    "cin48_cout64": (512, 3000, 5, 4, 48, 64, 256, 1024, False),
    "cin6_cout256": (512, 3000, 10, 1, 6, 256, 256, 1024, False),
    "cin200_cout40_b12": (512, 3000, 5, 12, 200, 40, 256, 1024, False),
    "eblk1000_rows128": (512, 3000, 5, 4, 32, 32, 128, 1000, False),
    "eblk250_rows64_hot": (512, 3000, 5, 4, 32, 32, 64, 250, True),
}
TOL = 1e-5   # rtol, and atol as a share of the largest entry: float32 sums
             # in another order


def make_case(name, seed=0):
    """Edges (with pair ids for the dropout keys) and operands of shape
    `name`: x in (-1, 1), weights at their init scale, an output
    gradient in (-1, 1)."""
    N, E, R, B, cin, cout, rows, eblk, hot = SHAPES[name]
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    if hot:
        dst[: E // 2] = 7
    etyp = rng.integers(0, R, E).astype(np.int32)
    mask = rng.random(E) < 0.9
    canon = rng.integers(0, E, E).astype(np.int32)
    bound = (B * cin) ** -0.5
    x = rng.uniform(-1, 1, (N, cin)).astype(np.float32)
    att = rng.uniform(-bound, bound, (R, B)).astype(np.float32)
    basis = rng.uniform(-bound, bound, (B, cin, cout)).astype(np.float32)
    g = rng.uniform(-1, 1, (N, cout)).astype(np.float32)
    return (src, dst, etyp, mask, canon), (x, att, basis, g)


def plans(fwd, twin, edges, N, rows, eblk):
    """Both plans of `edges` by the aligners `fwd` / `twin`, sized alike."""
    src, dst, etyp, mask, canon = edges
    need = max(fwd(src, dst, etyp, mask, N, eblk=eblk, rows=rows)[6],
               twin(src, dst, etyp, mask, N, eblk=eblk, rows=rows)[6])
    kw = dict(eblk=eblk, rows=rows, num_blocks=need, edge_canon=canon)
    return (fwd(src, dst, etyp, mask, N, **kw)[:6],
            twin(src, dst, etyp, mask, N, **kw)[:6])


def close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_kernels_match_jax_pallas(name):
    """The port's aggregate on CPU tensors (the plain K1, and K2 through
    its autograd Function) against the Pallas kernels in interpret mode,
    each over its own package's plans of the same edges: the output, and
    the gradients of sum(out * g) in x, att and basis."""
    N, _, _, _, _, _, rows, eblk, _ = SHAPES[name]
    edges, (x, att, basis, g) = make_case(name)
    jaf, jat = plans(jax_block_align_edges, jax_block_align_edges_transposed,
                     edges, N, rows, eblk)
    paf, pat = plans(block_align_edges, block_align_edges_transposed, edges, N,
                     rows, eblk)
    jaf, jat = (tuple(jnp.asarray(a) for a in p) for p in (jaf, jat))
    want = rgcn_aggregate_pallas(jnp.asarray(x), jnp.asarray(att),
                                 jnp.asarray(basis), jaf, rows, N, True)

    def jax_loss(x, att, basis):
        out = rgcn_aggregate_pallas_train(x, att, basis, jaf, jat, rows, N, True)
        return jnp.sum(out * g)

    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(att), jnp.asarray(basis))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, att, basis)]
    out = rgcn_aggregate(*ts, tuple(map(torch.from_numpy, paf)), rows, N,
                         tuple(map(torch.from_numpy, pat)))
    close(out.detach().numpy(), want, "out")
    (out * torch.from_numpy(g)).sum().backward()
    for t, w, what in zip(ts, want_grads, ("dx", "datt", "dbasis")):
        close(t.grad.numpy(), w, what)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_checks_accept_every_jax_shape(name):
    """The CUDA wrappers' pre-launch checks (device, dtype, contiguity and
    plan shapes; they need no card) take each shape with a gradient
    wanted: no width, base or block-size limit is left."""
    N, _, _, _, _, _, rows, eblk, _ = SHAPES[name]
    edges, (x, att, basis, _) = make_case(name)
    paf, pat = plans(block_align_edges, block_align_edges_transposed, edges, N,
                     rows, eblk)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, att, basis)]
    _check_cuda_inputs(*ts, tuple(map(torch.from_numpy, paf)), rows, N,
                       tuple(map(torch.from_numpy, pat)))


BATCH = 50
HIDDEN = 128


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(JAX, port) training datasets of 100 pairs of a 300 x 400,
    8,000-rating ml_1m fixture (h 1, at most 100 nodes per hop)."""
    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=300, n_movies=400, n_ratings=8000,
                      seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        ws = jax_split("ml_1m", seed=1234, testing=True, verbose=False)
        gs = create_trainvaltest_split("ml_1m", seed=1234, testing=True,
                                       verbose=False)
    links = (ws.train_u_indices, ws.train_v_indices)
    kw = dict(h=1, max_nodes_per_hop=100, max_num=100, backend="numpy")
    return (JaxStaticGraphDataset(None, ws.adj_train, links, ws.train_labels,
                                  class_values=ws.class_values, progress=False,
                                  **kw),
            StaticGraphDataset(gs.adj_train, links, ws.train_labels,
                               class_values=gs.class_values, **kw))


def first_batches(data, engine, rows, eblk, seed=3):
    want_ds, got_ds = data
    want = next(iter(JaxBatchLoader(want_ds, BATCH, shuffle=True, seed=seed,
                                    device_put=False, prefetch=0,
                                    flat_aggregate=engine, plan_rows=rows,
                                    plan_eblk=eblk)))
    got = next(iter(BatchLoader(got_ds, BATCH, shuffle=True, seed=seed,
                                prefetch=0, flat_aggregate=engine, plan_rows=rows,
                                plan_eblk=eblk)))
    return want, got


@pytest.mark.parametrize("rows,eblk", [(64, 256), (64, 1000), (128, 1001)])
@pytest.mark.parametrize("engine", ["pallas", "blocked"])
def test_loader_plan_geometry_matches_jax(data, engine, rows, eblk):
    """BatchLoader(plan_rows=, plan_eblk=) plans as JAX's loader does with
    the same arguments: the pallas engine's two plans (with their ukey
    streams) and the node pad rounded to `rows`, the blocked engine's
    plans field by field; the batch carries the pallas plans' rows."""
    want, got = first_batches(data, engine, rows, eblk)
    assert got.num_nodes == want.num_nodes and got.num_edges == want.num_edges
    np.testing.assert_array_equal(got.edge_src.numpy(), np.asarray(want.edge_src))
    if engine == "blocked":
        assert got.aligned is None and got.plan_rows is None
        assert_blocked_plans_equal(want.blocked, got.blocked)
        return
    assert got.num_nodes % rows == 0 and got.plan_rows == rows
    for g, w in ((got.aligned, want.aligned), (got.aligned_t, want.aligned_t)):
        assert g[0].shape[0] == g[4].shape[0] * eblk
        assert_plan_matches_jax(tuple(a.numpy() for a in g),
                                tuple(np.asarray(a) for a in w))


def jax_noise(key):
    """The noise igmc_forward draws from `key` in training mode, as the
    port's (edge_seed, feature_keep)."""
    key, k_edge = jax.random.split(key)
    seed = jax.random.randint(k_edge, (), 0, jnp.iinfo(jnp.int32).max)
    _, k_drop = jax.random.split(key)
    keep = jax.random.bernoulli(k_drop, 0.5, (BATCH, HIDDEN))
    return int(seed), torch.from_numpy(np.array(keep))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("latent", [(32, 32, 32, 32), (64, 64, 64, 64)])
def test_igmc_many_bases_matches_jax_pallas(data, latent):
    """IGMC with num_bases 16 and pallas_rows 128 over plans of 128 rows and
    blocks of 256 slots, against igmc_forward(use_pallas=True) with the
    same weights (params_from_jax), batch and noise: evaluation and
    training predictions to atol 1e-4, the loss (ARR 0.001) to rtol 1e-5,
    every gradient to rtol 1e-4 / atol 1e-4 of its largest entry (float32
    through four layers in other summation orders); a config whose
    pallas_rows differs from the batch's plan raises, naming both."""
    rows, eblk = 128, 256
    want_batch, got_batch = first_batches(data, "pallas", rows, eblk)
    kw = dict(num_features=4, latent_dim=latent, num_relations=5, num_bases=16,
              flat_aggregate="pallas")
    jcfg = JaxIGMCConfig(use_pallas=True, pallas_interpret=True, pallas_rows=rows,
                         **kw)
    params = igmc_init(jax.random.PRNGKey(5), jcfg)
    model = IGMC(IGMCConfig(pallas_rows=rows, **kw), torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(to_numpy(params)))
    want = np.asarray(igmc_forward(params, want_batch, jcfg, None, False))
    with torch.no_grad():
        got = model.eval()(got_batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

    key = jax.random.PRNGKey(11)
    fwd = lambda p, b, key=None, training=False: igmc_forward(p, b, jcfg, key, training)
    (want_loss, _), grads = jax.value_and_grad(
        _make_loss_fn(fwd, 0.001, True), has_aux=True)(params, want_batch, key)
    want_t = np.asarray(igmc_forward(params, want_batch, jcfg, key, True))
    model.train()
    noise = jax_noise(key)
    with torch.no_grad():
        np.testing.assert_allclose(model(got_batch, noise).numpy(), want_t,
                                   rtol=0, atol=1e-4)
    loss, _ = loss_fn(model, got_batch, noise, 0.001)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_grads = params_from_jax(to_numpy(grads))
    for name, p in model.named_parameters():
        w = want_grads[name]
        torch.testing.assert_close(p.grad, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()) + 1e-12,
                                   msg=name)

    other = IGMC(IGMCConfig(**kw), torch.Generator().manual_seed(0)).eval()
    with pytest.raises(ValueError, match="pallas_rows 256 != the batch's plan rows 128"):
        other(got_batch)
