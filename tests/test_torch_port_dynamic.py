"""igmc_torch on dynamic datasets against the JAX package on the CPU:
DynamicGraphDataset's graphs (JAX's, and the port's static dataset's),
BatchLoader's sampled ladders and their overflow extension, host-collated
dense batches (every array), prefetch against serial production, one
host-collated dense training step and one flat fused-aggregate step (JAX's
masks injected; the flat hash bit for bit), host-collated edge ids against
device-assembled ones, training and evaluation on dynamic data, the
profiler trace, and the port CLI with --dynamic-dataset against the JAX
CLI (RMSE band, layout exits)."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from igmc_tpu.batching.dataset import BatchLoader as JaxBatchLoader
from igmc_tpu.batching.dataset import DynamicGraphDataset as JaxDynamicGraphDataset
from igmc_tpu.cli.main import main as jax_main
from igmc_tpu.data.splits import create_trainvaltest_split as jax_split
from igmc_tpu.data.synthetic import write_ml1m_format
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import igmc_init
from igmc_tpu.models.igmc import igmc_forward
from igmc_tpu.ops.dropout import edge_dropout_dense as jax_edge_dropout_dense
from igmc_tpu.train.loop import _make_loss_fn

from igmc_torch.batching import (BatchLoader, DeviceDataset, DynamicGraphDataset,
                                 StaticGraphDataset, assemble_dense)
from igmc_torch.batching.dense import DYNAMIC_EDGE_STRIDE
from igmc_torch.cli.main import main as port_main
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.ops import edge_dropout_dense, hash_edge_keep
from igmc_torch.train import loss_fn, params_from_jax, save_pth, train_multiple_epochs
from igmc_torch.train import test_once as port_test_once

torch.set_num_threads(1)

N_PAIRS = 120
BATCH = 25
HIDDEN = 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("src", "dst", "etype", "node_label", "num_u", "num_v", "y", "u_feat",
          "v_feat")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The JAX package's testing split of a 150 x 120, 10,000-rating ml_1m
    fixture with side features."""
    root = tmp_path_factory.mktemp("raw")
    write_ml1m_format(str(root), n_users=150, n_movies=120, n_ratings=10000, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IGMC_RAW_DATA", str(root))
        return jax_split("ml_1m", seed=1234, testing=True, verbose=False)


def make(split, cls, part="train", n=N_PAIRS, mnph=100, features=False, **kw):
    """A dataset of the split's `part` links: `cls` is a port class, or
    JaxDynamicGraphDataset."""
    links = (getattr(split, f"{part}_u_indices"), getattr(split, f"{part}_v_indices"))
    common = dict(h=1, max_nodes_per_hop=mnph, class_values=split.class_values,
                  max_num=n, **kw)
    if features:
        common.update(u_features=split.u_features, v_features=split.v_features)
    if cls is JaxDynamicGraphDataset:
        return cls(None, split.adj_train, links, getattr(split, f"{part}_labels"),
                   **common)
    return cls(split.adj_train, links, getattr(split, f"{part}_labels"), **common)


def same_graph(got, want, what):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None or np.isscalar(w):
            assert g == w, (what, f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


@pytest.mark.parametrize("mnph,ratio", [(100, 1.0), (6, 0.7)])
def test_dynamic_graphs_match_jax_and_the_static_dataset(split, mnph, ratio):
    """NumPy engine: get(i) equals JAX's DynamicGraphDataset.get(i) and the
    port's StaticGraphDataset.get(i) in every field, and get_many of a
    shuffled subset equals get of each index, with subsampling binding
    (at most 6 nodes per hop, sample ratio 0.7) or not."""
    kw = dict(mnph=mnph, sample_ratio=ratio, backend="numpy", features=True, seed=3)
    got = make(split, DynamicGraphDataset, **kw)
    want = make(split, JaxDynamicGraphDataset, **kw)
    static = make(split, StaticGraphDataset, **kw)
    assert len(got) == len(want) == len(static) == N_PAIRS
    for i in range(N_PAIRS):
        g = got.get(i)
        same_graph(g, want.get(i), f"jax {i}")
        same_graph(g, static.get(i), f"static {i}")
    idxs = np.random.RandomState(0).permutation(N_PAIRS)[:40]
    for i, g in zip(idxs, got.get_many(idxs)):
        same_graph(g, got.get(int(i)), f"get_many {i}")


def test_native_engine_get_matches_get_many_and_static(split):
    """The C++ engine with subsampling binding: get(i), get_many and the
    static dataset's graph i agree (streams keyed by the dataset index)."""
    kw = dict(mnph=6, sample_ratio=0.7, backend="native", seed=5)
    got = make(split, DynamicGraphDataset, **kw)
    static = make(split, StaticGraphDataset, **kw)
    assert got.backend == "native"
    idxs = np.arange(N_PAIRS)[::-1]
    for i, g in zip(idxs, got.get_many(idxs)):
        same_graph(g, got.get(int(i)), f"get {i}")
        same_graph(g, static.get(int(i)), f"static {i}")


def jax_loader(ds, mode, **kw):
    return JaxBatchLoader(ds, BATCH, device_put=False, prefetch=0, batch_mode=mode,
                          flat_aggregate="pallas" if mode == "flat" else None, **kw)


@pytest.mark.parametrize("mode", ["flat", "dense"])
def test_sampled_ladders_and_overflow_extension_match_jax(split, mode, caplog):
    """Ladders estimated from 64 sampled graphs equal JAX's; from ladders
    cut to their first rung, one batch extends them as JAX's loader does
    (same sizes, same overflow count, same batch shape) and logs it."""
    got = BatchLoader(make(split, DynamicGraphDataset, backend="numpy"), BATCH,
                      batch_mode=mode, prefetch=0,
                      flat_aggregate="pallas" if mode == "flat" else None)
    want = jax_loader(make(split, JaxDynamicGraphDataset, backend="numpy"), mode)
    assert (got.node_ladder, got.edge_ladder) == (want.node_ladder, want.edge_ladder)
    for loader in (got, want):
        loader.node_ladder, loader.edge_ladder = loader.node_ladder[:1], loader.edge_ladder[:1]
    idxs = np.arange(BATCH)
    with caplog.at_level("WARNING", logger="igmc_torch.batching"):
        gb = got.make_batch(idxs)
    wb = want._make_batch(idxs)
    assert (got.node_ladder, got.edge_ladder) == (want.node_ladder, want.edge_ladder)
    assert len(got.node_ladder) > 1 and len(got.edge_ladder) > 1
    assert got.ladder_overflows == want.ladder_overflows == 2
    assert "ladder overflow #2" in caplog.text
    shape = lambda b: tuple(np.shape(getattr(b, f)) for f in ("node_label", "edge_src"))
    assert shape(gb) == shape(wb)


@pytest.mark.parametrize("features", [False, True])
def test_dense_host_batches_match_jax(split, features):
    """A shuffled epoch of host-collated dense batches of a dynamic
    dataset: every array of every batch equals JAX's _make_batch_dense's,
    in the same order (JAX without superbatches)."""
    got = BatchLoader(make(split, DynamicGraphDataset, backend="numpy",
                           features=features), BATCH, shuffle=True, seed=4,
                      batch_mode="dense")
    want = jax_loader(make(split, JaxDynamicGraphDataset, backend="numpy",
                           features=features), "dense", shuffle=True, seed=4)
    got.epoch = want.epoch = 2
    n = 0
    for gb, wb in zip(got, want):
        n += 1
        for f in ("node_label", "edge_src", "edge_dst", "edge_type", "node_mask",
                  "edge_mask", "y", "graph_mask", "u_feat", "v_feat"):
            g, w = getattr(gb, f), getattr(wb, f)
            if w is None:
                assert g is None, f
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
        assert gb.num_u is None and gb.edge_id.dtype == torch.int64
    assert n == len(got) == N_PAIRS // BATCH + 1


def tensors(batch):
    out = {}
    for name, v in vars(batch).items():
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif isinstance(v, tuple):
            out.update({f"{name}{i}": a for i, a in enumerate(v)})
    return out


@pytest.mark.parametrize("mode", ["flat", "dense"])
def test_prefetch_gives_the_serial_batches(split, mode):
    """prefetch=2 (threads) and prefetch=0 give the same batches in the same
    order, plans and edge ids included, over two shuffled epochs whose
    ladders start at their first rung (so batches extend them on the
    threads)."""
    ds = make(split, DynamicGraphDataset, backend="native", mnph=6, sample_ratio=0.7)
    out = []
    for prefetch in (2, 0):
        loader = BatchLoader(ds, BATCH, shuffle=True, seed=2, batch_mode=mode,
                             prefetch=prefetch,
                             flat_aggregate="pallas" if mode == "flat" else None)
        loader.node_ladder = loader.node_ladder[:1]
        loader.edge_ladder = loader.edge_ladder[:1]
        out.append([tensors(b) for _ in range(2) for b in loader])
    assert len(out[0]) == len(out[1]) == 2 * (N_PAIRS // BATCH + 1)
    for a, b in zip(*out):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    if mode == "flat":
        assert "aligned_t0" in out[0][0]


def jax_cfg(**kw):
    return JaxIGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                         num_relations=5, num_bases=4, **kw)


def port_model(params, **kw):
    model = IGMC(IGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                            num_relations=5, num_bases=4, **kw),
                 torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def grads_close(model, grads):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    got = dict(model.named_parameters())
    assert list(got) == list(want)
    for name, w in want.items():
        torch.testing.assert_close(got[name].grad, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()) + 1e-12, msg=name)


def test_host_collated_dense_step_matches_jax(split):
    """The first host-collated dense batch of a shuffled dynamic epoch,
    training mode with JAX's edge and feature masks injected: loss to rtol
    1e-5 and every gradient to rtol 1e-4 / atol 1e-4 of its largest entry
    against jax.value_and_grad of JAX's loss (MSE + ARR 0.001)."""
    got_b = next(iter(BatchLoader(make(split, DynamicGraphDataset, backend="numpy"),
                                  BATCH, shuffle=True, seed=6, batch_mode="dense")))
    want_b = next(iter(jax_loader(make(split, JaxDynamicGraphDataset, backend="numpy"),
                                  "dense", shuffle=True, seed=6)))
    params = igmc_init(jax.random.PRNGKey(2), jax_cfg())
    key = jax.random.PRNGKey(13)
    fwd = lambda p, b, key=None, training=False: igmc_forward(p, b, jax_cfg(), key,
                                                              training)
    (want_loss, _), grads = jax.value_and_grad(_make_loss_fn(fwd, 0.001, True),
                                               has_aux=True)(params, want_b, key)
    k, k_edge = jax.random.split(key)
    keep_f, keep_r = jax_edge_dropout_dense(
        k_edge, jnp.ones((BATCH, got_b.edge_slot), bool), 0.2, False, True)
    _, k_drop = jax.random.split(k)
    keep = jax.random.bernoulli(k_drop, 0.5, (BATCH, HIDDEN))
    t = lambda a: torch.from_numpy(np.array(a))
    model = port_model(params).train()
    loss, n = loss_fn(model, got_b, ((t(keep_f), t(keep_r)), t(keep)), 0.001)
    loss.backward()
    assert float(n) == BATCH
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads_close(model, grads)


def test_flat_fused_aggregate_step_on_dynamic_data_matches_jax(split):
    """The first flat batch of a shuffled dynamic epoch with its plans built
    on the loader's threads, through the fused aggregate's plain version,
    against JAX's Pallas path (interpret mode) with the same key: JAX's
    flat edge-dropout hash bit for bit, loss to rtol 1e-5, gradients to
    rtol 1e-4 / atol 1e-4 of the largest entry."""
    got_b = next(iter(BatchLoader(make(split, DynamicGraphDataset, backend="numpy"),
                                  BATCH, shuffle=True, seed=7, flat_aggregate="pallas")))
    want_b = next(iter(jax_loader(make(split, JaxDynamicGraphDataset, backend="numpy"),
                                  "flat", shuffle=True, seed=7)))
    cfg = jax_cfg(use_pallas=True, flat_aggregate="pallas")
    params = igmc_init(jax.random.PRNGKey(4), cfg)
    key = jax.random.PRNGKey(14)
    fwd = lambda p, b, key=None, training=False: igmc_forward(p, b, cfg, key, training)
    (want_loss, _), grads = jax.value_and_grad(_make_loss_fn(fwd, 0.001, True),
                                               has_aux=True)(params, want_b, key)
    k, k_edge = jax.random.split(key)
    seed = int(jax.random.randint(k_edge, (), 0, jnp.iinfo(jnp.int32).max))
    _, k_drop = jax.random.split(k)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(k_drop, 0.5, (BATCH, HIDDEN))))
    model = port_model(params, flat_aggregate="pallas").train()
    loss, _ = loss_fn(model, got_b, (seed, keep), 0.001)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads_close(model, grads)


def test_host_collated_edge_ids(split):
    """A static dataset's host-collated dense batch carries the packed edge
    index assemble_dense gives the same graphs, so training-mode hash
    dropout gives the same predictions either way; a dynamic dataset's ids
    are gid * 2**31 + j, distinct within the batch, and their hash masks
    differ between graphs."""
    ds = make(split, StaticGraphDataset, backend="numpy")
    loader = BatchLoader(ds, BATCH, shuffle=True, seed=1, batch_mode="dense")
    host = next(iter(loader))
    order = np.random.default_rng(np.random.SeedSequence([1, 0])).permutation(len(ds))
    gids = torch.from_numpy(order[:BATCH])
    dev = assemble_dense(DeviceDataset(ds.packed, torch.device("cpu")), gids,
                         host.node_slot, host.edge_slot)
    m = host.edge_mask
    assert torch.equal(m, dev.edge_mask)
    assert torch.equal(host.edge_id[m], dev.edge_id[m])
    model = IGMC(IGMCConfig(), torch.Generator().manual_seed(0)).train()
    keep = torch.ones(BATCH, HIDDEN, dtype=torch.bool)
    torch.testing.assert_close(model(host, (77, keep)), model(dev, (77, keep)),
                               rtol=0, atol=1e-6)

    dyn = BatchLoader(make(split, DynamicGraphDataset, backend="numpy"), BATCH,
                      batch_mode="dense")
    b = dyn.make_batch(np.arange(5, 5 + BATCH))
    ids = b.edge_id[b.edge_mask]
    assert len(torch.unique(ids)) == len(ids)
    rows = torch.arange(BATCH)[:, None].expand_as(b.edge_id)[b.edge_mask]
    pos = ids - (rows + 5) * DYNAMIC_EDGE_STRIDE
    assert (pos >= 0).all() and (pos < b.edge_slot).all()
    # keys of 2**32 and over hash with their high word; below, JAX's hash
    low = torch.arange(1000, dtype=torch.int64)
    k0 = hash_edge_keep(9, low, 0.5)
    assert torch.equal(k0, hash_edge_keep(9, low.int(), 0.5))
    assert not torch.equal(k0, hash_edge_keep(9, low + (1 << 32), 0.5))
    f, r = edge_dropout_dense(b.edge_mask, b.edge_id, 9, 0.5, False)
    assert not torch.equal(f[0, :20], f[1, :20]) or not torch.equal(r[0], r[1])


def data_pair(split, n_test=60):
    return {kind: (make(split, cls, backend="numpy"),
                   make(split, cls, part="test", n=n_test, backend="numpy"))
            for kind, cls in (("dynamic", DynamicGraphDataset),
                              ("static", StaticGraphDataset))}


def port_train(train, test, **kw):
    return train_multiple_epochs(
        train, test, IGMC(IGMCConfig(num_relations=5), torch.Generator().manual_seed(1)),
        epochs=kw.pop("epochs", 2), batch_size=BATCH, lr=5e-3, lr_decay_factor=0.1,
        lr_decay_step_size=50, ARR=0.001, seed=1, device="cpu", **kw)


def test_training_on_dynamic_data(split, tmp_path, capsys):
    """Dense (host-collated) training on dynamic data: finite, falling
    losses, identical with prefetch 2 and 0 (losses, RMSEs, parameters);
    the flat fused-aggregate path trains on dynamic data too; the epoch
    after the first is traced into profile_dir."""
    d = data_pair(split)["dynamic"]
    runs = []
    for prefetch in (2, 0):
        infos = []
        rmse, state = port_train(*d, batch_mode="dense", prefetch=prefetch,
                                 profile_dir=str(tmp_path / f"prof{prefetch}"),
                                 logger=lambda info, s: infos.append(dict(info)))
        runs.append((infos, state))
        trace = tmp_path / f"prof{prefetch}" / "epoch2.trace.json"
        assert trace.is_file() and trace.stat().st_size > 0
        assert f"torch.profiler trace of epoch 2 written to {tmp_path}" in \
            capsys.readouterr().out
    (a, sa), (b, sb) = runs
    assert a == b and a[1]["train_loss"] < a[0]["train_loss"]
    assert all(np.isfinite([i["train_loss"], i["test_rmse"]]).all() for i in a)
    for name, p in sa.model.state_dict().items():
        assert torch.equal(p, sb.model.state_dict()[name]), name
    assert all(0 <= h["host_seconds"] <= h["seconds"] for h in sa.history)
    rmse, _ = port_train(*d, batch_mode="flat", flat_aggregate="pallas", epochs=1)
    assert np.isfinite(rmse)


def test_evaluation_on_dynamic_data_equals_the_static_dense_path(split, tmp_path):
    """test_once of a dynamic dataset (host-collated unified batches) equals
    the static dataset's device-resident dense test_once, one model and a
    two-checkpoint ensemble, to 1e-5; the layouts and options host
    collation cannot run raise."""
    d = data_pair(split)
    model = IGMC(IGMCConfig(num_relations=5), torch.Generator().manual_seed(2))
    ckpts = []
    for seed in (3, 4):
        ckpts.append(str(tmp_path / f"model_checkpoint{seed}.pth"))
        save_pth(ckpts[-1], IGMC(IGMCConfig(num_relations=5),
                                 torch.Generator().manual_seed(seed)).state_dict())
    for kw in ({}, {"ensemble": True, "checkpoints": ckpts}):
        got = port_test_once(d["dynamic"][1], model, BATCH, batch_mode="dense",
                        device="cpu", **kw)
        want = port_test_once(d["static"][1], model, BATCH, batch_mode="dense",
                         device="cpu", **kw)
        assert abs(got - want) < 1e-5, (kw, got, want)
    with pytest.raises(ValueError, match="needs static"):
        port_test_once(d["dynamic"][1], model, BATCH, batch_mode="dense",
                  dense_layout="bipartite", device="cpu")
    with pytest.raises(ValueError, match="dense_chunk needs"):
        port_train(*d["dynamic"], batch_mode="dense", dense_chunk=5)
    with pytest.raises(ValueError, match="needs static"):
        port_train(*d["dynamic"], batch_mode="dense", dense_layout="bipartite")


# ---- the CLIs ----------------------------------------------------------------

RAW = os.path.join(REPO, "raw_data_synth")
LOG_LINE = re.compile(r"^Epoch (\d+), train loss \d+\.\d{4}, test rmse (\d+\.\d{6})$")


def cli(which, argv, raw, cwd, monkeypatch, capsys):
    monkeypatch.setenv("IGMC_RAW_DATA", raw)
    os.makedirs(cwd, exist_ok=True)
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    if which == "jax":
        jax_main(argv)
    else:
        port_main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def test_cli_dynamic_dataset_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """`--data-name ml_100k --testing --dynamic-dataset --epochs 2` on the
    repository's ml_100k fixture through both CLIs (each its own init and
    dropout): the same layout lines, log.txt in the same format, losses
    falling, and test RMSEs within 0.1 of each other after epoch 2
    (measured 1.0252 against 1.0117); no subgraph cache is written."""
    argv = ["--data-name", "ml_100k", "--testing", "--dynamic-dataset", "--epochs", "2"]
    logs = {}
    for w in ("port", "jax"):
        out = cli(w, argv, RAW, str(tmp_path / w), monkeypatch, capsys)
        assert "batch mode: dense (auto)" in out and "dense layout: unified (auto)" in out
        logs[w] = (tmp_path / w / "results" / "ml_100k_testmode" / "log.txt"
                   ).read_text().splitlines()
        assert not list((tmp_path / w).rglob("*.npz"))
    rm = {w: [LOG_LINE.match(l) for l in logs[w]] for w in logs}
    assert all(rm["port"]) and all(rm["jax"]) and len(rm["port"]) == len(rm["jax"]) == 2
    losses = [float(l.split(",")[1].split()[-1]) for l in logs["port"]]
    assert losses[1] < losses[0]
    got, want = float(rm["port"][1].group(2)), float(rm["jax"][1].group(2))
    assert abs(got - want) < 0.1, (got, want)


def test_cli_dynamic_flat_fused_aggregate_trains(tmp_path, monkeypatch, capsys):
    """`--dynamic-dataset --flat-aggregate pallas` trains through the fused
    aggregate (its plain version here) to a finite RMSE."""
    out = cli("port", ["--data-name", "ml_100k", "--testing", "--dynamic-dataset",
                       "--flat-aggregate", "pallas", "--epochs", "1",
                       "--max-train-num", "300", "--max-test-num", "100"],
              RAW, str(tmp_path), monkeypatch, capsys)
    assert "batch mode: flat (--flat-aggregate pallas)" in out
    rmse = float(re.search(r"Final Test RMSE: (\S+),", out).group(1))
    assert np.isfinite(rmse)


@pytest.mark.parametrize("flags,message", [
    (["--dense-chunk", "5", "--dynamic-train"], "--dense-chunk needs static"),
    (["--dense-layout", "bipartite", "--dynamic-dataset"],
     "--dense-layout bipartite needs the device-resident"),
])
def test_cli_layout_exits_on_dynamic_data_match_jax(flags, message, tmp_path,
                                                    monkeypatch, capsys):
    """Both CLIs exit with the same message on a layout that dynamic data
    cannot run."""
    argv = ["--data-name", "ml_100k", "--testing", "--max-train-num", "50",
            "--max-test-num", "20"] + flags
    texts = []
    for w in ("port", "jax"):
        with pytest.raises(SystemExit, match=re.escape(message)) as e:
            cli(w, argv, RAW, str(tmp_path / w), monkeypatch, capsys)
        texts.append(str(e.value))
    assert texts[0] == texts[1]
