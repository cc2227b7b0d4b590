"""igmc_torch reads the JAX package's `.ckpt` checkpoints: the stdlib
msgpack decoder against the msgpack package and flax's serializer (and
its refusals, by name), a
JAX-written `.ckpt` loaded to exactly state_dict_from_params, its
optimizer `.ckpt` refused by name, and `--ensemble`, `--transfer` and
`igmc_torch.cli.predict` run from a results directory of JAX `.ckpt`
files, each equal to the JAX CLI's result on the same files. msgpack and
flax are imported by this test only."""

import os
import random
import re

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from igmc_tpu.cli.main import main as jax_main
from igmc_tpu.cli.predict import main as jax_predict
from igmc_tpu.data.synthetic import write_ml100k_format
from igmc_tpu.models.igmc import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models.igmc import igmc_init
from igmc_tpu.train.checkpoints import save_checkpoint
from igmc_tpu.train.loop import make_optimizer as jax_make_optimizer
from igmc_tpu.train.torch_interop import state_dict_from_params

from igmc_torch.cli.main import main as port_main
from igmc_torch.cli.predict import main as port_predict
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.train import (load_checkpoint, load_optimizer_state,
                              resolve_checkpoint, save_pth)
from igmc_torch.train.flaxmsgpack import (load_flax_msgpack, restore_lists,
                                          unpackb)

torch.set_num_threads(1)


def random_tree(rng, depth=0):
    """A random msgpack-able tree reaching every format the decoder reads:
    each int width and sign, float, str / bin of each length class, fix /
    16-bit arrays and maps."""
    kind = rng.randrange(9 if depth < 3 else 6)
    if kind == 0:
        return rng.choice([None, True, False])
    if kind == 1:
        return rng.choice([0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
                           2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
                           -32769, -2**31, -2**31 - 1, -2**63,
                           rng.randrange(-2**63, 2**64)])
    if kind == 2:
        return rng.uniform(-1e30, 1e30)
    if kind == 3:
        n = rng.choice([0, 5, 31, 32, 255, 256, 70000])
        return chr(rng.randrange(32, 0x2FFF)) * n + chr(rng.randrange(32, 0x2FFF))
    if kind == 4:
        return bytes([rng.randrange(256)]) * rng.choice([0, 3, 255, 256, 70000])
    if kind == 5:
        return rng.random()
    if kind in (6, 7):
        return [random_tree(rng, depth + 1) for _ in range(rng.choice([0, 1, 15, 16, 17]))]
    return {rng.choice([str(i), i, -i]): random_tree(rng, depth + 1)
            for i in range(rng.choice([0, 1, 15, 16, 17]))}


@pytest.mark.parametrize("seed", range(6))
def test_decoder_matches_msgpack_on_random_trees(seed):
    """The decoder's object equals msgpack.unpackb's (raw=False) on 60
    random trees per seed, with float64 and with float32 floats."""
    rng = random.Random(seed)
    for _ in range(60):
        tree = random_tree(rng)
        for single in (False, True):
            data = msgpack.packb(tree, use_bin_type=True, use_single_float=single)
            assert unpackb(data) == msgpack.unpackb(data, raw=False,
                                                    strict_map_key=False)


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int8", "int32",
                                   "int64", "uint8", "uint32", "bool", "complex64"])
def test_flax_ndarrays_and_lists_decode_exactly(dtype, tmp_path):
    """A file of flax.serialization.to_bytes holding arrays of every shape
    class, an int, a float and nested lists and tuples: load_flax_msgpack
    gives flax's own msgpack_restore with the lists restored, arrays
    bit-equal with their dtype and shape."""
    rs = np.random.RandomState(1)
    arr = lambda shape: np.asarray(rs.standard_normal(shape) * 50).astype(dtype)
    tree = {"a": arr((3, 4)), "scalar0d": arr(()), "empty": arr((0, 5)),
            "nested": [arr((2,)), (arr((1, 2, 3)), {"x": arr((4,))})],
            "n": 7, "f": 0.25, "s": "adam"}
    data = serialization.to_bytes(tree)
    path = tmp_path / "tree.ckpt"
    path.write_bytes(data)
    got = load_flax_msgpack(str(path))
    want = restore_lists(serialization.msgpack_restore(data))
    assert isinstance(got["nested"], list) and isinstance(got["nested"][1], list)

    def same(g, w):
        if isinstance(w, dict):
            assert isinstance(g, dict) and set(g) == set(w)
            for k in w:
                same(g[k], w[k])
        elif isinstance(w, list):
            assert isinstance(g, list) and len(g) == len(w)
            for a, b in zip(g, w):
                same(a, b)
        elif isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            assert g.shape == w.shape and g.tobytes() == w.tobytes()
        else:
            assert type(g) is type(w) and g == w

    same(got, want)


def test_unhandled_ext_types_dtypes_and_truncation_raise_naming_them(tmp_path):
    with pytest.raises(ValueError, match="ext type 5"):
        unpackb(msgpack.packb(msgpack.ExtType(5, b"abc")))
    with pytest.raises(ValueError, match="ext type 2"):      # flax's complex
        unpackb(serialization.to_bytes({"c": 1 - 2j}))
    with pytest.raises(ValueError, match="ext type 3"):      # a NumPy scalar
        unpackb(serialization.to_bytes({"s": np.float32(2.0)}))
    bf16 = serialization.to_bytes({"w": jnp.ones((2,), jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        unpackb(bf16)
    data = serialization.to_bytes({"w": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        unpackb(data[:-2])
    with pytest.raises(ValueError, match="after the msgpack document"):
        unpackb(data + b"\x00")
    path = tmp_path / "model_checkpoint1.ckpt"
    path.write_bytes(b"")
    with pytest.raises(ValueError, match="truncated msgpack"):
        load_checkpoint(str(path))


def jax_cfg(**kw):
    return JaxIGMCConfig(num_features=4, latent_dim=(32, 32, 32, 32),
                         num_relations=5, num_bases=4, **kw)


@pytest.mark.parametrize("kw", [{}, {"num_relations": 10, "num_bases": 2},
                                {"side_features": True, "n_side_features": 23,
                                 "latent_dim": (16, 8)}])
def test_jax_ckpt_loads_to_exactly_state_dict_from_params(kw, tmp_path):
    """A `.ckpt` written by the JAX package's save_checkpoint loads to
    exactly state_dict_from_params of the same params (names, order,
    values, bit for bit), and into the port's IGMC of that config."""
    cfg = dict(num_features=4, latent_dim=(32, 32, 32, 32), num_relations=5,
               num_bases=4)
    cfg.update(kw)
    params = igmc_init(jax.random.PRNGKey(3), JaxIGMCConfig(**cfg))
    path = str(tmp_path / "model_checkpoint4.ckpt")
    save_checkpoint(path, params)
    got = load_checkpoint(path)
    want = state_dict_from_params(params)
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype == torch.float32
        assert torch.equal(got[name], w), name
    IGMC(IGMCConfig(**cfg), torch.Generator().manual_seed(0)).load_state_dict(got)
    tree = load_flax_msgpack(path)
    assert isinstance(tree["convs"], list) and len(tree["convs"]) == len(cfg["latent_dim"])


def test_resolve_checkpoint_prefers_pth_and_optimizer_ckpt_is_refused(tmp_path):
    d = str(tmp_path)
    params = igmc_init(jax.random.PRNGKey(0), jax_cfg())
    save_checkpoint(os.path.join(d, "model_checkpoint3.ckpt"), params)
    assert resolve_checkpoint(d, "model", 3).endswith(".ckpt")
    save_pth(os.path.join(d, "model_checkpoint3.pth"),
             IGMC(IGMCConfig(), torch.Generator().manual_seed(0)).state_dict())
    assert resolve_checkpoint(d, "model", 3).endswith(".pth")
    opt = os.path.join(d, "optimizer_checkpoint3.ckpt")
    save_checkpoint(opt, jax_make_optimizer(1e-3).init(params))
    with pytest.raises(ValueError, match="optax"):
        load_optimizer_state(opt)


# ---- the CLIs on a results directory of JAX .ckpt files --------------------

ARGV = ["--data-name", "ml_100k", "--testing", "--batch-size", "25",
        "--max-test-num", "150"]
EPOCHS = ["--epochs", "20"]


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """An ml_100k fixture (120 users x 100 items, 2,500 ratings) and a JAX
    results directory holding model and optimizer `.ckpt` files of epochs
    10 and 20, written by the JAX package from two seeded inits (the
    CLI's ensemble range at --epochs 20 is 10 and 20)."""
    raw = tmp_path_factory.mktemp("raw100k")
    write_ml100k_format(str(raw), n_users=120, n_movies=100, n_ratings=2500, seed=4)
    work = tmp_path_factory.mktemp("work")
    res = work / "results" / "ml_100k_testmode"
    for e in (10, 20):
        params = igmc_init(jax.random.PRNGKey(e), jax_cfg())
        save_checkpoint(str(res / f"model_checkpoint{e}.ckpt"), params)
        save_checkpoint(str(res / f"optimizer_checkpoint{e}.ckpt"),
                        jax_make_optimizer(1e-3).init(params))
    return str(raw), str(work), str(res)


def cli(which, argv, raw, cwd, monkeypatch, capsys):
    monkeypatch.setenv("IGMC_RAW_DATA", raw)
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    if which == "jax":
        jax_main(argv)
    else:
        port_main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def number(pattern, out):
    m = re.search(pattern + r" (\d+\.\d+)", out)
    assert m, out[-2000:]
    return float(m.group(1))


def test_ensemble_from_jax_ckpt_results_matches_jax_cli(jax_results, monkeypatch,
                                                        capsys, tmp_path):
    """`--ensemble --no-train` over the JAX results directory's epochs 10
    and 20: the port's ensemble RMSE equals the JAX CLI's on the same
    `.ckpt` files to 1e-5 (the same weights and graphs; float32 sums in
    another order)."""
    raw, work, _ = jax_results
    argv = ARGV + EPOCHS + ["--ensemble", "--no-train", "--keep-old"]
    got = number("Ensemble test rmse is:", cli("port", argv, raw, work, monkeypatch,
                                                 capsys))
    want = number("Ensemble test rmse is:", cli("jax", argv, raw, work, monkeypatch,
                                                  capsys))
    assert abs(got - want) < 1e-5, (got, want)


def test_transfer_from_jax_ckpt_results_matches_jax_cli(jax_results, monkeypatch,
                                                        capsys, tmp_path):
    """`--transfer <JAX results dir> --epochs 20 --no-train` from another
    directory: the port loads model_checkpoint20.ckpt and its test RMSE
    equals the JAX CLI's to 1e-5."""
    raw, _, res = jax_results
    argv = ARGV + EPOCHS + ["--transfer", res, "--no-train"]
    out = {}
    for w in ("port", "jax"):
        cwd = tmp_path / w
        cwd.mkdir()
        out[w] = number("Test rmse is:", cli(w, argv, raw, str(cwd), monkeypatch,
                                             capsys))
    assert abs(out["port"] - out["jax"]) < 1e-5, out


def test_predict_cli_from_jax_ckpt_results_matches_jax(jax_results, monkeypatch,
                                                       capsys, tmp_path):
    """igmc_torch.cli.predict --ensemble over the JAX `.ckpt` files scores
    12 pairs (a cold-start user among them) equal to
    igmc_tpu.cli.predict's scores on the same files to 1e-5."""
    raw, _, res = jax_results
    pairs = tmp_path / "pairs.csv"
    pairs.write_text("user,item\n" + "".join(f"{u},{v}\n" for u, v in
                                             [(0, 1), (3, 7), (10, 2), (119, 99),
                                              (5, 5), (40, 60), (77, 12), (1, 0),
                                              (60, 30), (2, 98), (100, 50), (9, 9)]))
    monkeypatch.setenv("IGMC_RAW_DATA", raw)
    monkeypatch.chdir(tmp_path)
    argv = ["--data-name", "ml_100k", "--testing", "--results-dir", res,
            "--epochs", "20", "--ensemble", "--pairs", str(pairs)]
    scores = {}
    for w, run in (("port", lambda a: port_predict(a + ["--device", "cpu"])),
                   ("jax", jax_predict)):
        run(argv + ["--out", str(tmp_path / f"{w}.csv")])
        rows = [l.split(",") for l in (tmp_path / f"{w}.csv").read_text().splitlines()]
        scores[w] = np.array([float(r[2]) for r in rows])
        assert [(int(r[0]), int(r[1])) for r in rows][:2] == [(0, 1), (3, 7)]
    assert "ensemble of 2 checkpoint(s)" in capsys.readouterr().err
    assert len(scores["port"]) == 12 and np.isfinite(scores["port"]).all()
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=0, atol=1e-5)


def test_continue_from_a_jax_optimizer_ckpt_is_refused_naming_optax(
        jax_results, monkeypatch, capsys, tmp_path):
    """`--continue-from 20` in the JAX results directory: the model `.ckpt`
    loads, the optimizer `.ckpt` is refused naming why."""
    raw, work, _ = jax_results
    with pytest.raises(ValueError, match="optax state, which does not carry over"):
        cli("port", ARGV + ["--epochs", "21", "--continue-from", "20", "--keep-old",
                            "--max-train-num", "50"], raw, work, monkeypatch, capsys)
