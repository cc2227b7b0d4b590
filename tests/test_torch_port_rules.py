"""igmc_torch package rules: nothing of JAX, the JAX package, pandas,
h5py, matplotlib, networkx, flax, tqdm or msgpack is imported (AST scan,
and a real import of
every module with those blocked); entry points default to the CUDA device
and raise without one; TF32 is off once a device is resolved; kernel and
extraction-engine sources ship with the package."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from igmc_torch import device as port_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "igmc_torch")
FORBIDDEN = ("jax", "jaxlib", "igmc_tpu", "pandas", "h5py", "matplotlib",
             "networkx", "flax", "tqdm", "msgpack")
# the modules each slice added, which the scans must reach
PORT_MODULES = ("igmc_torch.serve", "igmc_torch.cli.predict",
                "igmc_torch.cli.main", "igmc_torch.graphs.native",
                "igmc_torch.native.build", "igmc_torch.data.loaders",
                "igmc_torch.data.splits", "igmc_torch.data.synthetic",
                "igmc_torch.train.flaxmsgpack", "igmc_torch.data.hdf5",
                "igmc_torch.data.matio", "igmc_torch.models.families",
                "igmc_torch.ops.sort_pool", "igmc_torch.ops.segment",
                "igmc_torch.ops.blocked", "igmc_torch.parallel.mesh",
                "igmc_torch.parallel.dp", "igmc_torch.parallel.ep",
                "igmc_torch.parallel.multihost", "igmc_torch.utils.pdf",
                "igmc_torch.utils.progress", "igmc_torch.train.visualize",
                "igmc_torch.cli.resilient", "igmc_torch.scripts",
                "igmc_torch.scripts.summarize_fdy",
                "igmc_torch.scripts.transfer_experiment")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def _module_name(path):
    mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
    return mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def test_port_sources_import_nothing_forbidden():
    sources = _port_sources()
    assert len(sources) > 15
    assert set(PORT_MODULES) <= {_module_name(p) for p in sources}
    for path in sources:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_port_modules_import_with_forbidden_modules_blocked():
    modules = [_module_name(p) for p in _port_sources()
               if os.path.relpath(p, REPO).startswith("igmc_torch")]
    assert set(PORT_MODULES) <= set(modules)
    code = (
        "import importlib, importlib.abc, sys\n"
        f"BLOCK = {FORBIDDEN!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in BLOCK:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device("cuda:0")
    with pytest.raises(ValueError):
        port_device.resolve_device("meta")
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_resolving_a_device_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert port_device.tf32_enabled()
    port_device.resolve_device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not port_device.tf32_enabled()


def test_kernel_sources_are_packaged_and_build_paths_are_content_hashed(
        tmp_path, monkeypatch):
    from igmc_torch.kernels import build

    assert build.KERNELS == ("rgcn_aggregate_fwd", "rgcn_aggregate_bwd")
    paths = set()
    for name in build.KERNELS:
        source = os.path.join(build.CSRC_DIR, f"{name}.cu")
        assert os.path.isfile(source)
        text = open(source).read()
        # a plain C interface, bound with ctypes: no PyTorch headers
        assert f'extern "C" int {name}(' in text
        assert "<torch/" not in text and "ATen" not in text
        path = build.library_path(name)
        assert path.startswith(build.BUILD_DIR)
        assert path == build.library_path(name)   # stable for one source
        paths.add(path)
    assert len(paths) == len(build.KERNELS)
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    pyproject = open(os.path.join(REPO, "pyproject.toml")).read()
    assert '"igmc_torch*"' in pyproject and '"csrc/*.cu"' in pyproject
    assert '"csrc/*.cuh"' in pyproject
    # the experiment scripts' shell files ship with the package too
    assert '"igmc_torch.scripts" = ["*.sh"]' in pyproject
    for script in ("run_fdy.sh", "run_transfer_exps.sh"):
        assert os.access(os.path.join(PKG, "scripts", script), os.X_OK)
    # an edited shared header rebuilds every kernel
    shutil.copytree(build.CSRC_DIR, tmp_path / "csrc")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path / "csrc"))
    assert {build.library_path(n) for n in build.KERNELS} == paths   # same content
    with open(tmp_path / "csrc" / "rgcn_aggregate_common.cuh", "a") as f:
        f.write("// edited\n")
    assert not paths & {build.library_path(n) for n in build.KERNELS}


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line on a machine
    without CUDA (and outside the repository it cannot import the port)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
