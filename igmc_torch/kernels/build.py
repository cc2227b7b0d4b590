"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` (KERNELS) exposes a plain C interface and is
compiled on first use into `kernels/build/lib<name>-<hash>.so`, where the
hash covers the source, the shared headers of csrc/ and the compiler
flags: an edited source rebuilds, an unchanged one loads the library
already built. `build_many` starts one
nvcc per source, all at once. The ptxas report (registers, shared memory,
spills) is kept beside each library as `.log`.

nvcc is found through CUDA_HOME (or CUDA_PATH), then PATH, then PyTorch's
own idea of the CUDA home. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("rgcn_aggregate_fwd", "rgcn_aggregate_bwd")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> str:
    """Where the library built from csrc/<name>.cu lives, hashed over the
    source, the headers in csrc/ it may include, and the compiler flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_many(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile each csrc/<name>.cu that is not built already, one nvcc
    process per source, all started together; returns {name: library
    path}. Raises RuntimeError with nvcc's output if any build fails."""
    paths = {name: library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not os.path.isfile(path)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc {name}.cu (exit {proc.returncode}):\n{out}")
            continue
        with open(todo[name] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless it is built already; returns the
    library's path."""
    return build_many([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
