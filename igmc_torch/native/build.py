"""Build the C++ extraction engine with g++ and return the library's path.

`native/extract.cpp` is compiled on first use into
`native/build/libigmc_extract-<hash>.so`, where the hash covers the source
and the compiler flags: an edited source rebuilds, an unchanged one loads
the library already built. The build writes a temporary file and renames
it into place, so processes that build at once do not see a half-written
library. The compiler is $CXX if set, else g++. Nothing runs at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "extract.cpp")
BUILD_DIR = os.path.join(HERE, "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: install g++ or set CXX")
    return cxx


def library_path() -> str:
    """Where the library built from extract.cpp lives, hashed over the
    source and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libigmc_extract-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile extract.cpp unless it is built already; returns the
    library's path. Raises RuntimeError with the compiler's output if the
    build fails."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    out = subprocess.run([compiler(), *CXX_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True)
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE} failed (exit {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    return path
