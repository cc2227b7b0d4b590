"""Checkpoint naming and loading.

Port of igmc_tpu/train/checkpoints.py (checkpoint_path,
resolve_checkpoint). The port writes and reads the PyTorch reference's
``<kind>_checkpoint<E>.pth`` state_dicts. The JAX package's own
``.ckpt`` files are flax msgpack, which this package cannot read yet:
loading one raises.
"""

from __future__ import annotations

import os

from .interop import load_pth


def checkpoint_path(res_dir: str, kind: str, epoch) -> str:
    return os.path.join(res_dir, f"{kind}_checkpoint{epoch}.pth")


def resolve_checkpoint(res_dir: str, kind: str, epoch) -> str:
    """Path of the checkpoint for (kind, epoch): the `.pth` if it exists,
    else the JAX package's `.ckpt` if that exists (loading it raises a clear
    error), else the (nonexistent) `.pth` path, so callers' missing-file
    handling sees the name they would write."""
    pth = checkpoint_path(res_dir, kind, epoch)
    if os.path.exists(pth):
        return pth
    ckpt = os.path.join(res_dir, f"{kind}_checkpoint{epoch}.ckpt")
    if os.path.exists(ckpt):
        return ckpt
    return pth


def load_checkpoint(path: str):
    """The state_dict stored at `path` (a `.pth`)."""
    if path.endswith(".ckpt"):
        raise NotImplementedError(
            f"{path}: flax msgpack checkpoints of the JAX package cannot be "
            f"read by igmc_torch yet; export the parameters as a reference "
            f"'.pth' from the JAX package (train/torch_interop.py "
            f"save_reference_checkpoint)")
    return load_pth(path)
