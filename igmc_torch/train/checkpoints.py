"""Checkpoint naming, loading, and the optimizer state's files.

Port of igmc_tpu/train/checkpoints.py (checkpoint_path,
resolve_checkpoint, save/load). The port writes and reads the PyTorch
reference's ``model_checkpoint<E>.pth`` state_dicts, and keeps the
optimizer's state beside them as ``optimizer_checkpoint<E>.pth``
(torch.optim's state_dict; the JAX package's optax state does not carry
over). The JAX package's own ``.ckpt`` files are flax msgpack, which this
package cannot read yet: loading one raises.
"""

from __future__ import annotations

import os

import torch

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


def save_optimizer_state(path: str, optimizer: torch.optim.Optimizer) -> None:
    """Write optimizer.state_dict() as a `.pth`, atomically, as save_pth
    writes a model."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(optimizer.state_dict(), tmp)
    os.replace(tmp, path)


def load_optimizer_state(path: str) -> dict:
    """The optimizer state_dict stored at `path`, on the CPU
    (optimizer.load_state_dict moves it to the parameters' device)."""
    return torch.load(path, map_location="cpu", weights_only=True)
