"""Checkpoint naming, loading, and the optimizer state's files.

Port of igmc_tpu/train/checkpoints.py (checkpoint_path,
resolve_checkpoint, save/load). The port writes and reads the PyTorch
reference's ``model_checkpoint<E>.pth`` state_dicts, and keeps the
optimizer's state beside them as ``optimizer_checkpoint<E>.pth``
(torch.optim's state_dict). It also reads the JAX package's model
``.ckpt`` files (flax msgpack, decoded by train/flaxmsgpack.py and mapped
by params_from_jax), so `--ensemble`, `--transfer`, `--continue-from`'s
model and serving run from a JAX results directory; a JAX optimizer
``.ckpt`` is refused, as optax's state does not carry over to
torch.optim.
"""

from __future__ import annotations

import os

import torch

from .flaxmsgpack import load_flax_msgpack
from .interop import load_pth, params_from_jax


def checkpoint_path(res_dir: str, kind: str, epoch) -> str:
    return os.path.join(res_dir, f"{kind}_checkpoint{epoch}.pth")


def resolve_checkpoint(res_dir: str, kind: str, epoch) -> str:
    """Path of the checkpoint for (kind, epoch): the `.pth` if it exists,
    else the JAX package's `.ckpt` if that exists, else the (nonexistent)
    `.pth` path, so callers' missing-file handling sees the name they would
    write."""
    pth = checkpoint_path(res_dir, kind, epoch)
    if os.path.exists(pth):
        return pth
    ckpt = os.path.join(res_dir, f"{kind}_checkpoint{epoch}.ckpt")
    if os.path.exists(ckpt):
        return ckpt
    return pth


def load_checkpoint(path: str):
    """The model state_dict stored at `path`: a `.pth`, or the JAX
    package's `.ckpt` of IGMC parameters, mapped to the port's names."""
    if path.endswith(".ckpt"):
        return params_from_jax(load_flax_msgpack(path))
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
    (optimizer.load_state_dict moves it to the parameters' device), with
    its groups' `capturable` flag left out: the graphed training step
    (train/graphed.py) saves capturable Adam, which cannot step on the
    CPU, and sets the flag itself again when it resumes. A JAX `.ckpt`
    raises: optax's Adam state is not torch.optim's."""
    if path.endswith(".ckpt"):
        raise ValueError(
            f"{path}: the JAX package's optimizer checkpoint holds optax "
            f"state, which does not carry over to torch.optim; resume from a "
            f"run of igmc_torch, or start a new run from the model "
            f"checkpoint (--transfer)")
    state = torch.load(path, map_location="cpu", weights_only=True)
    for group in state.get("param_groups", ()):
        group.pop("capturable", None)
    return state
