"""Parameter interchange: JAX-package parameters and reference `.pth` files.

Port of igmc_tpu/train/torch_interop.py. The IGMC module's state_dict has
the PyTorch reference's names and layouts, so a reference
``model_checkpoint<E>.pth`` (``torch.save(model.state_dict())``) loads
natively:

  * ``convs.{i}.basis`` [B, in, out], ``.att`` [R, B], ``.root`` [in, out],
    ``.bias`` [out] — the JAX package's layouts, copied verbatim;
  * ``lin1`` / ``lin2`` as torch.nn.Linear: ``weight`` [out, in] (the JAX
    package stores [in, out], transposed on the way through) and ``bias``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

_CONV_KEYS = ("basis", "att", "root", "bias")   # the reference's order
_LINEAR_KEYS = ("lin1", "lin2")


def params_from_jax(params_np) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's IGMC parameter pytree, as numpy arrays
    ({"convs": [{"basis", "att", "root", "bias"}, ...], "lin1": {"weight",
    "bias"}, "lin2": ...}), -> a state_dict for `IGMC.load_state_dict`."""
    sd = OrderedDict()
    for i, conv in enumerate(params_np["convs"]):
        if set(conv) != set(_CONV_KEYS):
            raise KeyError(f"convs.{i}: expected {_CONV_KEYS}, got {sorted(conv)}")
        for k in _CONV_KEYS:
            sd[f"convs.{i}.{k}"] = torch.from_numpy(
                np.array(conv[k], dtype=np.float32))
    for name in _LINEAR_KEYS:
        w = np.array(params_np[name]["weight"], dtype=np.float32).T  # [out, in]
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.array(params_np[name]["bias"], dtype=np.float32))
    return sd


def load_pth(path: str) -> "OrderedDict[str, torch.Tensor]":
    """A reference-layout ``.pth`` state_dict, on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} does not contain a state_dict")
    return sd


def save_pth(path: str, state_dict) -> None:
    """Write a state_dict as a reference-loadable ``.pth``, atomically (a
    temporary file renamed into place, so a kill mid-save never leaves a
    truncated checkpoint under the name)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(OrderedDict((k, v.detach().cpu()) for k, v in state_dict.items()),
               tmp)
    os.replace(tmp, path)
