"""Parameter interchange: JAX-package parameters and reference `.pth` files.

Port of igmc_tpu/train/torch_interop.py. The modules of every family
(IGMC, GNN, DGCNN, DGCNN_RS) have the PyTorch reference's names and
layouts in their state_dicts, so a reference ``model_checkpoint<E>.pth``
(``torch.save(model.state_dict())``) loads natively:

  * R-GCN layers ``convs.{i}.basis`` [B, in, out], ``.att`` [R, B],
    ``.root`` [in, out], ``.bias`` [out]; GCN layers ``convs.{i}.weight``
    [in, out], ``.bias`` [out] — the JAX package's layouts, copied
    verbatim;
  * ``lin1`` / ``lin2`` as torch.nn.Linear: ``weight`` [out, in] (the JAX
    package stores [in, out], transposed on the way through) and ``bias``;
  * DGCNN's ``conv1d_params1`` / ``conv1d_params2`` (the JAX package's
    ``conv1d_1`` / ``conv1d_2``) as torch.nn.Conv1d: ``weight`` [out, in,
    k], copied verbatim, and ``bias``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

# each layer kind's parameters, in the reference's order
_CONV_KEYS = (("basis", "att", "root", "bias"),     # R-GCN
              ("weight", "bias"))                   # GCN
_LINEAR_KEYS = ("lin1", "lin2")
_CONV1D_NAMES = {"conv1d_1": "conv1d_params1", "conv1d_2": "conv1d_params2"}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.array(a, dtype=np.float32)))


def params_from_jax(params_np) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's parameter pytree of any family, as numpy arrays
    ({"convs": [{"basis", "att", "root", "bias"} or {"weight", "bias"},
    ...], "lin1": {"weight", "bias"}, "lin2": ..., and for DGCNN
    "conv1d_1", "conv1d_2"}), -> a state_dict for the family's
    `load_state_dict`."""
    sd = OrderedDict()
    for i, conv in enumerate(params_np["convs"]):
        keys = next((ks for ks in _CONV_KEYS if set(conv) == set(ks)), None)
        if keys is None:
            raise KeyError(f"convs.{i}: expected one of {_CONV_KEYS}, got "
                           f"{sorted(conv)}")
        for k in keys:
            sd[f"convs.{i}.{k}"] = _tensor(conv[k])
    for name in _LINEAR_KEYS:
        sd[f"{name}.weight"] = _tensor(params_np[name]["weight"]).t().contiguous()
        sd[f"{name}.bias"] = _tensor(params_np[name]["bias"])
    for ours, theirs in _CONV1D_NAMES.items():
        if ours in params_np:
            sd[f"{theirs}.weight"] = _tensor(params_np[ours]["weight"])
            sd[f"{theirs}.bias"] = _tensor(params_np[ours]["bias"])
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
