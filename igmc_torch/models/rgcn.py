"""The basis-decomposed relational graph convolution's parameters.

Port of igmc_tpu/models/rgcn.py (rgcn_init, rgcn_relation_weights) as an
nn.Module. The layer computes, as PyG 1.4.2's RGCNConv does,

    W_r  = sum_b att[r, b] * basis[b]                 (basis decomposition)
    out_i = aggr_{e: dst_e = i} x[src_e] @ W_{type_e} + x_i @ root + bias

with the aggregate done by kernels/rgcn_aggregate.py (models/igmc.py
wires it). Parameter names and layouts equal the JAX package's and the
PyTorch reference's state_dict (`convs.{i}.{basis,att,root,bias}`).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    """Fill `t` in place with U(-bound, bound) from `generator`."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class RGCNConv(nn.Module):
    """basis [B, Cin, Cout], att [R, B], root [Cin, Cout], bias [Cout]; every
    tensor ~ U(±1/sqrt(B * Cin)) (the PyG 1.4.2 init)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_relations: int, num_bases: int,
                 generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(num_bases * in_channels)
        shapes = {
            "basis": (num_bases, in_channels, out_channels),
            "att": (num_relations, num_bases),
            "root": (in_channels, out_channels),
            "bias": (out_channels,),
        }
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                uniform_(torch.empty(shape), bound, generator)))

    def relation_weights(self) -> torch.Tensor:
        """W_r = att @ basis, shape [R, Cin, Cout]."""
        R, B = self.att.shape
        _, i, o = self.basis.shape
        return (self.att @ self.basis.reshape(B, i * o)).reshape(R, i, o)
