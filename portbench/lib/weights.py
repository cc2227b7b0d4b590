"""Seeds and weights of a run, drawn by the harness from `--seed`."""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from ..reference.igmc import param_specs

WEIGHTS, ORDER, NOISE, REQUESTS, SAMPLE = range(1, 6)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use (`tags`) of the run seed."""
    ss = np.random.SeedSequence([int(seed) % 2**64, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_members(model: dict, num_relations: int, seed: int, members: int,
                 device) -> list:
    """`members` state_dicts of IGMC in float32 on `device`, each tensor
    U(-bound, bound) with the init bounds of the reference (param_specs),
    drawn in one call of a generator on the device."""
    specs = param_specs(model, num_relations)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.rand(members, sum(sizes), generator=gen, device=device) * 2 - 1
    out = []
    for m in range(members):
        parts = torch.split(flat[m], sizes)
        out.append(OrderedDict((name, (t * bound).reshape(shape).contiguous())
                               for (name, shape, bound), t in zip(specs, parts)))
    return out


def noise_generator(seed: int, pass_index: int) -> torch.Generator:
    """The CPU generator a training pass draws its noise from."""
    return torch.Generator().manual_seed(sub_seed(seed, NOISE, pass_index))
