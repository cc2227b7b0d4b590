"""Global seeding of the host RNGs and torch's default generator.

Port of igmc_tpu/utils/seeding.py. The port's training noise comes from
its own per-(seed, epoch) generators (train/loop.py) and model weights
from an explicit generator, so this only fixes what other code draws from
the global streams.
"""

import random

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
