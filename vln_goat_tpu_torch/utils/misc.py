"""Misc utilities (counterpart of vln_goat_tpu/utils/misc.py, reference
map_nav_src/utils/misc.py)."""
from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int):
    """Seeds Python's `random`, numpy's global generator and torch's
    default generators (CPU and every card)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
