"""Activations (counterpart of vln_goat_tpu/ops/activations.py).

The reference uses the exact erf GELU, not the tanh approximation;
checkpoint parity requires matching it.
"""
from __future__ import annotations

import torch


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    z = x.float()
    return (0.5 * z * (1.0 + torch.erf(z * 0.7071067811865476))).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACT2FN = {
    "gelu": gelu_erf,
    "relu": torch.relu,
    "swish": swish,
    "tanh": torch.tanh,
}
