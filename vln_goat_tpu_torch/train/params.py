"""Seeded parameter initialisation of the port's GoatModel, drawn on the
model's own device with an explicit torch.Generator.

The distributions are those the JAX package's flax modules use: Dense
kernels lecun-normal (a normal of std sqrt(1/fan_in) truncated at two
standard deviations and rescaled), biases zero, LayerNorm scale one and
bias zero, embeddings normal with std sqrt(1/width), the CFP pooling's raw
tim_*_attn vectors normal with std 0.02.  The draws differ from
JAX's, which use another generator.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..models.goat import TIM_ATTN
from ..models.layers import TorchMultiheadAttention

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


@torch.no_grad()
def init_goat_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise every parameter of `model` in place from `seed`; the
    generator lives on the model's device."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _lecun_(m.weight, m.in_features, g)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, math.sqrt(1.0 / m.embedding_dim),
                            generator=g)
        elif isinstance(m, TorchMultiheadAttention):
            _lecun_(m.in_proj_weight, m.in_proj_weight.shape[1], g)
            nn.init.zeros_(m.in_proj_bias)
        for name in TIM_ATTN:
            p = getattr(m, name, None)
            if isinstance(p, nn.Parameter):
                nn.init.normal_(p, 0.0, 0.02, generator=g)
    return model
