"""Mask utilities (counterpart of vln_goat_tpu/ops/masks.py).

extend_neg_masks turns a boolean [B, L] mask into an additive float mask
[B, 1, 1, L] of 0 / -10000 (not -inf): GOAT checkpoints were trained with
-10000, so it is reproduced exactly.
"""
from __future__ import annotations

import torch

NEG_INF_MASK_VALUE = -10000.0


def extend_neg_masks(masks: torch.Tensor) -> torch.Tensor:
    """[B, L] bool/float -> [B, 1, 1, L] additive float32 mask (0 keep /
    -10000 drop)."""
    m = masks.to(torch.float32)
    return (1.0 - m)[:, None, None, :] * NEG_INF_MASK_VALUE
