"""The port's plain attention (frozen from `ops/attention.py`): the q / k /
v projections, softmax(q k^T / sqrt(dh) + bias) in float32, the keep mask
of the fused kernel's dropout (`dropout.keep_mask`, the bits the CUDA
kernels draw) and the product with v.  `fused_qkv_mha` is this plain
version on every device: the reference launches no kernel."""
from __future__ import annotations

import math
from typing import Optional

import torch

from .dropout import keep_mask


def _split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, L, HD = t.shape
    return t.view(B, L, num_heads, HD // num_heads)


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain version sums in for inputs of `dtype`: float32
    for bf16, whose values it multiplies exactly in float32 (the products of
    the JAX kernel's bf16 operands with float32 sums), else `dtype`."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def project_plain(x, y, wq, bq, wk, bk, wv, bv):
    """The three projections: q [B, Lq, H*dh], k and v [B, Lk, H*dh].  In
    bf16 they are float32 (`_fa_qkv`: bf16 products summed in float32, plus
    the bias)."""
    acc = _sum_dtype(x.dtype)
    if acc != x.dtype:
        x, y, wq, bq, wk, bk, wv, bv = (t.to(acc) for t in (
            x, y, wq, bq, wk, bk, wv, bv))
    return x @ wq + bq, y @ wk + bk, y @ wv + bv


def attend_plain(q, k, v, bias=None, num_heads: int = 12,
                 dropout_rate: float = 0.0,
                 seed: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None,
                 scale: Optional[float] = None):
    """Attention over projected q [B, Lq, H*dh], k/v [B, Lk, H*dh]:
    softmax(q k^T / sqrt(dh) + bias) in float32, the keep mask of
    `keep_mask(seed, ...)` at `dropout_rate`, times v -> [B, Lq, H*dh].
    `scale` replaces 1 / sqrt(dh) (the head-padded call's true width).

    `dtype` (default q's) is the call's compute dtype.  bf16: q, k, v, the
    bias and p are rounded to bf16 where the JAX kernel casts them (before
    q k^T, at the bias's cast to x.dtype, before p v), every product sums
    in float32, and the output is bf16."""
    B, Lq, HD = q.shape
    H = num_heads
    dh = HD // H
    dt = q.dtype if dtype is None else dtype
    acc = _sum_dtype(dt)
    if acc != dt:
        def rd(t):
            return t.to(dt).to(acc)
    else:
        def rd(t):
            return t
    q, k, v = (_split_heads(rd(t), H) for t in (q, k, v))
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        s = s + rd(bias).to(s.dtype)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    if dropout_rate > 0.0:
        keep = keep_mask(seed, p.shape, dropout_rate)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)),
                        torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", rd(p), v).reshape(B, Lq, HD)
    return out.to(dt)


def fused_qkv_mha_plain(x, y, wq, bq, wk, bk, wv, bv, bias=None,
                        num_heads: int = 12, dropout_rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None):
    """x [B, Lq, D] (query side), y [B, Lk, D] (key/value side),
    projection weights [D, H*dh] with biases [H*dh], additive bias
    broadcastable to [B, {1,H}, Lq, Lk], per-row int32 seeds [B] (needed
    when dropout_rate > 0) -> [B, Lq, H*dh] in x's dtype.  Softmax in
    float32; bf16 inputs take the cast points of `attend_plain`."""
    return attend_plain(*project_plain(x, y, wq, bq, wk, bk, wv, bv), bias,
                        num_heads, dropout_rate, seed, dtype=x.dtype,
                        scale=scale)


def fused_qkv_mha(x, y, wq, bq, wk, bk, wv, bv, bias=None,
                  num_heads: int = 12, dropout_rate: float = 0.0,
                  seed: Optional[torch.Tensor] = None):
    """The port's `fused_qkv_mha` signature on its plain version."""
    return fused_qkv_mha_plain(x, y, wq, bq, wk, bk, wv, bv, bias,
                               num_heads, dropout_rate, seed)
