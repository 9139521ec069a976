"""Fused q/k/v projections + multi-head attention.

`fused_qkv_mha` is the port of the TPU kernel behind the JAX package's
`pallas_fused_qkv_mha` (vln_goat_tpu/ops/attention.py:347; kernel body
`_fa_fwd_kernel` :169, launched by `_fa_call` :251).  On a CUDA tensor it
launches the hand-written CUDA kernel `csrc/fused_qkv_mha.cu` or raises;
on a CPU tensor it computes `fused_qkv_mha_plain`, the same function in
plain PyTorch, which the CPU tests hold against the JAX package and the
chip smoke test holds the kernel against.

Forward only and deterministic: in-kernel attention-prob dropout and the
backward kernel belong to the training slice.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build


def _split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, L, HD = t.shape
    return t.view(B, L, num_heads, HD // num_heads)


def fused_qkv_mha_plain(x, y, wq, bq, wk, bk, wv, bv, bias=None,
                        num_heads: int = 12):
    """x [B, Lq, D] (query side), y [B, Lk, D] (key/value side),
    projection weights [D, H*dh] with biases [H*dh], additive bias
    broadcastable to [B, {1,H}, Lq, Lk] -> [B, Lq, H*dh].  Softmax in
    float32."""
    B, Lq, _ = x.shape
    H = num_heads
    dh = wq.shape[1] // H
    q = _split_heads(x @ wq + bq, H)
    k = _split_heads(y @ wk + bk, H)
    v = _split_heads(y @ wv + bv, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(dh))
    if bias is not None:
        s = s + bias.to(s.dtype)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, Lq, H * dh)


_VP, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_qkv_mha")
    fn = lib.fused_qkv_mha_fwd
    if fn.argtypes is None:
        w = [_VP, _LL, _LL, _VP]
        fn.argtypes = ([_VP, _VP] + w * 3 + [_VP, _LL, _LL, _LL, _LL, _VP]
                       + [_I] * 5 + [_F, _VP])
        fn.restype = _I
        lib.fused_qkv_mha_head_dim.restype = _I
        lib.fused_qkv_mha_max_lk.restype = _I
    return lib


def _check_weight(name, w, b, D, HD, dev):
    if w.shape != (D, HD) or b.shape != (HD,):
        raise ValueError(f"{name}: weight {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)}, expected ({D}, {HD}) / ({HD},)")
    for t in (w, b):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: needs float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if not (w.is_contiguous() or w.t().is_contiguous()):
        raise ValueError(f"{name}: weight must be [D, H*dh] contiguous or "
                         "the transpose of a contiguous [H*dh, D]")
    if not b.is_contiguous():
        raise ValueError(f"{name}: bias must be contiguous")


def fused_qkv_mha(x, y, wq, bq, wk, bk, wv, bv, bias=None,
                  num_heads: int = 12, dropout_rate: float = 0.0):
    """Signature and layout of `pallas_fused_qkv_mha`: x [B, Lq, D],
    y [B, Lk, D], weights [D, H*dh] (+ biases [H*dh]), additive bias
    broadcastable to [B, {1,H}, Lq, Lk] -> [B, Lq, H*dh].

    A weight may be the transposed view of a torch Linear weight
    (`lin.weight.t()`): the kernel reads it through its strides."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "in-kernel attention dropout is not ported yet (training slice)")
    if x.device.type == "cpu":
        return fused_qkv_mha_plain(x, y, wq, bq, wk, bk, wv, bv, bias,
                                   num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv_mha: unsupported device {x.device}")

    dev = x.device
    B, Lq, D = x.shape
    if y.dim() != 3 or y.shape[0] != B or y.shape[2] != D:
        raise ValueError(f"y {tuple(y.shape)} does not match x {tuple(x.shape)}")
    Lk = y.shape[1]
    H = num_heads
    HD = wq.shape[1]
    if HD % H:
        raise ValueError(f"{HD} columns do not split into {H} heads")
    dh = HD // H
    for t, name in ((x, "x"), (y, "y")):
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32 on {dev}")
    for name, w, b in (("q", wq, bq), ("k", wk, bk), ("v", wv, bv)):
        _check_weight(name, w, b, D, HD, dev)

    lib = _kernel_lib()
    if dh != lib.fused_qkv_mha_head_dim():
        raise ValueError(f"the kernel is built for head width "
                         f"{lib.fused_qkv_mha_head_dim()}, got {dh}")
    if Lk > lib.fused_qkv_mha_max_lk() or D % 32:
        raise ValueError(f"the kernel takes Lk <= "
                         f"{lib.fused_qkv_mha_max_lk()} and D % 32 == 0, "
                         f"got Lk={Lk}, D={D}")

    if bias is None:
        bias4, strides = None, (0, 0, 0, 0)
    else:
        if bias.device != dev:
            raise ValueError(f"bias: needs {dev}, got {bias.device}")
        hb = H if (bias.dim() == 4 and bias.shape[1] == H) else 1
        bias4 = bias.to(torch.float32).expand(B, hb, Lq, Lk)
        strides = bias4.stride()
        if hb == 1:
            strides = (strides[0], 0, strides[2], strides[3])

    out = torch.empty((B, Lq, HD), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_qkv_mha_fwd(
            x.data_ptr(), y.data_ptr(),
            wq.data_ptr(), wq.stride(0), wq.stride(1), bq.data_ptr(),
            wk.data_ptr(), wk.stride(0), wk.stride(1), bk.data_ptr(),
            wv.data_ptr(), wv.stride(0), wv.stride(1), bv.data_ptr(),
            None if bias4 is None else bias4.data_ptr(), *strides,
            out.data_ptr(), B, Lq, Lk, D, H, 1.0 / math.sqrt(dh), stream)
    fused_qkv_mha.launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_qkv_mha kernel launch failed: CUDA error "
                           f"{rc} (B={B}, Lq={Lq}, Lk={Lk}, D={D}, H={H})")
    return out


# kernel launches since the last reset; the plain path does not count
fused_qkv_mha.launches = 0
