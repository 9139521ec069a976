"""Fused q/k/v projections + multi-head attention, forward and backward,
and attention over projected heads.

`fused_qkv_mha` is the port of the TPU kernels behind the JAX package's
`pallas_fused_qkv_mha` (vln_goat_tpu/ops/attention.py:347):

- the forward `_fa_fwd_kernel` (:169, launched by `_fa_call` :251) is
  `csrc/fused_qkv_mha.cu`: the q / k / v projection GEMM of
  `csrc/qkv_proj.cuh` (the same jobs the backward recomputes through) on
  the tensor-core GEMM core `csrc/gemm_tf32x3.cuh`, then the attention
  core `csrc/attn_fwd.cuh` on 3xTF32 fragments, with the in-kernel
  attention-probability dropout of `_fa_probs` (:149-166);
- the backward `_fa_bwd_kernel` (:181, custom-VJP rule `_fa_bwd_rule`
  :316) is `csrc/fused_qkv_mha_bwd.cu` on the tensor-core GEMM core
  `csrc/gemm_tf32x3.cuh`: `attention_backward` (recompute, softmax and
  dropout backward -> dq, dk, dv, ds) and `projection_backward` (dx, dy,
  weight and bias gradients split over the rows as `bwd_plan.proj_plan`
  lays them out, dbias).

Both run in float32 or, for bf16 inputs (the JAX package's bf16 model,
`_bdot(..., dt=x.dtype)` :120-137), in bf16: bf16 operands of every
product with float32 sums, the GEMMs on the bf16 core `csrc/gemm_bf16.cuh`
(one persistent launch fed by TMA; `bf16_core_routes` counts its launches
by load route) and the attention on the Hopper cores
`csrc/attn_fwd_sm90.cuh` and `csrc/attn_bwd_sm90.cuh` (64-row tiles by
TMA, wgmma, the scores in registers, any Lk; `attn_core_routes` counts
their launches by load route); scores, softmax, dropout and the score
gradients in float32; q, k, v, p, ds and the projection gradients
rounded to bf16 where the JAX kernel casts them; outputs and gradients in
their input's dtype.  x, y, the weights and biases of one call share one
dtype; a mix raises.  On the card both builds take any Lk (the float32
attention forward past 256 keys in key blocks with an online softmax), the
head widths of `HEAD_DIMS` (32, 64, 128: one kernel instance each, chosen
at launch) and D % 32 == 0, and raise on any other shape.

On a CUDA tensor `fused_qkv_mha` runs `FusedQKVMHA`, an autograd Function
whose forward launches the forward kernel and whose backward launches the
two backward kernels; it saves its inputs and the per-row seeds, never the
probabilities, as the JAX rule does (:273-277).  On a CPU tensor it
computes `fused_qkv_mha_plain`, the same function in plain PyTorch, whose
autograd is the reference the CPU tests hold against the JAX package and
the chip smoke test holds the kernels against.  The dropout mask of both is
`ops.dropout.keep_mask`, a hash of (seed[b], b, h, q, k).

`mha` is the port of `pallas_mha` (:104, kernel `_mha_kernel` :49): the
attention alone, forward only, over q / k / v that are already projected
and split into heads, in float32 or bf16.  On a CUDA tensor it launches
`csrc/mha.cu`; on a CPU tensor it computes `mha_plain`.  As in the JAX
package, no model path calls it: it is a public op for A/B comparisons.
It runs the same attention core as the fused forward of its dtype,
without dropout (in bf16 with p v in float32 precision).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .bwd_plan import (CHUNK, JOB_IDS, TILE_K, TILE_K_BF16, TILE_M, TILE_N,
                       TILE_N_BF16, proj_plan, split_depth)
from .dropout import keep_mask, keep_threshold


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
                 dtype: Optional[torch.dtype] = None):
    """Attention over projected q [B, Lq, H*dh], k/v [B, Lk, H*dh]:
    softmax(q k^T / sqrt(dh) + bias) in float32, the keep mask of
    `keep_mask(seed, ...)` at `dropout_rate`, times v -> [B, Lq, H*dh].

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
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(dh))
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
                        seed: Optional[torch.Tensor] = None):
    """x [B, Lq, D] (query side), y [B, Lk, D] (key/value side),
    projection weights [D, H*dh] with biases [H*dh], additive bias
    broadcastable to [B, {1,H}, Lq, Lk], per-row int32 seeds [B] (needed
    when dropout_rate > 0) -> [B, Lq, H*dh] in x's dtype.  Softmax in
    float32; bf16 inputs take the cast points of `attend_plain`."""
    return attend_plain(*project_plain(x, y, wq, bq, wk, bk, wv, bv), bias,
                        num_heads, dropout_rate, seed, dtype=x.dtype)


def mha_plain(q, k, v, bias=None):
    """q [B, Lq, H, dh], k / v [B, Lk, H, dh], additive bias
    broadcastable to [B, H, Lq, Lk] -> [B, Lq, H*dh] in q's dtype:
    softmax(q k^T / sqrt(dh) + bias) v.  At the JAX kernel's cast points
    (`_mha_kernel` :49-62): a bf16 or float32 q, k, v and bias are taken
    in float32, scores, softmax and p v in float32, the output rounded
    once; float64 stays float64."""
    B, Lq, H, dh = q.shape
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    q, k, v = (t.to(acc) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(dh))
    if bias is not None:
        s = s + bias.to(acc)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, Lq, H * dh)
    return out.to(dt)


_VP, _LL, _I, _U, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_uint, ctypes.c_float
_W = [_VP, _LL, _LL]                    # weight pointer and its two strides

# the head widths the attention kernels are built for (csrc/head_dims.cuh;
# each library's `*_head_dims` entry must report the same set)
HEAD_DIMS = (32, 64, 128)


def check_head_dim(dh: int) -> None:
    """Raises ValueError for a head width the kernels are not built for,
    naming the widths they are."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernels are built for head widths "
                         f"{HEAD_DIMS}, got {dh}")


def _check_head_dims(lib: ctypes.CDLL, entry: str) -> None:
    """Holds the library's head widths (its entry `entry`) to HEAD_DIMS."""
    fn = getattr(lib, entry)
    fn.argtypes = [_VP, _I]
    fn.restype = _I
    out = (_I * 8)()
    n = fn(out, 8)
    if tuple(out[:n]) != HEAD_DIMS:
        raise RuntimeError(f"{entry}: the library is built for head widths "
                           f"{tuple(out[:n])}, the wrapper for {HEAD_DIMS}")


# the dtypes the kernels take, and the suffix of their C entries
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def _entry(lib: ctypes.CDLL, name: str, dtype: torch.dtype):
    """The C entry `name` of `lib` for `dtype` (float32 or bf16)."""
    return getattr(lib, name + _SUFFIX[dtype])


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_qkv_mha")
    if lib.fused_qkv_mha_fwd.argtypes is None:
        for sfx in _SUFFIX.values():
            fn = getattr(lib, "fused_qkv_mha_fwd" + sfx)
            fn.argtypes = ([_VP, _VP] + (_W + [_VP]) * 3
                           + [_VP, _LL, _LL, _LL, _LL, _VP, _VP] + [_I] * 6
                           + [_F, _VP, _U, _F, _VP])
            fn.restype = _I
            fn = getattr(lib, "fused_qkv_mha_proj" + sfx)
            fn.argtypes = ([_VP, _VP] + (_W + [_VP]) * 3 + [_VP] + [_I] * 6
                           + [_VP])
            fn.restype = _I
        # the bf16 attention core alone, for timing it (chip_smoke.py)
        lib.fused_qkv_mha_attn_bf16.argtypes = (
            [_VP, _VP, _LL, _LL, _LL, _LL, _VP] + [_I] * 5
            + [_F, _VP, _U, _F, _VP])
        lib.fused_qkv_mha_attn_bf16.restype = _I
        _check_head_dims(lib, "fused_qkv_mha_head_dims")
        lib.fused_qkv_mha_bf16_route.restype = _I
        lib.fused_qkv_mha_attn_route.restype = _I
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_qkv_mha_bwd")
    if lib.fused_qkv_mha_bwd_attn.argtypes is None:
        for sfx in _SUFFIX.values():
            fa = getattr(lib, "fused_qkv_mha_bwd_attn" + sfx)
            fa.argtypes = ([_VP, _VP] + (_W + [_VP]) * 3
                           + [_VP, _LL, _LL, _LL, _LL] + [_VP, _U, _F]
                           + [_VP] * 8 + [_I] * 6 + [_F, _VP])
            fa.restype = _I
            fp = getattr(lib, "fused_qkv_mha_bwd_proj" + sfx)
            fp.argtypes = ([_VP, _VP] + _W * 3 + [_VP] * 6 + [_VP] * 9
                           + [_I] * 8 + [_VP])
            fp.restype = _I
            fr = getattr(lib, "fused_qkv_mha_bwd_reduce" + sfx)
            fr.argtypes = [_VP] * 10 + [_I] * 3 + [_VP]
            fr.restype = _I
            fg = getattr(lib, "fused_qkv_mha_bwd_gemm" + sfx)
            fg.argtypes = [_VP, _LL, _LL] * 2 + [_VP] * 3 + [_I] * 5 + [_VP]
            fg.restype = _I
        lib.fused_qkv_mha_bwd_smem.argtypes = [_I, _VP]
        lib.fused_qkv_mha_bwd_smem.restype = None
        # (a)'s bf16 attention core alone, for timing it (chip_smoke.py)
        lib.fused_qkv_mha_bwd_core_bf16.argtypes = (
            [_VP, _VP] + [_LL] * 4 + [_VP, _U, _F] + [_VP] * 7 + [_I] * 5
            + [_F, _VP])
        lib.fused_qkv_mha_bwd_core_bf16.restype = _I
        _check_head_dims(lib, "fused_qkv_mha_bwd_head_dims")
        lib.fused_qkv_mha_bwd_bf16_route.restype = _I
        lib.fused_qkv_mha_bwd_attn_route.restype = _I
        lib.fused_qkv_mha_bwd_tile.argtypes = [_VP]
        lib.fused_qkv_mha_bwd_tile.restype = None
        tile = (_I * 6)()
        lib.fused_qkv_mha_bwd_tile(tile)
        want = (TILE_M, TILE_N, TILE_K, TILE_M, TILE_N_BF16, TILE_K_BF16)
        if tuple(tile) != want:
            raise RuntimeError(f"the backward kernels tile by {tuple(tile)}, "
                               f"their plan by {want}")
    return lib


# launches of the bf16 GEMM core (K1's projection, K2 (a)'s recompute,
# K2 (b)'s jobs, `gemm_bf16`) by the route its operands took: "tma", every
# operand through a tensor map, or "direct", at least one (a stride TMA
# cannot describe) loaded by the producer warp with ordinary loads
bf16_core_routes = {"tma": 0, "direct": 0}
# launches of the bf16 attention cores (csrc/attn_fwd_sm90.cuh under K1
# bf16 and the bf16 `mha`, csrc/attn_bwd_sm90.cuh under K2 (a) bf16) by
# the route their q, k, v (and dO) took, as above
attn_core_routes = {"tma": 0, "direct": 0}


def _count(routes: dict, route: int) -> None:
    """Counts one launch in `routes` by the route its library reports."""
    routes["tma" if route == 1 else "direct"] += 1


def _ints(ctype, values):
    return (ctype * len(values))(*values)


def _mha_lib() -> ctypes.CDLL:
    lib = _build.load("mha")
    if lib.mha_fwd.argtypes is None:
        # mha_fwd_bf16_one_term: the control of chip_smoke.py's check
        for fn in (lib.mha_fwd, lib.mha_fwd_bf16, lib.mha_fwd_bf16_one_term):
            fn.argtypes = ([_VP, _LL, _LL, _LL, _LL] * 3
                           + [_VP, _LL, _LL, _LL, _LL, _VP] + [_I] * 5
                           + [_F, _VP])
            fn.restype = _I
        _check_head_dims(lib, "mha_head_dims")
        lib.mha_attn_route.restype = _I
    return lib


def mha(q, k, v, bias=None):
    """Signature and layout of `pallas_mha`: q [B, Lq, H, dh], k / v
    [B, Lk, H, dh] in float32 or bf16, additive bias broadcastable to
    [B, H, Lq, Lk] -> [B, Lq, H*dh] in q's dtype, scores, softmax and p v
    in float32.  Forward only (no autograd), as the TPU kernel has no VJP.

    On the card the kernel reads q, k, v and the bias through their
    strides; it takes the head widths of HEAD_DIMS and any Lk (in bf16 on
    the Hopper core, whose launches count in `attn_core_routes`), and
    raises on anything else."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, bias)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"mha kernel: unsupported device {dev}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected [B, Lq, H, dh] and "
                         "[B, Lk, H, dh]")
    dtype = q.dtype
    if dtype not in _SUFFIX:
        raise ValueError(f"q: the kernel takes float32 or bfloat16, got "
                         f"{dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: needs {dtype} on {dev} like q, got "
                             f"{t.dtype} on {t.device}")
    B, Lq, H, dh = q.shape
    Lk = k.shape[1]
    check_head_dim(dh)
    lib = _mha_lib()
    bias4, bst = None, (0, 0, 0, 0)
    if bias is not None:
        if bias.device != dev:
            raise ValueError(f"bias: needs {dev}, got {bias.device}")
        bias4 = bias.to(torch.float32).expand(B, H, Lq, Lk)
        bst = bias4.stride()
    out = torch.empty((B, Lq, H * dh), device=dev, dtype=dtype)
    with torch.cuda.device(dev):
        rc = _entry(lib, "mha_fwd", dtype)(
            q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride(),
            v.data_ptr(), *v.stride(),
            None if bias4 is None else bias4.data_ptr(), *bst,
            out.data_ptr(), B, Lq, Lk, H, dh, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(dev).cuda_stream)
    mha.launches += 1
    if rc != 0:
        raise RuntimeError(f"mha kernel launch failed: CUDA error {rc} "
                           f"(B={B}, Lq={Lq}, Lk={Lk}, H={H})")
    if dtype == torch.bfloat16:
        _count(attn_core_routes, lib.mha_attn_route())
    return out


def _check_weight(name, w, b, D, HD, dev, dtype):
    if w.shape != (D, HD) or b.shape != (HD,):
        raise ValueError(f"{name}: weight {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)}, expected ({D}, {HD}) / ({HD},)")
    for t in (w, b):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: needs {dtype} on {dev} like x, got "
                             f"{t.dtype} on {t.device}")
    if not (w.is_contiguous() or w.t().is_contiguous()):
        raise ValueError(f"{name}: weight must be [D, H*dh] contiguous or "
                         "the transpose of a contiguous [H*dh, D]")
    if not b.is_contiguous():
        raise ValueError(f"{name}: bias must be contiguous")


class _Call:
    """Checked shapes and kernel arguments of one fused attention call on
    the card, shared by the forward and the backward launches."""

    def __init__(self, x, y, wq, bq, wk, bk, wv, bv, bias, seed,
                 num_heads: int, dropout_rate: float, lib):
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"fused_qkv_mha kernels: unsupported device "
                             f"{dev}")
        B, Lq, D = x.shape
        if y.dim() != 3 or y.shape[0] != B or y.shape[2] != D:
            raise ValueError(f"y {tuple(y.shape)} does not match x "
                             f"{tuple(x.shape)}")
        Lk = y.shape[1]
        H = num_heads
        HD = wq.shape[1]
        if HD % H:
            raise ValueError(f"{HD} columns do not split into {H} heads")
        dh = HD // H
        dtype = x.dtype
        if dtype not in _SUFFIX:
            raise ValueError(f"x: the kernels take float32 or bfloat16, got "
                             f"{dtype}")
        for t, name in ((x, "x"), (y, "y")):
            if t.device != dev or t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"{name}: needs contiguous {dtype} on {dev} "
                                 f"like x, got {t.dtype} on {t.device}")
        for name, w, b in (("q", wq, bq), ("k", wk, bk), ("v", wv, bv)):
            _check_weight(name, w, b, D, HD, dev, dtype)
        check_head_dim(dh)
        if D % 32:
            raise ValueError(f"the kernels take D % 32 == 0, got D={D}")
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")

        if bias is None:
            self.bias4, self.bias_strides = None, (0, 0, 0, 0)
        else:
            if bias.device != dev:
                raise ValueError(f"bias: needs {dev}, got {bias.device}")
            hb = H if (bias.dim() == 4 and bias.shape[1] == H) else 1
            # in x's dtype, as pallas_fused_qkv_mha casts it (:372-375)
            self.bias4 = bias.to(dtype).expand(B, hb, Lq, Lk)
            st = self.bias4.stride()
            self.bias_strides = (st[0], 0 if hb == 1 else st[1], st[2],
                                 st[3])
        self.seed = None
        if dropout_rate > 0.0:
            if seed is None or seed.shape != (B,) or seed.device != dev:
                raise ValueError(f"dropout needs int32 seeds [{B}] on {dev}")
            self.seed = seed.to(torch.int32).contiguous()
        self.rate = dropout_rate
        self.thresh = keep_threshold(dropout_rate) if dropout_rate > 0 else 0
        self.inv_keep = 1.0 / (1.0 - dropout_rate)
        self.dev, self.lib, self.dtype = dev, lib, dtype
        self.B, self.Lq, self.Lk, self.D, self.H, self.HD = B, Lq, Lk, D, H, HD
        self.dh = dh
        self.scale = 1.0 / math.sqrt(dh)
        self.ws = ((wq, bq), (wk, bk), (wv, bv))

    def weight_args(self, with_bias: bool = True):
        out = []
        for w, b in self.ws:
            out += [w.data_ptr(), w.stride(0), w.stride(1)]
            if with_bias:
                out.append(b.data_ptr())
        return out

    def bias_args(self):
        return [None if self.bias4 is None else self.bias4.data_ptr(),
                *self.bias_strides]

    def seed_args(self):
        return [None if self.seed is None else self.seed.data_ptr(),
                self.thresh, self.inv_keep]

    def stream(self):
        return torch.cuda.current_stream(self.dev).cuda_stream

    def entry(self, name: str):
        """The C entry `name` for this call's dtype."""
        return _entry(self.lib, name, self.dtype)

    def check(self, rc: int, what: str):
        if rc != 0:
            raise RuntimeError(
                f"{what} kernel launch failed: CUDA error {rc} (B={self.B}, "
                f"Lq={self.Lq}, Lk={self.Lk}, D={self.D}, H={self.H})")


def _fwd_call(x, y, wq, bq, wk, bk, wv, bv, bias, seed, num_heads,
              dropout_rate) -> _Call:
    return _Call(x, y, wq, bq, wk, bk, wv, bv, bias, seed, num_heads,
                 dropout_rate, _fwd_lib())


def _bwd_call(x, y, wq, bq, wk, bk, wv, bv, bias, seed, num_heads,
              dropout_rate) -> _Call:
    return _Call(x, y, wq, bq, wk, bk, wv, bv, bias, seed, num_heads,
                 dropout_rate, _bwd_lib())


def forward_kernel(x, y, wq, bq, wk, bk, wv, bv, bias=None,
                   num_heads: int = 12, dropout_rate: float = 0.0,
                   seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One call of the forward on CUDA tensors (no autograd), counted as
    one launch: the q / k / v projection GEMM into scratch of
    B (Lq + 2 Lk) H*dh elements of x's dtype, freed on return, then the
    attention."""
    c = _fwd_call(x, y, wq, bq, wk, bk, wv, bv, bias, seed, num_heads,
                  dropout_rate)
    like = dict(device=c.dev, dtype=c.dtype)
    out = torch.empty((c.B, c.Lq, c.HD), **like)
    qkv = torch.empty(c.B * (c.Lq + 2 * c.Lk) * c.HD, **like)
    with torch.cuda.device(c.dev):
        rc = c.entry("fused_qkv_mha_fwd")(
            x.data_ptr(), y.data_ptr(), *c.weight_args(), *c.bias_args(),
            out.data_ptr(), qkv.data_ptr(), c.B, c.Lq, c.Lk, c.D, c.H, c.dh,
            c.scale, *c.seed_args(), c.stream())
    fused_qkv_mha.launches += 1
    c.check(rc, "fused_qkv_mha")
    if c.dtype == torch.bfloat16:
        _count(bf16_core_routes, c.lib.fused_qkv_mha_bf16_route())
        _count(attn_core_routes, c.lib.fused_qkv_mha_attn_route())
    return out


def forward_projection(x, y, wq, bq, wk, bk, wv, bv, num_heads: int = 12):
    """The forward's first launch alone, for timing it apart from the
    attention (`mha` over its views runs the same attention core): q
    [B, Lq, H, dh], k and v [B, Lk, H, dh] as the forward projects them,
    views of one scratch.  Not counted in `fused_qkv_mha.launches`."""
    c = _fwd_call(x, y, wq, bq, wk, bk, wv, bv, None, None, num_heads, 0.0)
    qkv = torch.empty(c.B * (c.Lq + 2 * c.Lk) * c.HD, device=c.dev,
                      dtype=c.dtype)
    with torch.cuda.device(c.dev):
        rc = c.entry("fused_qkv_mha_proj")(
            x.data_ptr(), y.data_ptr(), *c.weight_args(), qkv.data_ptr(),
            c.B, c.Lq, c.Lk, c.D, c.H, c.dh, c.stream())
    c.check(rc, "fused_qkv_mha projection")
    dh = c.dh
    q, k, v = qkv.split([c.B * c.Lq * c.HD] + [c.B * c.Lk * c.HD] * 2)
    return (q.view(c.B, c.Lq, c.H, dh), k.view(c.B, c.Lk, c.H, dh),
            v.view(c.B, c.Lk, c.H, dh))


# keys per chunk of the attention backward (csrc/fused_qkv_mha_bwd.cu KC,
# csrc/attn_sm90.cuh TILE): past one, it takes row statistics and, in bf16,
# dq's running sum in float32 scratch
ATTN_KEY_CHUNK = 64


def attention_backward(x, y, wq, bq, wk, bk, wv, bv, bias, seed, dout,
                       num_heads: int = 12, dropout_rate: float = 0.0,
                       need_ds: bool = False):
    """Kernel (a) of the backward on CUDA tensors: from the forward's
    inputs and dO [B, Lq, H*dh], the gradients of the projected
    q [B, Lq, H*dh], k and v [B, Lk, H*dh], and ds [B, H, Lq, Lk] (the
    gradient of the scores, which is the bias's per head) when `need_ds`.
    Two launches: the q / k / v recompute into scratch of
    B (Lq + 2 Lk) H*dh elements of x's dtype, freed on return, then the
    attention backward over it.  dq, dk, dv come in x's dtype (dO's), ds in
    float32."""
    c = _bwd_call(x, y, wq, bq, wk, bk, wv, bv, bias, seed, num_heads,
                  dropout_rate)
    dout = dout.contiguous()
    if dout.shape != (c.B, c.Lq, c.HD) or dout.dtype != c.dtype:
        raise ValueError(f"dO {tuple(dout.shape)} {dout.dtype}, expected "
                         f"{c.dtype} {(c.B, c.Lq, c.HD)}")
    f32 = dict(device=c.dev, dtype=torch.float32)
    like = dict(device=c.dev, dtype=c.dtype)
    dq = torch.empty((c.B, c.Lq, c.HD), **like)
    dk = torch.empty((c.B, c.Lk, c.HD), **like)
    dv = torch.empty((c.B, c.Lk, c.HD), **like)
    ds = torch.empty((c.B, c.H, c.Lq, c.Lk), **f32) if need_ds else None
    qkv = torch.empty(c.B * (c.Lq + 2 * c.Lk) * c.HD, **like)
    # softmax statistics of each row, when the keys span several chunks,
    # and in bf16 dq's running sum over them (rounded once, at the end)
    several = c.Lk > ATTN_KEY_CHUNK
    stats = torch.empty(c.B * c.H * c.Lq * 3, **f32) if several else None
    dq_acc = torch.empty(dq.numel(), **f32) \
        if several and c.dtype == torch.bfloat16 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(c.dev):
        rc = c.entry("fused_qkv_mha_bwd_attn")(
            x.data_ptr(), y.data_ptr(), *c.weight_args(), *c.bias_args(),
            *c.seed_args(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ptr(ds), qkv.data_ptr(), ptr(stats), ptr(dq_acc),
            c.B, c.Lq, c.Lk, c.D, c.H, c.dh, c.scale, c.stream())
    attention_backward.launches += 1
    c.check(rc, "fused_qkv_mha_bwd_attn")
    if c.dtype == torch.bfloat16:
        _count(bf16_core_routes, c.lib.fused_qkv_mha_bwd_bf16_route())
        _count(attn_core_routes, c.lib.fused_qkv_mha_bwd_attn_route())
    return dq, dk, dv, ds


# the parts of the projection backward that `ProjectionBackward.launch`
# can run alone, for timing: the dx and dy GEMMs, the split-K weight
# gradients, the pass adding their slices, the head sum of ds
PROJ_PARTS = ("dx", "dy", "dw", "reduce", "hsum")


class ProjectionBackward:
    """Checked inputs, outputs, scratch and kernel arguments of one call of
    kernel (b); `launch()` runs it (two launches: the GEMM jobs as
    `bwd_plan.proj_plan` orders them, then the pass adding the weight
    gradients' slices), `launch(part)` one part of it for timing, leaving
    the other outputs unwritten.  `projection_backward` is the wrapper."""

    def __init__(self, x, y, wq, wk, wv, dq, dk, dv, ds=None,
                 num_heads: int = 12, need_dx: bool = True,
                 need_dy: bool = True):
        B, Lq, D = x.shape
        Lk, HD = y.shape[1], wq.shape[1]
        dev, dtype = x.device, x.dtype
        self.lib = _bwd_lib()
        if dtype not in _SUFFIX or y.dtype != dtype:
            raise ValueError(f"x, y: need one of float32 and bfloat16, got "
                             f"{x.dtype}, {y.dtype}")
        for t in (dq, dk, dv):
            if t.dtype != dtype or not t.is_contiguous() or \
                    t.device != dev or t.shape[0] != B or t.shape[2] != HD:
                raise ValueError(f"dq/dk/dv: need contiguous {dtype} "
                                 f"[{B}, L, {HD}] on {dev}")
        for name, w in (("wq", wq), ("wk", wk), ("wv", wv)):
            if w.shape != (D, HD) or w.dtype != dtype or \
                    not (w.is_contiguous() or w.t().is_contiguous()):
                raise ValueError(f"{name}: weight must be {dtype} [D, H*dh] "
                                 "contiguous or the transpose of a "
                                 "contiguous [H*dh, D]")
        f32 = dict(device=dev, dtype=torch.float32)
        like = dict(device=dev, dtype=dtype)
        self.dx = torch.empty_like(x) if need_dx else None
        self.dy = torch.empty_like(y) if need_dy else None
        self.dws = [torch.empty_strided(w.shape, w.stride(), **like)
                    for w in (wq, wk, wv)]
        self.dbs = [torch.empty(HD, **like) for _ in range(3)]
        self.dbias = None
        if ds is not None:
            if ds.shape != (B, num_heads, Lq, Lk) or not ds.is_contiguous():
                raise ValueError(f"ds {tuple(ds.shape)}, expected "
                                 f"contiguous {(B, num_heads, Lq, Lk)}")
            self.dbias = torch.empty((B, 1, Lq, Lk), **f32)
        self.plan = plan = proj_plan(
            B, Lq, Lk, D, HD, need_dx, need_dy, ds is not None,
            "bf16" if dtype == torch.bfloat16 else "tf32x3")
        self.dtype = dtype
        self.scratch = torch.empty(plan.scratch_floats, **f32)
        self.dev, self.shape = dev, (B, Lq, Lk, D, num_heads)
        dh = HD // num_heads
        self.proj_fn = _entry(self.lib, "fused_qkv_mha_bwd_proj", dtype)
        self.reduce_fn = _entry(self.lib, "fused_qkv_mha_bwd_reduce", dtype)

        def ptr(t):
            return None if t is None else t.data_ptr()

        wargs = []
        for w in (wq, wk, wv):
            wargs += [w.data_ptr(), w.stride(0), w.stride(1)]
        self.proj_args = (
            [x.data_ptr(), y.data_ptr(), *wargs, dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), ptr(self.dx), ptr(self.dy),
             self.scratch.data_ptr(),
             _ints(_LL, [w.stride(0) for w in self.dws]),
             _ints(_LL, [w.stride(1) for w in self.dws]),
             _ints(_I, plan.splits), _ints(_I, plan.kc),
             _ints(_LL, plan.wofs), _ints(_LL, plan.bofs), ptr(ds),
             ptr(self.dbias)], [B, Lq, Lk, D, num_heads, dh])
        self.reduce_args = [
            self.scratch.data_ptr(),
            *[t.data_ptr() for t in self.dws + self.dbs],
            _ints(_I, plan.splits), _ints(_LL, plan.wofs),
            _ints(_LL, plan.bofs), D, num_heads, dh]

    def launch(self, part: Optional[str] = None) -> None:
        if part is not None and part not in PROJ_PARTS:
            raise ValueError(f"part: one of {PROJ_PARTS}, got {part!r}")
        with torch.cuda.device(self.dev):
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            rc = 0
            if part != "reduce":
                group = {"dwq": "dw", "dwk": "dw", "dwv": "dw"}
                jobs = [j for j in self.plan.jobs
                        if part in (None, group.get(j.name, j.name))]
                head, dims = self.proj_args
                rc = self.proj_fn(
                    *head, _ints(_I, [JOB_IDS[j.name] for j in jobs]),
                    len(jobs), sum(j.blocks for j in jobs), *dims, stream)
            if rc == 0 and part in (None, "reduce"):
                rc = self.reduce_fn(*self.reduce_args, stream)
        if rc != 0:
            B, Lq, Lk, D, _ = self.shape
            raise RuntimeError(f"fused_qkv_mha_bwd_proj kernel launch "
                               f"failed: CUDA error {rc} (B={B}, Lq={Lq}, "
                               f"Lk={Lk}, D={D})")


def projection_backward(x, y, wq, wk, wv, dq, dk, dv, ds=None,
                        num_heads: int = 12, need_dx: bool = True,
                        need_dy: bool = True):
    """Kernel (b) of the backward on CUDA tensors: dx = dq Wq^T,
    dy = dk Wk^T + dv Wv^T, the weight gradients (each in the layout of its
    weight argument, so a `lin.weight.t()` argument gets the transposed
    view of a contiguous [H*dh, D] gradient), the bias gradients, and,
    given ds, its sum over the heads [B, 1, Lq, Lk].  dx (dy) is None when
    `need_dx` (`need_dy`) is false."""
    call = ProjectionBackward(x, y, wq, wk, wv, dq, dk, dv, ds, num_heads,
                              need_dx, need_dy)
    try:
        call.launch()
    finally:
        projection_backward.launches += 1
    if call.dtype == torch.bfloat16:
        _count(bf16_core_routes, call.lib.fused_qkv_mha_bwd_bf16_route())
    return call.dx, call.dy, call.dws, call.dbs, call.dbias


def _gemm_core(name, dtype, a, b, bias, splits):
    """One launch of the GEMM core of `dtype` alone (the C entry
    `fused_qkv_mha_bwd_gemm` or its `_bf16`), for `gemm_tf32x3` and
    `gemm_bf16`."""
    if a.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors")
    M, K = a.shape
    N = b.shape[1]
    S, kc = split_depth(
        K, splits, CHUNK["bf16" if dtype == torch.bfloat16 else "tf32x3"])
    for t in (a, b) + (() if bias is None else (bias,)):
        if t.device != a.device or t.dtype != dtype:
            raise ValueError(f"{name}: needs {dtype} on one card")
    if bias is not None and not bias.is_contiguous():
        raise ValueError(f"{name}: bias must be contiguous")
    f32 = dict(device=a.device, dtype=torch.float32)
    c = torch.empty((S, M, N), **f32)
    colsum = torch.empty((S, N), **f32)
    with torch.cuda.device(a.device):
        rc = _entry(_bwd_lib(), "fused_qkv_mha_bwd_gemm", dtype)(
            a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(),
            None if bias is None else bias.data_ptr(), c.data_ptr(),
            colsum.data_ptr(), M, N, K, S, kc,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} (M={M}, "
                           f"N={N}, K={K}, S={S})")
    return c, colsum


def gemm_tf32x3(a, b, bias=None, splits: int = 1):
    """The backward's GEMM core alone: a [M, K] and b [K, N] float32 in any
    strides, the depth cut as `bwd_plan.split_depth(K, splits)` does ->
    (c [S, M, N], colsum [S, N]): slice s's share of a b (+ bias [N]) and of
    the column sums of b.  On the card one launch of
    `fused_qkv_mha_bwd_gemm` (3xTF32 tensor-core products).  Card only:
    nothing in the package calls it, so it has no plain version."""
    out = _gemm_core("gemm_tf32x3", torch.float32, a, b, bias, splits)
    gemm_tf32x3.launches += 1
    return out


def gemm_bf16(a, b, bias=None, splits: int = 1):
    """`gemm_tf32x3` for the bf16 core: a, b and the bias in bf16, c and
    colsum in float32 (bf16 products, float32 sums), the depth cut into
    whole 64-deep chunks (`split_depth(K, splits, TILE_K_BF16)`); the
    launch is counted in `bf16_core_routes` too.  Card only."""
    out = _gemm_core("gemm_bf16", torch.bfloat16, a, b, bias, splits)
    gemm_bf16.launches += 1
    _count(bf16_core_routes, _bwd_lib().fused_qkv_mha_bwd_bf16_route())
    return out


def backward_needs(needs_input_grad, bias, num_heads: int):
    """What the backward computes, from autograd's `needs_input_grad` over
    FusedQKVMHA's inputs (x, y, wq, bq, wk, bk, wv, bv, bias, ...):
    (need_dx, need_dy, need_bias, per_head).  dx (dy) only when x (y)
    needs a gradient, so a stride-0 bank of the causal configuration gets
    none; the bias gradient only for a bias that needs one, per head when
    the bias has a head dimension of num_heads, else summed over them."""
    need_bias = bias is not None and bool(needs_input_grad[8])
    per_head = need_bias and bias.dim() == 4 and bias.shape[1] == num_heads
    return (bool(needs_input_grad[0]), bool(needs_input_grad[1]), need_bias,
            per_head)


class FusedQKVMHA(torch.autograd.Function):
    """Forward kernel, and the two backward kernels as its gradient.  dx,
    dy and the bias gradient are computed only when autograd asks for them
    (None otherwise), the bias gradient summed down to the caller's
    broadcast shape."""

    @staticmethod
    def forward(ctx, x, y, wq, bq, wk, bk, wv, bv, bias, seed, num_heads,
                dropout_rate):
        out = forward_kernel(x, y, wq, bq, wk, bk, wv, bv, bias, num_heads,
                             dropout_rate, seed)
        ctx.save_for_backward(x, y, wq, bq, wk, bk, wv, bv, bias, seed)
        ctx.num_heads, ctx.dropout_rate = num_heads, dropout_rate
        return out

    @staticmethod
    def backward(ctx, dout):
        x, y, wq, bq, wk, bk, wv, bv, bias, seed = ctx.saved_tensors
        H = ctx.num_heads
        need_dx, need_dy, need_bias, per_head = backward_needs(
            ctx.needs_input_grad, bias, H)
        dq, dk, dv, ds = attention_backward(
            x, y, wq, bq, wk, bk, wv, bv, bias, seed, dout, H,
            ctx.dropout_rate, need_ds=need_bias)
        dx, dy, (dwq, dwk, dwv), (dbq, dbk, dbv), dbias = \
            projection_backward(x, y, wq, wk, wv, dq, dk, dv,
                                ds if need_bias and not per_head else None,
                                H, need_dx=need_dx, need_dy=need_dy)
        if need_bias:
            dbias = (ds if per_head else dbias).sum_to_size(bias.shape) \
                .to(bias.dtype)
        return (dx, dy, dwq, dbq, dwk, dbk, dwv, dbv, dbias, None, None,
                None)


def fused_qkv_mha(x, y, wq, bq, wk, bk, wv, bv, bias=None,
                  num_heads: int = 12, dropout_rate: float = 0.0,
                  seed: Optional[torch.Tensor] = None):
    """Signature and layout of `pallas_fused_qkv_mha`: x [B, Lq, D],
    y [B, Lk, D], weights [D, H*dh] (+ biases [H*dh]), additive bias
    broadcastable to [B, {1,H}, Lq, Lk], per-row int32 seeds [B] for the
    attention-probability dropout at `dropout_rate` -> [B, Lq, H*dh].
    Differentiable in every tensor input but the seeds.

    A weight may be the transposed view of a torch Linear weight
    (`lin.weight.t()`): the kernels read it through its strides."""
    if x.device.type == "cpu":
        return fused_qkv_mha_plain(x, y, wq, bq, wk, bk, wv, bv, bias,
                                   num_heads, dropout_rate, seed)
    return FusedQKVMHA.apply(x, y, wq, bq, wk, bk, wv, bv, bias, seed,
                             num_heads, float(dropout_rate))


# kernel launches since the last reset; the plain path does not count
fused_qkv_mha.launches = 0
gemm_tf32x3.launches = 0
gemm_bf16.launches = 0
attention_backward.launches = 0
projection_backward.launches = 0
mha.launches = 0
