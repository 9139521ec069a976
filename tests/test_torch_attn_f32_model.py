"""Numpy models of two attention-forward arithmetics of the port, held to
the JAX package's Pallas kernels in interpret mode and to float64.

1. The float32 attention forward core, `ops/csrc/attn_fwd.cuh` (the
   float32 K1's attention and the float32 K3), in its stated order: per
   64-row query tile, keys in blocks of KB (read out of the header).  Up
   to KB keys one block holds the whole row: p = exp(s - max) / sum, then
   p v.  Past it the row's max m and sum l run over the blocks: a block's
   p = exp(s - m) unnormalised, the accumulator rescaled by
   exp(m_old - m_new) before the block's p v, and times 1 / l after the
   last block.  Held against `pallas_fused_qkv_mha(..., interpret=True)`
   in float32 at atol 2e-5 / rtol 1e-4 (tests/test_torch_attention.py's:
   sums in another order), at key lengths on both sides of KB, and with
   a first key block masked off for some rows (the rescale by a factor
   of about e^-10000); and at head width 256, whose instance takes key
   blocks of KB_WIDER (64: shared memory), so that every key length past
   64 runs the online softmax.

2. The bf16 K3 (`mha_fwd_bf16` of `ops/csrc/mha.cu` on the forward core
   of `attn_fwd_sm90.cuh`): 64-key tiles, online max and sum, e =
   exp(s - m) entering p v as two bf16 terms (e_hi + e_lo, 16 bits of e)
   or, in the control `mha_fwd_bf16_one_term`, as one bf16 rounding of e.
   The TPU kernel `_mha_kernel` keeps p in float32 and rounds only the
   output, so the card holds the bf16 K3 to one output rounding of the
   float64 function: |out - ref| <= 2^-8 |ref| + 2^-14 sum_k p |v|
   elementwise (the second term the float32 sums' own error, with room).
   The model with two terms meets that; the control must not, or the
   check could not tell the two apart."""
import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp

from vln_goat_tpu.ops.attention import pallas_fused_qkv_mha

CSRC = (Path(__file__).resolve().parent.parent / "vln_goat_tpu_torch" / "ops"
        / "csrc")
F = np.float32


def _header_int(name, header):
    m = re.search(rf"^constexpr int {name} = (\d+);",
                  (CSRC / header).read_text(), re.M)
    return int(m.group(1))


KB, TQ = _header_int("KB", "attn_fwd.cuh"), _header_int("TQ", "attn_fwd.cuh")
KB_WIDER = _header_int("KB_WIDER", "attn_fwd.cuh")
TILE = _header_int("TILE", "attn_sm90.cuh")
B, H, DH = 2, 2, 64
D = H * DH


def bf16(a):
    """a rounded to bf16 (to nearest, ties to even), as float32."""
    u = np.ascontiguousarray(a, F).view(np.uint32)
    u = (u + (((u >> 16) & 1) + 0x7FFF)) & 0xFFFF0000
    return u.view(F)


def f32_forward_model(q, k, v, bias, scale, KB=KB):
    """attn_fwd.cuh over q [B, Lq, H, dh], k, v [B, Lk, H, dh], bias
    [B, Hb, Lq, Lk], in float32, in key blocks of KB."""
    Lq, Lk, H, DH = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    out = np.zeros(q.shape, F)
    nblk = -(-Lk // KB)
    for b in range(B):
        for h in range(H):
            hb = h if bias.shape[1] == H else 0
            for q0 in range(0, Lq, TQ):
                qt = q[b, q0:q0 + TQ, h]
                m = np.full(len(qt), -np.inf, F)
                l = np.zeros(len(qt), F)
                acc = np.zeros((len(qt), DH), F)
                for k0 in range(0, Lk, KB):
                    s = (qt @ k[b, k0:k0 + KB, h].T) * F(scale) \
                        + bias[b, hb, q0:q0 + TQ, k0:k0 + KB]
                    if nblk == 1:
                        e = np.exp(s - s.max(1, keepdims=True))
                        p = e / e.sum(1, keepdims=True, dtype=F)
                    else:
                        m_new = np.maximum(m, s.max(1))
                        alpha = np.where(m == -np.inf, F(0),
                                         np.exp(m - m_new))
                        p = np.exp(s - m_new[:, None])
                        l = l * alpha + p.sum(1, dtype=F)
                        acc = acc * alpha[:, None]
                        m = m_new
                    acc = acc + p @ v[b, k0:k0 + KB, h]
                if nblk > 1:
                    acc = acc * (F(1) / l)[:, None]
                out[b, q0:q0 + TQ, h] = acc
    return out


def _f32_case(rng, Lq, Lk, kind, KB=KB, H=H, D=D):
    x = rng.standard_normal((B, Lq, D)).astype(F)
    y = rng.standard_normal((B, Lk, D)).astype(F)
    ws = []
    for _ in range(3):
        ws += [(rng.standard_normal((D, D)) / np.sqrt(D)).astype(F),
               (rng.standard_normal(D) * 0.1).astype(F)]
    mask = rng.random((B, Lk)) < 0.8
    mask[:, 0] = True
    if kind == "masked_first_block":
        # batch row 0 sees no key of the first block
        mask[0, :KB] = False
        mask[0, KB] = True
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :] \
        + np.zeros((B, 1, Lq, 1))
    if kind == "heads":
        bias = bias + rng.standard_normal((B, H, Lq, Lk))
    return x, y, ws, bias.astype(F)


def test_model_reads_the_header():
    assert KB == 256 and TQ == 64 and TILE == 64
    # past 128 columns the instances take the narrower key blocks
    assert KB_WIDER == 64 and "DH > 128 ? KB_WIDER" in \
        (CSRC / "attn_fwd.cuh").read_text()


@pytest.mark.parametrize("Lq,Lk,kind", [
    (70, 60, "key"), (70, 256, "heads"), (70, 257, "key"),
    (40, 300, "heads"), (40, 520, "key"), (40, 600, "masked_first_block")])
def test_f32_model_matches_pallas(rng, Lq, Lk, kind):
    x, y, ws, bias = _f32_case(rng, Lq, Lk, kind)
    ref = np.asarray(pallas_fused_qkv_mha(
        *(jnp.asarray(t) for t in (x, y, *ws)), jnp.asarray(bias),
        num_heads=H, interpret=True))
    wq, bq, wk, bk, wv, bv = ws
    q, k, v = (t.reshape(B, -1, H, DH) for t in
               (x @ wq + bq, y @ wk + bk, y @ wv + bv))
    out = f32_forward_model(q, k, v, bias, 1.0 / np.sqrt(DH))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out.reshape(B, Lq, D), ref, atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("Lq,Lk,kind", [
    (70, 54, "key"), (70, 64, "heads"), (70, 65, "key"), (40, 130, "heads"),
    (40, 200, "masked_first_block")])
def test_f32_model_at_256_columns_matches_pallas(rng, Lq, Lk, kind):
    """One head of 256 over D = 256, in key blocks of KB_WIDER."""
    x, y, ws, bias = _f32_case(rng, Lq, Lk, kind, KB_WIDER, 1, 256)
    ref = np.asarray(pallas_fused_qkv_mha(
        *(jnp.asarray(t) for t in (x, y, *ws)), jnp.asarray(bias),
        num_heads=1, interpret=True))
    wq, bq, wk, bk, wv, bv = ws
    q, k, v = (t.reshape(B, -1, 1, 256) for t in
               (x @ wq + bq, y @ wk + bk, y @ wv + bv))
    out = f32_forward_model(q, k, v, bias, 1.0 / 16.0, KB_WIDER)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out.reshape(B, Lq, 256), ref, atol=2e-5,
                               rtol=1e-4)


def bf16_mha_model(q, k, v, bias, scale, split):
    """The bf16 K3 over bf16 q [B, Lq, H, dh], k, v [B, Lk, H, dh] and a
    float32 bias [B, H, Lq, Lk]: e in two bf16 terms (`split`) or one."""
    Lq, Lk = q.shape[1], k.shape[1]
    out = np.zeros(q.shape, F)
    for b in range(B):
        for h in range(H):
            m = np.full(Lq, -np.inf, F)
            l = np.zeros(Lq, F)
            o = np.zeros((Lq, DH), F)
            for k0 in range(0, Lk, TILE):
                s = (q[b, :, h] @ k[b, k0:k0 + TILE, h].T) * F(scale) \
                    + bias[b, h, :, k0:k0 + TILE]
                m_new = np.maximum(m, s.max(1))
                alpha = np.where(m == -np.inf, F(0), np.exp(m - m_new))
                e = np.exp(s - m_new[:, None])
                l = l * alpha + e.sum(1, dtype=F)
                hi = bf16(e)
                vt = v[b, k0:k0 + TILE, h]
                o = o * alpha[:, None] + hi @ vt
                if split:
                    o = o + bf16(e - hi) @ vt
                m = m_new
            out[b, :, h] = bf16(o * (F(1) / l)[:, None])
    return out


def rounding_excess(out, q, k, v, bias, scale):
    """The largest |out - ref| over its allowance, one output rounding of
    the float64 function plus 2^-14 of sum_k p |v| (as chip_smoke.py
    `mha_rounding_excess`)."""
    q, k, v, bias = (t.astype(np.float64) for t in (q, k, v, bias))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale + bias
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("bhqk,bkhd->bqhd", p, v)
    mag = np.einsum("bhqk,bkhd->bqhd", p, np.abs(v))
    return float((np.abs(out - ref)
                  / (2.0 ** -8 * np.abs(ref) + 2.0 ** -14 * mag)).max())


@pytest.mark.parametrize("Lq,Lk,kind", [
    (16, 16, "none"), (24, 40, "key"), (50, 60, "key"), (20, 300, "key"),
    (40, 520, "heads")])
def test_split_p_meets_one_rounding_and_one_term_does_not(rng, Lq, Lk, kind):
    q, k, v = (bf16(rng.standard_normal((B, L, H, DH)))
               for L in (Lq, Lk, Lk))
    bias = np.zeros((B, H, Lq, Lk), F)
    if kind == "key":
        mask = rng.random((B, Lk)) < 0.85
        mask[:, 0] = True
        bias += ((1.0 - mask) * -10000.0)[:, None, None, :].astype(F)
    elif kind == "heads":
        bias += rng.standard_normal((B, H, Lq, Lk)).astype(F)
    scale = 1.0 / np.sqrt(DH)
    two = rounding_excess(bf16_mha_model(q, k, v, bias, scale, True),
                          q, k, v, bias, scale)
    one = rounding_excess(bf16_mha_model(q, k, v, bias, scale, False),
                          q, k, v, bias, scale)
    assert two <= 1.0 < one, (two, one)
