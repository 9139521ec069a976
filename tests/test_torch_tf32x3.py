"""The backward's arithmetic on the tensor cores, modelled in numpy, against
the JAX package's backward kernel.

`csrc/gemm_tf32x3.cuh` runs every product of the fused attention backward
(`csrc/fused_qkv_mha_bwd.cu`) as TF32 `mma.sync` in the 3xTF32 split: each
operand x is cut into big = tf32(x) and small = tf32(x - big), where
tf32 is `cvt.rna.tf32.f32` (round to nearest, ties away from zero, to 10
mantissa bits: add 0x1000 to the bits and clear the low 13), and each
8-deep step adds small*big, big*small and big*big to a float32
accumulator.  This file models that arithmetic, product by product as the
kernels take them (the recomputed projections, the five attention
products, dx, dy as one two-segment sum, the weight gradients split over
the rows in two slices added in order, the bias gradients as column sums),
and holds the result to `jax.grad` of `pallas_fused_qkv_mha` run in
interpret mode, which reaches `_fa_bwd_kernel`, within the gates the card
holds the kernels to: atol 1e-4 times each gradient's largest magnitude,
rtol 1e-3 (the key bias's gradient, zero up to rounding, at its weight's
scale).  The same model with one TF32 product (1xTF32) is recorded, not
gated, as `tf32x1_worst`: how far plain TF32 falls from those gates."""
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vln_goat_tpu.ops.attention import pallas_fused_qkv_mha

B, H, DH, D = 2, 2, 64, 96
HD = H * DH
NAMES = ("x", "y", "wq", "bq", "wk", "bk", "wv", "bv", "bias")
ATOL, RTOL = 1e-4, 1e-3
SLICES = 2


def tf32(x):
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def mm3(a, b):
    """a [M, K] b [K, N] as the kernels take it: per 8-deep step,
    acc += small*big, += big*small, += big*big, in float32."""
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32(a - ab), tf32(b - bb)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc = acc + as_[:, s] @ bb[s]
        acc = acc + ab[:, s] @ bs[s]
        acc = acc + ab[:, s] @ bb[s]
    return acc


def mm1(a, b):
    """The same with one TF32 product per step."""
    ab, bb = tf32(a), tf32(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        acc = acc + ab[:, k:k + 8] @ bb[k:k + 8]
    return acc


def split_k(mm, a, b):
    """a b over the rows in SLICES slices, partials added in order."""
    kc = -(-a.shape[1] // SLICES)
    out = mm(a[:, :kc], b[:kc])
    for s in range(1, SLICES):
        out = out + mm(a[:, s * kc:(s + 1) * kc], b[s * kc:(s + 1) * kc])
    return out


def col_sums(t):
    kc = -(-t.shape[0] // SLICES)
    out = t[:kc].sum(0, dtype=np.float32)
    for s in range(1, SLICES):
        out = out + t[s * kc:(s + 1) * kc].sum(0, dtype=np.float32)
    return out


def k2_model(mm, x, y, wq, bq, wk, bk, wv, bv, bias, dout):
    """The gradients K2 (a) and (b) compute, in NAMES order, with every
    product through `mm`; softmax and elementwise work in float32."""
    Lq, Lk = x.shape[1], y.shape[1]
    xf, yf = x.reshape(-1, D), y.reshape(-1, D)
    q = (mm(xf, wq) + bq).reshape(B, Lq, H, DH)
    k = (mm(yf, wk) + bk).reshape(B, Lk, H, DH)
    v = (mm(yf, wv) + bv).reshape(B, Lk, H, DH)
    do = dout.reshape(B, Lq, H, DH)
    scale = np.float32(1.0 / math.sqrt(DH))
    dq, dk, dv = (np.zeros_like(t) for t in (q, k, v))
    ds_all = np.zeros((B, H, Lq, Lk), np.float32)
    for b in range(B):
        for h in range(H):
            qh, kh, vh, oh = q[b, :, h], k[b, :, h], v[b, :, h], do[b, :, h]
            s = mm(qh, kh.T) * scale
            if bias is not None:
                s = s + bias[b, h if bias.shape[1] == H else 0]
            e = np.exp(s - s.max(1, keepdims=True))
            p = e / e.sum(1, keepdims=True)
            dp = mm(oh, vh.T)
            ds = p * (dp - (p * dp).sum(1, keepdims=True))
            ds_all[b, h] = ds
            dq[b, :, h] = mm(ds, kh) * scale
            dk[b, :, h] = mm(ds.T, qh) * scale
            dv[b, :, h] = mm(p.T, oh)
    dq, dk, dv = (t.reshape(-1, HD) for t in (dq, dk, dv))
    dx = mm(dq, wq.T).reshape(x.shape)
    dy = mm(np.concatenate([dk, dv], 1),
            np.concatenate([wk.T, wv.T], 0)).reshape(y.shape)
    out = [dx, dy, split_k(mm, xf.T, dq), col_sums(dq),
           split_k(mm, yf.T, dk), col_sums(dk), split_k(mm, yf.T, dv),
           col_sums(dv)]
    if bias is not None:
        if bias.shape[1] == H:
            db = ds_all
        else:
            db = ds_all.sum(1, keepdims=True, dtype=np.float32)
        out.append(db.sum(axis=tuple(i for i in range(4)
                                     if bias.shape[i] == 1),
                          keepdims=True).astype(np.float32))
    return out


def _bias(rng, kind, Lq, Lk):
    if kind is None:
        return None
    mask = rng.random((B, Lk)) < 0.8
    mask[:, 0] = True
    key = ((1.0 - mask) * -10000.0).astype(np.float32)[:, None, None, :]
    if kind == "key":
        return key
    hb = H if kind == "heads" else 1
    return key + rng.standard_normal((B, hb, Lq, Lk)).astype(np.float32)


def _worst(got, ref):
    """Largest |got - ref| over each gradient's gate, atol + rtol |ref|."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        if NAMES[i] == "bk":
            scale = max(scale, float(np.abs(np.asarray(ref[4])).max()))
        gate = ATOL * scale + RTOL * np.abs(r)
        worst = max(worst, float((np.abs(g - r) / gate).max()))
    return worst


@pytest.mark.parametrize("kind", [None, "key", "full", "heads"])
@pytest.mark.parametrize("Lq,Lk", [(20, 20), (12, 40)])
def test_3xtf32_backward_within_card_gates(rng, record_property, Lq, Lk,
                                           kind):
    args = [rng.standard_normal((B, Lq, D)).astype(np.float32),
            rng.standard_normal((B, Lk, D)).astype(np.float32)]
    for _ in range(3):
        args += [(rng.standard_normal((D, HD)) / math.sqrt(D))
                 .astype(np.float32),
                 (rng.standard_normal(HD) * 0.02).astype(np.float32)]
    bias = _bias(rng, kind, Lq, Lk)
    dout = rng.standard_normal((B, Lq, HD)).astype(np.float32)
    jargs = args + ([bias] if bias is not None else [])

    def jloss(*a):
        out = pallas_fused_qkv_mha(*a[:8], a[8] if len(a) > 8 else None,
                                   num_heads=H, interpret=True)
        return jnp.sum(out * dout)

    ref = jax.grad(jloss, argnums=tuple(range(len(jargs))))(
        *map(jnp.asarray, jargs))
    got = k2_model(mm3, *args, bias, dout)
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, name
    worst3 = _worst(got, ref)
    worst1 = _worst(k2_model(mm1, *args, bias, dout), ref)
    record_property("tf32x3_worst", worst3)
    record_property("tf32x1_worst", worst1)
    print(f"3xTF32 {worst3:.3f}, 1xTF32 {worst1:.3f} of the card's gate")
    assert worst3 <= 1.0
