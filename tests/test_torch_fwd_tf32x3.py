"""The forward kernels' arithmetic on the tensor cores, modelled in numpy,
against the JAX package's forward kernels.

`csrc/fused_qkv_mha.cu` (K1) projects q, k and v with the GEMM jobs of
`csrc/qkv_proj.cuh` and runs the attention core `csrc/attn_fwd.cuh`, which
`csrc/mha.cu` (K3) runs alone; every product is TF32 in the 3xTF32 split
(`csrc/gemm_tf32x3.cuh`, modelled by `mm3` of test_torch_tf32x3.py): the
projections over D, the scores q k^T over dh and p v over the keys, each
8-deep step adding small*big, big*small and big*big to a float32
accumulator.  The softmax is float32 in the plain version's order (scale,
bias, row max, exponentials, sum, division), then the keep mask of
`csrc/dropout_hash.cuh` at each (b, h, q, k), modelled here by
`dropout_bits` in numpy uint32 arithmetic.  The model rounds every sum to
nearest; the tensor cores round the sums inside a wgmma toward zero, a
drift over the projections' depth that only the card shows (chip_smoke.py
holds it to the same gates).

The model is held to `pallas_fused_qkv_mha` and `pallas_mha` run in
interpret mode (`_fa_fwd_kernel`, `_mha_kernel`) within the gates the card
holds the kernels to, atol 1e-4 + rtol 1e-3 |ref|, at the plain
configuration's shapes, the causal configuration's and ragged ones (Lq 1,
63, 65; Lk up to 200).  The same model with one TF32 product per step
(1xTF32) is recorded, not gated, as `tf32x1_worst`.  Dropout cannot be
compared with JAX (its mask is the TPU's own bits): the model's mask is
held equal to `ops.dropout.keep_mask`, and the model with dropout to the
port's plain version."""
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vln_goat_tpu.ops.attention import pallas_fused_qkv_mha, pallas_mha
from vln_goat_tpu_torch.ops.attention import fused_qkv_mha_plain
from vln_goat_tpu_torch.ops.dropout import keep_mask, keep_threshold
from test_torch_tf32x3 import mm1, mm3

B, H, DH, D = 2, 2, 64, 96
HD = H * DH
ATOL, RTOL = 1e-4, 1e-3


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _word(h, w):
    w = w * np.uint32(0xcc9e2d51)
    w = _rotl(w, 15) * np.uint32(0x1b873593)
    h = _rotl(h ^ w, 13)
    return h * np.uint32(5) + np.uint32(0xe6546b64)


def dropout_bits(seed, b, h, q, k):
    """`dropout_bits` of dropout_hash.cuh in numpy uint32 arithmetic
    (broadcast over its arguments)."""
    with np.errstate(over="ignore"):
        x = _word(np.uint32(seed), np.uint32(b))
        for w in (h, q, k):
            x = _word(x, np.uint32(w))
        x = x ^ np.uint32(16)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85ebca6b)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xc2b2ae35)
        return x ^ (x >> np.uint32(16))


def model_mask(seeds, Lq, Lk, rate):
    """The keep mask [B, H, Lq, Lk] the forward kernel draws."""
    seeds = np.asarray(seeds).astype(np.int64) & 0xFFFFFFFF
    bits = dropout_bits(seeds[:, None, None, None].astype(np.uint32),
                        np.arange(B)[:, None, None, None],
                        np.arange(H)[None, :, None, None],
                        np.arange(Lq)[None, None, :, None],
                        np.arange(Lk)[None, None, None, :])
    return bits >= np.uint32(keep_threshold(rate))


def attend_model(mm, q, k, v, bias, keep=None, rate=0.0):
    """attn_fwd.cuh over q [B, Lq, H, dh], k / v [B, Lk, H, dh] ->
    [B, Lq, H*dh], every product through `mm`."""
    Lq = q.shape[1]
    scale = np.float32(1.0 / math.sqrt(DH))
    out = np.zeros((B, Lq, H, DH), np.float32)
    for b in range(B):
        for h in range(H):
            s = mm(q[b, :, h], k[b, :, h].T) * scale
            if bias is not None:
                s = s + bias[b, h if bias.shape[1] == H else 0]
            e = np.exp(s - s.max(1, keepdims=True))
            p = e / e.sum(1, keepdims=True)
            if keep is not None:
                p = np.where(keep[b, h], p * np.float32(1.0 / (1.0 - rate)),
                             np.float32(0.0))
            out[b, :, h] = mm(p, v[b, :, h])
    return out.reshape(B, Lq, HD)


def k1_model(mm, x, y, wq, bq, wk, bk, wv, bv, bias, keep=None, rate=0.0):
    """fused_qkv_mha.cu: the three projection jobs, then attn_fwd.cuh."""
    Lq, Lk = x.shape[1], y.shape[1]
    xf, yf = x.reshape(-1, D), y.reshape(-1, D)
    q = (mm(xf, wq) + bq).reshape(B, Lq, H, DH)
    k = (mm(yf, wk) + bk).reshape(B, Lk, H, DH)
    v = (mm(yf, wv) + bv).reshape(B, Lk, H, DH)
    return attend_model(mm, q, k, v, bias, keep, rate)


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


def _inputs(rng, Lq, Lk):
    args = [rng.standard_normal((B, Lq, D)).astype(np.float32),
            rng.standard_normal((B, Lk, D)).astype(np.float32)]
    for _ in range(3):
        args += [(rng.standard_normal((D, HD)) / math.sqrt(D))
                 .astype(np.float32),
                 (rng.standard_normal(HD) * 0.02).astype(np.float32)]
    return args


def _worst(got, ref):
    """Largest |got - ref| over the card's gate, atol + rtol |ref|."""
    ref = np.asarray(ref)
    return float((np.abs(got - ref) / (ATOL + RTOL * np.abs(ref))).max())


# (Lq, Lk, bias): the plain configuration's text, map and local
# self-attention; the causal configuration's cross-attention to the banks
# and the front-door self-attention under a key mask; ragged query tiles
# and keys past one 64-key chunk, up to R2R's text cap
K1_CASES = [(60, 60, "key"), (50, 50, "full"), (54, 54, "key"),
            (50, 50, "heads"), (60, 36, None), (54, 24, None),
            (1, 200, "key"), (63, 65, "full"), (65, 200, None)]


@pytest.mark.parametrize("Lq,Lk,kind", K1_CASES)
def test_3xtf32_forward_within_card_gates(rng, record_property, Lq, Lk,
                                          kind):
    args = _inputs(rng, Lq, Lk)
    bias = _bias(rng, kind, Lq, Lk)
    ref = pallas_fused_qkv_mha(*map(jnp.asarray, args),
                               None if bias is None else jnp.asarray(bias),
                               num_heads=H, interpret=True)
    got = k1_model(mm3, *args, bias)
    assert got.shape == ref.shape
    worst3 = _worst(got, ref)
    worst1 = _worst(k1_model(mm1, *args, bias), ref)
    record_property("tf32x3_worst", worst3)
    record_property("tf32x1_worst", worst1)
    print(f"3xTF32 {worst3:.3f}, 1xTF32 {worst1:.3f} of the card's gate")
    assert worst3 <= 1.0


@pytest.mark.parametrize("Lq,Lk,kind", [
    (16, 16, None), (24, 40, "key"), (12, 12, "heads"), (50, 60, "key"),
    (1, 63, None), (65, 200, "key")])
def test_3xtf32_attention_only_within_card_gates(rng, record_property, Lq,
                                                 Lk, kind):
    q, k, v = (rng.standard_normal((B, L, H, DH)).astype(np.float32)
               for L in (Lq, Lk, Lk))
    bias = _bias(rng, kind, Lq, Lk)
    ref = pallas_mha(*map(jnp.asarray, (q, k, v)),
                     None if bias is None else jnp.asarray(bias),
                     interpret=True)
    got = attend_model(mm3, q, k, v, bias)
    worst3 = _worst(got, ref)
    record_property("tf32x3_worst", worst3)
    record_property("tf32x1_worst", _worst(attend_model(mm1, q, k, v, bias),
                                           ref))
    assert worst3 <= 1.0


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_model_mask_is_the_plain_versions(rate):
    """The model's keep mask (dropout_hash.cuh in numpy) is bit for bit
    `ops.dropout.keep_mask`, at seeds that use the sign bit."""
    seeds = np.array([-7, 2 ** 31 - 1], np.int32)
    got = model_mask(seeds, 65, 200, rate)
    ref = keep_mask(torch.from_numpy(seeds), (B, H, 65, 200), rate)
    assert np.array_equal(got, ref.numpy())
    assert abs(got.mean() - (1 - rate)) < 0.02


@pytest.mark.parametrize("Lq,Lk,kind", [(60, 60, "key"), (63, 200, "full")])
def test_3xtf32_dropout_forward_matches_plain(rng, Lq, Lk, kind):
    """With dropout the model, its mask from dropout_hash.cuh, against the
    port's plain version (which the card holds the kernel to) within the
    card's gates."""
    args = _inputs(rng, Lq, Lk)
    bias = _bias(rng, kind, Lq, Lk)
    seeds = rng.integers(0, 2 ** 31 - 1, B).astype(np.int32)
    keep = model_mask(seeds, Lq, Lk, 0.1)
    got = k1_model(mm3, *args, bias, keep, 0.1)
    ref = fused_qkv_mha_plain(
        *map(torch.from_numpy, args),
        None if bias is None else torch.from_numpy(bias), num_heads=H,
        dropout_rate=0.1, seed=torch.from_numpy(seeds)).numpy()
    assert _worst(got, ref) <= 1.0
