"""F6: any head width and any model width (up to 128 here; the widths
past it in tests/test_torch_f6_wide.py).

On the card the wrappers zero-pad a head width outside (32, 64, 128) to
the next of them and D to a multiple of 32 (`padded_call`, `mha_padded`):
each head's q / k / v columns and D's extra rows of the weights are zero,
the scale is the true head width's, and the padded output columns are
sliced off.  Here the same pad and slice run around the plain versions
(what the kernels compute) and are held to the unpadded plain version
(forward and gradients, float32 atol 1e-6 / rtol 1e-5: the zero columns add
exact zeros, only the order of a sum over the padded D may change; with
dropout too, whose mask does not depend on the head width) and to the JAX
package's Pallas kernels in interpret mode, which take these widths
unpadded (atol 2e-5 / rtol 1e-4 forward, gradients at 1e-5 of each
gradient's largest magnitude / rtol 1e-3, as test_torch_head_width.py).
The kernels themselves at these widths run on the card (chip_smoke.py
phase (m))."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.ops.attention import pallas_fused_qkv_mha, pallas_mha
from vln_goat_tpu_torch.ops.attention import (fused_qkv_mha_plain,
                                              mha_padded, mha_plain,
                                              padded_call, padded_widths)

B, LQ, LK = 2, 20, 24
ATOL, RTOL = 2e-5, 1e-4
# (model width D, heads): head widths 16, 48, 96, 20 (D 100) and 40
# (D 200, 5 heads: chip_smoke.py phase (m))
SHAPES = [(96, 6), (96, 2), (192, 2), (100, 5), (200, 5)]


def _args(rng, D, heads):
    x = rng.standard_normal((B, LQ, D)).astype(np.float32)
    y = rng.standard_normal((B, LK, D)).astype(np.float32)
    ws = [(rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
          for _ in range(3)]
    bs = [(rng.standard_normal(D) * 0.02).astype(np.float32)
          for _ in range(3)]
    keep = rng.random((B, LK)) < 0.8
    keep[:, 0] = True
    bias = ((1.0 - keep) * -10000.0).astype(np.float32)[:, None, None, :]
    bias = bias + rng.standard_normal((B, heads, LQ, LK)).astype(np.float32)
    return [x, y, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], bias]


def _grads(out, args, dout):
    return torch.autograd.grad(out, args, torch.from_numpy(dout))


@pytest.mark.parametrize("D,heads", SHAPES)
def test_padded_widths(D, heads):
    Dp, dp = padded_widths(D, D // heads)
    assert Dp % 32 == 0 and Dp - 32 < D <= Dp
    assert dp in (32, 64, 128) and dp >= D // heads
    assert dp // 2 < D // heads or dp == 32


def test_past_128_raises():
    """Past 128 nothing raises any more: a head width is padded to the next
    width the kernels take, an instance up to 256 and past it a multiple of
    64 that the wide-head core takes as it is
    (tests/test_torch_f6_wide.py)."""
    assert padded_widths(768, 128) == (768, 128)
    assert padded_widths(768, 192) == (768, 192)
    assert padded_widths(800, 160) == (800, 192)
    assert padded_widths(780, 130) == (800, 192)
    assert padded_widths(1568, 224) == (1568, 256)
    assert padded_widths(1600, 320) == (1600, 320)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("D,heads", SHAPES)
def test_pad_matches_unpadded_plain(rng, D, heads, rate):
    args = _args(rng, D, heads)
    dout = rng.standard_normal((B, LQ, D)).astype(np.float32)
    seed = torch.tensor([11, 12], dtype=torch.int32) if rate else None
    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    ref = fused_qkv_mha_plain(*ta, num_heads=heads, dropout_rate=rate,
                              seed=seed)
    gref = _grads(ref, ta, dout)
    tb = [torch.from_numpy(a).requires_grad_() for a in args]
    got = padded_call(fused_qkv_mha_plain, *tb, num_heads=heads,
                      dropout_rate=rate, seed=seed)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               atol=1e-6, rtol=1e-5)
    for i, (g, r) in enumerate(zip(_grads(got, tb, dout), gref)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=f"argument {i}")


@pytest.mark.parametrize("D,heads", SHAPES)
def test_pad_matches_pallas(rng, D, heads):
    args = _args(rng, D, heads)
    dout = rng.standard_normal((B, LQ, D)).astype(np.float32)

    def jfn(*a):
        return pallas_fused_qkv_mha(*a, num_heads=heads, interpret=True)

    ref, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    jgrads = vjp(jnp.asarray(dout))
    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    out = padded_call(fused_qkv_mha_plain, *ta, num_heads=heads)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    for i, (g, r) in enumerate(zip(_grads(out, ta, dout), jgrads)):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        if i == 5:
            # the key bias's gradient is zero up to rounding: at dWk's scale
            scale = max(scale, float(np.abs(np.asarray(jgrads[4])).max()))
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * scale,
                                   rtol=1e-3, err_msg=f"argument {i}")


@pytest.mark.parametrize("dh", [16, 48, 96, 40])
def test_mha_pad_matches_plain_and_pallas(rng, dh):
    heads = 3
    q, k, v = (rng.standard_normal((B, L, heads, dh)).astype(np.float32)
               for L in (LQ, LK, LK))
    keep = rng.random((B, LK)) < 0.8
    keep[:, 0] = True
    bias = ((1.0 - keep) * -10000.0).astype(np.float32)[:, None, None, :]
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    got = mha_padded(mha_plain, *t)
    np.testing.assert_allclose(got.numpy(), mha_plain(*t).numpy(),
                               atol=1e-6, rtol=1e-5)
    ref = pallas_mha(*(jnp.asarray(a) for a in (q, k, v)),
                     bias=jnp.asarray(bias), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(
        got.shape), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D,heads", [(96, 2), (100, 5)])
def test_pad_bf16_matches_unpadded_plain(rng, D, heads):
    """bf16 inputs: the padded call rounds where the unpadded one does
    (zeros are exact in bf16); the outputs agree to one bf16 rounding
    (2^-8 relative) of the float32 sums."""
    args = [torch.from_numpy(a).to(torch.bfloat16)
            for a in _args(rng, D, heads)]
    ref = fused_qkv_mha_plain(*args, num_heads=heads).float()
    got = padded_call(fused_qkv_mha_plain, *args, num_heads=heads).float()
    np.testing.assert_allclose(got.numpy(), ref.numpy(),
                               atol=2 ** -8 * float(ref.abs().max()),
                               rtol=2 ** -7)
