"""F6 past 128: head widths 160, 192 and 256 (and 165 over a D of 330, not
a multiple of 32).

On the card head widths 192 and 256 run on tensor-core instances of every
attention core as they are; a width up to 256 that is not one of the
instances is zero-padded to the next (`padded_widths`: 160 and 165 go to
192, 224 to 256, D 330 to 352) by `padded_call` / `mha_padded` around it,
the scale the true width's; past 256 a multiple of 64 runs on the
wide-head core `ops/csrc/attn_wide.cuh` as it is, any other is padded to
the next multiple of 64.  Here the plain versions take both routes (the wrapper on a CPU
tensor, and `padded_call` around `fused_qkv_mha_plain`, what the card's
route computes around the kernel) and are held to the JAX package's Pallas
kernels in interpret mode, which take these widths unpadded:

- float32, forward and the gradients of every input: atol 2e-5 / rtol
  1e-4 forward, gradients at 1e-5 of each gradient's largest magnitude /
  rtol 1e-3 (test_torch_f6_widths.py); with dropout, the padded route
  against the unpadded plain version (the mask does not depend on the head
  width), 1e-6 / 1e-5;
- bf16: the output and every gradient within twice the JAX bf16 kernel's
  distance from its float32 run plus 1e-3 of the scale
  (test_torch_bf16_attention.py's gate);
- `mha` (K3): the padded and unpadded plain versions against `pallas_mha`
  in float32 (as above) and in bf16 (the output rounded once: 2^-8 of the
  scale).
The kernels themselves at these widths run on the card (chip_smoke.py
phase 3 (n))."""
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.ops.attention import pallas_fused_qkv_mha, pallas_mha
from vln_goat_tpu_torch.ops.attention import (HEAD_DIMS, WIDE_STEP,
                                              fused_qkv_mha,
                                              fused_qkv_mha_plain,
                                              mha_padded, mha_plain,
                                              on_wide_core, padded_call,
                                              padded_widths,
                                              takes_head_dim)
from test_torch_bf16_attention import _bf16_values, _gate
from test_torch_gate_witness import one_thread  # noqa: F401

B, LQ, LK = 2, 12, 20
ATOL, RTOL = 2e-5, 1e-4
# (D, heads): head widths 160, 192, 256, and 165 over D = 330
SHAPES = [(160, 1), (384, 2), (256, 1), (330, 2)]


def _args(rng, D, heads, bf16=False):
    f = _bf16_values if bf16 else (lambda a: a.astype(np.float32))
    x = f(rng.standard_normal((B, LQ, D)))
    y = f(rng.standard_normal((B, LK, D)))
    out = [x, y]
    for _ in range(3):
        out += [f(rng.standard_normal((D, D)) / np.sqrt(D)),
                f(rng.standard_normal(D) * 0.02)]
    keep = rng.random((B, LK)) < 0.8
    keep[:, 0] = True
    bias = ((1.0 - keep) * -10000.0)[:, None, None, :] + \
        rng.standard_normal((B, heads, LQ, LK))
    out.append(f(bias))
    return out


def _pallas(args, heads, dout, dtype=jnp.float32):
    def fn(*a):
        return pallas_fused_qkv_mha(*a, num_heads=heads, interpret=True)

    ref, vjp = jax.vjp(fn, *[jnp.asarray(a, dtype) for a in args])
    grads = vjp(jnp.asarray(dout, dtype))
    f64 = lambda t: np.asarray(t.astype(jnp.float32), np.float64)  # noqa
    return f64(ref), [f64(g) for g in grads]


def _routes(heads):
    """The wrapper (plain on the CPU) and the card's route around the
    kernel (the zero pad to a width the kernels take)."""
    return {"wrapper": lambda *a, **k: fused_qkv_mha(*a, num_heads=heads,
                                                     **k),
            "padded": lambda *a, **k: padded_call(
                fused_qkv_mha_plain, *a, num_heads=heads, **k)}


@pytest.mark.parametrize("D,heads", SHAPES)
def test_widths_the_kernels_take(D, heads):
    """Each of these widths runs on a tensor-core instance: 192 and 256 as
    they are, 160 and 165 padded to 192; none on the wide-head core."""
    dh = D // heads
    Dp, dp = padded_widths(D, dh)
    assert takes_head_dim(dp) and Dp % 32 == 0
    assert dp == dh if dh % 64 == 0 else dp == 192
    assert dp in HEAD_DIMS and not on_wide_core(dp)


@pytest.mark.parametrize("dh,dp,wide", [
    (160, 192, False), (192, 192, False), (200, 256, False),
    (224, 256, False), (256, 256, False), (257, 320, True),
    (320, 320, True), (384, 384, True)])
def test_pad_and_route_of_a_width(dh, dp, wide):
    """The width a head of dh runs at and its core: an instance up to 256
    (the next one), the wide-head core past 256 (the next multiple of
    64)."""
    assert padded_widths(1600, dh)[1] == dp
    assert takes_head_dim(dp) and takes_head_dim(dh) == (dh == dp)
    assert on_wide_core(dp) == wide and (dp in HEAD_DIMS) != wide


def test_head_dims_header_is_the_wrappers():
    """`head_dims.cuh` (whose `query` every library's `*_head_dims` entry
    reports, held to HEAD_DIMS + (WIDE_STEP,) by `_check_head_dims` at
    load): its instances, its wide step, and `wide` past the widest."""
    text = (Path(__file__).resolve().parent.parent / "vln_goat_tpu_torch"
            / "ops" / "csrc" / "head_dims.cuh").read_text()
    dims = re.search(r"DIMS\[COUNT\] = \{([^}]*)\}", text).group(1)
    assert tuple(int(d) for d in dims.split(",")) == HEAD_DIMS
    assert int(re.search(r"constexpr int COUNT = (\d+);", text).group(1)) \
        == len(HEAD_DIMS)
    assert int(re.search(r"constexpr int WIDE_STEP = (\d+);", text)
               .group(1)) == WIDE_STEP
    assert "return dh > DIMS[COUNT - 1] && dh % WIDE_STEP == 0;" in text


@pytest.mark.parametrize("route", ["wrapper", "padded"])
@pytest.mark.parametrize("D,heads", SHAPES)
def test_float32_matches_pallas(rng, D, heads, route):
    args = _args(rng, D, heads)
    dout = rng.standard_normal((B, LQ, D)).astype(np.float32)
    ref, jgrads = _pallas(args, heads, dout)
    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    out = _routes(heads)[route](*ta)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL,
                               rtol=RTOL)
    got = torch.autograd.grad(out, ta, torch.from_numpy(dout))
    for i, (g, r) in enumerate(zip(got, jgrads)):
        scale = float(np.abs(r).max())
        if i == 5:
            # the key bias's gradient is zero up to rounding: at dWk's scale
            scale = max(scale, float(np.abs(jgrads[4]).max()))
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * scale,
                                   rtol=1e-3, err_msg=f"argument {i}")


@pytest.mark.parametrize("D,heads", SHAPES)
def test_dropout_pad_matches_unpadded(rng, D, heads):
    args = _args(rng, D, heads)
    dout = torch.from_numpy(rng.standard_normal((B, LQ, D))
                            .astype(np.float32))
    seed = torch.tensor([5, 9], dtype=torch.int32)
    res = []
    for route in ("wrapper", "padded"):
        ta = [torch.from_numpy(a).requires_grad_() for a in args]
        out = _routes(heads)[route](*ta, dropout_rate=0.3, seed=seed)
        res.append([out] + list(torch.autograd.grad(out, ta, dout)))
    for i, (a, b) in enumerate(zip(*res)):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("route", ["wrapper", "padded"])
@pytest.mark.parametrize("D,heads", [(384, 2), (330, 2)])
def test_bf16_matches_pallas_bf16(rng, D, heads, route):
    args = _args(rng, D, heads, bf16=True)
    dout = _bf16_values(rng.standard_normal((B, LQ, D)))
    ref, rgrads = _pallas(args, heads, dout)
    j16, j16grads = _pallas(args, heads, dout, jnp.bfloat16)
    ta = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in args]
    out = _routes(heads)[route](*ta)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, ta,
                              torch.from_numpy(dout).to(torch.bfloat16))
    _gate("out", out.detach().double().numpy(), j16, ref,
          np.abs(ref).max())
    for i, g in enumerate(got):
        scale = np.abs(rgrads[4 if i == 5 else i]).max()
        _gate(f"argument {i}", g.double().numpy(), j16grads[i], rgrads[i],
              scale)


@pytest.mark.parametrize("dh", [160, 192, 256, 165])
def test_mha_matches_pallas(rng, dh):
    heads = 2
    q, k, v = (rng.standard_normal((B, L, heads, dh)).astype(np.float32)
               for L in (LQ, LK, LK))
    bias = rng.standard_normal((B, heads, LQ, LK)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    ref = np.asarray(pallas_mha(*(jnp.asarray(a) for a in (q, k, v)),
                                bias=jnp.asarray(bias), interpret=True))
    for got in (mha_plain(*t), mha_padded(mha_plain, *t)):
        np.testing.assert_allclose(got.numpy(), ref.reshape(got.shape),
                                   atol=ATOL, rtol=RTOL)
    b16 = [x.to(torch.bfloat16) for x in t[:3]]
    ref16 = np.asarray(pallas_mha(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in b16),
        bias=jnp.asarray(bias), interpret=True).astype(jnp.float32))
    for got in (mha_plain(*b16, t[3]), mha_padded(mha_plain, *b16, t[3])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   ref16.reshape(got.shape),
                                   atol=2 ** -8 * np.abs(ref16).max())
