"""Head widths 32 and 128 (F6): the attention kernels of both builds are
templates of the head width, built for 32, 64 and 128
(`ops/csrc/head_dims.cuh`), and their wrappers refuse any other width,
naming the set.

On the CPU the wrappers take the plain versions, which are held here to
the JAX package's Pallas kernels in interpret mode (as its own kernel
tests run them) at GOAT's model width D = 768 split into 24 heads of 32
and 6 heads of 128: `fused_qkv_mha_plain` and its autograd against
`pallas_fused_qkv_mha` and its custom VJP, `mha_plain` against
`pallas_mha`.  float32, atol 2e-5 / rtol 1e-4 for the forward as
test_torch_attention.py, the gradients at atol 1e-5 of each gradient's
largest magnitude / rtol 1e-3 (sums over 768 in another order; the key
bias's gradient, zero up to rounding, at dWk's scale, as the card tests
hold it).  The kernels themselves at these widths run on the card
(tests/test_torch_kernel_cuda.py `test_head_widths_match_plain` and its
bf16 and `mha` cases; chip_smoke.py phase 3)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.ops.attention import pallas_fused_qkv_mha, pallas_mha
from vln_goat_tpu_torch.ops.attention import (HEAD_DIMS, check_head_dim,
                                              fused_qkv_mha, mha, mha_plain)

D, B = 768, 2
ATOL, RTOL = 2e-5, 1e-4


def _args(rng, Lq, Lk, heads, bias_kind):
    x = rng.standard_normal((B, Lq, D)).astype(np.float32)
    y = rng.standard_normal((B, Lk, D)).astype(np.float32)
    ws = [(rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
          for _ in range(3)]
    bs = [(rng.standard_normal(D) * 0.02).astype(np.float32)
          for _ in range(3)]
    keep = rng.random((B, Lk)) < 0.8
    keep[:, 0] = True
    bias = ((1.0 - keep) * -10000.0).astype(np.float32)[:, None, None, :]
    if bias_kind == "heads":
        bias = bias + rng.standard_normal((B, heads, Lq, Lk)).astype(
            np.float32)
    return [x, y, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], bias]


@pytest.mark.parametrize("dh,Lq,Lk,bias_kind", [
    (32, 54, 54, "key"), (128, 54, 54, "key"), (32, 20, 60, "heads"),
    (128, 20, 60, "heads")])
def test_fused_plain_and_autograd_match_pallas(rng, dh, Lq, Lk, bias_kind):
    heads = D // dh
    args = _args(rng, Lq, Lk, heads, bias_kind)
    dout = rng.standard_normal((B, Lq, D)).astype(np.float32)

    def jfn(*a):
        return pallas_fused_qkv_mha(*a, num_heads=heads, interpret=True)

    jargs = [jnp.asarray(a) for a in args]
    ref, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(dout))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_qkv_mha(*targs, num_heads=heads)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    grads = torch.autograd.grad(out, targs, torch.from_numpy(dout))
    for i, (g, r) in enumerate(zip(grads, jgrads)):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        if i == 5:
            # the key bias's gradient is zero up to rounding (softmax
            # ignores a constant added to a row): held at dWk's scale
            scale = max(scale, float(np.abs(np.asarray(jgrads[4])).max()))
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * scale,
                                   rtol=1e-3, err_msg=f"argument {i}")


@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("Lq,Lk", [(16, 16), (54, 60)])
def test_mha_plain_matches_pallas(rng, dh, Lq, Lk):
    heads = D // dh
    q, k, v = (rng.standard_normal((B, L, heads, dh)).astype(np.float32)
               for L in (Lq, Lk, Lk))
    keep = rng.random((B, Lk)) < 0.8
    keep[:, 0] = True
    bias = ((1.0 - keep) * -10000.0).astype(np.float32)[:, None, None, :]
    ref = pallas_mha(*(jnp.asarray(a) for a in (q, k, v)),
                     bias=jnp.asarray(bias), interpret=True)
    got = mha(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(
        got.shape), atol=ATOL, rtol=RTOL)
    assert torch.equal(got, mha_plain(*(torch.from_numpy(a)
                                        for a in (q, k, v, bias))))


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_shape_check_takes_the_built_widths(dh):
    check_head_dim(dh)


@pytest.mark.parametrize("dh", [16, 48, 96, 256])
def test_shape_check_refuses_other_widths(dh):
    """768 / 16 heads = 48: refused, with the widths the kernels take."""
    with pytest.raises(ValueError, match=r"head widths \(32, 64, 128\), "
                                         rf"got {dh}"):
        check_head_dim(dh)
