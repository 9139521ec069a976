"""Gradients of the port's fused q/k/v + attention against the JAX
package's backward kernel.

`fused_qkv_mha_plain`'s autograd (the reference the CUDA backward kernels
are held against on the card) against `jax.grad` of `pallas_fused_qkv_mha`
run in interpret mode, which reaches the Pallas backward `_fa_bwd_kernel`
through the custom VJP.  dx, dy, every weight and bias gradient and the
additive bias's gradient (summed to the caller's broadcast shape), for no
bias, a key mask [B,1,1,Lk], a graph bias [B,1,Lq,Lk] and a per-head bias
[B,H,Lq,Lk].  Float32, atol 2e-5 / rtol 1e-4 as the JAX package's kernel
tests use (sums are taken in another order)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.ops.attention import pallas_fused_qkv_mha
from vln_goat_tpu_torch.ops.attention import fused_qkv_mha_plain

ATOL, RTOL = 2e-5, 1e-4
B, H, DH, D = 2, 4, 8, 24
NAMES = ("x", "y", "wq", "bq", "wk", "bk", "wv", "bv", "bias")


def _bias(rng, kind, Lq, Lk):
    if kind is None:
        return None
    mask = rng.random((B, Lk)) < 0.8
    mask[:, 0] = True
    key = ((1.0 - mask) * -10000.0).astype(np.float32)[:, None, None, :]
    if kind == "key":
        return key
    if kind == "full":
        return key + rng.standard_normal((B, 1, Lq, Lk)).astype(np.float32)
    return key + rng.standard_normal((B, H, Lq, Lk)).astype(np.float32)


@pytest.mark.parametrize("kind", [None, "key", "full", "heads"])
@pytest.mark.parametrize("Lq,Lk", [(16, 16), (12, 20), (20, 9)])
def test_plain_grads_match_pallas_backward(rng, Lq, Lk, kind):
    d = H * DH
    args = [rng.standard_normal((B, Lq, D)).astype(np.float32),
            rng.standard_normal((B, Lk, D)).astype(np.float32)]
    for _ in range(3):
        args += [(rng.standard_normal((D, d)) * 0.2).astype(np.float32),
                 (rng.standard_normal(d) * 0.1).astype(np.float32)]
    bias = _bias(rng, kind, Lq, Lk)
    if bias is not None:
        args.append(bias)
    dout = rng.standard_normal((B, Lq, d)).astype(np.float32)

    def jloss(*a):
        out = pallas_fused_qkv_mha(*a[:8], a[8] if len(a) > 8 else None,
                                   num_heads=H, interpret=True)
        return jnp.sum(out * dout)

    ref = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))

    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_qkv_mha_plain(*targs[:8],
                              targs[8] if len(targs) > 8 else None,
                              num_heads=H)
    got = torch.autograd.grad(out, targs, torch.from_numpy(dout))
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
