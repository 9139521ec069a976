"""The port's fused q/k/v + attention in bf16 against the JAX package's
Pallas kernel on bf16 operands.

`fused_qkv_mha_plain` on bf16 tensors (the reference the bf16 CUDA
kernels are held against on the card) and its autograd, against
`pallas_fused_qkv_mha(..., interpret=True)` on bf16 arrays and its custom
VJP (the Pallas backward `_fa_bwd_kernel` at dt = bf16): the output and the
gradients of x, y, every weight and bias and the additive bias, for a key
mask [B,1,1,Lk], a graph bias [B,1,Lq,Lk] and a per-head bias
[B,H,Lq,Lk], at D 64, 2 heads, Lq / Lk 40 and 24.  Inputs and the output
cotangent are bf16 values drawn from a numpy seed.

Both bf16 versions round where the JAX kernel casts, but not all in the
same places (the port's autograd rounds each gradient where it passes a
cast, the JAX kernel its own intermediates), so both are compared with the
JAX kernel on the same values in float32: each result's distance from it,
scaled by its largest magnitude (the key bias's gradient, zero up to
rounding, at its weight's), is at most twice the JAX bf16 distance plus
ATOL = 1e-3 (a quarter bf16 ulp).  Measured: the two distances agree to
within 5e-3 of each other, at 7e-4 to 1.1e-2."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.ops.attention import pallas_fused_qkv_mha
from vln_goat_tpu_torch.ops.attention import fused_qkv_mha_plain
# torch on one thread: under xdist the workers share the cores
from test_torch_gate_witness import one_thread  # noqa: F401

ATOL = 1e-3
B, H, DH, D = 2, 2, 32, 64
NAMES = ("x", "y", "wq", "bq", "wk", "bk", "wv", "bv", "bias")


def _bf16_values(a):
    """a rounded to bf16, as float32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def _case(rng, kind, Lq, Lk):
    d = H * DH
    args = [_bf16_values(rng.standard_normal((B, Lq, D))),
            _bf16_values(rng.standard_normal((B, Lk, D)))]
    for _ in range(3):
        args += [_bf16_values(rng.standard_normal((D, d)) * 0.2),
                 _bf16_values(rng.standard_normal(d) * 0.1)]
    mask = rng.random((B, Lk)) < 0.8
    mask[:, 0] = True
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
    if kind != "key":
        bias = bias + rng.standard_normal(
            (B, 1 if kind == "full" else H, Lq, Lk))
    args.append(_bf16_values(bias))
    dout = _bf16_values(rng.standard_normal((B, Lq, d)))
    return args, dout


def _jax(args, dout, dtype):
    def loss(*a):
        out = pallas_fused_qkv_mha(*a[:8], a[8], num_heads=H,
                                   interpret=True)
        return jnp.sum(out.astype(jnp.float32) * dout), out

    a = [jnp.asarray(x, dtype) for x in args]
    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(a))), has_aux=True)(*a)
    assert out.dtype == dtype
    f64 = lambda t: np.asarray(t.astype(jnp.float32), np.float64)  # noqa
    return f64(out), [f64(g) for g in grads]


def _gate(name, got, j16, ref, scale):
    err = np.abs(got - ref).max() / scale
    err_j = np.abs(j16 - ref).max() / scale
    assert err <= 2 * err_j + ATOL, (name, err, err_j)


@pytest.mark.parametrize("kind", ["key", "full", "heads"])
@pytest.mark.parametrize("Lq,Lk", [(40, 24), (24, 40)])
def test_bf16_plain_matches_pallas_bf16(rng, kind, Lq, Lk):
    args, dout = _case(rng, kind, Lq, Lk)
    ref_out, ref = _jax(args, dout, jnp.float32)
    j16_out, j16 = _jax(args, dout, jnp.bfloat16)

    targs = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
             for a in args]
    out = fused_qkv_mha_plain(*targs[:8], targs[8], num_heads=H)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, targs,
                              torch.from_numpy(dout).to(torch.bfloat16))
    _gate("out", out.detach().double().numpy(), j16_out, ref_out,
          np.abs(ref_out).max())
    for i, (name, g) in enumerate(zip(NAMES, got)):
        assert g.dtype == torch.bfloat16 and g.shape == ref[i].shape, name
        scale = np.abs(ref[4 if name == "bk" else i]).max()
        _gate(name, g.double().numpy(), j16[i], ref[i], scale)
