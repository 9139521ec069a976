"""The port's attention over projected heads in bf16 against the JAX
package: `mha_plain` on bf16 tensors (the reference the bf16 `mha` kernel
is held to on the card) against `pallas_mha(..., interpret=True)` on the
same bf16 arrays, at the three cases of tests/test_pallas_attention.py and
at 300 keys (past the float32 kernel's 256).  The TPU kernel `_mha_kernel`
upcasts q, k, v and the bias, computes scores, softmax and p v in float32
and rounds the output once to q's dtype; so does the plain version, so the
two differ by at most one bf16 rounding of the output: |out - ref| <=
2^-8 |ref| + 1e-6 elementwise (the float32 values before the rounding
differ only by their sums' order)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vln_goat_tpu.ops.attention import pallas_mha
from vln_goat_tpu_torch.ops.attention import mha, mha_plain

B, H, DH = 2, 4, 8


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("Lq,Lk,bias_kind", [
    (16, 16, None), (24, 40, "key"), (12, 12, "full"), (20, 300, "key")])
def test_mha_plain_bf16_matches_pallas_bf16(rng, Lq, Lk, bias_kind):
    q, k, v = (_bf16(rng.standard_normal((B, L, H, DH))) for L in (Lq, Lk, Lk))
    if bias_kind is None:
        bias = None
    elif bias_kind == "key":
        mask = rng.random((B, Lk)) < 0.8
        mask[:, 0] = True
        bias = torch.from_numpy(((1.0 - mask) * -10000.0).astype(
            np.float32)[:, None, None, :])
    else:
        bias = torch.from_numpy(rng.standard_normal((B, H, Lq, Lk)).astype(
            np.float32))
    ref = pallas_mha(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        None if bias is None else jnp.asarray(bias.numpy()), interpret=True)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32), np.float64)
    mha.launches = 0
    out = mha(q, k, v, bias)              # the CPU path: mha_plain
    assert mha.launches == 0
    assert out.dtype == torch.bfloat16 and out.shape == (B, Lq, H * DH)
    assert torch.equal(out, mha_plain(q, k, v, bias))
    err = np.abs(out.double().numpy() - ref)
    assert (err <= 2.0 ** -8 * np.abs(ref) + 1e-6).all(), err.max()


def test_mha_plain_bf16_rounds_once():
    """In bf16 the plain version keeps the scores, p and p v in float32:
    it equals the float32 computation on the same values, rounded once."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, L, H, DH, generator=g).to(torch.bfloat16)
               for L in (9, 70, 70))
    bias = torch.randn(2, 1, 9, 70, generator=g)
    out = mha_plain(q, k, v, bias)
    want = mha_plain(q.float(), k.float(), v.float(), bias)
    assert torch.equal(out, want.to(torch.bfloat16))
