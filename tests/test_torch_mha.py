"""The port's attention over projected heads, `mha` (the port of the TPU
kernel behind `pallas_mha`), against the JAX package: its plain version,
which the wrapper takes for CPU tensors, is held against `pallas_mha` in
interpret mode at the three cases of tests/test_pallas_attention.py (no
bias, a key mask with Lq != Lk, a full per-head bias), at that test's
tolerance, atol 2e-5 / rtol 1e-4 (float32, sums in another order)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vln_goat_tpu.ops.attention import pallas_mha
from vln_goat_tpu_torch.ops.attention import attend_plain, mha, mha_plain

B, H, DH = 2, 4, 8


def _case(rng, Lq, Lk, bias_kind):
    q, k, v = (rng.standard_normal((B, L, H, DH)).astype(np.float32)
               for L in (Lq, Lk, Lk))
    if bias_kind is None:
        bias = None
    elif bias_kind == "key":
        mask = rng.random((B, Lk)) < 0.8
        bias = ((1.0 - mask) * -10000.0).astype(np.float32)[:, None, None, :]
    else:
        bias = rng.standard_normal((B, H, Lq, Lk)).astype(np.float32)
    return q, k, v, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("Lq,Lk,bias_kind", [
    (16, 16, None), (24, 40, "key"), (12, 12, "full")])
def test_mha_plain_matches_pallas(rng, Lq, Lk, bias_kind):
    q, k, v, bias = _case(rng, Lq, Lk, bias_kind)
    ref = pallas_mha(*(jnp.asarray(a) for a in (q, k, v)),
                     None if bias is None else jnp.asarray(bias),
                     interpret=True)
    mha.launches = 0
    out = mha(*map(_t, (q, k, v, bias)))
    assert mha.launches == 0          # the CPU path launches nothing
    assert out.shape == (B, Lq, H * DH)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)


def test_mha_plain_reads_views(rng):
    """Heads sliced out of a packed [B, L, 3, H, dh] projection (strided
    views, as the kernel takes them) give what contiguous copies give, and
    what attend_plain gives on the flat [B, L, H*dh] layout."""
    qkv = torch.from_numpy(rng.standard_normal((B, 20, 3, H, DH))
                           .astype(np.float32))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = mha_plain(q, k, v)
    torch.testing.assert_close(
        out, mha_plain(q.contiguous(), k.contiguous(), v.contiguous()))
    flat = [t.reshape(B, 20, H * DH) for t in (q, k, v)]
    torch.testing.assert_close(out, attend_plain(*flat, num_heads=H),
                               atol=1e-6, rtol=1e-5)
