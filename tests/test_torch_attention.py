"""The port's fused q/k/v + attention module against the JAX package.

`fused_qkv_mha_plain` (the plain PyTorch version of the CUDA kernel, which
the wrapper takes for CPU tensors) is held against the Pallas kernel
`pallas_fused_qkv_mha` run in interpret mode, and the port's gated
`AttentionCore` against the JAX one with `use_pallas=True`.  Tolerances:
float32 throughout, atol 2e-5 / rtol 1e-4 as the JAX package's own kernel
tests use (sums are taken in another order)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.models.layers import AttentionCore as JaxAttentionCore
from vln_goat_tpu.ops.attention import pallas_fused_qkv_mha
from vln_goat_tpu_torch.models.layers import AttentionCore
from vln_goat_tpu_torch.ops import attention as port_attn
from vln_goat_tpu_torch.ops.attention import (fused_qkv_mha,
                                              fused_qkv_mha_plain)
from vln_goat_tpu_torch.train.checkpoint import params_from_flax

ATOL, RTOL = 2e-5, 1e-4
B, H, DH, D = 2, 4, 8, 24


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


@pytest.mark.parametrize("Lq,Lk,kind", [
    (16, 16, None), (16, 16, "key"), (12, 12, "full"), (10, 10, "heads"),
    (12, 20, "key"), (20, 9, "full")])
def test_plain_matches_pallas_interpret(rng, Lq, Lk, kind):
    d = H * DH
    x = rng.standard_normal((B, Lq, D)).astype(np.float32)
    y = rng.standard_normal((B, Lk, D)).astype(np.float32)
    ws = [(rng.standard_normal((D, d)) * 0.2).astype(np.float32)
          for _ in range(3)]
    bs = [(rng.standard_normal(d) * 0.1).astype(np.float32)
          for _ in range(3)]
    bias = _bias(rng, kind, Lq, Lk)
    args = [x, y, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2]]
    ref = pallas_fused_qkv_mha(
        *map(jnp.asarray, args), None if bias is None else jnp.asarray(bias),
        num_heads=H, interpret=True)
    targs = [torch.from_numpy(a) for a in args]
    tbias = None if bias is None else torch.from_numpy(bias)
    out = fused_qkv_mha_plain(*targs, tbias, num_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = fused_qkv_mha.launches
    out2 = fused_qkv_mha(*targs, tbias, num_heads=H)
    assert torch.equal(out2, out)
    assert fused_qkv_mha.launches == before


def _jax_core_params(rng, hidden):
    d = H * DH
    p = {}
    for n in ("query", "key", "value"):
        p[n] = {"kernel": (rng.standard_normal((hidden, d)) * 0.2
                           ).astype(np.float32),
                "bias": (rng.standard_normal(d) * 0.1).astype(np.float32)}
    return p


@pytest.mark.parametrize("Lq,Lk,kind", [(40, 40, "key"), (36, 50, "full"),
                                        (33, 33, "heads")])
def test_attention_core_gate_matches_jax_pallas(rng, monkeypatch, Lq, Lk,
                                                kind):
    """Gate on and Lq >= 32: both packages take their fused kernel (Pallas
    in interpret mode; the port's plain version on the CPU)."""
    p = _jax_core_params(rng, D)
    q_in = rng.standard_normal((B, Lq, D)).astype(np.float32)
    kv_in = rng.standard_normal((B, Lk, D)).astype(np.float32)
    bias = _bias(rng, kind, Lq, Lk)
    jcore = JaxAttentionCore(H, DH, 0.0, use_pallas=True)
    ref = jcore.apply({"params": p}, jnp.asarray(q_in), jnp.asarray(kv_in),
                      jnp.asarray(bias))

    calls = []
    real = port_attn.fused_qkv_mha

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr("vln_goat_tpu_torch.models.layers.fused_qkv_mha",
                        counting)
    core = AttentionCore(D, H, DH, use_fused=True, min_lq=32)
    core.load_state_dict(params_from_flax(p))
    with torch.no_grad():
        out = core(torch.from_numpy(q_in), torch.from_numpy(kv_in),
                   torch.from_numpy(bias))
    assert calls == [(B, Lq, D)]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_attention_core_gate_keeps_short_queries_and_kv_cache_eager(
        rng, monkeypatch):
    """Below min_lq, or with hoisted K/V, the gate stays on the eager path
    (as the JAX gate does) and still matches the JAX AttentionCore."""
    p = _jax_core_params(rng, D)
    calls = []
    monkeypatch.setattr("vln_goat_tpu_torch.models.layers.fused_qkv_mha",
                        lambda *a, **k: calls.append(1))
    core = AttentionCore(D, H, DH, use_fused=True, min_lq=32)
    core.load_state_dict(params_from_flax(p))
    jcore = JaxAttentionCore(H, DH, 0.0, use_pallas=True)
    bias = _bias(rng, "key", 40, 40)
    for Lq, use_cache in ((12, False), (40, True)):
        q_in = rng.standard_normal((B, Lq, D)).astype(np.float32)
        kv_in = rng.standard_normal((B, 40, D)).astype(np.float32)
        jk, jv = jcore.apply({"params": p}, None, jnp.asarray(kv_in),
                             kv_only=True)
        ref = jcore.apply(
            {"params": p}, jnp.asarray(q_in), jnp.asarray(kv_in),
            jnp.asarray(bias), kv_cache=(jk, jv) if use_cache else None)
        with torch.no_grad():
            kv = core.kv(torch.from_numpy(kv_in))
            np.testing.assert_allclose(kv[0].numpy(), np.asarray(jk),
                                       atol=ATOL, rtol=RTOL)
            out = core(torch.from_numpy(q_in), torch.from_numpy(kv_in),
                       torch.from_numpy(bias),
                       kv_cache=kv if use_cache else None)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=RTOL)
    assert calls == []
