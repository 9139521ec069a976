"""The fused gate's route and the port's `AttentionCore` on the shapes
that reach the kernels, against the JAX package.

The JAX gate sends every query block of 32 rows or more to its Pallas
kernel (vln_goat_tpu/models/layers.py:113-136), which takes any key
length, head width and model width; the port's gate does the same and
never decides by shape: on the card the fused kernels take any Lk in both
builds (the float32 attention forward past 256 keys in key blocks with an
online softmax) and raise on a head width other than 64 or a width not a
multiple of 32.  So the port's `AttentionCore` is held to the JAX one with
`use_pallas=True` (interpret mode) past 256 keys and at head width 32 on
both of its paths: the fused one (here its plain version) and the eager
one.  float32, atol 2e-5 / rtol 1e-4 as tests/test_torch_attention.py
(sums in another order).  The gate's decision itself is checked on meta
tensors, the one device besides the CPU that runs here."""
import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vln_goat_tpu.models.layers import AttentionCore as JaxAttentionCore
from vln_goat_tpu_torch.models.layers import AttentionCore
from vln_goat_tpu_torch.ops import attention as port_attn
from vln_goat_tpu_torch.train.checkpoint import params_from_flax

CSRC = (Path(__file__).resolve().parent.parent / "vln_goat_tpu_torch" / "ops"
        / "csrc")
ATOL, RTOL = 2e-5, 1e-4
F32, BF16 = torch.float32, torch.bfloat16


def test_no_kernel_caps_the_key_length():
    """No source of the fused kernels or of `mha` keeps a largest key
    length, and the wrappers ask none."""
    for path in CSRC.iterdir():
        assert not re.search(r"MAX_LK|max_lk", path.read_text()), path.name
    assert not hasattr(port_attn, "fused_route")
    src = Path(port_attn.__file__).read_text()
    assert "max_lk" not in src


@pytest.mark.parametrize("Lq,Lk,dh,dtype", [
    (40, 60, 64, F32), (40, 300, 64, F32), (40, 520, 64, BF16),
    (40, 60, 32, F32), (31, 60, 64, F32)])
def test_gate_sends_every_block_to_the_kernels(monkeypatch, Lq, Lk, dh,
                                               dtype):
    """On any device the gate sends every query block of at least 32 rows
    to `fused_qkv_mha`, whatever its key length or head width, and blocks
    of fewer rows to the eager path, as the JAX gate does."""
    calls = []
    monkeypatch.setattr(
        "vln_goat_tpu_torch.models.layers.fused_qkv_mha",
        lambda x, *a, **k: calls.append(x.shape) or x.new_empty(
            x.shape[0], x.shape[1], 12 * dh))
    H, D = 12, 12 * dh
    core = AttentionCore(D, H, dh, use_fused=True, min_lq=32,
                         compute_dtype=None if dtype == F32 else dtype)
    q_in = torch.zeros(2, Lq, D)
    kv_in = torch.zeros(2, Lk, D)
    with torch.no_grad():
        core(q_in, kv_in)
    core = core.to("meta")
    with torch.no_grad():
        out = core(q_in.to("meta"), kv_in.to("meta"))
    assert out.shape == (2, Lq, D)
    assert calls == ([(2, Lq, D)] * 2 if Lq >= 32 else [])


def _params(rng, hidden, d):
    return {n: {"kernel": (rng.standard_normal((hidden, d)) * 0.2)
                .astype(np.float32),
                "bias": (rng.standard_normal(d) * 0.1).astype(np.float32)}
            for n in ("query", "key", "value")}


@pytest.mark.parametrize("H,dh,Lq,Lk", [(2, 64, 40, 300), (2, 32, 36, 50)])
@pytest.mark.parametrize("fused", [True, False])
def test_attention_core_matches_jax_pallas(rng, H, dh, Lq, Lk, fused):
    """Past 256 keys (the float32 build's key blocks) and at head width 32
    (the kernels raise on it on the card), both of the port's paths match
    the JAX AttentionCore on its Pallas kernel."""
    D, B = 48, 2
    p = _params(rng, D, H * dh)
    q_in = rng.standard_normal((B, Lq, D)).astype(np.float32)
    kv_in = rng.standard_normal((B, Lk, D)).astype(np.float32)
    mask = rng.random((B, Lk)) < 0.8
    mask[:, 0] = True
    bias = (((1.0 - mask) * -10000.0)[:, None, None, :]
            + rng.standard_normal((B, 1, Lq, Lk))).astype(np.float32)
    jcore = JaxAttentionCore(H, dh, 0.0, use_pallas=True)
    ref = jcore.apply({"params": p}, jnp.asarray(q_in), jnp.asarray(kv_in),
                      jnp.asarray(bias))
    core = AttentionCore(D, H, dh, use_fused=fused, min_lq=32)
    core.load_state_dict(params_from_flax(p))
    before = port_attn.fused_qkv_mha.launches
    with torch.no_grad():
        out = core(torch.from_numpy(q_in), torch.from_numpy(kv_in),
                   torch.from_numpy(bias))
    assert port_attn.fused_qkv_mha.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
