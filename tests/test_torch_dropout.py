"""The port's dropout (ops/dropout.py): the counter-based keep mask shared
by the fused attention kernels and their plain version, and the eager
generator-driven dropout of the model's other sites.

- the keep bits are murmur3_32 of the counter words (b, h, q, k) under the
  key seed[b], checked against a plain-Python murmur3;
- the keep share is within 4 binomial standard deviations of 1 - rate;
- the mask depends on (seed, b, h, q, k) only: the same for any call shape
  or batch prefix, different for another seed;
- at rate 0, and in eval mode, the result is the deterministic path's,
  bitwise."""
import math
import struct

import numpy as np
import pytest
import torch

from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import TINY, build_model
from vln_goat_tpu_torch.ops.attention import fused_qkv_mha_plain
from vln_goat_tpu_torch.ops.dropout import (Dropout, dropout, keep_bits,
                                            keep_mask, keep_threshold,
                                            set_generator)


def _murmur3(words, seed):
    """Reference murmur3_32 over little-endian 32-bit words."""
    data = struct.pack(f"<{len(words)}I", *words)
    rot = lambda x, r: ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF  # noqa
    h = seed & 0xFFFFFFFF
    for (k,) in struct.iter_unpack("<I", data):
        k = rot((k * 0xcc9e2d51) & 0xFFFFFFFF, 15)
        h ^= (k * 0x1b873593) & 0xFFFFFFFF
        h = (rot(h, 13) * 5 + 0xe6546b64) & 0xFFFFFFFF
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85ebca6b) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xc2b2ae35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_keep_bits_are_murmur3(rng):
    seeds = rng.integers(-2 ** 31, 2 ** 31, 64)
    words = rng.integers(0, 2 ** 32, (64, 4))
    words[:8] = rng.integers(0, 300, (8, 4))       # small counters too
    got = keep_bits(torch.from_numpy(seeds), *(torch.from_numpy(words[:, i])
                                               for i in range(4)))
    ref = [_murmur3([int(w) for w in words[i]], int(seeds[i]))
           for i in range(64)]
    assert got.tolist() == ref


@pytest.mark.parametrize("rate", [0.1, 0.4, 0.9])
def test_keep_share(rate):
    shape = (16, 12, 60, 60)
    seed = torch.arange(shape[0], dtype=torch.int32) * 7919 + 11
    share = float(keep_mask(seed, shape, rate).float().mean())
    n = math.prod(shape)
    assert abs(share - (1 - rate)) < 4 * math.sqrt(rate * (1 - rate) / n)
    assert keep_threshold(rate) == min(int(rate * 2 ** 32), 2 ** 32 - 1)


def test_mask_depends_on_counter_only():
    seed = torch.tensor([5, -17, 2 ** 31 - 1, 0], dtype=torch.int32)
    full = keep_mask(seed, (4, 12, 60, 60), 0.3)
    # another call shape: the common (b, h, q, k) agree
    small = keep_mask(seed, (4, 5, 50, 54), 0.3)
    assert torch.equal(small, full[:, :5, :50, :54])
    # a batch prefix: same seeds at the same rows give the same mask
    assert torch.equal(keep_mask(seed[:2], (2, 12, 60, 60), 0.3), full[:2])
    # another seed at a row changes that row only
    other = seed.clone()
    other[1] += 1
    moved = keep_mask(other, (4, 12, 60, 60), 0.3)
    assert torch.equal(moved[[0, 2, 3]], full[[0, 2, 3]])
    assert not torch.equal(moved[1], full[1])
    # equal seeds on two rows still differ through the counter's b
    same = keep_mask(torch.tensor([9, 9], dtype=torch.int32),
                     (2, 12, 60, 60), 0.3)
    assert not torch.equal(same[0], same[1])


def test_plain_attention_applies_the_mask(rng):
    """The plain fused attention at rate r equals the one with the mask
    applied by hand; at rate 0 it is the deterministic path bitwise."""
    Bx, Lq, Lk, D, Hx = 2, 7, 9, 16, 2
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x, y = t(Bx, Lq, D), t(Bx, Lk, D)
    w = [t(D, D) * 0.3 for _ in range(3)]
    b = [t(D) * 0.1 for _ in range(3)]
    args = (x, y, w[0], b[0], w[1], b[1], w[2], b[2], None)
    seed = torch.tensor([3, 4], dtype=torch.int32)
    base = fused_qkv_mha_plain(*args, num_heads=Hx)
    assert torch.equal(
        fused_qkv_mha_plain(*args, num_heads=Hx, dropout_rate=0.0,
                            seed=seed), base)
    got = fused_qkv_mha_plain(*args, num_heads=Hx, dropout_rate=0.25,
                              seed=seed)
    q, k, v = (a.view(Bx, -1, Hx, D // Hx) for a in
               (x @ w[0] + b[0], y @ w[1] + b[1], y @ w[2] + b[2]))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                      / math.sqrt(D // Hx), dim=-1)
    keep = keep_mask(seed, p.shape, 0.25)
    p = torch.where(keep, p * (1 / 0.75), torch.zeros_like(p))
    ref = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(Bx, Lq, D)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-5)
    assert not torch.allclose(got, base, atol=1e-3)


def test_eager_dropout_share_and_generator():
    x = torch.ones(400, 500)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, g)
    kept = (y != 0).float()
    n = x.numel()
    assert abs(float(kept.mean()) - 0.9) < 4 * math.sqrt(0.09 / n)
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    again = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(again, y)
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.1, None)


def test_model_dropout_rate0_and_eval_are_deterministic():
    """Train mode with every dropout probability 0, and eval mode with
    dropout on, both give the deterministic forward bitwise; train mode with
    dropout on draws from the generator set_generator gave the model."""
    ids = torch.arange(40).view(2, 20) % 60 + 3
    masks = torch.ones(2, 20, dtype=torch.bool)
    on = GoatConfig(use_fused_attention=True, fused_attn_min_lq=16, **TINY)
    off = on.replace(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, feat_dropout=0.0)
    m_on, m_off = build_model(on, "cpu"), build_model(off, "cpu")
    ref = m_off.forward_text(ids, masks)
    m_off.train()
    assert torch.equal(m_off.forward_text(ids, masks), ref)
    assert torch.equal(m_on.forward_text(ids, masks), ref)    # eval mode
    m_on.train()
    assert sum(isinstance(m, Dropout) for m in m_on.modules()) > 10
    with pytest.raises(ValueError, match="generator"):
        m_on.forward_text(ids, masks)
    set_generator(m_on, torch.Generator().manual_seed(1))
    a = m_on.forward_text(ids, masks)
    set_generator(m_on, torch.Generator().manual_seed(1))
    assert torch.equal(m_on.forward_text(ids, masks), a)
    assert not torch.allclose(a, ref, atol=1e-3)
