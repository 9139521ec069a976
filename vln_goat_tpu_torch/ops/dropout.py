"""Dropout of the port.

Two kinds of draws:

- `keep_mask(seed, shape, rate)`: the keep mask of the fused attention's
  in-kernel dropout, a counter-based hash of (seed[b], b, h, q, k).  The
  CUDA kernels compute the same bits (ops/csrc/dropout_hash.cuh), so the
  plain version reproduces the kernel's mask bit for bit, and the forward
  and backward kernels regenerate it whatever their tiling.
- `dropout(x, rate, generator)`: the eager dropout sites (hidden states,
  eager attention probabilities, environment features), drawn from an
  explicit torch.Generator.  `Dropout` is the module form; `set_generator`
  hands one generator to every `Dropout` of a model.

Both keep with probability 1 - rate and scale what they keep by
1 / (1 - rate), as the JAX package does.

`checkpoint(module, fn, ...)` is torch.utils.checkpoint with the draws of
`module`'s generators replayed when the backward recomputes `fn`:
torch's checkpoint restores only the default generators, so a recompute
would draw other attention seeds and masks from these and give other
gradients without any error.  Their draws differ from JAX's
(the TPU PRNG in-kernel, threefry elsewhere): stochastic paths are compared
by distribution, deterministic ones exactly.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from .remat import both, checkpoint_name, count_checkpoint
from .remat import contexts as policy_contexts

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow:
    the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _word(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    w = _mul32(w, 0xcc9e2d51)
    w = _mul32(_rotl(w, 15), 0x1b873593)
    h = _rotl(h ^ w, 13)
    return (_mul32(h, 5) + 0xe6546b64) & _M32


def keep_bits(seed: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
              q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """murmur3_32 of the counter words (b, h, q, k) under the key `seed`
    (all int64 tensors, broadcast together) -> bits in [0, 2^32) as int64.
    `dropout_bits` in ops/csrc/dropout_hash.cuh is the same function."""
    x = _word(seed & _M32, b)
    x = _word(x, h)
    x = _word(x, q)
    x = _word(x, k)
    x = x ^ 16
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85ebca6b)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xc2b2ae35)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """Bits at or above this are kept (the JAX package's `_keep_mask`)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def keep_mask(seed: torch.Tensor, shape: Sequence[int],
              rate: float) -> torch.Tensor:
    """Bool keep mask of shape (B, H, Lq, Lk) for per-row seeds [B]."""
    B, H, Lq, Lk = shape
    dev = seed.device
    ar = lambda n: torch.arange(n, device=dev, dtype=torch.int64)  # noqa: E731
    bits = keep_bits(seed.to(torch.int64).view(B, 1, 1, 1),
                     ar(B).view(B, 1, 1, 1), ar(H).view(1, H, 1, 1),
                     ar(Lq).view(1, 1, Lq, 1), ar(Lk).view(1, 1, 1, Lk))
    return bits >= keep_threshold(rate)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout of x with keep probability 1 - rate, drawn from
    `generator` (which must live on x's device)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator: "
                         "call set_generator(model, g) before training")
    keep = checkpoint_name(
        torch.rand(x.shape, generator=generator, device=x.device) >= rate,
        "drop_mask")
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dropout(nn.Module):
    """`dropout` while the module is in training mode, the identity in
    eval mode.  `generator` is set by `set_generator`."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training:
            return x
        return dropout(x, self.rate, self.generator)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def set_generator(module: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Make every `Dropout` in `module` draw from `generator`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def generators(module: nn.Module) -> List[torch.Generator]:
    """The distinct generators of `module`'s `Dropout`s."""
    seen = {}
    for m in module.modules():
        if isinstance(m, Dropout) and m.generator is not None:
            seen[id(m.generator)] = m.generator
    return list(seen.values())


@contextlib.contextmanager
def _replay(gens: List[torch.Generator], states: List[torch.Tensor]):
    """Sets each generator to its recorded state for the body, and back to
    the state it had on entry after it."""
    now = [g.get_state() for g in gens]
    for g, s in zip(gens, states):
        g.set_state(s)
    try:
        yield
    finally:
        for g, s in zip(gens, now):
            g.set_state(s)


def checkpoint(module: nn.Module, fn, *args, policy: Optional[str] = None,
               **kwargs):
    """`fn(*args, **kwargs)` under torch.utils.checkpoint (non-reentrant):
    its activations are dropped after the forward and recomputed in the
    backward, the JAX package's `jax.checkpoint` of one model call.  The
    states of `module`'s dropout generators at the call are recorded and
    set again for the recompute, which therefore draws the forward's seeds
    and masks; after it each generator is put back to the state it had
    before the recompute, so a step leaves them as it would without the
    checkpoint.  `policy` (`ops.remat.POLICIES`; None keeps nothing) adds
    the selective checkpoint's own pair of contexts to the replay's."""
    gens = generators(module)
    caches = []

    def contexts():
        states = [g.get_state() for g in gens]
        fwd, rec, cache = policy_contexts(policy)
        caches.append(cache)
        return fwd, both(_replay(gens, states), rec)

    out = _ckpt.checkpoint(fn, *args, use_reentrant=False,
                           context_fn=contexts, **kwargs)
    count_checkpoint(args, kwargs, caches[0] if caches else None)
    return out
