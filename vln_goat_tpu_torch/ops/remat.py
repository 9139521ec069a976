"""Rematerialisation policies of the training rollouts and the checkpoint
names they read (counterpart of the JAX package's `remat=` options,
vln_goat_tpu/rollout/rollout.py:1004-1040, :1419-1468, :1636-1663, and of
the `checkpoint_name`s of vln_goat_tpu/models/layers.py).

Policies (`POLICIES`):
- "none": every activation is kept for the backward;
- per model call ("model", "model_probs", "model_wide"): each
  `forward_panorama` / `forward_navigation` call of a rollout is
  checkpointed;
- per decision step ("full", "dots", "bounds", "probs", "wide"): the whole
  step `NavRollout._step` is checkpointed, its bookkeeping with it;
- "ffn" (JAX's save_anything_except_these_names("ffn_wide")): everything is
  kept but the FFN's wide tensors: each FFN sublayer runs under a
  checkpoint of its own (`ffn_sublayer`), keeping its input and output.
  JAX's policy picks among the residuals, the values the backward reads;
  a selective checkpoint of the step in eager PyTorch would keep every
  output instead, more than "none" keeps.

What a checkpoint keeps besides its inputs (`SAVED`):
- "full", "model": nothing;
- "dots": the outputs of the products without batch dimensions (aten.mm,
  aten.addmm: the projections; JAX's dots_with_no_batch_dims_saveable);
- the others: the tensors carrying the named checkpoint names
  (save_only_these_names): "bounds" `blk`; "probs" and "model_probs" `blk`,
  `attn_probs`, `drop_mask`; "wide" and "model_wide" those and `ffn_wide`.

A name marks a tensor by passing it through the op `goat_remat::tag` (a
copy, seen by the selective checkpoint's dispatch mode), and only while a
policy that saves names is running; elsewhere `checkpoint_name` returns its
argument.  JAX recomputes only what the saved values do not cover; eager
PyTorch reruns the whole checkpointed function and takes the saved values
in place of the ops that made them, so a saved name spares its own op and
the memory of everything else.  On the fused-kernel path the kernel saves
its inputs, not the probabilities, as the JAX kernel's custom VJP does, so
`attn_probs` names only the eager attention's probabilities.  A selective
policy keeps only product outputs or named copies, never a buffer that an
op merely allocates: the fused kernels write through ctypes into buffers
torch allocates, which no version counter sees, so a kept one would be
written again in the recompute.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

CALL_POLICIES = ("model", "model_probs", "model_wide")
STEP_POLICIES = ("full", "dots", "bounds", "probs", "wide")
POLICIES = ("none", "model", "full", "dots", "ffn", "bounds", "probs",
            "wide", "model_probs", "model_wide")
_PROBS = ("blk", "attn_probs", "drop_mask")
SAVED = {"bounds": ("blk",), "probs": _PROBS, "model_probs": _PROBS,
         "wide": _PROBS + ("ffn_wide",), "model_wide": _PROBS + ("ffn_wide",)}
# the products without batch dimensions ("dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

_state = threading.local()


def check(policy: str) -> None:
    """Raises ValueError for a policy that is not one of POLICIES."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r} (one of "
                         f"{POLICIES})")


@torch.library.custom_op("goat_remat::tag", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_named.register_fake
def _(x, name):
    return torch.empty_like(x)


_named.register_autograd(lambda ctx, grad: (grad, None))
_NAMED = torch.ops.goat_remat.tag.default


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """x under the checkpoint name `name` (`blk`, `attn_probs`,
    `drop_mask` or `ffn_wide`, as `SAVED` reads them): a copy through
    `goat_remat::tag` while a policy that saves names runs, x itself
    otherwise."""
    if getattr(_state, "naming", 0):
        return _named(x, name)
    return x


@contextlib.contextmanager
def _counter(attr: str):
    setattr(_state, attr, getattr(_state, attr, 0) + 1)
    try:
        yield
    finally:
        setattr(_state, attr, getattr(_state, attr) - 1)


def ffn_region():
    """The region in which the FFN sublayers run under checkpoints of their
    own (`ffn_sublayer`): remat "ffn"."""
    return _counter("ffn")


def ffn_sublayer(module, fn, *args):
    """fn(*args), an FFN sublayer of `module`: inside `ffn_region()` under
    `ops.dropout.checkpoint` (its wide tensors recomputed in the backward,
    `module`'s dropout draws replayed), else as it is."""
    if getattr(_state, "ffn", 0):
        from .dropout import checkpoint
        return checkpoint(module, fn, *args)
    return fn(*args)


def _policy_fn(policy: str):
    must, other = CheckpointPolicy.MUST_SAVE, \
        CheckpointPolicy.PREFER_RECOMPUTE
    if policy == "dots":
        return lambda ctx, func, *a, **k: must if func in _DOTS else other
    names = SAVED[policy]
    return lambda ctx, func, *a, **k: must \
        if func is _NAMED and a[1] in names else other


def contexts(policy: Optional[str]):
    """(forward context, recompute context, cache) of one checkpoint under
    `policy`: nothing for "full" and "model" (or None), else the selective
    checkpoint's pair, with names on in both for the policies that save
    names; `cache` is the forward's dispatch mode, whose storage holds what
    it keeps (None without one)."""
    if policy in (None, "full", "model"):
        return contextlib.nullcontext(), contextlib.nullcontext(), None
    fwd, rec = create_selective_checkpoint_contexts(_policy_fn(policy))
    if policy not in SAVED:
        return fwd, rec, fwd
    return (both(_counter("naming"), fwd), both(_counter("naming"), rec),
            fwd)


class SavedBytes:
    """Counts, over the forwards run inside it, the bytes of the distinct
    storages kept for the backward: the tensors autograd saves outside any
    checkpoint (through `torch.autograd.graph.saved_tensors_hooks`), and,
    for each checkpoint (`ops.dropout.checkpoint`), its tensor inputs and
    the outputs its selective policy caches.  `nbytes` is the total."""

    def __init__(self):
        self.storages = {}
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)

    def __enter__(self):
        _state.counter = self
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)
        _state.counter = None

    def _pack(self, t):
        self.add(t)
        return t

    def add(self, *trees) -> None:
        for t in tree_leaves(trees):
            t = getattr(t, "val", t)        # a selective cache's entry
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.storages[st.data_ptr()] = st.nbytes()

    @property
    def nbytes(self) -> int:
        return sum(self.storages.values())


def count_checkpoint(args, kwargs, cache) -> None:
    """Adds one checkpoint's inputs and cached outputs to the running
    `SavedBytes`, if any."""
    counter = getattr(_state, "counter", None)
    if counter is not None:
        counter.add(args, kwargs,
                    list(cache.storage.values()) if cache is not None
                    else [])


@contextlib.contextmanager
def both(a, b):
    """Enters context a, then b."""
    with a, b:
        yield


def call_policy(policy: str) -> Optional[str]:
    """The checkpoint of a rollout's model call under `policy`: None (no
    checkpoint) for "none" and the step policies, else the policy."""
    return policy if policy in CALL_POLICIES else None


def vec_call_policy(policy: str) -> Optional[str]:
    """The vectorized teacher's model calls under `policy`: every policy
    but "none" checkpoints them, keeping the names of "probs" / "wide" and
    their per-call forms (JAX rollout.py:1636-1663), nothing otherwise."""
    if policy == "none":
        return None
    if policy in ("probs", "model_probs"):
        return "model_probs"
    if policy in ("wide", "model_wide"):
        return "model_wide"
    return "model"
