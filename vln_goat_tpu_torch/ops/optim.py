"""AdamW with the global-norm clip over a table of leaves, for both of the
port's optimizers: the fine-tune `AdamW` (train/trainer.py) and the
pretraining chains of adam / adamw with or without the clip
(pretrain/optimizers.py `apply_updates`, which the speaker's Adam also
takes).

`clip_adamw_(groups, max_norm, clip_at_max)` takes one update of every
leaf of `groups`, each group a set of leaves that share the update's
scalars, in optax's order of operations:

    g = (g / |g|) max_norm           where the clip engages: |g| > max_norm
                                     (fine-tuning), or unless |g| < max_norm
                                     (pretraining: `clip_at_max`)
    mu = (1 - b1) g + b1 mu          nu = (1 - b2) (g g) + b2 nu
    u = (mu / bc1) / (sqrt(nu / bc2) + eps)
    u = u + weight_decay p           on the leaves that decay
    p = p + neg_lr u

|g| is the global norm of every group's gradients; a leaf without one
(None) steps with a zero gradient, as optax steps a leaf whose gradient
is zero.  p, mu and nu are updated in place.  bc1 / bc2 are tensors on the
leaves' device (fine-tuning) or Python floats (pretraining); each rounds as
it does in the loops: torch divides by a device tensor, and on the card
multiplies by the float reciprocal of a Python float.

On CUDA tensors it launches `csrc/adamw.cu` twice: `adamw_norm` (partial
sums of the squares of every gradient) and one `adamw_update` a group
(which finishes the norm and updates every leaf), with no read of the
norm on the host.  The launches count in `launches`; in the tracer they
sit in the span `fused_adamw`.  The table of leaves (pointers, sizes,
flags) is filled in one pass over the leaves and copied to the card in one
copy from pinned memory; its host buffer comes from torch's caching host
allocator, which hands a buffer out again only once the copy from it has
completed, so no table still in flight is overwritten.  The update is
bit-equal to `clip_adamw_plain` given the same norm (tests/
test_torch_fused_adamw_cuda.py); the norm is the kernel's own (float32
squares summed in float64 in a fixed order).

On CPU tensors it computes `clip_adamw_plain`, the loops' operations in
plain PyTorch, with the norm `global_norm_plain` and the clip's decision
read on the host.  `global_norm_plain(grads)` is the norm alone, on any
device and with no read (the fine-tune accumulator's and guard's).

What bounds the kernels: bytes, 32 an element in float32 (the norm reads g,
the update reads p, g, mu, nu and writes p, mu, nu); see the source.
"""
from __future__ import annotations

import array
import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.logger import read, span
from . import _build

# elements of an item, the unit of work of a block (a multiple of 4)
CHUNK = 8192
# columns of a table row: p, g, mu, nu, n, first item, flags, first
# gradient item (items of the leaves with a gradient only: the norm's)
COLS = 8
DECAY, F64 = 1, 2
# the kernels' launches: the norm's partial sums, and the updates (with
# the norm's last sum)
launches = {"norm": 0, "update": 0}

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_HYPER = ctypes.c_double * 11
_ENTRY = {torch.float32: "adamw_update_f32", torch.float64: "adamw_update_f64"}


@dataclass
class Group:
    """Leaves that take one update's scalars: parameters, their gradients
    (None: none), first and second moments, all of one dtype, and
    `decay` (one bool a leaf; None: every leaf decays)."""

    params: Sequence[torch.Tensor]
    grads: Sequence[Optional[torch.Tensor]]
    mus: Sequence[torch.Tensor]
    nus: Sequence[torch.Tensor]
    b1: float
    b2: float
    eps: float
    weight_decay: float
    neg_lr: float
    bc1: Union[float, torch.Tensor]
    bc2: Union[float, torch.Tensor]
    decay: Optional[Sequence[bool]] = None


def global_norm_plain(grads: Sequence[Optional[torch.Tensor]]
                      ) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm),
    leaf by leaf in float32, as the loops summed it; None counts as zero."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))


@torch.no_grad()
def clip_adamw_plain(groups: Sequence[Group],
                     max_norm: Optional[float] = None,
                     clip_at_max: bool = False,
                     norm: Optional[torch.Tensor] = None
                     ) -> Optional[torch.Tensor]:
    """`clip_adamw_` in plain PyTorch (the module docstring), leaf by leaf:
    the operations of the fine-tune AdamW loop and of the pretraining
    chain, which are the same.  `norm`: the global norm to clip by
    (default: `global_norm_plain`'s).  Returns the norm (None without a
    clip)."""
    clip = False
    if max_norm is not None:
        if norm is None:
            norm = global_norm_plain([g for grp in groups for g in grp.grads])
        clip = (not read(norm < max_norm)) if clip_at_max \
            else read(norm) > max_norm
    for grp in groups:
        decay = grp.decay or [True] * len(grp.params)
        for p, g, mu, nu, d in zip(grp.params, grp.grads, grp.mus, grp.nus,
                                   decay):
            g = torch.zeros_like(p) if g is None else g
            if clip:
                g = (g / norm.to(g.dtype)) * max_norm
            m = (1 - grp.b1) * g + grp.b1 * mu
            v = (1 - grp.b2) * (g * g) + grp.b2 * nu
            u = (m / grp.bc1) / (torch.sqrt(v / grp.bc2) + grp.eps)
            if d:
                u = u + grp.weight_decay * p
            p.add_(grp.neg_lr * u)
            mu.copy_(m)
            nu.copy_(v)
    return norm


def _lib() -> ctypes.CDLL:
    lib = _build.load("adamw")
    if lib.adamw_norm.argtypes is None:
        lib.adamw_norm.argtypes = [_VP, _I, _LL, _LL, _VP, _VP]
        lib.adamw_norm.restype = _I
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [_VP, _I, _I, _LL, _LL, _LL, _VP, _VP, _HYPER,
                           _VP, _VP, _I, _VP]
            fn.restype = _I
        lib.adamw_norm_blocks.restype = _I
    return lib


def _check(what: str, t: torch.Tensor, dtype: torch.dtype, n: int) -> None:
    if not t.is_cuda or t.dtype != dtype or t.numel() != n or \
            not t.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous {dtype} CUDA tensor "
                         f"of {n} elements, got {t.dtype} on {t.device}, "
                         f"{t.numel()} elements, contiguous "
                         f"{t.is_contiguous()}")


def table_rows(groups: Sequence[Group]) -> tuple:
    """(rows, spans, gradient items): the table's rows (`COLS` ints a leaf,
    flattened), each group's (first row, end row, first item, end item)
    and the number of gradient items, in one pass
    over the leaves, each checked: a contiguous CUDA tensor of the group's
    dtype (float32 or float64), its gradient, mu and nu of its size."""
    rows: List[int] = []
    spans = []
    item = gitem = 0
    for grp in groups:
        dtype = grp.params[0].dtype
        if dtype not in _ENTRY:
            raise ValueError(f"the fused AdamW takes float32 or float64 "
                             f"leaves, got {dtype}")
        flag = F64 if dtype == torch.float64 else 0
        decay = grp.decay or [True] * len(grp.params)
        l0, w0 = len(rows) // COLS, item
        for p, g, mu, nu, d in zip(grp.params, grp.grads, grp.mus, grp.nus,
                                   decay):
            n = p.numel()
            _check("parameter", p, dtype, n)
            _check("mu", mu, dtype, n)
            _check("nu", nu, dtype, n)
            if g is not None:
                _check("gradient", g, dtype, n)
            rows += (p.data_ptr(), 0 if g is None else g.data_ptr(),
                     mu.data_ptr(), nu.data_ptr(), n, item,
                     flag | (DECAY if d else 0), gitem)
            item += -(-n // CHUNK)
            if g is not None:
                gitem += -(-n // CHUNK)
        spans.append((l0, len(rows) // COLS, w0, item))
    return rows, spans, gitem


def _norm_launch(lib, tab, L: int, W: int, dev, stream) -> torch.Tensor:
    partials = torch.empty(lib.adamw_norm_blocks(), dtype=torch.float64,
                           device=dev)
    rc = lib.adamw_norm(tab.data_ptr(), L, W, CHUNK, partials.data_ptr(),
                        stream)
    launches["norm"] += 1
    if rc != 0:
        raise RuntimeError(f"adamw_norm launch failed: CUDA error {rc}")
    return partials


def _update_launch(lib, dtype, tab, span_, partials, norm, grp, clip_mode,
                   max_norm, stream) -> None:
    l0, l1, w0, w1 = span_
    dev_bc = isinstance(grp.bc1, torch.Tensor)
    if dev_bc:
        for bc in (grp.bc1, grp.bc2):
            _check("bias correction", bc, dtype, 1)
        inv1 = inv2 = 0.0
    elif dtype == torch.float32:
        one = np.float32(1.0)
        inv1 = float(one / np.float32(grp.bc1))
        inv2 = float(one / np.float32(grp.bc2))
    else:
        inv1, inv2 = 1.0 / grp.bc1, 1.0 / grp.bc2
    mx = 0.0 if max_norm is None else float(max_norm)
    # the clip's threshold as the loops compare it: a float32 tensor
    # against a Python float in float32 (pretraining), a Python float
    # against a Python float (fine-tuning)
    cmp = float(np.float32(mx)) if clip_mode == 2 else mx
    h = _HYPER(1 - grp.b1, grp.b1, 1 - grp.b2, grp.b2, grp.eps,
               grp.weight_decay, grp.neg_lr, inv1, inv2, mx, cmp)
    rc = getattr(lib, _ENTRY[dtype])(
        tab.data_ptr(), l0, l1, w0, w1, CHUNK,
        None if partials is None else partials.data_ptr(),
        None if norm is None else norm.data_ptr(), h,
        grp.bc1.data_ptr() if dev_bc else None,
        grp.bc2.data_ptr() if dev_bc else None, clip_mode, stream)
    launches["update"] += 1
    if rc != 0:
        raise RuntimeError(f"adamw_update launch failed: CUDA error {rc}")


def _launch(groups: Sequence[Group], max_norm: Optional[float],
            clip_mode: int) -> Optional[torch.Tensor]:
    """The table of `groups`, then (with `max_norm`) the norm's launch and
    one update launch a group -> the norm, or None."""
    rows, spans, gitems = table_rows(groups)
    dev, lib = groups[0].params[0].device, _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tab = torch.frombuffer(array.array("q", rows), dtype=torch.int64
                               ).pin_memory().to(dev, non_blocking=True)
        partials = norm = None
        if max_norm is not None:
            partials = _norm_launch(lib, tab, len(rows) // COLS, gitems, dev,
                                    stream)
            norm = torch.empty((), dtype=torch.float32, device=dev)
        for grp, sp in zip(groups, spans):
            _update_launch(lib, grp.params[0].dtype, tab, sp, partials, norm,
                           grp, clip_mode, max_norm, stream)
    return norm


@torch.no_grad()
def clip_adamw_(groups: Sequence[Group], max_norm: Optional[float] = None,
                clip_at_max: bool = False) -> Optional[torch.Tensor]:
    """One update of every leaf of `groups` (the module docstring), clipped
    by their global norm when `max_norm` is given -> that norm, a float32
    tensor on the leaves' device (None without a clip).  CUDA tensors take
    the kernels, CPU tensors `clip_adamw_plain`."""
    groups = [grp for grp in groups if len(grp.params)]
    if not groups or not groups[0].params[0].is_cuda:
        return clip_adamw_plain(groups, max_norm, clip_at_max)
    with span("fused_adamw"):
        return _launch(groups, max_norm, 0 if max_norm is None
                       else 2 if clip_at_max else 1)

