"""Numerical failure guards (counterpart of vln_goat_tpu/utils/guard.py).

`FiniteGuard` is `optax.apply_if_finite(max_consecutive_errors=10)`'s
decision and counters, which the trainer's `apply_update` consults before
the clip and the AdamW step (`make_optimizer(finite_guard=True)`): an
update whose gradients hold a non-finite entry is skipped, so the
optimizer's moments, its update count and the schedule stay as they were;
past `max_consecutive_errors` consecutive skips the update is applied.
"""
from __future__ import annotations

from typing import List

import torch

from .logger import read


class FiniteGuard:
    """optax.apply_if_finite's state: `notfinite_count` (consecutive
    non-finite updates), `last_finite`, `total_notfinite`."""

    def __init__(self, max_consecutive_errors: int = 10):
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0
        self.last_finite = True
        self.total_notfinite = 0

    def allow(self, grads: List[torch.Tensor]) -> bool:
        """Counts one update of `grads`; True when it is to be applied:
        every entry finite, or more than max_consecutive_errors
        consecutive updates non-finite."""
        finite = True
        if grads:
            finite = read(torch.stack(
                [torch.isfinite(g).all() for g in grads]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.last_finite = finite
        if not finite:
            self.total_notfinite += 1
        return finite or self.notfinite_count > self.max_consecutive_errors


def finite_guard(max_consecutive_errors: int = 10) -> FiniteGuard:
    """A guard that drops non-finite updates (optax.apply_if_finite)."""
    return FiniteGuard(max_consecutive_errors)


def grad_finite_fraction(grads: List[torch.Tensor]) -> torch.Tensor:
    """Fraction of finite gradient entries (diagnostic scalar)."""
    total = sum(g.numel() for g in grads)
    fin = sum(torch.isfinite(g).sum() for g in grads)
    return fin / total


def notfinite_count(guard: FiniteGuard) -> int:
    """Skipped-update counter of a guard."""
    return guard.notfinite_count
