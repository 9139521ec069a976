"""Optimizers of the pretraining stack (counterpart of
vln_goat_tpu/pretrain/optimizers.py and of the optax transformations it
chains), in optax's arithmetic order on lists of torch tensors.

A `Transform` is optax's GradientTransformation: `init(params) -> state`,
`update(updates, state, params) -> (updates, state)`, where updates,
params and every per-parameter state are lists of tensors in one order.
`chain` composes them; the caller adds the final updates to the
parameters (optax.apply_updates).  The variants (the reference's
optim/misc.py registry, plus radam / ralamb):

- adam, adamax, radam (optax's rectification, threshold 5): each
  scale_by_* then the learning rate;
- adamw: scale_by_adam, the decayed weights of the leaves `decay_mask`
  picks, the learning rate;
- ralamb: the decayed weights of every leaf before RAdam, then the LARS
  trust ratio ||p|| / ||u|| with ||p|| clamped to [0, 10];
- lookahead(base, alpha 0.5, k 6): the slow copy pulled in and synced
  every k-th update; rangerlars = lookahead(ralamb).

Learning rates are schedules of optax's update count, which starts at 0;
each schedule value is a float32 number, as the JAX package computes it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops import optim
from ..utils.logger import read


@dataclass
class Transform:
    """`fused`: what `apply_updates` needs of a transformation the fused
    update takes ({"kind": "clip" | "adam" | "decay" | "lr", ...}); `parts`:
    a chain's transformations."""
    init: Callable
    update: Callable
    fused: Optional[dict] = None
    parts: tuple = ()


def chain(*ts: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in ts]

    def update(updates, state, params=None):
        new = []
        for t, s in zip(ts, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, new

    return Transform(init, update, parts=ts)


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32 (optax's bias_correction), computed on
    the host: a float32 value that a tensor op takes exactly."""
    return float(np.float32(1.0) - np.float32(decay) ** np.int32(count))


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> Transform:
    def init(params):
        return dict(count=0, mu=_zeros(params), nu=_zeros(params))

    def update(updates, state, params=None):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(updates, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(updates,
                                                          state["nu"])]
        n = state["count"] + 1
        out = []
        for m, v in zip(mu, nu):
            m_hat = m / _bias_correction(b1, n)
            v_hat = v / _bias_correction(b2, n)
            out.append(m_hat / (torch.sqrt(v_hat) + eps))
        return out, dict(count=n, mu=mu, nu=nu)

    return Transform(init, update, dict(kind="adam", b1=b1, b2=b2, eps=eps))


def scale_by_adamax(b1=0.9, b2=0.999, eps=1e-8) -> Transform:
    def init(params):
        return dict(count=0, mu=_zeros(params), nu=_zeros(params))

    def update(updates, state, params=None):
        n = state["count"] + 1
        mu = [(1 - b1) * g + b1 * m for g, m in zip(updates, state["mu"])]
        nu = [torch.maximum(g.abs() + eps, b2 * v)
              for g, v in zip(updates, state["nu"])]
        out = [(m / _bias_correction(b1, n)) / v for m, v in zip(mu, nu)]
        return out, dict(count=n, mu=mu, nu=nu)

    return Transform(init, update)


def scale_by_radam(b1=0.9, b2=0.999, eps=1e-8,
                   threshold: float = 5.0) -> Transform:
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def init(params):
        return dict(count=0, mu=_zeros(params), nu=_zeros(params))

    def update(updates, state, params=None):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(updates, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(updates,
                                                          state["nu"])]
        n = state["count"] + 1
        f32 = np.float32
        b2t = f32(b2) ** np.int32(n)
        ro = f32(ro_inf) - f32(2 * n) * b2t / (f32(1) - b2t)
        rect = ro >= threshold
        if rect:
            r = float(np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                              / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        out = []
        for m, v in zip(mu, nu):
            m_hat = m / _bias_correction(b1, n)
            if rect:
                v_hat = v / _bias_correction(b2, n)
                m_hat = r * m_hat / (torch.sqrt(v_hat) + eps)
            out.append(m_hat)
        return out, dict(count=n, mu=mu, nu=nu)

    return Transform(init, update)


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Sequence[bool]] = None) -> Transform:
    """u + weight_decay p on the leaves `mask` picks (all without one)."""
    def update(updates, state, params=None):
        keep = mask if mask is not None else [True] * len(updates)
        return [u + weight_decay * p if d else u
                for u, p, d in zip(updates, params, keep)], state

    return Transform(lambda params: None, update,
                     dict(kind="decay", weight_decay=weight_decay, mask=mask))


def scale_by_learning_rate(lr: Callable[[int], float]) -> Transform:
    """u * -lr(count), count the updates before this one."""
    def update(updates, state, params=None):
        step = float(-np.float32(lr(state)))
        return [step * u for u in updates], state + 1

    return Transform(lambda params: 0, update, dict(kind="lr", lr=lr))


def clip_by_global_norm(max_norm: float) -> Transform:
    """optax.clip_by_global_norm: (u / ||u||) max_norm unless ||u|| <
    max_norm."""
    def update(updates, state, params=None):
        norm = torch.sqrt(sum((u.float() * u.float()).sum()
                              for u in updates))
        if read(norm < max_norm):
            return updates, state
        return [(u / norm.to(u.dtype)) * max_norm for u in updates], state

    return Transform(lambda params: None, update,
                     dict(kind="clip", max_norm=max_norm))


def lars_trust(base: Transform, clamp: float = 10.0) -> Transform:
    """base's updates each scaled by ||p|| / ||u||, ||p|| clamped to
    [0, clamp]; by 1 where either norm is 0."""
    def update(updates, state, params=None):
        updates, state = base.update(updates, state, params)
        out = []
        for u, p in zip(updates, params):
            wn = torch.linalg.vector_norm(p.float()).clamp(0.0, clamp)
            un = torch.linalg.vector_norm(u.float())
            trust = torch.where((wn > 0) & (un > 0),
                                wn / un.clamp(min=1e-12),
                                torch.ones_like(wn))
            out.append(u * trust.to(u.dtype))
        return out, state

    return Transform(base.init, update)


def lookahead(base: Transform, alpha: float = 0.5, k: int = 6
              ) -> Transform:
    """Every k-th update the fast weights p + u are pulled toward the slow
    copy, slow + alpha (fast - slow), which becomes the new slow copy;
    the update returned is the new weights minus p."""
    def init(params):
        return dict(base=base.init(params),
                    slow=[p.detach().clone() for p in params], step=0)

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("lookahead needs params")
        updates, bstate = base.update(updates, state["base"], params)
        step = state["step"] + 1
        fast = [p + u for p, u in zip(params, updates)]
        if step % k == 0:
            new_p = [s + alpha * (f - s) for f, s in zip(fast, state["slow"])]
            slow = new_p
        else:
            new_p, slow = fast, state["slow"]
        return [q - p for q, p in zip(new_p, params)], \
            dict(base=bstate, slow=slow, step=step)

    return Transform(init, update)


def radam(lr, b1=0.9, b2=0.999, eps=1e-8) -> Transform:
    return chain(scale_by_radam(b1, b2, eps), scale_by_learning_rate(lr))


def ralamb(lr, b1=0.9, b2=0.999, eps=1e-8,
           weight_decay: float = 0.0) -> Transform:
    base = radam(lr, b1, b2, eps)
    if weight_decay:
        base = chain(add_decayed_weights(weight_decay), base)
    return lars_trust(base)


def rangerlars(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay: float = 0.0,
               alpha: float = 0.5, k: int = 6) -> Transform:
    return lookahead(ralamb(lr, b1, b2, eps, weight_decay), alpha=alpha, k=k)


OPTIMIZERS = ("adam", "adamax", "adamw", "radam", "ralamb", "rangerlars")


def build_optimizer(name: str, lr, b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay: float = 0.01,
                    decay_mask: Optional[Sequence[bool]] = None
                    ) -> Transform:
    """The JAX package's build_optimizer: `lr` a schedule of the update
    count; `decay_mask` (adamw only) one bool per parameter."""
    name = name.lower()
    if name == "adam":
        return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr))
    if name == "adamax":
        return chain(scale_by_adamax(b1, b2, eps),
                     scale_by_learning_rate(lr))
    if name == "adamw":
        return chain(scale_by_adam(b1, b2, eps),
                     add_decayed_weights(weight_decay, decay_mask),
                     scale_by_learning_rate(lr))
    if name == "radam":
        return radam(lr, b1, b2, eps)
    if name == "ralamb":
        return ralamb(lr, b1, b2, eps, weight_decay)
    if name == "rangerlars":
        return rangerlars(lr, b1, b2, eps, weight_decay)
    raise ValueError(f"invalid optimizer {name}")


# the chains the fused update takes: [clip], adam, [decay], lr
_FUSED = {("adam", "lr"), ("adam", "decay", "lr"), ("clip", "adam", "lr"),
          ("clip", "adam", "decay", "lr")}


def _flat(tx: Transform) -> list:
    """The transformations of a chain in order, nested chains flattened."""
    return [x for t in tx.parts for x in _flat(t)] if tx.parts else [tx]


def _flat_states(tx: Transform, state) -> list:
    """The states of `_flat(tx)`'s transformations, in the same order."""
    if not tx.parts:
        return [state]
    return [x for t, s in zip(tx.parts, state) for x in _flat_states(t, s)]


def fused_parts(tx: Transform) -> Optional[dict]:
    """{kind: its `fused` dict} of the transformations of `tx` when it is a
    chain the fused update takes (adam or adamw, with or without the clip
    first); None for any other."""
    ts = _flat(tx)
    if tuple(t.fused["kind"] if t.fused else None for t in ts) not in _FUSED:
        return None
    return {t.fused["kind"]: t.fused for t in ts}


def _advance(tx: Transform, state):
    """`tx`'s state after one fused update: the Adam and learning-rate
    counts one up, the moments (updated in place) kept."""
    if tx.parts:
        return [_advance(t, s) for t, s in zip(tx.parts, state)]
    kind = tx.fused["kind"] if tx.fused else None
    if kind == "adam":
        return dict(state, count=state["count"] + 1)
    return state + 1 if kind == "lr" else state


@torch.no_grad()
def apply_updates(tx: Transform, state, params: List[torch.Tensor],
                  grads: List[Optional[torch.Tensor]]):
    """One update of `params` in place by `tx` from `grads` (None: a leaf
    without a gradient, which steps with a zero one) -> tx's new state
    (optax's update, then apply_updates).  A chain of `fused_parts` takes
    `ops.optim.clip_adamw_` (on the card two launches, no read of the
    norm), bit-equal to its loop; any other runs its transformations'
    loops."""
    parts = fused_parts(tx)
    if parts is None:
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        updates, state = tx.update(grads, state, params)
        for p, u in zip(params, updates):
            p.add_(u)
        return state
    states = {t.fused["kind"]: s for t, s in zip(_flat(tx),
                                                  _flat_states(tx, state))}
    adam, count = states["adam"], states["lr"]
    a, n = parts["adam"], adam["count"] + 1
    decay = parts.get("decay")
    clip = parts.get("clip")
    optim.clip_adamw_([optim.Group(
        params, grads, adam["mu"], adam["nu"], a["b1"], a["b2"], a["eps"],
        decay["weight_decay"] if decay else 0.0,
        float(-np.float32(parts["lr"]["lr"](count))),
        _bias_correction(a["b1"], n), _bias_correction(a["b2"], n),
        (decay["mask"] or [True] * len(params)) if decay
        else [False] * len(params))],
        clip["max_norm"] if clip else None, clip_at_max=True)
    return _advance(tx, state)
