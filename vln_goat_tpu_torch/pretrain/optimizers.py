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
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.logger import read


@dataclass
class Transform:
    init: Callable
    update: Callable


def chain(*ts: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in ts]

    def update(updates, state, params=None):
        new = []
        for t, s in zip(ts, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, new

    return Transform(init, update)


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

    return Transform(init, update)


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

    return Transform(lambda params: None, update)


def scale_by_learning_rate(lr: Callable[[int], float]) -> Transform:
    """u * -lr(count), count the updates before this one."""
    def update(updates, state, params=None):
        step = float(-np.float32(lr(state)))
        return [step * u for u in updates], state + 1

    return Transform(lambda params: 0, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    """optax.clip_by_global_norm: (u / ||u||) max_norm unless ||u|| <
    max_norm."""
    def update(updates, state, params=None):
        norm = torch.sqrt(sum((u.float() * u.float()).sum()
                              for u in updates))
        if read(norm < max_norm):
            return updates, state
        return [(u / norm.to(u.dtype)) * max_norm for u in updates], state

    return Transform(lambda params: None, update)


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
