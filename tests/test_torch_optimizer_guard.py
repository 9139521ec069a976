"""The optimizer's finite guard and gradient accumulation against the JAX
package's `make_optimizer(finite_guard=..., accumulate_steps=...)`, i.e.
optax's MultiSteps(apply_if_finite(chain(clip, adamw))), over 12 steps of
numpy gradients on a small parameter set (test_torch_optimizer.py's):

- the guard alone, with non-finite gradients at two steps (skipped: the
  parameters, the moments and the schedule stay), and with 11 consecutive
  non-finite steps (the 11th, past max_consecutive_errors = 10, is
  applied and makes the parameters non-finite, as optax's does);
- accumulation alone, k = 3, with the global-norm clip acting (gradients
  scaled by 300) and a warm-up schedule: the mean of each 3 mini-batch
  gradients is clipped once and makes one update, the schedule counts
  updates;
- both together, with a NaN mini-batch: as in optax the running mean keeps
  it (its reset multiplies by 0), so every later update is skipped.

Parameters agree to 1e-7 absolute, non-finite entries where optax's are;
the guard's counters and the update count exactly.  The guard's helpers
against the JAX package's utils.guard."""
import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu.utils import guard as jguard
from vln_goat_tpu_torch.train import trainer as ptr
from vln_goat_tpu_torch.utils import guard as pguard
from test_torch_optimizer import LR, SHAPES, WD, _rig

STEPS = 12


def _guard_state(js):
    """The ApplyIfFiniteState inside a JAX optimizer state."""
    return js.inner_opt_state if hasattr(js, "inner_opt_state") else js


def _run(grads_per_step, **kw):
    """The same gradients through optax and the port, compared after
    every step; returns (port state, JAX optimizer state)."""
    _, params, module = _rig()
    tx = jtr.make_optimizer(lr=LR, weight_decay=WD, grad_clip=40.0, **kw)
    update = jax.jit(tx.update)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    opt, scheduler = ptr.make_optimizer(list(module.values()), LR, WD, **kw)
    state = ptr.TrainState(module, opt, scheduler, 40.0)
    for i, grads in enumerate(grads_per_step):
        upd, js = update({k: jnp.asarray(g) for k, g in grads.items()}, js,
                         jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.items():
            p.grad = torch.from_numpy(grads[k].copy())
        ptr.apply_update(state)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-7,
                                       rtol=0, err_msg=f"{k} @ step {i}")
        if kw.get("finite_guard"):
            jg = _guard_state(js)
            assert opt.guard.notfinite_count == int(jg.notfinite_count)
            assert opt.guard.total_notfinite == int(jg.total_notfinite)
            assert opt.guard.last_finite == bool(jg.last_finite)
    return state, js


def _grads(seed, scale=1.0, bad=()):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(STEPS):
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in SHAPES.items()}
        if i in bad:
            g["a"][1, 2] = np.nan if i % 2 else np.inf
        out.append(g)
    return out


def test_guard_skips_non_finite_steps():
    state, _ = _run(_grads(1, bad=(3, 7)), finite_guard=True)
    assert state.step == STEPS - 2
    assert state.optimizer.guard.total_notfinite == 2
    assert all(np.isfinite(p.detach().numpy()).all()
               for p in state.model.parameters())


def test_guard_applies_past_ten_consecutive():
    state, _ = _run(_grads(2, bad=range(11)), finite_guard=True)
    guard = state.optimizer.guard
    assert guard.notfinite_count == 0 and guard.total_notfinite == 11
    # steps 0-9 skipped, the 11th applied (non-finite), the 12th finite
    assert state.step == 2
    assert not np.isfinite(state.model["a"].detach().numpy()).all()


def test_accumulation_clips_the_mean_once():
    state, js = _run(_grads(3, scale=300.0), accumulate_steps=3,
                     warmup_steps=2, total_steps=6)
    assert state.step == STEPS // 3 == int(js.gradient_step)
    assert state.optimizer.accumulator.mini_step == int(js.mini_step) == 0


def test_accumulation_with_guard_keeps_a_nan_mean():
    state, js = _run(_grads(4, scale=300.0, bad=(4,)), accumulate_steps=3,
                     finite_guard=True)
    # updates at steps 2 (applied), 5, 8, 11 (the mean holds the NaN)
    assert state.step == 1
    assert state.optimizer.guard.notfinite_count == 3
    assert int(js.gradient_step) == 4


def test_guard_helpers_match_jax():
    rng = np.random.default_rng(6)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in SHAPES.values()]
    grads[0][0, 0] = np.nan
    grads[2][1, 1, 1] = -np.inf
    got = pguard.grad_finite_fraction([torch.from_numpy(g) for g in grads])
    ref = jguard.grad_finite_fraction({str(i): jnp.asarray(g)
                                       for i, g in enumerate(grads)})
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-7)
    guard = pguard.finite_guard()
    assert not guard.allow([torch.from_numpy(g) for g in grads])
    assert pguard.notfinite_count(guard) == 1


def test_accumulation_needs_two_steps():
    _, _, module = _rig()
    with pytest.raises(ValueError, match="accumulate_steps"):
        ptr.GradAccumulator(list(module.values()), 1)
