"""The port's optimizer against the JAX package's `make_optimizer`
(optax clip + AdamW), on small parameter sets with numpy gradients:

- the warmup-cosine default: `make_optimizer(lr, warmup_steps,
  total_steps)` without a named schedule follows
  optax.warmup_cosine_decay_schedule(0, lr, warmup, total, lr * 0.01),
  over 20 updates that cross the end of the warm-up and of the decay;
- a parameter without a gradient: optax steps a leaf whose gradient is
  zero (its moments decay, the weight decay shrinks it), and the port's
  AdamW does the same for a parameter whose `grad` is None.

Parameters agree to 1e-7 absolute (float32, magnitudes below 4; optax
evaluates the schedule in float32, the port in Python floats)."""
import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu_torch.train import trainer as ptr

SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
LR, WD = 2e-3, 0.01


def _rig(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    return rng, params, module


def _state(module, **sched):
    opt, scheduler = ptr.make_optimizer(list(module.values()), LR, WD,
                                        **sched)
    return ptr.TrainState(module, opt, scheduler, 40.0)


def _run(module, params, grads_per_step, **sched):
    """The same gradients through optax (JAX make_optimizer) and the
    port (make_optimizer + apply_update); a None gradient is a zero leaf
    on the JAX side and `grad = None` on the port's."""
    tx = jtr.make_optimizer(lr=LR, weight_decay=WD, **sched)
    update = jax.jit(tx.update)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    state = _state(module, **sched)
    for grads in grads_per_step:
        jg = {k: jnp.zeros(SHAPES[k]) if g is None else jnp.asarray(g)
              for k, g in grads.items()}
        upd, js = update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.items():
            p.grad = None if grads[k] is None else torch.from_numpy(grads[k])
        ptr.apply_update(state)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-7,
                                       rtol=0, err_msg=f"{k} @ {state.step}")
    return state


def test_warmup_cosine_default_matches_optax():
    rng, params, module = _rig()
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(20)]
    state = _run(module, params, grads, warmup_steps=5, total_steps=15)
    assert state.step == 20


@pytest.mark.parametrize("count", [0, 1, 4, 5, 6, 10, 14, 15, 16, 40])
def test_warmup_cosine_schedule_values(count):
    """The schedule itself: 0 at update 0, lr at the end of the warm-up,
    lr * 0.01 from the end of the decay on."""
    ref = optax.warmup_cosine_decay_schedule(0.0, LR, 5, 15,
                                             end_value=LR * 0.01)
    got = ptr.warmup_cosine_schedule(LR, 5, 15)
    np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6,
                               atol=1e-12)


def test_without_schedule_lr_is_constant():
    """warmup_steps alone (no total_steps) keeps the constant rate, as the
    JAX package's make_optimizer does."""
    _, _, module = _rig()
    state = _state(module, warmup_steps=5)
    assert state.scheduler.get_last_lr() == [LR]


def test_parameter_without_gradient_decays_like_optax():
    """'b' has no gradient at all, 'c' only at the first update: optax
    decays both (and 'c' keeps moving on its first moment); the port's
    AdamW must too.  torch.optim.AdamW would leave both untouched."""
    rng, params, module = _rig(1)
    grads = []
    for i in range(4):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
        g["b"] = None
        if i > 0:
            g["c"] = None
        grads.append(g)
    _run(module, params, grads)
    b0 = params["b"]
    # four decays of lr * wd * p and nothing else
    expect = b0.copy()
    for _ in range(4):
        expect = expect + np.float32(-LR) * (np.float32(0.0)
                                             + np.float32(WD) * expect)
    np.testing.assert_allclose(module["b"].detach().numpy(), expect,
                               atol=1e-7, rtol=0)
    assert not np.array_equal(module["b"].detach().numpy(), b0)
