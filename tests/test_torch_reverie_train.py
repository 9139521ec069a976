"""The port's REVERIE train step, with the object-grounding loss, against
the JAX package's `make_train_step`, on the rig of
test_torch_reverie_rollout.py (every dropout at 0, gt_obj_slot in the
batch).  The sampled rollout's actions are forced to agree by one numpy
Gumbel array substituted on both sides (`jax.random.gumbel` there, the
port's `gumbel_noise`), as test_torch_train_step.py does.

- the og loss is part of the step: the teacher rollout's loss with the
  gt object slots exceeds the one without them;
- "dagger": the port's vectorized teacher and its per-step teacher, each
  against the JAX package's per-step teacher: loss, il_loss, sample_loss
  and grad_norm to a relative 1e-4, every parameter's gradient (og_head's
  and the object embeddings' included) at atol 1e-5 / rtol 1e-3;
- "dagger_fused" (the fused batch of two minibatches) the same way, in
  test_torch_reverie_fused.py.
"""
import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu_torch.rollout import rollout as port_rollout
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from vln_goat_tpu_torch.train.trainer import init_train_state
from test_torch_reverie_rollout import N, obj_rig

G = N + 2


def _keep_grads():
    """An optax transformation whose state is the last gradient."""
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(
        lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


def _noise(n):
    return np.random.default_rng(5).gumbel(size=(n, G)).astype(np.float32)


@pytest.fixture(scope="module")
def rig():
    return obj_rig("reverie", batch_size=4)


def _pair(rig, alg, jbatch, tbatch, vectorized):
    noise = _noise(jbatch["scan_idx"].shape[0])
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax.random, "gumbel",
                   lambda key, shape, *a, **k: jnp.asarray(noise))
        mp.setattr(port_rollout, "gumbel_noise",
                   lambda g, shape, device: torch.from_numpy(noise))
        tx = _keep_grads()
        jstep = jax.jit(jtr.make_train_step(
            rig["jro"], tx, train_alg=alg, ml_weight=0.2,
            vectorized_teacher=False))
        jstate, jm = jstep(jtr.init_train_state(rig["params"], tx), jbatch,
                           jax.random.PRNGKey(0))
        jgrads = params_from_flax(flatten(
            jax.tree.map(np.asarray, jstate.opt_state)["params"]))
        outs = []
        for vec in vectorized:
            # each step from the JAX weights (a step updates the model)
            rig["tm"].load_state_dict(params_from_flax(
                flatten(rig["params"]["params"])))
            state = init_train_state(rig["tm"], rig["tro"], train_alg=alg,
                                     vectorized_teacher=vec)
            pm, pgrads, _ = state.step_fn(
                state, tbatch, torch.Generator().manual_seed(0), keep=True)
            outs.append((vec, pm, pgrads))
    finally:
        mp.undo()
    return jm, jgrads, outs


def _check(jm, jgrads, outs, objects=True):
    for vec, pm, pgrads in outs:
        for k in ("loss", "grad_norm", "il_loss", "sample_loss"):
            np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-4,
                                       err_msg=f"{k} vectorized={vec}")
        assert set(pgrads) <= set(jgrads)
        for name, ref in jgrads.items():
            got = pgrads[name].numpy() if name in pgrads \
                else np.zeros_like(ref)
            np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5,
                                       rtol=1e-3, err_msg=name)
        if not objects:
            continue
        # the object branch learns
        assert float(pgrads["og_head.net.3.weight"].abs().sum()) > 0
        assert float(pgrads["img_embeddings.obj_reverie_linear.weight"]
                     .abs().sum()) > 0


def test_og_loss_in_teacher_rollout(rig):
    """With the gt slots the teacher rollout's loss grows by the og
    cross-entropy at the goal; without any it is the navigation loss."""
    tro, tb = rig["tro"], rig["tbatch"]
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        with_og = tro.train_rollout(tb, "teacher", g)["loss_per_ep"]
        plain = tro.train_rollout(
            {k: v for k, v in tb.items() if k != "gt_obj_slot"}, "teacher",
            g)["loss_per_ep"]
        vec = tro.teacher_rollout_vec(tb, g)["loss_per_ep"]
    has = tb["gt_obj_slot"] >= 0
    assert has.any()
    assert bool((with_og[has] > plain[has] + 1e-3).all())
    assert torch.equal(with_og[~has], plain[~has])
    np.testing.assert_allclose(vec.numpy(), with_og.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_dagger_step_matches_jax(rig):
    _check(*_pair(rig, "dagger", rig["jbatch"], rig["tbatch"],
                  (True, False)))
