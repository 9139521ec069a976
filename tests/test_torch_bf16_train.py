"""The port's train step in bf16 compute against the JAX package's
`make_train_step` on its bf16 model (`GoatModel(cfg, dtype=bf16)`), at the
tiny configuration of test_torch_train_step.py, every dropout at 0, the
Gumbel array substituted on both sides as there: one DAgger step at the
"auto" teacher horizon and one imitation step at 4.

The float32 reference is the port's float32 step on the same weights and
batch, which test_torch_train_step.py and test_torch_train_imitation.py
hold to the JAX float32 step within 1e-4 (loss) and 1e-5 (gradients).
The sampled (dagger) or teacher-forced (imitation) actions are identical
on the three; the loss's and the whole gradient's distances from the
float32 reference, |l - l32| / |l32| and |g - g32| / |g32| over every
parameter, are at most twice the JAX bf16 step's plus ATOL = 1e-3.

Measured: dagger gradients 3.2e-2 from float32 (JAX bf16 2.9e-2),
imitation 5.0e-2 (4.9e-2); losses within 1.4e-4 (JAX 9.5e-4).  The test
holds the whole gradient, not each parameter's: XLA keeps bf16 chains of
elementwise operations in float32 inside its fusions on the CPU
(`--xla_allow_excess_precision`, on by default), PyTorch rounds after each
operation, so single parameters of the port sit up to 3x farther from
float32 than JAX's (some small ones more); with that XLA flag off the JAX
bf16 step lands where the port does (3.6e-2 and 6.5e-2)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu_torch.config import TrainConfig
from vln_goat_tpu_torch.entry import build_train_flagship
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from test_torch_train_step import (B, _jax_rig, _keep_grads, _patch_noise,
                                   rigs)  # noqa: F401  (the fixture)
# torch on one thread: under xdist the workers share the cores
from test_torch_gate_witness import one_thread  # noqa: F401

ATOL = 1e-3


def _port(rigs, alg, th, dtype):
    state, _ = build_train_flagship(
        "cpu", tiny=True, batch_size=B, dropout=False,
        tcfg=TrainConfig(train_alg=alg, weight_decay=0.01),
        teacher_horizon=th, compute_dtype=dtype)
    state.model.load_state_dict(rigs["sd"])
    m, grads, outs = state.step_fn(state, rigs["tbatch"],
                                   torch.Generator().manual_seed(0),
                                   keep=True)
    feedback = "sample" if alg == "dagger" else "teacher"
    return (float(m["loss"]), {k: v.double().numpy() for k, v in
                               grads.items()},
            outs[feedback]["actions"].numpy())


def _jax_bf16(rigs, alg, th):
    ro, params, _ = _jax_rig(rigs["sd"], dtype=jnp.bfloat16)
    tx = _keep_grads()
    step = jax.jit(jtr.make_train_step(
        ro, tx, train_alg=alg, ml_weight=0.2, teacher_horizon=th,
        vectorized_teacher=False))
    state, m = step(jtr.init_train_state(params, tx), rigs["jbatch"],
                    jax.random.PRNGKey(0))
    grads = params_from_flax(flatten(jax.tree.map(
        lambda t: np.asarray(t, np.float64), state.opt_state)["params"]))
    feedback = "sample" if alg == "dagger" else "teacher"
    fn = jax.jit(ro.build_rollout(feedback, train_ml=True,
                                  deterministic=False))
    actions = np.asarray(fn(params, rigs["jbatch"],
                            jax.random.PRNGKey(0))["actions"])
    return float(m["loss"]), grads, actions


@pytest.mark.parametrize("alg,th", [("dagger", "auto"), ("imitation", 4)])
def test_bf16_step_matches_jax_bf16(rigs, alg, th):  # noqa: F811
    mp = pytest.MonkeyPatch()
    try:
        _patch_noise(mp, rigs["noise"])
        l32, g32, a32 = _port(rigs, alg, th, "float32")
        l16, g16, a16 = _port(rigs, alg, th, "bfloat16")
        lj, gj, aj = _jax_bf16(rigs, alg, th)
    finally:
        mp.undo()
    T = a16.shape[0]
    assert np.array_equal(a16, a32) and np.array_equal(a16, aj[:T])
    assert (aj[T:] == -1).all()

    err_l, err_lj = abs(l16 - l32) / abs(l32), abs(lj - l32) / abs(l32)
    assert err_l <= 2 * err_lj + ATOL, (err_l, err_lj)
    names = sorted(g32)
    flat = lambda g: np.concatenate(  # noqa: E731
        [np.ravel(g.get(n, np.zeros_like(g32[n]))) for n in names])
    ref = flat(g32)
    norm = np.linalg.norm(ref)
    err_g = np.linalg.norm(flat(g16) - ref) / norm
    err_gj = np.linalg.norm(flat(gj) - ref) / norm
    print(f"{alg}: loss {err_l:.2e} (jax {err_lj:.2e}), grads {err_g:.2e} "
          f"(jax {err_gj:.2e})")
    assert err_g <= 2 * err_gj + ATOL, (err_g, err_gj)
