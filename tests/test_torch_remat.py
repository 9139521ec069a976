"""Rematerialisation of the training rollouts (`remat="model"`: each
step's `forward_panorama` and `forward_navigation` under
`ops.dropout.checkpoint`, recomputed in the backward).

- With dropout on (0.1 everywhere, features 0.1), two consecutive steps
  under "model" and under "none" from the same weights, batches and
  generator seed give the same loss, bit for bit the same gradients and
  parameters, and leave the generator in the same state: the recompute
  replays the forward's dropout draws, the attention seeds included, and
  leaves the generator as the forward left it.  Plain and causal.
- With dropout off, the DAgger step under "model" equals the JAX package's
  `make_train_step(remat="model")` as test_torch_train_step.py holds the
  "none" step (losses 1e-4 relative, gradients atol 1e-5 / rtol 1e-3,
  identical sampled actions, the Gumbel array substituted on both sides).
- A policy that is none of the JAX package's raises, naming it (the
  others: tests/test_torch_remat_policies.py).
"""
import numpy as np
import pytest
import jax
import torch

from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu_torch.entry import build_train_flagship
from vln_goat_tpu_torch.ops.dropout import Dropout, checkpoint, set_generator
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from test_torch_train_step import (B, _keep_grads, _patch_noise,
                                   rigs)  # noqa: F401  (the fixture)
# torch on one thread: under xdist the workers share the cores
from test_torch_gate_witness import one_thread  # noqa: F401


def _two_steps(remat, causal):
    state, batcher = build_train_flagship("cpu", tiny=True, batch_size=4,
                                          causal=causal, remat=remat)
    g = torch.Generator().manual_seed(11)
    steps = []
    for _ in range(2):
        m, grads, _ = state.step_fn(state, batcher.next_batch()[1], g,
                                    keep=True)
        steps.append((float(m["loss"]), grads, g.get_state().clone()))
    params = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    return steps, params


@pytest.mark.parametrize("causal", [False, True])
def test_model_remat_equals_none_with_dropout(causal):
    got, p_got = _two_steps("model", causal)
    ref, p_ref = _two_steps("none", causal)
    for (l1, g1, s1), (l2, g2, s2) in zip(got, ref):
        assert l1 == l2
        assert set(g1) == set(g2)
        for name in g2:
            assert torch.equal(g1[name], g2[name]), name
        assert torch.equal(s1, s2)
    for name in p_ref:
        assert torch.equal(p_got[name], p_ref[name]), name


def test_checkpoint_replays_dropout_draws():
    """One module through `checkpoint`: the gradient is the one without it
    (the recompute draws the forward's mask from the module's generator),
    and the generator ends where the forward left it."""
    lin, drop = torch.nn.Linear(8, 8), Dropout(0.5)
    net = torch.nn.Sequential(lin, drop, torch.nn.Tanh(),
                              torch.nn.Linear(8, 1))
    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(1))
    grads, states = [], []
    for use_ckpt in (True, False):
        g = torch.Generator().manual_seed(5)
        set_generator(net, g)
        net.zero_grad()
        out = checkpoint(net, net, x) if use_ckpt else net(x)
        torch.randn(3, generator=g)     # a draw between forward and backward
        out.sum().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
        states.append(g.get_state())
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert torch.equal(*states)


def test_model_remat_matches_jax(rigs):  # noqa: F811
    mp = pytest.MonkeyPatch()
    try:
        _patch_noise(mp, rigs["noise"])
        tx = _keep_grads()
        jstep = jax.jit(jtr.make_train_step(
            rigs["jro"], tx, train_alg="dagger", ml_weight=0.2,
            teacher_horizon="auto", vectorized_teacher=False,
            remat="model"))
        jstate, jm = jstep(jtr.init_train_state(rigs["params"], tx),
                           rigs["jbatch"], jax.random.PRNGKey(0))
        jgrads = params_from_flax(flatten(
            jax.tree.map(np.asarray, jstate.opt_state)["params"]))
        state, _ = build_train_flagship("cpu", tiny=True, batch_size=B,
                                        dropout=False, remat="model")
        state.model.load_state_dict(rigs["sd"])
        pm, pgrads, outs = state.step_fn(
            state, rigs["tbatch"], torch.Generator().manual_seed(0),
            keep=True)
        fn = jax.jit(rigs["jro"].build_rollout(
            "sample", train_ml=True, deterministic=False))
        jactions = np.asarray(fn(rigs["params"], rigs["jbatch"],
                                 jax.random.PRNGKey(0))["actions"])
    finally:
        mp.undo()
    for k in ("loss", "grad_norm", "il_loss", "sample_loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert set(pgrads) <= set(jgrads)
    for name, ref in jgrads.items():
        got = pgrads[name].numpy() if name in pgrads else np.zeros_like(ref)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-3,
                                   err_msg=name)
    assert np.array_equal(outs["sample"]["actions"].numpy(), jactions)


@pytest.mark.parametrize("policy", [
    "bogus", "", "Full", "none ", "model_dots", "dots_saveable", "offload",
    "blk", "ffn_wide"])
def test_unported_remat_policies_raise(policy):
    with pytest.raises(ValueError, match=repr(policy)):
        build_train_flagship("cpu", tiny=True, batch_size=4, remat=policy)
