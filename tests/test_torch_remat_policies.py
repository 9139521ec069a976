"""The JAX package's rematerialisation policies in the port
(`ops.remat.POLICIES`; vln_goat_tpu/rollout/rollout.py:1004-1040,
:1419-1468, :1636-1663).

- With dropout on (0.1 everywhere), one DAgger step of the tiny build
  (vectorized teacher, and the per-step teacher for the step policies)
  under each policy gives "none"'s loss and every gradient bit for bit,
  and leaves the generator in "none"'s state: each recompute replays the
  forward's draws, and a value a policy keeps is the value the forward
  made.
- With dropout off, the port's "full" step equals the JAX package's default
  `make_train_step` (remat "full") as test_torch_train_step.py holds the
  "none" step: losses to 1e-4 relative, gradients atol 1e-5 / rtol 1e-3,
  identical sampled actions (one Gumbel array substituted on both sides).
- The bytes a forward keeps for its backward (`ops.remat.SavedBytes`:
  what autograd saves outside a checkpoint, and each checkpoint's inputs
  and kept outputs) follow full < bounds < probs < wide <= none, and
  model < none, so no policy is a silent no-op.
"""
import numpy as np
import pytest
import jax
import torch

from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu_torch.entry import build_train_flagship
from vln_goat_tpu_torch.ops.dropout import set_generator
from vln_goat_tpu_torch.ops.remat import (POLICIES, SavedBytes,
                                          checkpoint_name)
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from vln_goat_tpu_torch.train.trainer import make_loss_fn
from test_torch_train_step import (B, _keep_grads, _patch_noise,
                                   rigs)  # noqa: F401  (the fixture)
from test_torch_gate_witness import one_thread  # noqa: F401


def _step(remat, vec=True):
    state, batcher = build_train_flagship("cpu", tiny=True, batch_size=4,
                                          remat=remat,
                                          vectorized_teacher=vec)
    g = torch.Generator().manual_seed(11)
    m, grads, _ = state.step_fn(state, batcher.next_batch()[1], g,
                                keep=True)
    return float(m["loss"]), grads, g.get_state()


@pytest.fixture(scope="module")
def none_steps():
    n = torch.get_num_threads()
    torch.set_num_threads(1)     # as one_thread sets it for each test
    try:
        return {vec: _step("none", vec) for vec in (True, False)}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("policy", [p for p in POLICIES if p != "none"])
def test_policy_equals_none_with_dropout(policy, none_steps):
    loss, grads, gen = _step(policy)
    ref_loss, ref_grads, ref_gen = none_steps[True]
    assert loss == ref_loss
    assert set(grads) == set(ref_grads)
    for name, g in ref_grads.items():
        assert torch.equal(grads[name], g), name
    assert torch.equal(gen, ref_gen)


@pytest.mark.parametrize("policy", ["full", "dots", "ffn", "probs"])
def test_step_policy_per_step_teacher(policy, none_steps):
    """The per-step teacher runs its steps under the step policies too."""
    loss, grads, _ = _step(policy, vec=False)
    ref_loss, ref_grads, _ = none_steps[False]
    assert loss == ref_loss
    for name, g in ref_grads.items():
        assert torch.equal(grads[name], g), name


def test_full_matches_jax_default(rigs):  # noqa: F811
    mp = pytest.MonkeyPatch()
    try:
        _patch_noise(mp, rigs["noise"])
        tx = _keep_grads()
        jstep = jax.jit(jtr.make_train_step(
            rigs["jro"], tx, train_alg="dagger", ml_weight=0.2,
            teacher_horizon="auto", vectorized_teacher=False))
        jstate, jm = jstep(jtr.init_train_state(rigs["params"], tx),
                           rigs["jbatch"], jax.random.PRNGKey(0))
        jgrads = params_from_flax(flatten(
            jax.tree.map(np.asarray, jstate.opt_state)["params"]))
        state, _ = build_train_flagship("cpu", tiny=True, batch_size=B,
                                        dropout=False, remat="full",
                                        vectorized_teacher=False)
        state.model.load_state_dict(rigs["sd"])
        pm, pgrads, _ = state.step_fn(
            state, rigs["tbatch"], torch.Generator().manual_seed(0),
            keep=True)
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


@pytest.fixture(scope="module")
def saved():
    """Bytes kept by one forward of the DAgger loss under each policy."""
    state, batcher = build_train_flagship("cpu", tiny=True, batch_size=4,
                                          remat="none")
    batch = batcher.next_batch()[1]
    model = state.model
    model.train()
    out = {}
    for policy in POLICIES:
        loss_fn = make_loss_fn(state.rollout, teacher_horizon="auto",
                               remat=policy)
        g = torch.Generator().manual_seed(11)
        set_generator(model, g)
        with SavedBytes() as counter:
            loss, _, _ = loss_fn(batch, g)
        out[policy] = counter.nbytes
        del loss
    return out


def test_saved_bytes_order(saved):
    s = saved
    assert s["full"] < s["bounds"] < s["probs"] < s["wide"] <= s["none"], s
    assert s["model"] < s["none"], s
    assert s["model_probs"] < s["model_wide"], s
    assert s["ffn"] < s["none"], s


def test_names_are_copies_only_under_a_naming_policy():
    x = torch.randn(3, requires_grad=True)
    assert checkpoint_name(x, "blk") is x
    with SavedBytes() as counter:
        y = (x * x).sum()
    assert counter.nbytes == x.untyped_storage().nbytes()   # x, once
    y.backward()
    assert torch.equal(x.grad, 2 * x)


@pytest.mark.parametrize("policy", ["bogus", "", "FULL", "model_dots"])
def test_unknown_policy_raises(policy):
    with pytest.raises(ValueError, match="unknown remat policy"):
        make_loss_fn(None, remat=policy)
