"""The port's fused DAgger step (`train_alg="dagger_fused"`: the teacher
and the sampled rollout of the reference's DAgger step, each on a
minibatch of its own, as one rollout over both) at the tiny configuration
of test_torch_train_step.py, every dropout at 0:

- `fuse_dagger_batches` gives the JAX package's fused batch, for halves
  of one gt-length bucket and of two (the narrower gt paths padded with
  -1);
- the fused rollout's halves are the separate rollouts they replace (as
  the JAX package's tests/test_fused_dagger.py:46 holds its own): the
  teacher half's per-episode losses and actions those of the per-step
  teacher on the first minibatch, the sampled half's those of the sampled
  rollout on the second, the Gumbel draw substituted (the same rows of
  one array on both: the fused rollout gathers it by its episodes' uids,
  the second half's from B on);
- one `dagger_fused` train step against the JAX package's
  `make_train_step(train_alg="dagger_fused")`, the Gumbel draw
  substituted on both sides: loss, il_loss, sample_loss and grad_norm to
  a relative 1e-4, every parameter's gradient at atol 1e-5 / rtol 1e-3.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu_torch.config import TrainConfig
from vln_goat_tpu_torch.entry import build_train_flagship
from vln_goat_tpu_torch.ops.dropout import set_generator
from vln_goat_tpu_torch.rollout import rollout as port_rollout
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from vln_goat_tpu_torch.train.trainer import fuse_dagger_batches
from test_torch_train_step import B, _jax_rig, _keep_grads, rigs  # noqa
# torch on one thread: under xdist the workers share the cores
from test_torch_gate_witness import one_thread  # noqa: F401

G = 16 + 2          # map tokens of the tiny configuration


def _two_batches(rigs, widths_differ):  # noqa: F811
    """Two consecutive batches of fresh JAX and port batchers (identical
    draws), the first pair whose gt widths differ (or agree)."""
    _, _, jbatcher = _jax_rig(rigs["sd"])
    _, tbatcher = build_train_flagship("cpu", tiny=True, batch_size=B,
                                       dropout=False)
    jprev, tprev = jbatcher.next_batch()[1], tbatcher.next_batch()[1]
    for _ in range(40):
        jb, tb = jbatcher.next_batch()[1], tbatcher.next_batch()[1]
        differ = jprev["gt_path"].shape[1] != jb["gt_path"].shape[1]
        if differ == widths_differ:
            return (jprev, jb), (tprev, tb)
        jprev, tprev = jb, tb
    raise AssertionError("no such pair of batches")


@pytest.mark.parametrize("widths_differ", [False, True])
def test_fuse_matches_jax(rigs, widths_differ):  # noqa: F811
    (j1, j2), (t1, t2) = _two_batches(rigs, widths_differ)
    ref = jtr.fuse_dagger_batches(j1, j2)
    got = fuse_dagger_batches(t1, t2)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    assert got["is_teacher"].tolist() == [True] * B + [False] * B
    if widths_differ:
        assert (got["gt_path"] == -1).any()


def _noise(n):
    return np.random.default_rng(7).gumbel(size=(n, G)).astype(np.float32)


def test_fused_halves_match_separate_rollouts(rigs):  # noqa: F811
    (_, _), (t1, t2) = _two_batches(rigs, True)
    fused = fuse_dagger_batches(t1, t2)
    noise = _noise(2 * B)
    state, _ = build_train_flagship("cpu", tiny=True, batch_size=B,
                                    dropout=False)
    ro = state.rollout
    ro.model.load_state_dict(rigs["sd"])
    ro.model.train()
    mp = pytest.MonkeyPatch()
    try:
        # the rows of the episodes that sample: B.. of the fused batch,
        # the last B of the array for the second batch alone
        mp.setattr(port_rollout, "gumbel_noise",
                   lambda g, shape, device: torch.from_numpy(
                       noise[noise.shape[0] - shape[0]:]))
        outs = {}
        for name, batch, feedback in (("fused", fused, "fused_dagger"),
                                      ("teacher", t1, "teacher"),
                                      ("sample", t2, "sample")):
            g = torch.Generator().manual_seed(0)
            set_generator(ro.model, g)
            with torch.no_grad():
                outs[name] = ro.train_rollout(batch, feedback, g)
    finally:
        mp.undo()
    f = outs["fused"]
    for half, name in ((slice(0, B), "teacher"), (slice(B, 2 * B), "sample")):
        np.testing.assert_allclose(f["loss_per_ep"][half].numpy(),
                                   outs[name]["loss_per_ep"].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        T = outs[name]["actions"].shape[0]
        assert torch.equal(f["actions"][:T, half], outs[name]["actions"])
        assert (f["actions"][T:, half] == -1).all()
    assert (f["actions"][:, B:] >= 0).any()


def test_fused_train_step_matches_jax(rigs):  # noqa: F811
    (j1, j2), (t1, t2) = _two_batches(rigs, True)
    noise = _noise(2 * B)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax.random, "gumbel",
                   lambda key, shape, *a, **k: jnp.asarray(noise))
        mp.setattr(port_rollout, "gumbel_noise",
                   lambda g, shape, device: torch.from_numpy(noise))
        tx = _keep_grads()
        jstep = jax.jit(jtr.make_train_step(
            rigs["jro"], tx, train_alg="dagger_fused", ml_weight=0.2))
        jstate, jm = jstep(jtr.init_train_state(rigs["params"], tx),
                           jtr.fuse_dagger_batches(j1, j2),
                           jax.random.PRNGKey(0))
        jgrads = params_from_flax(flatten(
            jax.tree.map(np.asarray, jstate.opt_state)["params"]))
        state, _ = build_train_flagship(
            "cpu", tiny=True, batch_size=B, dropout=False,
            tcfg=TrainConfig(train_alg="dagger_fused", weight_decay=0.01))
        state.model.load_state_dict(rigs["sd"])
        pm, pgrads, outs = state.step_fn(
            state, fuse_dagger_batches(t1, t2),
            torch.Generator().manual_seed(0), keep=True)
    finally:
        mp.undo()
    for k in ("loss", "grad_norm", "il_loss", "sample_loss"):
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert pm["node_overflow"].item() == float(jm["node_overflow"])
    assert set(pgrads) <= set(jgrads)
    for name, ref in jgrads.items():
        got = pgrads[name].numpy() if name in pgrads else np.zeros_like(ref)
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5,
                                   rtol=1e-3, err_msg=name)
    assert int(pm["fused_steps"]) == int(outs["fused"]["steps"]) > 1
