"""A back-translated DAgger step of the port against the JAX package's, on
the CPU: the batch carries back-translation's shared noise
(`batch["feat_noise"]`), which the panorama's image features take in
place of the model's own feature dropout (already_dropout), on the
per-step teacher and on the vectorized teacher.

The rig is test_torch_train_step.py's (the JAX package's train-step test
configuration, the port's seeded weights carried across, one numpy Gumbel
array substituted for the sampled rollout's draws), with the feature
dropout at 0.4 and every other dropout at 0: with the noise given, the
step draws nothing, so it is deterministic on both sides, and a feature
dropout that was not skipped would make it differ.  Gates as that file's:
loss, il_loss, sample_loss and grad_norm to a relative 1e-4, every
gradient at atol 1e-5 / rtol 1e-3; the sampled rollout moved; without
the noise the port's step draws its feature dropout and its loss moves."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.rollout.env import EpisodeBatcher as JaxBatcher
from vln_goat_tpu.rollout.env import make_synthetic_dataset as jax_dataset
from vln_goat_tpu.rollout.rollout import NavRollout as JaxRollout
from vln_goat_tpu.rollout.rollout import RolloutConfig as JaxRolloutConfig
from vln_goat_tpu.rollout.world import NavWorld as JaxWorld
from vln_goat_tpu.sim.graph_sim import make_synthetic_scan as jax_scan
from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu.train.checkpoint import torch_to_flax
from vln_goat_tpu_torch.entry import TINY, build_train_flagship
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from test_torch_train_step import _keep_grads, _patch_noise

FEAT_DROP, B = 0.4, 8


@pytest.fixture(scope="module")
def rigs():
    state, tbatcher = build_train_flagship("cpu", tiny=True, batch_size=B,
                                           dropout=False)
    sd = state.model.state_dict()
    cfg = JaxConfig(**TINY, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0, feat_dropout=FEAT_DROP)
    scans = [jax_scan("s0", num_vps=12, seed=0)]
    world = JaxWorld.build(scans, feat_dim=16, seed=0)
    jro = JaxRollout(JaxModel(cfg), world,
                     JaxRolloutConfig(num_nodes=16, horizon=6, feat_dim=16))
    graphs = {g.scan_id: g for g in scans}
    data = jax_dataset(graphs, 16, vocab_size=64, path_len=(3, 4), seed=1,
                       max_instr_len=24)
    jbatcher = JaxBatcher(data, graphs, ["s0"], batch_size=B,
                          max_instr_len=24, max_gt_len=6, bucket_caps=(4, 6))
    _, jbatch = jbatcher.next_batch()
    _, tbatch = tbatcher.next_batch()
    keep = np.random.default_rng(3).random(16) >= FEAT_DROP
    feat_noise = keep.astype(np.float32) / np.float32(1.0 - FEAT_DROP)
    jbatch = dict(jbatch, feat_noise=jnp.asarray(feat_noise))
    tbatch = dict(tbatch, feat_noise=torch.from_numpy(feat_noise))
    noise = np.random.default_rng(5).gumbel(size=(B, 18)).astype(np.float32)
    params = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    return dict(jro=jro, params=params, jbatch=jbatch, tbatch=tbatch, sd=sd,
                noise=noise)


@pytest.fixture(scope="module")
def jax_step(rigs):
    """The JAX step on the vectorized teacher (its feat_noise product at
    rollout.py:1805-1806); without dropout its per-step teacher is
    loss-identical, so both port paths are held to this one compile."""
    mp = pytest.MonkeyPatch()
    try:
        _patch_noise(mp, rigs["noise"])
        tx = _keep_grads()
        jstep = jax.jit(jtr.make_train_step(
            rigs["jro"], tx, train_alg="dagger", ml_weight=0.2,
            teacher_horizon="auto", vectorized_teacher=True))
        jstate, jm = jstep(jtr.init_train_state(rigs["params"], tx),
                           rigs["jbatch"], jax.random.PRNGKey(0))
    finally:
        mp.undo()
    return {k: float(v) for k, v in jm.items()}, params_from_flax(flatten(
        jax.tree.map(np.asarray, jstate.opt_state)["params"]))


@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["per_step", "vectorized"])
def test_feat_noise_dagger_step(rigs, jax_step, vectorized):
    jm, jgrads = jax_step
    mp = pytest.MonkeyPatch()
    try:
        _patch_noise(mp, rigs["noise"])
        state, _ = build_train_flagship("cpu", tiny=True, batch_size=B,
                                        dropout=False,
                                        vectorized_teacher=vectorized)
        state.model.load_state_dict(rigs["sd"])
        # the model's own feature dropout on: the noise must replace it
        state.model.drop_env.rate = FEAT_DROP
        pm, pgrads, outs = state.step_fn(
            state, rigs["tbatch"], torch.Generator().manual_seed(0),
            keep=True)
    finally:
        mp.undo()
    for k in ("loss", "grad_norm", "il_loss", "sample_loss"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4,
                                   err_msg=k)
    assert set(pgrads) <= set(jgrads)
    for name, ref in jgrads.items():
        got = pgrads[name].numpy() if name in pgrads else np.zeros_like(ref)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-3,
                                   err_msg=name)
    assert (outs["sample"]["actions"].numpy() >= 0).any()
    # without the noise the step would draw the feature dropout: another
    # loss from the same weights and batch
    batch = {k: v for k, v in rigs["tbatch"].items() if k != "feat_noise"}
    state.model.load_state_dict(rigs["sd"])
    other = state.step_fn(state, batch, torch.Generator().manual_seed(0))
    assert float(other["loss"]) != float(pm["loss"])
