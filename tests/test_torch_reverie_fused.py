"""The port's fused DAgger step ("dagger_fused": a teacher minibatch and a
sampled one fused into one rollout) on the REVERIE rig of
test_torch_reverie_rollout.py, the object-grounding loss included,
against the JAX package's: the checks of test_torch_reverie_train.py (the
Gumbel draw substituted on both sides; loss, il_loss, sample_loss and
grad_norm to a relative 1e-4, every gradient at atol 1e-5 / rtol 1e-3)."""
from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu_torch.train.trainer import fuse_dagger_batches
from test_torch_reverie_rollout import obj_rig
from test_torch_reverie_train import _check, _pair, rig  # noqa: F401


def test_fused_dagger_step_matches_jax(rig):  # noqa: F811
    other = obj_rig("reverie", batch_size=4, seed=10)
    jbatch = jtr.fuse_dagger_batches(rig["jbatch"], other["jbatch"])
    tbatch = fuse_dagger_batches(rig["tbatch"], other["tbatch"])
    _check(*_pair(rig, "dagger_fused", jbatch, tbatch, (False,)))
