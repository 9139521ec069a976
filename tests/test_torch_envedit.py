"""EnvEdit features in the port (the JAX package's `NavWorld.feat_aug`,
the batcher's `env_edit` alternation and the rollout's feature reads;
tests/test_envedit.py is the model).

- `NavWorld.get_feat(scan, vp, use_aug)` picks the EnvEdit row where
  use_aug is set and the original elsewhere, as the JAX package's does,
  exactly; without a selector, or without EnvEdit features, the original.
- A batcher with `env_edit` marks the even episodes of every batch, the
  JAX batcher's `use_aug` exactly, and one without marks none.
- The panorama inputs of a batch read each episode's features by its mark,
  equal to the JAX package's `_pano_inputs` (atol 0: gathers only).
- The vectorized teacher's tiled feature read equals the per-step
  teacher's under EnvEdit (dropout off, loss to 1e-6 relative), and the
  EnvEdit features change the loss.
"""
import numpy as np
import pytest
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
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import TINY, build_model
from vln_goat_tpu_torch.ops.dropout import set_generator
from vln_goat_tpu_torch.rollout.env import EpisodeBatcher, \
    make_synthetic_dataset
from vln_goat_tpu_torch.rollout.rollout import NavRollout, RolloutConfig
from vln_goat_tpu_torch.rollout.world import NavWorld
from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan
from test_torch_gate_witness import one_thread  # noqa: F401

DF = 16


def _feats(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 36, DF)).astype(np.float32),
            rng.standard_normal((n, 36, DF)).astype(np.float32))


def test_get_feat_alternation_matches_jax():
    base, aug = _feats(8)
    world = NavWorld.build([make_synthetic_scan("w1", num_vps=8, seed=1)],
                           features=base, feat_dim=DF, aug_features=aug,
                           device="cpu")
    jworld = JaxWorld.build([jax_scan("w1", num_vps=8, seed=1)],
                            features=base, feat_dim=DF, aug_features=aug)
    assert world.has_aug and jworld.has_aug
    scan, vp = np.zeros(4, np.int64), np.array([0, 1, 2, 3])
    use_aug = np.array([True, False, True, False])
    got = world.get_feat(torch.from_numpy(scan), torch.from_numpy(vp),
                         torch.from_numpy(use_aug)).numpy()
    ref = np.asarray(jworld.get_feat(jnp.asarray(scan), jnp.asarray(vp),
                                     jnp.asarray(use_aug)))
    assert np.array_equal(got, ref)
    assert np.array_equal(got[0], aug[0]) and np.array_equal(got[1], base[1])
    plain = world.get_feat(torch.from_numpy(scan), torch.from_numpy(vp))
    assert np.array_equal(plain.numpy(), base[:4])
    bare = NavWorld.build([make_synthetic_scan("w1", num_vps=8, seed=1)],
                          features=base, feat_dim=DF, device="cpu")
    assert not bare.has_aug
    assert np.array_equal(bare.get_feat(
        torch.from_numpy(scan), torch.from_numpy(vp),
        torch.from_numpy(use_aug)).numpy(), base[:4])


@pytest.mark.parametrize("env_edit", [True, False])
def test_batcher_marks_even_episodes(env_edit):
    g = make_synthetic_scan("s0", num_vps=12, seed=0)
    jg = jax_scan("s0", num_vps=12, seed=0)
    data = make_synthetic_dataset({"s0": g}, 10, vocab_size=64,
                                  path_len=(3, 4), seed=1)
    jdata = jax_dataset({"s0": jg}, 10, vocab_size=64, path_len=(3, 4),
                        seed=1)
    b = EpisodeBatcher(data, {"s0": g}, ["s0"], batch_size=5,
                       max_instr_len=24, max_gt_len=6, env_edit=env_edit,
                       device="cpu")
    jb = JaxBatcher(jdata, {"s0": jg}, ["s0"], batch_size=5,
                    max_instr_len=24, max_gt_len=6, env_edit=env_edit)
    for _ in range(2):
        _, batch = b.next_batch()
        _, jbatch = jb.next_batch()
        assert ("use_aug" in batch) == env_edit == ("use_aug" in jbatch)
        if env_edit:
            assert np.array_equal(batch["use_aug"].numpy(),
                                  np.asarray(jbatch["use_aug"]))
            assert batch["use_aug"].tolist() == [True, False, True, False,
                                                 True]


def _rig(aug=True, n_items=8):
    base, feat_aug = _feats(12, seed=3)
    scans = [make_synthetic_scan("s0", num_vps=12, seed=0)]
    world = NavWorld.build(scans, features=base, feat_dim=DF,
                           aug_features=feat_aug if aug else None,
                           device="cpu")
    cfg = GoatConfig(**{**TINY, "hidden_dropout_prob": 0.0,
                        "attention_probs_dropout_prob": 0.0,
                        "feat_dropout": 0.0})
    ro = NavRollout(build_model(cfg, "cpu"), world,
                    RolloutConfig(num_nodes=16, horizon=6, feat_dim=DF))
    data = make_synthetic_dataset({"s0": scans[0]}, n_items, vocab_size=64,
                                  path_len=(3, 4), seed=1)
    batcher = EpisodeBatcher(data, {"s0": scans[0]}, ["s0"],
                             batch_size=n_items, max_instr_len=24,
                             max_gt_len=6, env_edit=True, device="cpu")
    return ro, batcher, base, feat_aug


def test_pano_inputs_read_each_episodes_features():
    ro, batcher, base, feat_aug = _rig()
    batch = batcher.next_batch()[1]
    jworld = JaxWorld.build([jax_scan("s0", num_vps=12, seed=0)],
                            features=base, feat_dim=DF,
                            aug_features=feat_aug)
    jro = JaxRollout(JaxModel(JaxConfig(**TINY)), jworld,
                     JaxRolloutConfig(num_nodes=16, horizon=6, feat_dim=DF))
    B = batch["scan_idx"].shape[0]
    cur_vp = torch.arange(B) % 12
    view_ix = torch.arange(B) * 5 % 36
    got = ro._pano_inputs(None, batch, cur_vp=cur_vp, view_ix=view_ix)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ref = jro._pano_inputs(None, jbatch, cur_vp=jnp.asarray(cur_vp.numpy()),
                           view_ix=jnp.asarray(view_ix.numpy()))
    assert np.array_equal(got["img"].numpy(), np.asarray(ref["img"]))
    views = got["img"][:, -36:].numpy()
    for b in range(B):
        src = feat_aug if b % 2 == 0 else base
        assert np.array_equal(views[b], src[int(cur_vp[b])])


def test_vectorized_teacher_reads_envedit_features():
    losses = {}
    for aug in (True, False):
        ro, batcher, _, _ = _rig(aug=aug)
        batch = batcher.next_batch()[1]
        ro.model.train()
        g = torch.Generator().manual_seed(0)
        set_generator(ro.model, g)
        with torch.no_grad():
            vec = ro.teacher_rollout_vec(batch, g, remat="none")
            step = ro.train_rollout(batch, "teacher", g, remat="none")
        np.testing.assert_allclose(float(vec["ml_loss"]),
                                   float(step["ml_loss"]), rtol=1e-6)
        losses[aug] = float(vec["ml_loss"])
    assert losses[True] != losses[False]
