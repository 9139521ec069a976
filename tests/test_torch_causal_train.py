"""The port's DAgger train step under GOAT's causal configuration against
the JAX package's `make_train_step`, at the tiny train-step configuration
(`build_train_flagship(tiny=True, causal=True, dropout=False)`) with the
causal banks attached to the batch on both sides.

As in tests/test_torch_train_step.py the port's seeded weights go to the
JAX model through `torch_to_flax` (so the JAX tree also holds
`front_txt_encoder`, which nothing calls: JAX gives it zero gradients),
the JAX gradients come back through `params_from_flax`, and one numpy
Gumbel array is substituted on both sides.  Checked: losses to 1e-5
relative; every gradient, a missing one compared as zero, within 1e-4 of
its largest magnitude; and the parameters
after the step's clip + AdamW update (the JAX package's `make_optimizer`,
chained after a transformation that keeps the gradients) within 1e-6 of
each tensor's largest magnitude; and the unused `front_txt_encoder`
decayed to the same float32 values as optax decays its zero-gradient
leaves."""
import numpy as np
import optax
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
from vln_goat_tpu.tools.zdict import broadcast_zdict
from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu.train.checkpoint import torch_to_flax
from vln_goat_tpu_torch.config import TrainConfig
from vln_goat_tpu_torch.entry import CAUSAL, TINY, build_train_flagship
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from test_torch_train_step import NO_DROP, _patch_noise

B = 8
LR, WD = 2e-5, 0.01


def _pass_grads():
    """An optax transformation that passes the gradients on unchanged and
    keeps them as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def pair():
    state, tbatcher = build_train_flagship(
        "cpu", tiny=True, batch_size=B, dropout=False, causal=True,
        tcfg=TrainConfig(lr=LR, weight_decay=WD))
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}

    cfg = JaxConfig(**TINY, **NO_DROP, **CAUSAL)
    scans = [jax_scan("s0", num_vps=12, seed=0)]
    world = JaxWorld.build(scans, feat_dim=16, seed=0)
    params = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    jro = JaxRollout(JaxModel(cfg), world,
                     JaxRolloutConfig(num_nodes=16, horizon=6, feat_dim=16))
    graphs = {g.scan_id: g for g in scans}
    data = jax_dataset(graphs, 16, vocab_size=64, path_len=(3, 4), seed=1,
                       max_instr_len=24)
    jbatcher = JaxBatcher(data, graphs, ["s0"], batch_size=B,
                          max_instr_len=24, max_gt_len=6, bucket_caps=(4, 6))
    _, jbatch = jbatcher.next_batch()
    jbatch = {**jbatch, **broadcast_zdict(tbatcher.banks, B)}
    _, tbatch = tbatcher.next_batch()
    assert set(jbatch) == set(tbatch)
    for k, v in jbatch.items():
        assert np.array_equal(np.asarray(v), tbatch[k].numpy()), k

    noise = np.random.default_rng(5).gumbel(size=(B, 18)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    try:
        _patch_noise(mp, noise)
        # the gradients kept in the first state, then the JAX package's
        # clip + AdamW on them: one compiled step gives both
        tx = optax.chain(_pass_grads(),
                         jtr.make_optimizer(lr=LR, weight_decay=WD))
        jstep = jax.jit(jtr.make_train_step(
            jro, tx, train_alg="dagger", ml_weight=0.2,
            teacher_horizon="auto", vectorized_teacher=False))
        jstate, jm = jstep(jtr.init_train_state(params, tx), jbatch,
                           jax.random.PRNGKey(0))
        jgrads = jax.tree.map(np.asarray, jstate.opt_state[0])
        pm, pgrads, outs = state.step_fn(
            state, tbatch, torch.Generator().manual_seed(0), keep=True)
    finally:
        mp.undo()
    jnew = _numpy(params_from_flax(flatten(jax.tree.map(
        np.asarray, jstate.params)["params"])))
    return dict(jm={k: float(v) for k, v in jm.items()}, pm=pm,
                jgrads=_numpy(params_from_flax(flatten(jgrads["params"]))),
                pgrads=pgrads, outs=outs, sd=sd,
                jnew=jnew, model=state.model)


def test_losses_match(pair):
    jm, pm = pair["jm"], pair["pm"]
    for k in ("loss", "il_loss", "sample_loss"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(pm["grad_norm"]), jm["grad_norm"],
                               rtol=1e-4)


def test_sampled_rollout_moves(pair):
    """The step learns from a sampled rollout that moves (its actions
    follow from the substituted noise; a different action would show in
    sample_loss)."""
    assert (pair["outs"]["sample"]["actions"] >= 0).any()


def _grad_scales(jg):
    """Tolerance scale of each gradient: its largest magnitude, and at
    least 1e-4 of the largest gradient of the model.  Below that floor a
    gradient is zero up to float32 rounding: the key biases, the graph
    bias's bias and the global head's last two biases each add one
    constant to a whole row of scores or logits, which softmax ignores.
    Here their gradients are 2e-10 to 5e-8 where the largest is 2.3, and
    every other gradient's largest magnitude is above the floor."""
    floor = 1e-4 * max(float(np.abs(g).max()) for g in jg.values())
    return {n: max(float(np.abs(g).max()), floor) for n, g in jg.items()}, \
        floor


def test_grads_match(pair):
    jg, pg = pair["jgrads"], pair["pgrads"]
    assert set(jg) == set(pair["sd"])
    assert set(pg) < set(jg)
    for name, scale in _grad_scales(jg)[0].items():
        ref = jg[name]
        got = pg[name].numpy() if name in pg else np.zeros_like(ref)
        assert float(np.abs(got - ref).max()) <= 1e-4 * scale, name
    # the causal modules on the path all learn; the unused text
    # front-door encoder gets none, in both packages
    for prefix in ("lang_encoder.z_direc_cross_attn", "lang_encoder.z_front",
                   "lang_encoder.instr_aug_linear",
                   "img_embeddings.do_img_before_linear",
                   "front_local_encoder.lg_cross_attn",
                   "front_global_encoder.ll_self_attn"):
        assert any(n.startswith(prefix) and np.abs(g).max() > 0
                   for n, g in jg.items()), prefix
        assert any(n.startswith(prefix) for n in pg), prefix
    unused = [n for n in jg if n.startswith("front_txt_encoder.")]
    assert unused and all(n not in pg and not jg[n].any() for n in unused)


def test_params_after_update_match(pair):
    """Within 1e-6 of each tensor's largest magnitude.  Where a gradient
    is nonzero but under the gradient tolerance's reach (the whole tensor
    below the floor of `_grad_scales`, or an element below 1e-4 of its
    tensor's scale, too small for the 1e-4 agreement to fix its sign),
    AdamW's first step divides it by its own size, so the two packages may
    move that element by up to the step size each in opposite directions:
    it is held at 2 lr.  An element
    whose gradient is zero in both steps is held strictly."""
    jnew, jg, pg = pair["jnew"], pair["jgrads"], pair["pgrads"]
    scales, floor = _grad_scales(jg)
    for name, p in pair["model"].named_parameters():
        got, ref, g = p.detach().numpy(), jnew[name], jg[name]
        tol = np.full(ref.shape, 1e-6 * float(np.abs(ref).max()))
        nonzero = (g != 0) | (pg[name].numpy() != 0 if name in pg else False)
        noisy = nonzero & ((np.abs(g) < 1e-4 * scales[name])
                           | (float(np.abs(g).max()) < floor))
        tol[noisy] += 2 * LR
        assert (np.abs(got - ref) <= tol).all(), name


def test_unused_encoder_decays_as_optax_decays(pair):
    """front_txt_encoder has no gradient in the port and a zero one in
    JAX: optax moves it by -lr * wd * p, and the port's AdamW must give
    the same float32 values (skipping it would leave it where it was)."""
    jnew, model, sd = pair["jnew"], pair["model"], pair["sd"]
    names = [n for n, _ in model.named_parameters()
             if n.startswith("front_txt_encoder.")]
    assert len(names) == 26
    moved = 0
    for name in names:
        got = dict(model.named_parameters())[name].detach().numpy()
        assert np.array_equal(got, jnew[name]), name
        moved += not np.array_equal(got, sd[name].numpy())
    assert moved == 13     # every weight; the zero biases stay at zero
