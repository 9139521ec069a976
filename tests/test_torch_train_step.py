"""The port's DAgger / imitation train step against the JAX package's
`make_train_step` at the tiny configuration of the JAX package's own
train-step test, every dropout probability 0: here the DAgger step at the
"auto" teacher horizon and the optimizer; the imitation step in
test_torch_train_imitation.py.

Both packages build the same synthetic world and batch; the port's seeded
weights go to the JAX model through the JAX package's `torch_to_flax`, and
the JAX gradients come back through the port's `params_from_flax`.  The
JAX step runs the per-step teacher (`vectorized_teacher=False`) and hands
its gradients to an optax transformation that keeps them; the port's
`make_train_step` gives its metrics and, with keep=True, its gradients
before clipping and its rollouts.  The sampled rollout is made comparable
by one numpy Gumbel array substituted on both sides (`jax.random.gumbel`
here, the port's `gumbel_noise`).  Loss, il_loss,
sample_loss and grad_norm agree to a relative 1e-4, every parameter's
gradient at atol 1e-5 / rtol 1e-3, and the sampled actions exactly
(float32 on the CPU, sums in another order).

The optimizers are checked on their own: the JAX gradients fed to optax's
clip + AdamW and to the port's give the same parameters after one and two
steps, to 1e-7."""
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
from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu.train.checkpoint import torch_to_flax
from vln_goat_tpu_torch.config import TrainConfig
from vln_goat_tpu_torch.entry import TINY, build_train_flagship
from vln_goat_tpu_torch.rollout import rollout as port_rollout
from vln_goat_tpu_torch.train import trainer as ptr
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax

NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               feat_dropout=0.0)
B = 8


def _jax_rig(state_dict, dtype=jnp.float32, **over):
    """The JAX side of build_train_flagship(tiny=True, dropout=False), with
    the port's seeded weights moved over by the JAX package's
    `torch_to_flax` (the same tree and shapes as its own init gives); the
    model computes in `dtype`, its config TINY's with `over`."""
    cfg = JaxConfig(**{**TINY, **NO_DROP, **over})
    scans = [jax_scan("s0", num_vps=12, seed=0)]
    world = JaxWorld.build(scans, feat_dim=16, seed=0)
    model = JaxModel(cfg, dtype=dtype)
    params = torch_to_flax({k: v.numpy() for k, v in state_dict.items()})
    ro = JaxRollout(model, world, JaxRolloutConfig(num_nodes=16, horizon=6,
                                                   feat_dim=16))
    graphs = {g.scan_id: g for g in scans}
    data = jax_dataset(graphs, 16, vocab_size=64, path_len=(3, 4), seed=1,
                       max_instr_len=24)
    batcher = JaxBatcher(data, graphs, ["s0"], batch_size=B,
                         max_instr_len=24, max_gt_len=6, bucket_caps=(4, 6))
    return ro, params, batcher


def _keep_grads():
    """An optax transformation whose state is the last gradient."""
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(
        lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


@pytest.fixture(scope="module")
def rigs():
    state, tbatcher = build_train_flagship("cpu", tiny=True, batch_size=B,
                                           dropout=False)
    sd = state.model.state_dict()
    jro, params, jbatcher = _jax_rig(sd)
    _, jbatch = jbatcher.next_batch()
    _, tbatch = tbatcher.next_batch()
    for k, v in jbatch.items():
        assert np.array_equal(np.asarray(v), tbatch[k].numpy()), k
    G = 16 + 2
    noise = np.random.default_rng(5).gumbel(size=(B, G)).astype(np.float32)
    return dict(jro=jro, params=params, jbatch=jbatch, tbatch=tbatch,
                sd=sd, noise=noise)


def _patch_noise(monkeypatch, noise):
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, *a, **k: jnp.asarray(noise))
    monkeypatch.setattr(port_rollout, "gumbel_noise",
                        lambda g, shape, device: torch.from_numpy(noise))


def _port(rigs, alg, th):
    """(metrics, {name: grad before clipping}, rollout outs) of one train
    step of the port from the JAX weights."""
    state, _ = build_train_flagship(
        "cpu", tiny=True, batch_size=B, dropout=False,
        tcfg=TrainConfig(train_alg=alg, weight_decay=0.01),
        teacher_horizon=th)
    state.model.load_state_dict(rigs["sd"])
    return state.step_fn(state, rigs["tbatch"],
                         torch.Generator().manual_seed(0), keep=True)


def run_pair(rigs, alg, th):
    """One train step of each package from the same weights and batch,
    the Gumbel noise substituted on both sides."""
    mp = pytest.MonkeyPatch()
    try:
        _patch_noise(mp, rigs["noise"])
        tx = _keep_grads()
        jstep = jax.jit(jtr.make_train_step(
            rigs["jro"], tx, train_alg=alg, ml_weight=0.2,
            teacher_horizon=th, vectorized_teacher=False))
        jstate = jtr.init_train_state(rigs["params"], tx)
        jstate, jm = jstep(jstate, rigs["jbatch"], jax.random.PRNGKey(0))
        jgrads = params_from_flax(flatten(
            jax.tree.map(np.asarray, jstate.opt_state)["params"]))
        jm = {k: float(v) for k, v in jm.items()}
        # the actions of the rollout the step learns from on-policy
        # (dagger's sample rollout; imitation's teacher, full horizon)
        feedback = "sample" if alg == "dagger" else "teacher"
        fn = jax.jit(rigs["jro"].build_rollout(
            feedback, train_ml=True, deterministic=False))
        jactions = np.asarray(fn(rigs["params"], rigs["jbatch"],
                                 jax.random.PRNGKey(0))["actions"])
        pm, pgrads, outs = _port(rigs, alg, th)
    finally:
        mp.undo()
    return dict(alg=alg, jm=jm, jgrads=jgrads, jactions=jactions, pm=pm,
                pgrads=pgrads, outs=outs)


# The imitation step, at an int and at the "auto" teacher horizon, is in
# test_torch_train_imitation.py: each JAX train step takes 15-30 s to
# compile on the CPU, and the two files run on separate workers.
@pytest.fixture(scope="module", params=[("dagger", "auto")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def step_pair(request, rigs):
    return run_pair(rigs, *request.param)


def test_metrics_match(step_pair):
    jm, pm = step_pair["jm"], step_pair["pm"]
    keys = ["loss", "grad_norm", "il_loss"]
    if step_pair["alg"] == "dagger":
        keys.append("sample_loss")
    for k in keys:
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, err_msg=k)
    assert float(pm["node_overflow"]) == jm["node_overflow"]


def test_grads_match(step_pair):
    jg, pg = step_pair["jgrads"], step_pair["pgrads"]
    assert set(pg) <= set(jg)
    moved = 0
    for name, ref in jg.items():
        got = pg[name].numpy() if name in pg else np.zeros_like(ref)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-3,
                                   err_msg=name)
        moved += bool(np.abs(np.asarray(ref)).max() > 0)
    assert moved > 0.8 * len(jg)
    # the learnable graph bias sits behind the fused gate's bias input
    assert np.abs(pg["global_encoder.sprel_linear.weight"].numpy()).max() > 0


def test_actions_identical(step_pair):
    """dagger: the sampled rollout's actions; imitation: the teacher's
    (the JAX reference runs the full horizon, the port's `auto` or int
    horizon stops earlier: the steps it ran agree, the rest is -1)."""
    feedback = "sample" if step_pair["alg"] == "dagger" else "teacher"
    got = step_pair["outs"][feedback]["actions"].numpy()
    ref = step_pair["jactions"]
    assert got.shape[1:] == ref.shape[1:]
    T = got.shape[0]
    assert np.array_equal(got, ref[:T])
    assert (ref[T:] == -1).all()
    assert (ref >= 0).any()


@pytest.mark.parametrize("scale", [1.0, 300.0])
def test_optimizer_matches_optax(rigs, scale):
    """Clip + AdamW on the same gradients (scale 300 makes the global-norm
    clip act) for two steps."""
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, rigs["params"])
    g1 = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale
                                 ).astype(np.float32), params)
    g2 = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale
                                 ).astype(np.float32), params)
    tx = jtr.make_optimizer(lr=2e-5)
    update = jax.jit(tx.update)
    jp, js = params, tx.init(params)
    jsteps = []
    for g in (g1, g2):
        upd, js = update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        jsteps.append(params_from_flax(flatten(
            jax.tree.map(np.asarray, jp)["params"])))

    state, _ = build_train_flagship("cpu", tiny=True, batch_size=B,
                                    dropout=False)
    model = state.model
    model.load_state_dict(rigs["sd"])
    named = dict(model.named_parameters())
    for g, ref in zip((g1, g2), jsteps):
        for name, t in params_from_flax(flatten(g["params"])).items():
            named[name].grad = torch.as_tensor(t).clone()
        ptr.apply_update(state)
        for name, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[name],
                                       atol=1e-7, rtol=0, err_msg=name)
    assert state.step == 2


@pytest.mark.parametrize("name", ["constant_with_warmup", "linear",
                                  "polynomial", "cosine"])
def test_lr_schedule_matches_optax(name):
    """optax evaluates the schedule in float32, the port in Python floats:
    rtol 1e-5, and atol 1e-6 of the peak rate (the cosine's 1 + cos cancels
    near the end of the decay)."""
    ref = jtr.make_lr_schedule(name, 2e-5, 10, 50)
    got = ptr.make_lr_schedule(name, 2e-5, 10, 50)
    for count in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        np.testing.assert_allclose(got(count), float(ref(count)),
                                   rtol=1e-5, atol=2e-11)
