"""The port's fine-tune train step over two processes (gloo, on the CPU)
against the JAX package's `make_train_step` on a 2-device mesh (its
batch sharded on ('dp',), its state replicated) and against the port in
one process, at the tiny train-step configuration of
tests/test_torch_train_step.py, every dropout probability 0:

- `imitation` on one global batch of 8, each rank on its 4 rows;
- `dagger_fused` on two batches of different gt-length buckets, each rank
  on its rows of each half (`fused_dagger_rank_batch`), the sampled
  half's Gumbel draws fixed as tests/test_torch_fused_dagger.py fixes
  them, each rank taking its rows of the global array;
- `--accumulate_grad` (two micro-batches a step, `GradAccumulator`) on
  two imitation batches, against the port in one process only (the JAX
  mesh step compiles for 20-30 s a case on the CPU; the one-process
  accumulation is held to optax.MultiSteps by
  test_torch_optimizer_guard.py).

Checked for each: the losses within 1e-5 relative, every gradient (a
missing one as zero) within 1e-4 of its scale (`_grad_scales` of
test_torch_causal_train.py, `torch_dist_rig.tolerance_scales`; the
biases whose gradients are zero up to rounding, NOISE_GRAD_BIASES and
TEACHER_NOISE_BIASES, at their weight's),
the parameters after the update by test_torch_causal_train.py's rule
(the gradient it reads being the mean of the update's micro-batches), and
the two ranks' parameters equal bit for bit.  The ranks run in spawned
processes (`torch_dist_rig`)."""
import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from vln_goat_tpu.parallel.mesh import make_mesh as jax_mesh
from vln_goat_tpu.parallel.mesh import shard_batch as jax_shard
from vln_goat_tpu.train import trainer as jtr
from vln_goat_tpu_torch.rollout import rollout as port_rollout
from vln_goat_tpu_torch.tools.gate_witness import (NOISE_GRAD_BIASES,
                                                    TEACHER_NOISE_BIASES)
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
import torch_dist_rig as R
from test_torch_causal_train import _pass_grads
from test_torch_fused_dagger import _noise, _two_batches
from test_torch_train_step import B, rigs  # noqa: F401
# torch on one thread: under xdist the workers share the cores
from test_torch_gate_witness import one_thread  # noqa: F401

CASES = ("imitation", "dagger_fused", "accumulate")
# zero up to rounding (tools/gate_witness.py): held at their weight's scale
NOISE = NOISE_GRAD_BIASES + TEACHER_NOISE_BIASES


def _numpy(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def _port_tree(tree):
    return _numpy(params_from_flax(flatten(jax.tree.map(np.asarray,
                                                        tree))))


def _jax_mesh_run(rigs, alg, batch, noise=None):  # noqa: F811
    """The JAX step on a 2-device mesh on `batch` -> (its metrics and
    gradients, the parameters after)."""
    mesh = jax_mesh(n_devices=2)
    tx = optax.chain(_pass_grads(), jtr.make_optimizer(
        lr=R.LR, weight_decay=R.WD))
    step = jax.jit(jtr.make_train_step(
        rigs["jro"], tx, train_alg=alg, ml_weight=0.2,
        teacher_horizon="auto"))
    # an executable over several devices is compiled, not cached
    # (tests/test_train_step.py:72-80)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 10**9)
    mp = pytest.MonkeyPatch()
    try:
        if noise is not None:
            mp.setattr(jax.random, "gumbel",
                       lambda key, shape, *a, **k: jnp.asarray(noise))
        state = jax.device_put(jtr.init_train_state(rigs["params"], tx),
                               NamedSharding(mesh, P()))
        with mesh:
            state, m = step(state, jax_shard(batch, mesh),
                            jax.random.PRNGKey(0))
    finally:
        mp.undo()
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return dict(metrics=[{k: float(v) for k, v in m.items()}],
                grads=[_port_tree(state.opt_state[0]["params"])],
                params=_port_tree(state.params["params"]))


@pytest.fixture(scope="module")
def runs(rigs):  # noqa: F811
    sd = R.numpy_tree(rigs["sd"])
    (j1, j2), (t1, t2) = _two_batches(rigs, True)
    _, (t3, t4) = _two_batches(rigs, False)
    noise = _noise(2 * B)
    np_ = R.numpy_tree
    cases = dict(
        imitation=dict(alg="imitation", B=B, sd=sd,
                       batches=[np_(rigs["tbatch"])]),
        dagger_fused=dict(alg="dagger_fused", B=B, sd=sd,
                          batches=[(np_(t1), np_(t2))], noise=noise),
        accumulate=dict(alg="imitation", B=B, sd=sd, accumulate=2,
                        batches=[np_(t3), np_(t4)]))
    two = R.run_ranks(R.train_cases, 2, cases)
    one = R.train_cases(0, 1, cases)
    # the reference: the JAX mesh step, for accumulation the port's one
    # process
    ref = dict(
        imitation=_jax_mesh_run(rigs, "imitation", rigs["jbatch"]),
        dagger_fused=_jax_mesh_run(rigs, "dagger_fused",
                                   jtr.fuse_dagger_batches(j1, j2),
                                   noise=noise),
        accumulate=one["accumulate"])
    return {c: dict(ref=ref[c], one=one[c], ranks=[t[c] for t in two],
                    sd=sd) for c in CASES}


def _mean(grads):
    """The gradient an update applies: the mean of its micro-batches'."""
    return {k: sum(g.get(k, 0) for g in grads) / len(grads)
            for k in set().union(*grads)}


@pytest.mark.parametrize("case", CASES)
def test_losses_match(runs, case):
    r = runs[case]
    keys = {"imitation": ("loss", "il_loss"),
            "dagger_fused": ("loss", "il_loss", "sample_loss"),
            "accumulate": ("loss", "il_loss")}[case]
    for i, jm in enumerate(r["ref"]["metrics"]):
        for k in keys:
            for got in (r["ranks"][0]["metrics"][i][k],
                        r["ranks"][1]["metrics"][i][k],
                        r["one"]["metrics"][i][k]):
                np.testing.assert_allclose(got, jm[k], rtol=1e-5,
                                           err_msg=f"{case} {i} {k}")
        # counts summed over the ranks, the global norm on both
        assert r["ranks"][0]["metrics"][i]["node_overflow"] == \
            jm["node_overflow"]
        np.testing.assert_allclose(r["ranks"][0]["metrics"][i]["grad_norm"],
                                   jm["grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_grads_match(runs, case):
    r = runs[case]
    for i, jg in enumerate(r["ref"]["grads"]):
        for got in (r["ranks"][0]["grads"][i], r["one"]["grads"][i]):
            R.check_grads(got, jg, NOISE, f"{case} {i}")


@pytest.mark.parametrize("case", CASES)
def test_params_after_update_match(runs, case):
    r = runs[case]
    a, b = r["ranks"]
    for name, v in a["params"].items():
        assert np.array_equal(v, b["params"][name]), name
    for got in (a, r["one"]):
        R.check_params(got["params"], r["ref"]["params"],
                       _mean(r["ref"]["grads"]), _mean(got["grads"]), R.LR,
                       NOISE)
    # the update moved every weight (and the biases that learn)
    moved = [n for n, v in a["params"].items()
             if not np.array_equal(v, r["sd"][n])]
    assert len(moved) > len(a["params"]) // 2


class _Stop(Exception):
    pass


class _FailingBatches:
    """The batches of a case whose first step fails."""

    def __iter__(self):
        raise _Stop


@pytest.mark.parametrize("ending", ("returns", "raises"))
def test_train_case_puts_back_the_draw(rigs, ending):  # noqa: F811
    """`train_case` fixes the rollout's Gumbel draw for its steps and puts
    the module's own function back whether it returns or raises, so an
    in-process call leaves nothing behind for the tests after it."""
    drawn = port_rollout.gumbel_noise
    assert drawn.__qualname__ == "gumbel_noise"
    (_, _), (t1, t2) = _two_batches(rigs, True)
    case = dict(alg="dagger_fused", B=B, sd=R.numpy_tree(rigs["sd"]),
                noise=_noise(2 * B),
                batches=[(R.numpy_tree(t1), R.numpy_tree(t2))])
    if ending == "returns":
        out = R.train_case(0, 1, case)
        assert np.isfinite(out["metrics"][0]["sample_loss"])
    else:
        case["batches"] = _FailingBatches()
        with pytest.raises(_Stop):
            R.train_case(0, 1, case)
    assert port_rollout.gumbel_noise is drawn
