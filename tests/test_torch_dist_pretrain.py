"""The port's pretraining step over two processes (gloo, on the CPU)
against the JAX package's pretrain step on a 2-device mesh (its batch
sharded on ('dp',), its state replicated), at test_torch_pretrain_model.py's
tiny width, every dropout 0, one update per task from the same weights:
MLM, MRC, SAP and CFP on the R2R rig, OG on the REVERIE one
(`torch_pretrain_rig`).  Each rank takes its 3 rows of the global batch
of 6, and the model's `mesh` makes each loss the rank's share of the
global one: MLM, MRC and OG divide by the global count, CFP scores the
rank's rows against the gathered global batch.  The MLM, MRC and OG
batches' two halves hold different numbers of masked tokens, views and
targets, so a per-rank count would show.

Checked per task: the loss and the metrics within 1e-5 relative,
every gradient within 1e-4 of its scale (`torch_dist_rig.tolerance_scales`,
the biases that are zero up to rounding at their weight's), the
parameters after the update by test_torch_causal_train.py's rule and the
two ranks' parameters equal bit for bit; that the ranks with the
one-process arithmetic (no `mesh` on the model, the gradients still
averaged) miss the JAX MLM and CFP losses; and that a process group of
one leaves the loss, the gradients and the parameters bit for bit those
of the plain step."""
import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from vln_goat_tpu.config import PretrainConfig as JaxPretrainConfig
from vln_goat_tpu.parallel.mesh import make_mesh as jax_mesh
from vln_goat_tpu.parallel.mesh import shard_batch as jax_shard
from vln_goat_tpu.pretrain import train as jpt
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
import torch_dist_rig as R
from test_torch_causal_train import _pass_grads
from test_torch_pretrain_model import NOISE
from test_torch_pretrain_og import OG_NOISE
# torch on one thread: under xdist the workers share the cores
from test_torch_gate_witness import one_thread  # noqa: F401
from torch_pretrain_rig import (PROBS, R2R_TASKS, REVERIE, TINY, builders,
                                configs, jax_batch, jax_model, jax_params,
                                port_model)

B = 6
OG_TASKS = ("og",)
LR = 1e-4


def _batches(pb, pitems, tasks, counted):
    """One global batch of B per task; for the tasks in `counted` (key
    -> the rows that count) the first seed whose two halves count
    differently."""
    out = {}
    for i, t in enumerate(tasks):
        for seed in range(100 * i, 100 * i + 100):
            b = pb.build_batch(pitems[:B], t, rng=np.random.default_rng(seed))
            if t not in counted:
                break
            ok = counted[t](b).reshape(B, -1).sum(1)
            if ok[:B // 2].sum() != ok[B // 2:].sum():
                break
        out[t] = b
    return out


COUNTED = {"mlm": lambda b: b["mlm_pos"] >= 0,
           "mrc": lambda b: b["mrc_masks"],
           "og": lambda b: b["vp_obj_masks"].any(1) & (b["obj_labels"] >= 0)}


def _jax_step(jm, params, batch, task, tasks):
    """The JAX pretrain step (make_pretrain_steps, its optimizer behind a
    transformation that keeps the gradients) on a 2-device mesh ->
    (metrics, gradients, parameters after) by the port's names."""
    pcfg = JaxPretrainConfig(tasks=tuple(tasks), learning_rate=LR,
                             num_train_steps=10, warmup_steps=0)
    tx = optax.chain(_pass_grads(), jpt.make_pretrain_optimizer(pcfg))
    step = jpt.make_pretrain_steps(jm, tx, [task])[task]
    p = {"params": params}
    mesh = jax_mesh(n_devices=2)
    # an executable over several devices is compiled, not cached
    # (tests/test_train_step.py:72-80)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 10**9)
    try:
        state = jax.device_put(
            jpt.PretrainState(p, tx.init(p), jnp.zeros((), jnp.int32)),
            NamedSharding(mesh, P()))
        with mesh:
            state, m = step(state, jax_shard(jax_batch(batch), mesh),
                            jax.random.PRNGKey(0))
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)

    def names(tree):
        return {k: np.asarray(v) for k, v in params_from_flax(flatten(
            jax.tree.map(np.asarray, tree))).items()}

    return ({k: float(v) for k, v in m.items()},
            names(state.opt_state[0]["params"]),
            names(state.params["params"]))


@pytest.fixture(scope="module")
def runs():
    cases, jax_ref, noise = {}, {}, {}
    for name, objnav, tasks, extra in (
            ("r2r", False, R2R_TASKS, {}),
            ("reverie", True, OG_TASKS, REVERIE)):
        (_, _), (pb, pitems) = builders(objnav=objnav)
        jcfg, cfg = configs(objnav=objnav)
        tm = port_model(cfg, tasks, seed=3)
        params = jax_params(tm)
        batches = _batches(pb, pitems, tasks, COUNTED)
        jm = jax_model(jcfg, tasks)
        cases[name] = dict(cfg=dict(TINY, **extra), tasks=tasks, probs=PROBS,
                           sd=R.numpy_tree(tm.state_dict()), lr=LR,
                           batches=batches, mesh=True, share=True)
        for t in tasks:
            jax_ref[t] = _jax_step(jm, params, batches[t], t, tasks)
            noise[t] = OG_NOISE if t == "og" else NOISE
    # the one-process arithmetic on two ranks: MLM and CFP only
    r2r = cases["r2r"]
    cases["unshared"] = dict(r2r, share=False, batches={
        t: r2r["batches"][t] for t in ("mlm", "cfp")})
    two = R.run_ranks(R.pretrain_cases, 2, cases)
    # a group of one against the plain step (no mesh, no group)
    solo = {"r2r": dict(r2r, batches={t: r2r["batches"][t]
                                      for t in ("mlm", "cfp")})}
    one_group = R.run_ranks(R.pretrain_cases, 1, solo)[0]["r2r"]
    # on one thread, as the spawned ranks run (a reduction's order, and so
    # its bits, follows the thread count)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = R.pretrain_cases(0, 1, {"r2r": dict(
            solo["r2r"], mesh=False, share=False)})["r2r"]
    finally:
        torch.set_num_threads(threads)
    ranks = [{**t["r2r"], **t["reverie"]} for t in two]
    return dict(jax=jax_ref, ranks=ranks, noise=noise,
                unshared=two[0]["unshared"], one_group=one_group,
                plain=plain, sd={**cases["r2r"]["sd"],
                                 **cases["reverie"]["sd"]})


TASKS = R2R_TASKS + OG_TASKS


@pytest.mark.parametrize("task", TASKS)
def test_task_matches_jax_mesh(runs, task):
    jm, jg, jp = runs["jax"][task]
    (m0, g0, p0), (m1, _, p1) = (r[task] for r in runs["ranks"])
    assert set(m0) == set(jm)
    for k, v in jm.items():
        for m in (m0, m1):
            np.testing.assert_allclose(m[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{task} {k}")
    R.check_grads(g0, jg, runs["noise"][task], task)
    assert any(float(np.abs(g).max()) > 0 for g in g0.values())
    for name, v in p0.items():
        assert np.array_equal(v, p1[name]), name
    R.check_params(p0, jp, jg, g0, LR, runs["noise"][task])


@pytest.mark.parametrize("task", ("mlm", "cfp"))
def test_one_process_arithmetic_misses(runs, task):
    """Without the loss shares (per-rank counts, in-rank negatives) the
    two ranks' loss is not the global one: the check above has teeth."""
    got = runs["unshared"][task][0]["loss"]
    ref = runs["jax"][task][0]["loss"]
    assert abs(got - ref) > 1e-3 * abs(ref), (got, ref)


@pytest.mark.parametrize("task", ("mlm", "cfp"))
def test_world_of_one_is_the_plain_step(runs, task):
    (m, g, p), (pm, pg, pp) = runs["one_group"][task], runs["plain"][task]
    assert m == pm
    assert set(pg) <= set(g)
    for name, v in g.items():
        assert np.array_equal(v, pg.get(name, np.zeros_like(v))), name
    for name, v in p.items():
        assert np.array_equal(v, pp[name]), name
