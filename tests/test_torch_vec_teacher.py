"""The port's vectorized teacher (`NavRollout.teacher_rollout_vec`) at the
tiny configuration of test_torch_train_step.py, every dropout at 0 unless
a test says otherwise:

- against the JAX package's `build_teacher_rollout_vec(deterministic=True)`
  from the same weights (`params_from_flax`) and batch: loss and loss per
  episode to a relative 1e-4, every parameter's gradient at atol 1e-5 /
  rtol 1e-3 (float32 on the CPU, sums in another order), the targets and
  the node counts exactly;
- against the port's own per-step teacher (`train_rollout("teacher")`):
  the same tolerances, the targets and actions exactly, in the plain
  configuration, with a node table small enough to spill (the vectorized
  path replays the recorded slot clears on its node embeddings) and in
  GOAT's causal configuration;
- under dropout, remat "model" against "none": the same loss, the same
  gradients and the generator left in the same state, bit for bit;
- in bf16 against the JAX package's bf16 vectorized teacher by the
  distance rule of the test_torch_bf16_*.py files: the loss's and the
  whole gradient's distances from the port's float32 result at most twice
  the JAX bf16 result's (from the JAX float32 one) plus 1e-3;
- phase B's batch (the steps times the episodes) at the bench's shape
  plans its split-K weight gradients like any other batch.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu_torch.entry import build_train_flagship
from vln_goat_tpu_torch.ops.bwd_plan import CHUNK, weight_splits
from vln_goat_tpu_torch.ops.dropout import set_generator
from vln_goat_tpu_torch.rollout.rollout import NavRollout
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from test_torch_train_step import B, _jax_rig, rigs  # noqa: F401
# torch on one thread: under xdist the workers share the cores
from test_torch_gate_witness import one_thread  # noqa: F401

ATOL = 1e-3


def _port_state(rigs, dtype="float32", causal=False, dropout=False):
    state, batcher = build_train_flagship(
        "cpu", tiny=True, batch_size=B, dropout=dropout, causal=causal,
        compute_dtype=dtype)
    if rigs is not None:
        state.model.load_state_dict(rigs["sd"])
    state.model.train()
    return state, batcher


def _run(ro, batch, vectorized, seed=0, remat="none"):
    """(outputs, {name: gradient}, generator state) of one teacher rollout
    and the backward of its ml_loss."""
    g = torch.Generator().manual_seed(seed)
    set_generator(ro.model, g)
    ro.model.zero_grad(set_to_none=True)
    if vectorized:
        out = ro.teacher_rollout_vec(batch, g, remat=remat)
    else:
        out = ro.train_rollout(batch, "teacher", g, remat=remat)
    out["ml_loss"].backward()
    grads = {n: p.grad.clone() for n, p in ro.model.named_parameters()
             if p.grad is not None}
    return out, grads, g.get_state()


def _jax_vec(ro, params, batch):
    """(ml_loss, outputs, {name: gradient}) of the JAX package's
    vectorized teacher."""
    fn = ro.build_teacher_rollout_vec(deterministic=True)

    def loss(p):
        out = fn(p, batch, jax.random.PRNGKey(0))
        return out["ml_loss"], out

    (value, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    grads = params_from_flax(flatten(jax.tree.map(
        lambda t: np.asarray(t, np.float64), grads)["params"]))
    return (float(value), jax.tree.map(np.asarray, out),
            {k: np.asarray(v, np.float64) for k, v in grads.items()})


def _assert_grads(got, ref):
    assert set(got) <= set(ref)
    moved = 0
    for name, r in ref.items():
        g = got[name].double().numpy() if name in got else np.zeros_like(r)
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-3, err_msg=name)
        moved += bool(np.abs(np.asarray(r)).max() > 0)
    assert moved > 0.5 * len(ref)


@pytest.fixture(scope="module")
def jax_f32(rigs):  # noqa: F811
    return _jax_vec(rigs["jro"], rigs["params"], rigs["jbatch"])


def test_matches_jax_vectorized_teacher(rigs, jax_f32):  # noqa: F811
    loss, jout, jgrads = jax_f32
    state, _ = _port_state(rigs)
    out, grads, _ = _run(state.rollout, rigs["tbatch"], True)
    np.testing.assert_allclose(out["ml_loss"].item(), loss, rtol=1e-4)
    np.testing.assert_allclose(out["loss_per_ep"].detach().numpy(),
                               jout["loss_per_ep"], rtol=1e-4, atol=1e-6)
    T = jout["targets"].shape[0]
    assert np.array_equal(out["targets"].numpy(), jout["targets"][:T])
    for k in ("n_nodes", "overflow_n", "spilled_n"):
        assert np.array_equal(out[k].numpy(), jout[k]), k
    assert (jout["targets"] >= 0).any()
    _assert_grads(grads, jgrads)


def _vs_per_step(ro, batch):
    vout, vgrads, _ = _run(ro, batch, True)
    sout, sgrads, _ = _run(ro, batch, False)
    np.testing.assert_allclose(vout["ml_loss"].item(), sout["ml_loss"].item(),
                               rtol=1e-4)
    for k in ("targets", "actions", "n_nodes", "overflow_n", "spilled_n",
              "steps"):
        assert torch.equal(vout[k], sout[k]), k
    _assert_grads(vgrads, {n: g.double().numpy() for n, g in sgrads.items()})
    return vout


def test_matches_per_step_teacher(rigs):  # noqa: F811
    state, _ = _port_state(rigs)
    out = _vs_per_step(state.rollout, rigs["tbatch"])
    assert int(out["steps"]) > 1


def test_spill_matches_per_step_teacher(rigs):  # noqa: F811
    """Five node slots: candidates spill into evicted slots, whose running
    embeddings the vectorized path clears as the per-step path does."""
    state, _ = _port_state(rigs)
    ro = state.rollout
    small = NavRollout(ro.model, ro.world,
                       type(ro.rcfg)(**{**ro.rcfg.__dict__, "num_nodes": 5}))
    out = _vs_per_step(small, rigs["tbatch"])
    assert int(out["spilled_n"].sum()) > 0, "no spill in the fixture"


def test_causal_matches_per_step_teacher():
    state, batcher = _port_state(None, causal=True)
    _vs_per_step(state.rollout, batcher.next_batch()[1])


def test_model_remat_equals_none_with_dropout():
    """Dropout on: the panorama call over every step and each navigation
    call under `ops.dropout.checkpoint` replay their draws in the
    backward, and leave the generator where the forward left it."""
    runs = []
    for remat in ("model", "none"):
        state, batcher = _port_state(None, dropout=True)
        runs.append(_run(state.rollout, batcher.next_batch()[1], True,
                         seed=3, remat=remat))
    (o1, g1, s1), (o2, g2, s2) = runs
    assert torch.equal(o1["ml_loss"], o2["ml_loss"])
    assert set(g1) == set(g2)
    for name in g2:
        assert torch.equal(g1[name], g2[name]), name
    assert torch.equal(s1, s2)


def _distance(got, ref):
    """|got - ref| / |ref| over every gradient (or a scalar)."""
    if isinstance(ref, dict):
        num = sum(float(np.sum((np.asarray(got[k], np.float64) - r) ** 2))
                  for k, r in ref.items())
        den = sum(float(np.sum(r ** 2)) for r in ref.values())
        return (num / den) ** 0.5
    return abs(got - ref) / abs(ref)


def test_bf16_matches_jax_bf16(rigs, jax_f32):  # noqa: F811
    """bf16 compute: the port's distance from its float32 result at most
    twice the JAX bf16 teacher's from JAX float32 plus ATOL, the targets
    identical."""
    j32_loss, _, j32_grads = jax_f32
    ro16, params16, _ = _jax_rig(rigs["sd"], dtype=jnp.bfloat16)
    j16_loss, j16_out, j16_grads = _jax_vec(ro16, params16, rigs["jbatch"])
    outs = {}
    for dtype in ("float32", "bfloat16"):
        state, _ = _port_state(rigs, dtype=dtype)
        out, grads, _ = _run(state.rollout, rigs["tbatch"], True)
        outs[dtype] = (out["ml_loss"].item(),
                       {k: v.double().numpy() for k, v in grads.items()},
                       out["targets"].numpy())
    (l32, g32, t32), (l16, g16, t16) = outs["float32"], outs["bfloat16"]
    assert np.array_equal(t16, t32)
    assert np.array_equal(t16, j16_out["targets"][:t16.shape[0]])
    dl, dl_jax = _distance(l16, l32), _distance(j16_loss, j32_loss)
    dg, dg_jax = _distance(g16, g32), _distance(j16_grads, j32_grads)
    assert dl <= 2 * dl_jax + ATOL, (dl, dl_jax)
    assert dg <= 2 * dg_jax + ATOL, (dg, dg_jax)


@pytest.mark.parametrize("steps", [5, 8])
@pytest.mark.parametrize("core", ["tf32x3", "bf16"])
def test_phase_b_rows_plan_like_any_batch(steps, core):
    """Phase B of the bench's step: steps x 64 panoramas of 52 tokens,
    26,624 rows at the 8-step bucket.  Each weight gradient takes the same
    slices as a 64-episode batch's does, each a whole number of the
    core's depth chunks, none empty."""
    rows = steps * 64 * 52
    s, kc = weight_splits(rows, 768, 768, core)
    assert (s, kc) != (0, 0) and kc % CHUNK[core] == 0
    assert (s - 1) * kc < rows <= s * kc
    assert s == weight_splits(64 * 52, 768, 768, core)[0]
    # the dropout kernels' per-row seeds and every index stay in 32 bits
    assert rows * 768 < 2 ** 31 and steps * 64 * 12 * 52 * 52 < 2 ** 31

