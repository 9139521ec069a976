"""The port's `expl_sample` training feedback (the reference's
`--expl_sample`: act by argmax, but with probability 1 - expl_max_ratio
move to a uniformly random action among the finite logits) against the
JAX package's `build_rollout("expl_sample", train_ml=True)` at the tiny
configuration of test_torch_train_step.py, every dropout at 0.

Both draws are substituted on both sides by one numpy array each, as
test_torch_train_step.py substitutes the Gumbel draw of "sample": the
uniform explore draw (salt 11, `jax.random.uniform` / the port's
`uniform_noise`) and the Gumbel draw of the random move (salt 13,
`jax.random.gumbel` / `gumbel_noise`).  The actions are identical, the
loss agrees to a relative 1e-4 and every parameter's gradient at atol
1e-5 / rtol 1e-3.

With the port's own draws: the share of exploring episodes lies within 4
binomial standard deviations of 1 - 0.6, and a random move only ever
lands on a finite logit."""
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu_torch.entry import build_train_flagship
from vln_goat_tpu_torch.ops.dropout import set_generator
from vln_goat_tpu_torch.rollout import rollout as port_rollout
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from test_torch_train_step import B, rigs  # noqa: F401
# torch on one thread: under xdist the workers share the cores
from test_torch_gate_witness import one_thread  # noqa: F401

RATIO = 0.6
G = 16 + 2          # map tokens of the tiny configuration


@pytest.fixture(scope="module")
def draws():
    """The explore draw (half the episodes above RATIO) and the random
    move's Gumbel noise."""
    rng = np.random.default_rng(9)
    u = rng.permutation(np.linspace(0.05, 0.95, B)).astype(np.float32)
    assert (u > RATIO).any() and (u <= RATIO).any()
    return u, rng.gumbel(size=(B, G)).astype(np.float32)


def _patch(mp, u, noise):
    uniform, gumbel = jax.random.uniform, jax.random.gumbel
    mp.setattr(jax.random, "uniform",
               lambda key, shape=(), *a, **k: jnp.asarray(u)
               if tuple(shape) == u.shape else uniform(key, shape, *a, **k))
    mp.setattr(jax.random, "gumbel",
               lambda key, shape=(), *a, **k: jnp.asarray(noise)
               if tuple(shape) == noise.shape else gumbel(key, shape, *a,
                                                          **k))
    mp.setattr(port_rollout, "uniform_noise",
               lambda g, shape, device: torch.from_numpy(u))
    mp.setattr(port_rollout, "gumbel_noise",
               lambda g, shape, device: torch.from_numpy(noise))


@pytest.fixture(scope="module")
def pair(rigs, draws):  # noqa: F811
    """The JAX and the port expl_sample rollout on the same weights and
    batch: (loss, actions, {name: gradient}) each."""
    mp = pytest.MonkeyPatch()
    try:
        _patch(mp, *draws)
        fn = rigs["jro"].build_rollout("expl_sample", train_ml=True,
                                       deterministic=False,
                                       expl_max_ratio=RATIO)

        def loss(p):
            out = fn(p, rigs["jbatch"], jax.random.PRNGKey(0))
            return out["ml_loss"], out["actions"]

        (jl, ja), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            rigs["params"])
        jg = params_from_flax(flatten(jax.tree.map(
            lambda t: np.asarray(t, np.float64), jg)["params"]))
        state, _ = build_train_flagship("cpu", tiny=True, batch_size=B,
                                        dropout=False)
        model = state.model
        model.load_state_dict(rigs["sd"])
        model.train()
        g = torch.Generator().manual_seed(0)
        set_generator(model, g)
        out = state.rollout.train_rollout(rigs["tbatch"], "expl_sample", g,
                                          expl_max_ratio=RATIO)
        out["ml_loss"].backward()
    finally:
        mp.undo()
    pg = {n: p.grad.double().numpy() for n, p in model.named_parameters()
          if p.grad is not None}
    return dict(jax=(float(jl), np.asarray(ja), jg),
                port=(out["ml_loss"].item(), out["actions"].numpy(), pg))


def test_actions_identical(pair):
    _, ja, _ = pair["jax"]
    _, pa, _ = pair["port"]
    T = pa.shape[0]
    assert np.array_equal(pa, ja[:T]) and (ja[T:] == -1).all()
    assert (ja >= 0).any()


def test_loss_and_grads_match(pair):
    jl, _, jg = pair["jax"]
    pl, _, pg = pair["port"]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert set(pg) <= set(jg)
    for name, ref in jg.items():
        got = pg.get(name, np.zeros_like(ref))
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5,
                                   rtol=1e-3, err_msg=name)


def test_explore_share_and_finite_moves():
    """The port's own draws over 4000 episodes and three steps: logits
    with 5 finite actions (one far ahead, the argmax) and 13 at -inf.  An
    exploring episode leaves the argmax with probability 4/5, so the share
    of actions off the argmax lies within 4 binomial sd of (1 - RATIO)
    4 / 5; no action lands on -inf."""
    state, _ = build_train_flagship("cpu", tiny=True, batch_size=B,
                                    dropout=False)
    ro = state.rollout
    n = 4000
    logits = torch.full((n, G), -math.inf)
    finite = torch.tensor([0, 2, 5, 9, 17])
    logits[:, finite] = 0.0
    logits[:, 5] = 50.0
    p = (1 - RATIO) * 4 / 5
    for t in range(3):
        a = ro._sampled_action("expl_sample", logits, torch.arange(n), t,
                               12345, RATIO)
        assert torch.isfinite(logits.gather(1, a[:, None])).all()
        off = float((a != 5).float().mean())
        assert abs(off - p) <= 4 * math.sqrt(p * (1 - p) / n), (t, off)
        # the random moves spread over the other finite actions
        assert set(a.unique().tolist()) == set(finite.tolist())
