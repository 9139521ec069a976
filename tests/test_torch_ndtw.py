"""The port's nDTW expert (RxR, `RolloutConfig.expert_policy="ndtw"`)
against the JAX package's:

- `dtw_extend_row` against the JAX function on seeded rows and costs (one
  float32 rounding apart, relative 1e-6) and, grown node by node, against
  the classic O(n m) DP of `eval.metrics.cal_dtw` (1e-3, as the JAX
  package's own test); a masked row stays as it was;
- the sampled rollout of the small RxR rig (test_torch_reverie_rollout.py
  `obj_rig`), the Gumbel draw substituted on both sides: the expert's
  targets at every step and the actions identical to the JAX package's,
  exactly (they are integers);
- the first step's target against the host: the candidate whose path
  [start] + shortest path scores the best nDTW (`cal_dtw`)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.rollout.rollout import dtw_extend_row as jax_extend
from vln_goat_tpu_torch.eval.metrics import cal_dtw
from vln_goat_tpu_torch.rollout import rollout as port_rollout
from vln_goat_tpu_torch.rollout.rollout import dtw_extend_row, dtw_init_row
from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan
from test_torch_reverie_rollout import N, obj_rig

G = N + 2


def test_dtw_extend_row_matches_jax(rng):
    row = dtw_init_row((3, 5), 9)
    for step in range(6):
        cost = rng.uniform(0, 20, (3, 5, 8)).astype(np.float32)
        valid = rng.random((3, 5)) < 0.8
        ref = jax_extend(jnp.asarray(row.numpy()), jnp.asarray(cost),
                         jnp.asarray(valid))
        row = dtw_extend_row(row, torch.from_numpy(cost),
                             torch.from_numpy(valid))
        np.testing.assert_allclose(row.numpy(), np.asarray(ref), rtol=1e-6)


def test_dtw_rows_match_host_dp():
    g = make_synthetic_scan("d0", num_vps=15, seed=0)
    for pred, ref in (([0, 3, 5, 7, 9], [0, 2, 7, 11]),
                      ([1, 4, 4, 12], [1, 6, 12, 13, 2])):
        want = cal_dtw(g.dist, pred, ref)["DTW"]
        row = dtw_init_row((1,), len(ref) + 1)
        for p in pred:
            row = dtw_extend_row(row, torch.from_numpy(
                g.dist[p, np.asarray(ref)][None].astype(np.float32)))
        assert abs(float(row[0, len(ref)]) - want) < 1e-3


def test_dtw_extend_row_masking():
    g = make_synthetic_scan("d1", num_vps=10, seed=1)
    ref = np.asarray([0, 4, 8])
    row = dtw_init_row((2,), 4)
    cost = torch.from_numpy(np.stack([g.dist[1, ref], g.dist[2, ref]])
                            .astype(np.float32))
    out = dtw_extend_row(row, cost, valid=torch.tensor([True, False]))
    assert not torch.allclose(out[0], row[0])
    assert torch.equal(out[1], row[1])


@pytest.fixture(scope="module")
def sampled():
    rig = obj_rig("rxr", expert_policy="ndtw", batch_size=6, seed=3)
    noise = np.random.default_rng(5).gumbel(size=(6, G)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax.random, "gumbel",
                   lambda key, shape, *a, **k: jnp.asarray(noise))
        mp.setattr(port_rollout, "gumbel_noise",
                   lambda g, shape, device: torch.from_numpy(noise))
        fn = jax.jit(rig["jro"].build_rollout(
            "sample", train_ml=True, deterministic=False))
        ref = jax.tree.map(np.asarray, fn(rig["params"], rig["jbatch"],
                                          jax.random.PRNGKey(0)))
        with torch.no_grad():
            out = rig["tro"].train_rollout(rig["tbatch"], "sample",
                                           torch.Generator().manual_seed(0))
    finally:
        mp.undo()
    return rig, ref, out


def test_expert_targets_identical(sampled):
    _, ref, out = sampled
    for key in ("targets", "actions"):
        o, r = out[key].numpy(), ref[key]
        assert np.array_equal(o, r.astype(o.dtype)), key
    assert (ref["targets"] >= 2).any()
    np.testing.assert_allclose(out["loss_per_ep"].numpy(),
                               ref["loss_per_ep"], rtol=1e-4, atol=1e-5)


def test_first_step_matches_host_dp(sampled):
    rig, _, out = sampled
    g = rig["graph"]
    checked = 0
    for b, it in enumerate(rig["items"]):
        gt = [g.index[v] for v in it["path"]]
        start = gt[0]
        if start == gt[-1]:
            continue
        best_vp, best = None, -1.0
        for k in range(int(g.cand_mask[start].sum())):
            w = int(g.cand_local[start, k])
            nd = cal_dtw(g.dist, [start] + g.shortest_path(start, w),
                         gt)["nDTW"]
            if nd > best:
                best, best_vp = nd, w
        t0 = int(out["targets"][0, b])
        assert t0 >= 2
        assert int(out["node_vp_t"][0, b, t0 - 2]) == best_vp
        checked += 1
    assert checked > 0
