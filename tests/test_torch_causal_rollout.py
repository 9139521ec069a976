"""The port's greedy decode under GOAT's causal configuration against the
JAX package's: the tiny flagship (`build_flagship(tiny=True,
causal=True)`) with the same weights (the port's, moved by the JAX
package's `torch_to_flax`), world, batch and banks (the port batcher's
seeded banks, broadcast on the JAX side by its own `broadcast_zdict`).

Actions, path segments, node tables and trajectories must be identical;
the fused logits agree to 1e-4 with the same -inf pattern (float32, sums
in another order, as tests/test_torch_rollout.py)."""
import numpy as np
import pytest
import jax

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.rollout.env import EpisodeBatcher as JaxBatcher
from vln_goat_tpu.rollout.env import make_synthetic_dataset as jax_dataset
from vln_goat_tpu.rollout.rollout import NavRollout as JaxRollout
from vln_goat_tpu.rollout.rollout import RolloutConfig as JaxRolloutConfig
from vln_goat_tpu.rollout.trajectory import assemble_trajectories
from vln_goat_tpu.rollout.world import NavWorld as JaxWorld
from vln_goat_tpu.sim.graph_sim import make_synthetic_scan as jax_scan
from vln_goat_tpu.tools.zdict import broadcast_zdict
from vln_goat_tpu.train.checkpoint import torch_to_flax
from vln_goat_tpu_torch.entry import (CAUSAL, TINY, build_flagship,
                                      greedy_rollout)
from vln_goat_tpu_torch.tools.zdict import SHARED_BANKS
from test_torch_rollout import EXACT

# weights whose first batch moves in most episodes (seed 0 stops at once)
WEIGHT_SEED = 1


@pytest.fixture(scope="module")
def runs():
    tm, tro, tb = build_flagship("cpu", tiny=True, causal=True,
                                 seed=WEIGHT_SEED)
    _, tbatch = tb.next_batch()
    out = greedy_rollout(tro, tbatch)

    scans = [jax_scan("s0", num_vps=10, seed=0)]
    world = JaxWorld.build(scans, feat_dim=16, seed=0)
    model = JaxModel(JaxConfig(**TINY, **CAUSAL))
    params = torch_to_flax({k: v.numpy() for k, v in
                            tm.state_dict().items()})
    ro = JaxRollout(model, world, JaxRolloutConfig(num_nodes=12, horizon=3,
                                                   feat_dim=16))
    graphs = {g.scan_id: g for g in scans}
    data = jax_dataset(graphs, 16, vocab_size=TINY["vocab_size"],
                       path_len=(3, 3), seed=1)
    batcher = JaxBatcher(data, graphs, ["s0"], batch_size=8,
                         max_instr_len=16, max_gt_len=4)
    _, batch = batcher.next_batch()
    batch = {**batch, **broadcast_zdict(tb.banks, 8)}
    fn = jax.jit(ro.build_rollout(feedback="argmax", record_logits=True))
    ref = jax.tree.map(np.asarray, fn(params, batch, jax.random.PRNGKey(0)))
    return ref, jax.tree.map(np.asarray, batch), out, tbatch


def test_same_batch_and_banks(runs):
    _, ref_batch, _, tbatch = runs
    assert set(ref_batch) == set(tbatch)
    assert SHARED_BANKS <= set(tbatch)
    for k, v in ref_batch.items():
        assert np.array_equal(v, tbatch[k].numpy()), k


def test_episodes_move(runs):
    assert (runs[0]["actions"] >= 0).sum() >= 8


@pytest.mark.parametrize("key", EXACT)
def test_identical_records(runs, key):
    ref, _, out, _ = runs
    o, r = out[key].numpy(), ref[key]
    assert o.shape == r.shape, key
    assert np.array_equal(o, r.astype(o.dtype)), key


def test_trajectories_identical(runs):
    ref, ref_batch, out, _ = runs
    assert out["trajectories"] == assemble_trajectories(ref_batch, ref)


def test_fused_logits(runs):
    ref, _, out, _ = runs
    r, o = ref["logits"], out["fused_logits"].numpy()
    fin = np.isfinite(r)
    assert np.array_equal(fin, np.isfinite(o))
    assert np.array_equal(o[~fin], r[~fin])
    np.testing.assert_allclose(o[fin], r[fin], atol=1e-4, rtol=1e-4)
