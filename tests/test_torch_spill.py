"""The port's node-table overflow handling (the default 'spill' policy)
against the JAX package's: a node table too small for the scan, so that
arrivals evict far unvisited nodes, through both greedy rollouts with the
same weights.  Records must be identical, fused logits within 1e-4
(float32, other summation order)."""
import numpy as np
import pytest
import jax

import __graft_entry__ as graft
from vln_goat_tpu.rollout.env import EpisodeBatcher as JaxBatcher
from vln_goat_tpu.rollout.env import make_synthetic_dataset as jax_dataset
from vln_goat_tpu.rollout.rollout import NavRollout as JaxRollout
from vln_goat_tpu.rollout.rollout import RolloutConfig as JaxRolloutConfig
from vln_goat_tpu.rollout.world import NavWorld as JaxWorld
from vln_goat_tpu.sim.graph_sim import make_synthetic_scan as jax_scan
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import TINY, build_model, greedy_rollout
from vln_goat_tpu_torch.rollout.env import EpisodeBatcher
from vln_goat_tpu_torch.rollout.env import make_synthetic_dataset
from vln_goat_tpu_torch.rollout.rollout import NavRollout, RolloutConfig
from vln_goat_tpu_torch.rollout.world import NavWorld
from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax

RCFG = dict(num_nodes=6, horizon=6, feat_dim=16)


@pytest.fixture(scope="module")
def runs():
    model, params, _, _ = graft._flagship(tiny=True)
    scans = [jax_scan("s0", num_vps=20, degree=4, seed=3)]
    world = JaxWorld.build(scans, feat_dim=16, seed=0)
    ro = JaxRollout(model, world, JaxRolloutConfig(**RCFG))
    graphs = {g.scan_id: g for g in scans}
    data = jax_dataset(graphs, 8, vocab_size=64, path_len=(3, 6), seed=1)
    _, batch = JaxBatcher(data, graphs, ["s0"], batch_size=4,
                          max_instr_len=16, max_gt_len=7).next_batch()
    fn = jax.jit(ro.build_rollout(feedback="argmax", record_logits=True))
    ref = jax.tree.map(np.asarray, fn(params, batch, jax.random.PRNGKey(0)))

    tscans = [make_synthetic_scan("s0", num_vps=20, degree=4, seed=3)]
    tworld = NavWorld.build(tscans, feat_dim=16, seed=0, device="cpu")
    tm = build_model(GoatConfig(**TINY), "cpu")
    tm.load_state_dict(params_from_flax(flatten(params["params"])))
    tro = NavRollout(tm, tworld, RolloutConfig(**RCFG))
    tgraphs = {g.scan_id: g for g in tscans}
    tdata = make_synthetic_dataset(tgraphs, 8, vocab_size=64,
                                   path_len=(3, 6), seed=1)
    _, tbatch = EpisodeBatcher(tdata, tgraphs, ["s0"], batch_size=4,
                               max_instr_len=16, max_gt_len=7,
                               device="cpu").next_batch()
    return ref, greedy_rollout(tro, tbatch)


def test_table_overflows(runs):
    ref, out = runs
    assert ref["spilled_n"].sum() > 0
    assert np.array_equal(out["spilled_n"].numpy(), ref["spilled_n"])
    assert np.array_equal(out["overflow_n"].numpy(), ref["overflow_n"])


@pytest.mark.parametrize("key", ("actions", "segs", "seg_hops", "node_vp",
                                 "stop_node", "back_seg", "back_hops",
                                 "final_cur", "n_nodes", "node_vp_t",
                                 "visited_t"))
def test_identical_records(runs, key):
    ref, out = runs
    o = out[key].numpy()
    assert np.array_equal(o, ref[key].astype(o.dtype)), key


def test_fused_logits(runs):
    ref, out = runs
    r, o = ref["logits"], out["fused_logits"].numpy()
    fin = np.isfinite(r)
    assert np.array_equal(fin, np.isfinite(o))
    np.testing.assert_allclose(o[fin], r[fin], atol=1e-4, rtol=1e-4)
