"""The port's greedy-decode slice against the JAX package's: the same
synthetic world, batch and weights (moved by `params_from_flax`) through
`NavRollout.build_rollout(feedback="argmax")` and the port's rollout.

Actions, path segments, node tables and trajectories must be identical;
the fused logits agree to 1e-4 (float32, other summation order, see
test_torch_model.py) with the same -inf pattern."""
import numpy as np
import pytest
import jax
import torch

import __graft_entry__ as graft
from vln_goat_tpu.rollout.env import EpisodeBatcher as JaxBatcher
from vln_goat_tpu.rollout.env import make_synthetic_dataset as jax_dataset
from vln_goat_tpu.rollout.trajectory import assemble_trajectories
from vln_goat_tpu.sim.graph_sim import make_synthetic_scan as jax_scan
from vln_goat_tpu_torch.entry import build_flagship, greedy_rollout
from vln_goat_tpu_torch.rollout.env import EpisodeBatcher
from vln_goat_tpu_torch.rollout.env import make_synthetic_dataset
from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax

EXACT = ("actions", "segs", "seg_hops", "node_vp", "stop_node", "back_seg",
         "back_hops", "final_cur", "n_nodes", "overflow_n", "spilled_n",
         "active", "node_vp_t", "visited_t")


@pytest.fixture(scope="module")
def runs():
    model, params, ro, batcher = graft._flagship(tiny=True)
    _, batch = batcher.next_batch()
    fn = jax.jit(ro.build_rollout(feedback="argmax", record_logits=True))
    ref = jax.tree.map(np.asarray, fn(params, batch, jax.random.PRNGKey(0)))
    ref_batch = jax.tree.map(np.asarray, batch)

    tm, tro, tb = build_flagship("cpu", tiny=True)
    tm.load_state_dict(params_from_flax(flatten(params["params"])))
    _, tbatch = tb.next_batch()
    out = greedy_rollout(tro, tbatch)
    return ref, ref_batch, out, tbatch


def test_same_batch(runs):
    _, ref_batch, _, tbatch = runs
    for k, v in ref_batch.items():
        assert np.array_equal(v, tbatch[k].numpy()), k


def test_episodes_move(runs):
    """The parity below is about a rollout that moves: some episode takes
    at least one step before stopping."""
    ref = runs[0]
    assert (ref["actions"] >= 0).any()


@pytest.mark.parametrize("key", EXACT)
def test_identical_records(runs, key):
    ref, _, out, _ = runs
    o = out[key].numpy()
    r = ref[key]
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


@pytest.mark.parametrize("sweep", [False, True])
def test_scan_tables_identical(sweep):
    """Candidate tables and all-pairs shortest paths (the port's numpy
    Dijkstra against the JAX package's) agree: exactly, except the
    distances within 1e-6 relative, since the JAX package sums them in
    float64 when its native library is not built."""
    for seed in range(3):
        a = jax_scan("s", num_vps=30, seed=seed, sweep_visibility=sweep)
        b = make_synthetic_scan("s", num_vps=30, seed=seed,
                                sweep_visibility=sweep)
        assert a.vp_ids == b.vp_ids
        for f in ("pos", "cand_local", "cand_ptid", "cand_heading",
                  "cand_elev", "cand_dist", "cand_mask", "hops", "nexthop"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (seed, f)
        np.testing.assert_allclose(b.dist, a.dist, rtol=1e-6, atol=0)


def test_bucketed_batches_identical():
    """EpisodeBatcher with bucket_caps draws the same items and pads the
    gt arrays to the same caps as the JAX batcher."""
    ga = {"s0": jax_scan("s0", num_vps=24, seed=0)}
    gb = {"s0": make_synthetic_scan("s0", num_vps=24, seed=0)}
    da = jax_dataset(ga, 30, vocab_size=64, path_len=(3, 7), seed=2)
    db = make_synthetic_dataset(gb, 30, vocab_size=64, path_len=(3, 7),
                                seed=2)
    ja = JaxBatcher(da, ga, ["s0"], batch_size=4, max_instr_len=20,
                    max_gt_len=8, bucket_caps=(4, 6))
    tb = EpisodeBatcher(db, gb, ["s0"], batch_size=4, max_instr_len=20,
                        max_gt_len=8, bucket_caps=(4, 6), device="cpu")
    caps = set()
    for _ in range(12):
        ia, ba = ja.next_batch()
        ib, bb = tb.next_batch()
        assert [i["instr_id"] for i in ia] == [i["instr_id"] for i in ib]
        caps.add(bb["gt_path"].shape[1])
        for k, v in ba.items():
            assert np.array_equal(np.asarray(v), bb[k].numpy()), k
    assert caps == {4, 6}
    assert all(t.device == torch.device("cpu") for t in bb.values())
