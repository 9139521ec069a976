"""The port's REVERIE / SOON rollouts against the JAX package's: one
synthetic scan with a seeded object store (directions, so the object angles
are camera-relative; some viewpoints without objects), the same batch and
weights (`params_from_flax`) in both packages, at the small configuration
of test_torch_reverie_model.py with every dropout at 0.

- the panorama inputs: object tokens after the 36 views, their angle
  features relative to the camera at each step (identical to the JAX
  package's, and to angle_feature(dir - camera));
- greedy decode for REVERIE and for SOON (no object names): actions,
  segments, node tables, the stop node and `pred_obj_id` identical, the
  fused logits within 1e-4 with the same -inf pattern.

`obj_rig` builds the pair for the train-step tests too
(test_torch_reverie_train.py)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.core import geometry as JG
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.rollout.env import EpisodeBatcher as JaxBatcher
from vln_goat_tpu.rollout.env import make_synthetic_dataset as jax_dataset
from vln_goat_tpu.rollout.rollout import NavRollout as JaxRollout
from vln_goat_tpu.rollout.rollout import RolloutConfig as JaxRolloutConfig
from vln_goat_tpu.rollout.world import NavWorld as JaxWorld
from vln_goat_tpu.sim.graph_sim import make_synthetic_scan as jax_scan
from vln_goat_tpu.train.params import init_goat_params as jax_init
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import build_model
from vln_goat_tpu_torch.rollout.env import (EpisodeBatcher,
                                            make_synthetic_dataset)
from vln_goat_tpu_torch.rollout.rollout import NavRollout, RolloutConfig
from vln_goat_tpu_torch.rollout.world import NavWorld
from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from test_torch_reverie_model import SMALL

NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               feat_dropout=0.0)
LO, K, N, HORIZON = 5, 16, 16, 6
EXACT = ("actions", "segs", "seg_hops", "node_vp", "stop_node", "back_seg",
         "back_hops", "final_cur", "n_nodes", "pred_obj_id")


def make_objects(vtot, seed=0):
    """A seeded object store of LO objects a viewpoint; viewpoints 3 and 7
    have none."""
    rng = np.random.default_rng(seed)
    mask = rng.random((vtot, LO)) < 0.7
    mask[:, 0] = True
    mask[[3, 7]] = False
    return dict(
        feat=rng.standard_normal((vtot, LO, 12)).astype(np.float32),
        loc=rng.standard_normal((vtot, LO, 7)).astype(np.float32),
        dir=rng.uniform(-np.pi, np.pi, (vtot, LO, 2)).astype(np.float32),
        mask=mask, name=rng.integers(0, 45, (vtot, LO)),
        oid=np.arange(vtot * LO).reshape(vtot, LO))


def gt_obj_slots(items, graph, objects):
    """The gt object slot of each episode (the CLI's causal_batch): the
    first object of its goal viewpoint, after the 2 + K + 36 tokens; -1
    where the goal has none."""
    out = np.full(len(items), -1, np.int64)
    for b, it in enumerate(items):
        row = graph.index[it["path"][-1]]
        if objects["mask"][row].any():
            out[b] = 2 + K + 36 + int(np.argmax(objects["mask"][row]))
    return out


def obj_rig(dataset="reverie", expert_policy="spl", batch_size=4,
            n_items=12, seed=9):
    """Both packages' model, rollout and first batch on the same synthetic
    world: for REVERIE / SOON with the object store (gt_obj_slot
    attached), for R2R / RxR without."""
    objnav = dataset in ("reverie", "soon")
    kw = dict(SMALL, obj_feat_size=12 if objnav else 0, **NO_DROP)
    jm = JaxModel(JaxConfig.for_dataset(dataset, **kw))
    params = jax_init(jm, jax.random.PRNGKey(0), max_cands=K, num_nodes=N,
                      max_obj=LO)
    tm = build_model(GoatConfig.for_dataset(dataset, **kw), "cpu")
    tm.load_state_dict(params_from_flax(flatten(params["params"])),
                       strict=True)
    jg = jax_scan("rv0", num_vps=14, seed=8)
    tg = make_synthetic_scan("rv0", num_vps=14, seed=8)
    objects = make_objects(tg.num_vps) if objnav else None
    jw = JaxWorld.build([jg], feat_dim=16, objects=objects, seed=0)
    tw = NavWorld.build([tg], feat_dim=16, objects=objects, seed=0,
                        device="cpu")
    rk = dict(num_nodes=N, horizon=HORIZON, feat_dim=16,
              expert_policy=expert_policy)
    jro = JaxRollout(jm, jw, JaxRolloutConfig(**rk))
    tro = NavRollout(tm, tw, RolloutConfig(**rk))
    dk = dict(vocab_size=64, path_len=(3, 5), seed=seed, max_instr_len=24)
    bk = dict(batch_size=batch_size, max_instr_len=24, max_gt_len=6)
    jb = JaxBatcher(jax_dataset({"rv0": jg}, n_items, **dk), {"rv0": jg},
                    ["rv0"], **bk)
    tb = EpisodeBatcher(make_synthetic_dataset({"rv0": tg}, n_items, **dk),
                        {"rv0": tg}, ["rv0"], device="cpu", **bk)
    items, jbatch = jb.next_batch()
    titems, tbatch = tb.next_batch()
    assert [i["instr_id"] for i in items] == [i["instr_id"] for i in titems]
    if objnav:
        slots = gt_obj_slots(items, tg, objects)
        jbatch = dict(jbatch, gt_obj_slot=jnp.asarray(slots, jnp.int32))
        tbatch = dict(tbatch, gt_obj_slot=torch.from_numpy(slots))
    return dict(jm=jm, params=params, tm=tm, jro=jro, tro=tro,
                jbatch=jbatch, tbatch=tbatch, objects=objects, graph=tg,
                items=items)


@pytest.fixture(scope="module", params=["reverie", "soon"])
def decoded(request):
    rig = obj_rig(request.param)
    fn = jax.jit(rig["jro"].build_rollout(feedback="argmax",
                                          record_logits=True))
    ref = jax.tree.map(np.asarray, fn(rig["params"], rig["jbatch"],
                                      jax.random.PRNGKey(0)))
    out = rig["tro"].rollout(rig["tbatch"])
    return rig, ref, out


def test_episodes_move_and_pick_objects(decoded):
    rig, ref, _ = decoded
    assert (ref["actions"] >= 0).any()
    assert (ref["pred_obj_id"] >= 0).any()


@pytest.mark.parametrize("key", EXACT)
def test_decode_identical(decoded, key):
    _, ref, out = decoded
    o, r = out[key].numpy(), ref[key]
    assert o.shape == r.shape, key
    assert np.array_equal(o, r.astype(o.dtype)), key


def test_decode_logits(decoded):
    _, ref, out = decoded
    r, o = ref["logits"], out["logits"].numpy()
    fin = np.isfinite(r)
    assert np.array_equal(fin, np.isfinite(o))
    np.testing.assert_allclose(o[fin], r[fin], atol=1e-4, rtol=1e-4)


def test_pred_obj_id_from_stop_node(decoded):
    """Each predicted object is one of the stop node's (or -1)."""
    rig, _, out = decoded
    objects = rig["objects"]
    for b in range(out["stop_node"].shape[0]):
        vp = int(out["node_vp"][b, out["stop_node"][b]])
        oid = int(out["pred_obj_id"][b])
        assert oid in set(objects["oid"][vp][objects["mask"][vp]]) | {-1}


def test_object_angles_are_camera_relative():
    """The object tokens' location features at the start and after a turn
    of the camera: the JAX package's, and angle_feature(dir - camera)
    followed by the stored box features."""
    rig = obj_rig("reverie")
    jro, tro, objects = rig["jro"], rig["tro"], rig["objects"]
    for view in (0, 14, 29):
        jbatch = dict(rig["jbatch"], start_view=jnp.full(
            rig["jbatch"]["start_view"].shape, view, jnp.int32))
        tbatch = dict(rig["tbatch"], start_view=torch.full_like(
            rig["tbatch"]["start_view"], view))
        ref = jro._pano_inputs(jro.init_state(jbatch, need_dtw=False),
                               jbatch)
        got = tro._pano_inputs(tro.init_state(tbatch), tbatch)
        np.testing.assert_allclose(got["loc"].numpy(),
                                   np.asarray(ref["loc"]), atol=1e-6)
        assert np.array_equal(got["nav_types"].numpy(),
                              np.asarray(ref["nav_types"]))
        vp = tbatch["start_vp"].numpy()
        cam_h = JG.VIEW_HEADINGS[0] + (view % 12) * np.pi / 6
        cam_e = (view // 12 - 1) * np.pi / 6
        d = objects["dir"][vp]
        want = JG.angle_feature_np(d[..., 0] - cam_h, d[..., 1] - cam_e, 4)
        np.testing.assert_allclose(got["loc"][:, -LO:, :4].numpy(), want,
                                   atol=1e-5)
        np.testing.assert_array_equal(got["loc"][:, -LO:, 4:].numpy(),
                                      objects["loc"][vp][..., 4:])
