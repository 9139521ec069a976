"""The port's object branch (REVERIE / SOON) and the panorama encoder's
trajectory path against the JAX package's, at a small configuration (2
layers per stack, hidden 32, 2 heads, object features of 12), the JAX
parameters moved across by `params_from_flax`:

- the parameter names: every JAX leaf of a REVERIE, SOON and CFP-mode
  model lands on one port parameter of the same size;
- `forward_panorama` with object tokens (names for REVERIE, none for
  SOON): embeds, masks and the fused embedding;
- the trajectory path of `CausalImageEmbeddings` (per_step=False) for R2R
  and for objects with and without the pretrain LayerNorm;
- `forward_navigation` with `vp_obj_masks`: `obj_logits`, -inf outside the
  mask at the same places, and the other logits.

Tolerance 1e-4 abs / 1e-4 rel, float32 on both sides (sums in another
order, flax's one-pass LayerNorm variance; test_torch_model.py)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.train.params import init_goat_params as jax_init
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import build_model
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax

TOL = dict(atol=1e-4, rtol=1e-4)
# 2 layers per stack, width 32 (the port's tests' small size)
SMALL = dict(num_l_layers=2, num_x_layers=2, num_pano_layers=2,
             hidden_size=32, num_attention_heads=2, intermediate_size=64,
             vocab_size=64, max_position_embeddings=64, image_feat_size=16)
OBJ = dict(obj_feat_size=12, feat_dropout=0.0)
B, K, LO, N = 3, 16, 5, 12
LV = K + 36


def small_pair(dataset: str, **kw):
    """(JAX model, its params, the port's model with them) of `dataset`'s
    preset at SMALL."""
    jm = JaxModel(JaxConfig.for_dataset(dataset, **SMALL, **kw))
    params = jax_init(jm, jax.random.PRNGKey(0), max_cands=K, num_nodes=N,
                      max_obj=LO)
    tm = build_model(GoatConfig.for_dataset(dataset, **SMALL, **kw), "cpu")
    tm.load_state_dict(params_from_flax(flatten(params["params"])),
                       strict=True)
    return jm, params, tm


@pytest.fixture(scope="module", params=["reverie", "soon"])
def objnav(request):
    return (request.param,) + small_pair(request.param, **OBJ)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def pano_inputs(rng, objects=True):
    """Seeded panorama inputs: candidates first, then views, then objects."""
    img = rng.standard_normal((B, LV, 16)).astype(np.float32)
    L = LV + (LO if objects else 0)
    loc = rng.standard_normal((B, L, 7)).astype(np.float32)
    nav = np.zeros((B, L), np.int64)
    nav[:, :4] = 1
    if objects:
        nav[:, LV:] = 2
    vmask = rng.random((B, LV)) < 0.8
    vmask[:, 0] = True
    out = dict(view_img_fts=img, loc_fts=loc, nav_types=nav,
               view_masks=vmask)
    if objects:
        omask = rng.random((B, LO)) < 0.7
        omask[0] = False      # an episode without any object
        out.update(obj_fts=rng.standard_normal((B, LO, 12))
                   .astype(np.float32), obj_masks=omask,
                   obj_names=rng.integers(0, 45, (B, LO)))
    return out


@pytest.mark.parametrize("dataset,kw", [
    ("reverie", OBJ), ("soon", OBJ),
    ("r2r", dict(mode="extract_cfp_features"))])
def test_parameter_names_round_trip(dataset, kw):
    _, params, tm = small_pair(dataset, **kw)
    flat = flatten(params["params"])
    sd = params_from_flax(flat)
    assert set(sd) == set(tm.state_dict())
    assert sum(v.size for v in flat.values()) == \
        sum(v.numel() for v in sd.values())


def test_forward_panorama_with_objects(objnav, rng):
    dataset, jm, params, tm = objnav
    x = pano_inputs(rng)
    ref = jm.apply(params, *(jnp.asarray(x[k]) for k in (
        "view_img_fts", "loc_fts", "nav_types", "view_masks")),
        obj_fts=jnp.asarray(x["obj_fts"]),
        obj_masks=jnp.asarray(x["obj_masks"]),
        obj_names=jnp.asarray(x["obj_names"]),
        method=JaxModel.forward_panorama)
    with torch.no_grad():
        out = tm.forward_panorama(
            *(_t(x[k]) for k in ("view_img_fts", "loc_fts", "nav_types",
                                 "view_masks")),
            obj_fts=_t(x["obj_fts"]), obj_masks=_t(x["obj_masks"]),
            obj_names=_t(x["obj_names"]))
    assert out[0].shape == (B, LV + LO, 32)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **TOL)
    assert np.array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), **TOL)
    # SOON has no name embedding: the names change nothing
    assert (tm.img_embeddings.obj_name_linear is None) == (dataset == "soon")


@pytest.mark.parametrize("case", ["r2r", "objects", "objects_pretrain"])
def test_trajectory_path(case, rng):
    """per_step=False: location features before the intervention, and for
    objects no final LayerNorm unless `pretrain`."""
    objects = case != "r2r"
    jm, params, tm = small_pair("reverie", **OBJ) if objects \
        else small_pair("r2r")
    x = pano_inputs(rng, objects)
    kw = dict(per_step=False, pretrain=case == "objects_pretrain")
    jkw = {k: jnp.asarray(v) for k, v in x.items()}
    tkw = {k: _t(v) for k, v in x.items()}
    ref = jm.apply(params, **jkw, **kw,
                   method=lambda m, **a: m.img_embeddings(**a))
    with torch.no_grad():
        out = tm.img_embeddings(**tkw, **kw)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), **TOL)


def test_forward_navigation_obj_logits(objnav, rng):
    dataset, jm, params, tm = objnav
    LT, G, L = 10, N + 2, LV + LO + 2
    txt = rng.standard_normal((B, LT, 32)).astype(np.float32)
    tmask = np.arange(LT)[None] < np.array([LT, 7, 4])[:, None]
    gmask = np.arange(G)[None] < np.array([6, 9, 4])[:, None]
    gmask[:, 1] = False
    vmask = rng.random((B, L)) < 0.8
    vmask[:, :2] = True
    nav = np.zeros((B, L), bool)
    nav[:, 0] = True
    nav[:, 2:6] = True
    omask = np.zeros((B, L), bool)
    omask[:, 2 + LV:] = rng.random((B, LO)) < 0.7
    omask[0] = False
    l2g = np.full((B, L), -1, np.int64)
    l2g[:, 2:6] = np.array([2, 3, 4, 5])
    visited = np.zeros((B, G), bool)
    visited[:, 1:3] = True
    args = dict(
        txt_embeds=txt, txt_masks=tmask,
        gmap_img_embeds=rng.standard_normal((B, G, 32)).astype(np.float32),
        gmap_step_ids=rng.integers(0, 5, (B, G)),
        gmap_pos_fts=rng.standard_normal((B, G, 7)).astype(np.float32),
        gmap_masks=gmask,
        gmap_pair_dists=rng.random((B, G, G)).astype(np.float32),
        gmap_visited_masks=visited,
        vp_img_embeds=rng.standard_normal((B, L, 32)).astype(np.float32),
        vp_pos_fts=rng.standard_normal((B, L, 14)).astype(np.float32),
        vp_masks=vmask, vp_nav_masks=nav, local_to_gmap=l2g,
        vp_obj_masks=omask)
    ref = jm.apply(params, **{k: jnp.asarray(v) for k, v in args.items()},
                   method=JaxModel.forward_navigation)
    with torch.no_grad():
        out = tm.forward_navigation(**{k: _t(v) for k, v in args.items()})
    for key in ("obj_logits", "fused_logits", "local_logits"):
        r, o = np.asarray(ref[key]), out[key].numpy()
        fin = np.isfinite(r)
        assert np.array_equal(fin, np.isfinite(o)), key
        np.testing.assert_allclose(o[fin], r[fin], err_msg=key, **TOL)
    assert not np.isfinite(out["obj_logits"][0].numpy()).any()
    assert np.array_equal(np.isfinite(out["obj_logits"].numpy()), omask)
