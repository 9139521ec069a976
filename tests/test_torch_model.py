"""The port's GoatModel against the JAX package's, at the tiny config of
`__graft_entry__._flagship(tiny=True)`, with the JAX parameters moved
across by `params_from_flax`.

Tolerance 1e-4 abs / 1e-4 rel: float32 on both sides, but the sums run in
another order and flax's LayerNorm takes the variance as E[x^2] - E[x]^2
where torch's subtracts the mean first, so the two differ in the last
digits after each of the model's many LayerNorms."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.models.goat import fuse_logits as jax_fuse_logits
from vln_goat_tpu.train.params import init_goat_params as jax_init
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import TINY, build_model
from vln_goat_tpu_torch.models.goat import fuse_logits
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax

TOL = dict(atol=1e-4, rtol=1e-4)
B, LT, K, N = 3, 16, 16, 12
LP = K + 36
G, L = N + 2, LP + 2


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(JaxConfig(**TINY))
    params = jax_init(jm, jax.random.PRNGKey(0), max_cands=K, num_nodes=N)
    tm = build_model(GoatConfig(**TINY), "cpu")
    tm.load_state_dict(params_from_flax(flatten(params["params"])),
                       strict=True)
    return jm, params, tm


def _text_inputs(rng):
    ids = rng.integers(0, TINY["vocab_size"], (B, LT))
    masks = np.arange(LT)[None, :] < np.array([LT, 9, 5])[:, None]
    return ids, masks


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_state_dict_keys_round_trip(models):
    """Every JAX parameter lands on one port parameter of the same size."""
    _, params, tm = models
    flat = flatten(params["params"])
    sd = params_from_flax(flat)
    assert set(sd) == set(tm.state_dict())
    assert sum(v.size for v in flat.values()) == \
        sum(v.numel() for v in sd.values())


def test_forward_text(models, rng):
    jm, params, tm = models
    ids, masks = _text_inputs(rng)
    ref = jm.apply(params, jnp.asarray(ids), jnp.asarray(masks),
                   method=JaxModel.forward_text)
    with torch.no_grad():
        out = tm.forward_text(_t(ids), _t(masks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_forward_text_fused_gate(models, rng, monkeypatch):
    """Gate on with the query-length threshold at 1: the JAX model runs the
    Pallas kernel (interpret mode), the port its plain version."""
    jm, params, tm = models
    monkeypatch.setenv("GOAT_PALLAS_MIN_LQ", "1")
    jf = JaxModel(JaxConfig(use_pallas_attention=True, **TINY))
    tf = build_model(GoatConfig(use_fused_attention=True,
                                fused_attn_min_lq=1, **TINY), "cpu")
    tf.load_state_dict(tm.state_dict())
    ids, masks = _text_inputs(rng)
    ref = jf.apply(params, jnp.asarray(ids), jnp.asarray(masks),
                   method=JaxModel.forward_text)
    with torch.no_grad():
        out = tf.forward_text(_t(ids), _t(masks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_forward_panorama(models, rng):
    jm, params, tm = models
    img = rng.standard_normal((B, LP, TINY["image_feat_size"])).astype(
        np.float32)
    loc = rng.standard_normal((B, LP, 7)).astype(np.float32)
    nav_types = rng.integers(0, 2, (B, LP))
    masks = rng.random((B, LP)) < 0.7
    masks[:, 0] = True
    ref = jm.apply(params, *map(jnp.asarray, (img, loc, nav_types, masks)),
                   method=JaxModel.forward_panorama)
    with torch.no_grad():
        out = tm.forward_panorama(*map(_t, (img, loc, nav_types, masks)))
    for o, r in zip((out[0], out[2]), (ref[0], ref[2])):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    assert np.array_equal(out[1].numpy(), np.asarray(ref[1]))


def _nav_inputs(rng):
    D = TINY["hidden_size"]
    n_real = np.array([N, 7, 3])
    real = np.arange(N)[None, :] < n_real[:, None]
    visited = real & (rng.random((B, N)) < 0.4)
    visited[:, 0] = True
    gmap_masks = np.concatenate([np.ones((B, 1), bool),
                                 np.zeros((B, 1), bool), real], 1)
    gmap_visited = np.concatenate([np.zeros((B, 1), bool),
                                   np.ones((B, 1), bool), visited], 1)
    pair = rng.uniform(0, 10, (B, G, G)).astype(np.float32)
    pair[:, :2] = 0.0
    pair[:, :, :2] = 0.0
    n_cand = np.array([5, 3, 2])
    cand = np.arange(K)[None, :] < n_cand[:, None]
    l2g = np.full((B, L), -1)
    for b in range(B):
        slots = rng.permutation(n_real[b])[:n_cand[b]] + 2
        l2g[b, 2:2 + n_cand[b]] = slots
    vp_masks = np.concatenate([np.ones((B, 2), bool),
                               cand, rng.random((B, 36)) < 0.8], 1)
    vp_nav = np.concatenate([np.ones((B, 1), bool), np.zeros((B, 1), bool),
                             cand, np.zeros((B, 36), bool)], 1)
    txt_masks = np.arange(LT)[None, :] < np.array([LT, 9, 5])[:, None]
    f32 = np.float32
    return dict(
        txt_embeds=rng.standard_normal((B, LT, D)).astype(f32),
        txt_masks=txt_masks,
        gmap_img_embeds=rng.standard_normal((B, G, D)).astype(f32),
        gmap_step_ids=rng.integers(0, 10, (B, G)),
        gmap_pos_fts=rng.standard_normal((B, G, 7)).astype(f32),
        gmap_masks=gmap_masks, gmap_pair_dists=pair,
        gmap_visited_masks=gmap_visited,
        vp_img_embeds=rng.standard_normal((B, L, D)).astype(f32),
        vp_pos_fts=rng.standard_normal((B, L, 14)).astype(f32),
        vp_masks=vp_masks, vp_nav_masks=vp_nav, local_to_gmap=l2g)


@pytest.mark.parametrize("hoisted_kv", [False, True])
def test_forward_navigation(models, rng, hoisted_kv):
    jm, params, tm = models
    nav = _nav_inputs(rng)
    jnav = {k: jnp.asarray(v) for k, v in nav.items()}
    tnav = {k: _t(v) for k, v in nav.items()}
    if hoisted_kv:
        jnav["txt_kv"] = jm.apply(params, jnav["txt_embeds"],
                                  method=JaxModel.forward_text_kv)
        with torch.no_grad():
            tnav["txt_kv"] = tm.forward_text_kv(tnav["txt_embeds"])
    ref = jm.apply(params, method=JaxModel.forward_navigation, **jnav)
    with torch.no_grad():
        out = tm.forward_navigation(**tnav)
    for k in ("gmap_embeds", "vp_embeds", "global_logits", "local_logits",
              "fused_logits", "cls_embeds"):
        r, o = np.asarray(ref[k]), out[k].numpy()
        assert np.array_equal(np.isfinite(r), np.isfinite(o)), k
        fin = np.isfinite(r)
        np.testing.assert_allclose(o[fin], r[fin], err_msg=k, **TOL)
        assert np.array_equal(o[~fin], r[~fin]), k


def test_fuse_logits_exact(rng):
    """Same inputs -> bitwise the same fused logits, including a visited
    candidate's backtrack sum and the -inf masks."""
    Bf, Gf, Lf = 4, 9, 7
    gl = rng.standard_normal((Bf, Gf)).astype(np.float32)
    ll = rng.standard_normal((Bf, Lf)).astype(np.float32)
    gm = rng.random((Bf, Gf)) < 0.8
    gm[:, 0], gm[:, 1] = True, False
    vis = rng.random((Bf, Gf)) < 0.3
    vis[:, 0], vis[:, 1] = False, True
    nav = rng.random((Bf, Lf)) < 0.8
    nav[:, 0], nav[:, 1] = True, False
    l2g = np.where(np.arange(Lf)[None] >= 2,
                   rng.integers(-1, Gf, (Bf, Lf)), -1)
    for b in range(Bf):   # one local candidate per gmap slot
        seen = set()
        for j in range(Lf):
            if l2g[b, j] in seen:
                l2g[b, j] = -1
            seen.add(l2g[b, j])
    ref = jax_fuse_logits(*map(jnp.asarray, (gl, ll, gm, vis, nav, l2g)))
    out = fuse_logits(*map(_t, (gl, ll, gm, vis, nav, l2g)))
    for o, r in zip(out, ref):
        assert np.array_equal(o.numpy(), np.asarray(r))
