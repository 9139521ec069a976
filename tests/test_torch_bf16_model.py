"""The port's GoatModel in bf16 compute (`compute_dtype="bfloat16"`,
float32 parameters) against the JAX package's `GoatModel(cfg,
dtype=jnp.bfloat16)`, plain and under GOAT's causal configuration, at the
tiny test widths, from one set of seeded weights (the port's, moved to the
JAX model by its `torch_to_flax`, through test_torch_causal_model.py).

bf16 rounds at other places in the two frameworks (torch's bf16 matmul
adds the bias before it rounds, XLA after; softmax and the one-pass
LayerNorm statistics are float32 on both sides), so the two bf16 models
are compared through the JAX float32 model on the same weights: for each
output, the port's distance from it, scaled by the output's largest
magnitude, is at most twice the JAX bf16 model's distance plus ATOL.
ATOL = 2e-3 (half a bf16 ulp at the scale) covers an output whose JAX
bf16 error happens to be small; the test prints both distances, which
come out at 4e-3 to 1.5e-2 and mostly equal (the same element rounds the
same way)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import CAUSAL, TINY, build_model
from test_torch_causal_model import (NO_CAUSAL, TEXT_KEYS, _pano_inputs,
                                     _text_inputs)
from test_torch_causal_model import _pair as _f32_pair
from test_torch_model import _nav_inputs
# torch on one thread: under xdist the workers share the cores
from test_torch_gate_witness import one_thread  # noqa: F401

ATOL = 2e-3


def _models(use_fused=False, **flags):
    """(JAX f32 model, JAX bf16 model, params, port bf16 model, banks)."""
    jm, params, tm, banks = _f32_pair(**flags)
    kw = {**TINY, **NO_CAUSAL, **flags}
    jf = dict(use_pallas_attention=True) if use_fused else {}
    tf = dict(use_fused_attention=True, fused_attn_min_lq=1) \
        if use_fused else {}
    j16 = JaxModel(JaxConfig(**kw, **jf), dtype=jnp.bfloat16)
    t16 = build_model(GoatConfig(**kw, **tf, compute_dtype="bfloat16"),
                      "cpu")
    t16.load_state_dict(tm.state_dict())
    return JaxModel(JaxConfig(**kw, **jf)), j16, params, t16, banks


@pytest.fixture(scope="module")
def plain():
    return _models()


@pytest.fixture(scope="module")
def causal():
    return _models(**CAUSAL)


def _gate(name, out, j16, ref):
    """out: port tensor; j16, ref: JAX bf16 and float32 arrays."""
    ref = np.asarray(ref, np.float64)
    j16 = np.asarray(jnp.asarray(j16, jnp.float32), np.float64)
    out = out.detach().double().numpy()
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(out)), name
    assert np.array_equal(out[~fin], ref[~fin]), name
    scale = np.abs(ref[fin]).max()
    err = np.abs(out[fin] - ref[fin]).max() / scale
    err_j = np.abs(j16[fin] - ref[fin]).max() / scale
    print(f"{name}: port {err:.3e}, jax bf16 {err_j:.3e}")
    assert err <= 2 * err_j + ATOL, (name, err, err_j)


def _text(models, rng):
    j32, j16, params, t16, banks = models
    ids, masks = _text_inputs(rng)
    kw = {dst: banks[src] for src, dst in TEXT_KEYS if src in banks}
    jargs = (jnp.asarray(ids), jnp.asarray(masks))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    ref = j32.apply(params, *jargs, method=JaxModel.forward_text, **jkw)
    r16 = j16.apply(params, *jargs, method=JaxModel.forward_text, **jkw)
    with torch.no_grad():
        out = t16.forward_text(
            torch.from_numpy(ids), torch.from_numpy(masks),
            **{k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in kw.items()})
    assert out.dtype == torch.bfloat16 and r16.dtype == jnp.bfloat16
    _gate("txt_embeds", out, r16, ref)


def _panorama(models, rng):
    j32, j16, params, t16, banks = models
    args = _pano_inputs(rng)
    zk = {}
    if "img_z_features" in banks:
        zk = dict(z_img_features=banks["img_z_features"],
                  z_img_pzs=banks["img_z_pzs"])
    jargs = tuple(map(jnp.asarray, args))
    jkw = {k: jnp.asarray(v) for k, v in zk.items()}
    ref = j32.apply(params, *jargs, method=JaxModel.forward_panorama, **jkw)
    r16 = j16.apply(params, *jargs, method=JaxModel.forward_panorama, **jkw)
    with torch.no_grad():
        out = t16.forward_panorama(
            *map(torch.from_numpy, args),
            **{k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in zk.items()})
    _gate("pano_embeds", out[0], r16[0], ref[0])
    _gate("pano_fused", out[2], r16[2], ref[2])
    assert np.array_equal(out[1].numpy(), np.asarray(ref[1]))


def _navigation(models, rng, hoisted_kv):
    j32, j16, params, t16, banks = models
    nav = _nav_inputs(rng)
    if "front_vp_feats" in banks:
        nav.update(front_vp_feats=banks["front_vp_feats"],
                   front_gmap_feats=banks["front_gmap_feats"])
    jnav = {k: jnp.asarray(v) for k, v in nav.items()}
    tnav = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in nav.items()}
    refs = []
    for jm in (j32, j16):
        kw = dict(jnav)
        if hoisted_kv:
            kw["txt_kv"] = jm.apply(params, jnav["txt_embeds"],
                                    method=JaxModel.forward_text_kv)
        refs.append(jm.apply(params, method=JaxModel.forward_navigation,
                             **kw))
    with torch.no_grad():
        if hoisted_kv:
            tnav["txt_kv"] = t16.forward_text_kv(tnav["txt_embeds"])
        out = t16.forward_navigation(**tnav)
    for k in ("gmap_embeds", "vp_embeds", "global_logits", "local_logits",
              "fused_logits", "cls_embeds"):
        assert out[k].dtype == torch.bfloat16, k
        _gate(k, out[k], refs[1][k], refs[0][k])


def test_bf16_forward_text(plain, rng):
    _text(plain, rng)


def test_bf16_forward_text_fused_gate(rng, monkeypatch):
    """Gate on with the query-length threshold at 1: the JAX bf16 model
    runs the Pallas kernel on bf16 operands (interpret mode), the port its
    plain bf16 version."""
    monkeypatch.setenv("GOAT_PALLAS_MIN_LQ", "1")
    _text(_models(use_fused=True), rng)


def test_bf16_forward_panorama(plain, rng):
    _panorama(plain, rng)


@pytest.mark.parametrize("hoisted_kv", [False, True])
def test_bf16_forward_navigation(plain, rng, hoisted_kv):
    _navigation(plain, rng, hoisted_kv)


def test_bf16_causal_forward_text(causal, rng):
    _text(causal, rng)


def test_bf16_causal_forward_panorama(causal, rng):
    _panorama(causal, rng)


def test_bf16_causal_forward_navigation(causal, rng):
    _navigation(causal, rng, True)


def test_compute_dtype_is_per_call():
    """Parameters stay float32 in a bf16 model; an unknown dtype raises."""
    tm = build_model(GoatConfig(**TINY, compute_dtype="bfloat16"), "cpu")
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert tm.config.torch_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        GoatConfig(compute_dtype="float16").torch_dtype
