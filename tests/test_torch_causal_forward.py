"""`forward_text`, `forward_panorama` and `forward_navigation` of the port
under GOAT's causal configuration against the JAX package's, at the tiny
test widths with the banks at a real run's row counts
(test_torch_causal_model.py has the setting and the tolerance)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu_torch.entry import CAUSAL
from test_torch_causal_model import TOL, _close, _forward_panorama, \
    _forward_text, _pair
from test_torch_model import _nav_inputs


@pytest.fixture(scope="module")
def causal_pair():
    return _pair(**CAUSAL)


def test_causal_forward_text(causal_pair, rng):
    _close(*_forward_text(*causal_pair, rng))


def test_causal_forward_panorama(causal_pair, rng):
    out, ref = _forward_panorama(*causal_pair, rng)
    for o, r in zip((out[0], out[2]), (ref[0], ref[2])):
        _close(o, r)
    assert np.array_equal(out[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("hoisted_kv", [False, True])
def test_causal_forward_navigation(causal_pair, rng, hoisted_kv):
    jm, params, tm, banks = causal_pair
    nav = _nav_inputs(rng)
    nav.update(front_vp_feats=banks["front_vp_feats"],
               front_gmap_feats=banks["front_gmap_feats"])
    jnav = {k: jnp.asarray(v) for k, v in nav.items()}
    tnav = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in nav.items()}
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
        fin = np.isfinite(r)
        assert np.array_equal(fin, np.isfinite(o)), k
        np.testing.assert_allclose(o[fin], r[fin], err_msg=k, **TOL)
        assert np.array_equal(o[~fin], r[~fin]), k
