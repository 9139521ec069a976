"""The causal modules of the port against the JAX package's, at the tiny
test widths (hidden 32, 2 heads, one layer per stack) with the banks at
the row counts a real run holds (`make_causal_banks`): LanguageEncoderDo
for each back-door type and merge the JAX package defines, the image
back door for type_1 and type_2 with each merge, FrontDoorEncoder, and
`forward_text` / `forward_panorama` / `forward_navigation` under the
causal configuration.  The port's seeded weights go to the JAX model
through the JAX package's `torch_to_flax`.

The cases are spread over three files, so that the test workers build
the JAX models apart: this one holds the language encoder's and the
helpers; test_torch_causal_image.py the image back door and
FrontDoorEncoder; test_torch_causal_forward.py the model's forwards
under the causal configuration.

Tolerance atol 5e-5 / rtol 1e-4: float32 on both sides, sums in another
order, and flax's LayerNorm takes the variance as E[x^2] - E[x]^2 where
torch's subtracts the mean first."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.train.checkpoint import torch_to_flax
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import TINY, build_model, make_causal_banks
from test_torch_model import _text_inputs

TOL = dict(atol=5e-5, rtol=1e-4)
B = 3
NO_CAUSAL = dict(do_back_txt=False, do_back_img=False, do_front_txt=False,
                 do_front_img=False, do_front_his=False)


def _pair(**flags):
    """(JAX model, its params, port model, banks [B, ...] as numpy) of the
    tiny config with `flags`, from the port's seeded weights."""
    kw = {**TINY, **NO_CAUSAL, **flags}
    tm = build_model(GoatConfig(**kw), "cpu", seed=3)
    params = torch_to_flax({k: v.numpy() for k, v in
                            tm.state_dict().items()})
    banks = {}
    for k, v in make_causal_banks(tm.config, seed=1, device="cpu").items():
        v = v[:, None] if v.ndim == 1 else v
        banks[k] = np.broadcast_to(v[None], (B,) + v.shape)
    return JaxModel(JaxConfig(**kw)), params, tm, banks


def _close(out, ref):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


TEXT_KEYS = (("instr_z_direction_features", "z_direc_embeds"),
             ("instr_z_direction_pzs", "z_direc_pzs"),
             ("instr_z_landmark_features", "z_landm_embeds"),
             ("instr_z_landmark_pzs", "z_landm_pzs"),
             ("front_txt_feats", "front_txt_embeds"))


def _forward_text(jm, params, tm, banks, rng):
    ids, masks = _text_inputs(rng)
    kw = {dst: banks[src] for src, dst in TEXT_KEYS if src in banks}
    ref = jm.apply(params, jnp.asarray(ids), jnp.asarray(masks),
                   method=JaxModel.forward_text,
                   **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out = tm.forward_text(torch.from_numpy(ids), torch.from_numpy(masks),
                              **{k: torch.from_numpy(np.ascontiguousarray(v))
                                 for k, v in kw.items()})
    return out, ref


@pytest.mark.parametrize("txt_type,method,back,front", [
    ("type_1", "door", True, True),
    ("type_1", "door", True, False),
    ("type_2", "door", True, True),
    ("type_2", "add", True, True),
    ("type_2", "concat", True, True),
    ("type_2", "door", False, True),
    ("type_2", "add", False, True),
])
def test_language_encoder_do(rng, txt_type, method, back, front):
    jm, params, tm, banks = _pair(do_back_txt=back, do_front_txt=front,
                                  do_back_txt_type=txt_type,
                                  do_add_method=method)
    _close(*_forward_text(jm, params, tm, banks, rng))


def _pano_inputs(rng):
    LP = 16 + 36
    img = rng.standard_normal((B, LP, TINY["image_feat_size"])).astype(
        np.float32)
    loc = rng.standard_normal((B, LP, 7)).astype(np.float32)
    nav_types = rng.integers(0, 2, (B, LP))
    masks = rng.random((B, LP)) < 0.7
    masks[:, 0] = True
    return img, loc, nav_types, masks


def _forward_panorama(jm, params, tm, banks, rng):
    args = _pano_inputs(rng)
    zk = dict(z_img_features=banks["img_z_features"],
              z_img_pzs=banks["img_z_pzs"])
    ref = jm.apply(params, *map(jnp.asarray, args),
                   method=JaxModel.forward_panorama,
                   **{k: jnp.asarray(v) for k, v in zk.items()})
    with torch.no_grad():
        out = tm.forward_panorama(
            *map(torch.from_numpy, args),
            **{k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in zk.items()})
    return out, ref


