"""The image back door and FrontDoorEncoder of the port against the JAX
package's, at the tiny test widths with the banks at a real run's row
counts (test_torch_causal_model.py has the setting and the tolerance)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vln_goat_tpu.models.goat import FrontDoorEncoder as JaxFrontDoor
from vln_goat_tpu_torch.entry import CAUSAL, TINY
from test_torch_causal_model import B, _close, _forward_panorama, _pair


@pytest.mark.parametrize("img_type,method", [
    ("type_1", "door"), ("type_2", "door"), ("type_2", "add"),
    ("type_2", "concat")])
def test_image_backdoor(rng, img_type, method):
    jm, params, tm, banks = _pair(do_back_img=True,
                                  do_back_img_type=img_type,
                                  do_add_method=method)
    out, ref = _forward_panorama(jm, params, tm, banks, rng)
    for o, r in zip((out[0], out[2]), (ref[0], ref[2])):
        _close(o, r)


@pytest.mark.parametrize("masked", [True, False])
def test_front_door_encoder(rng, masked):
    jm, params, tm, banks = _pair(**CAUSAL)
    D = TINY["hidden_size"]
    local = rng.standard_normal((B, 14, D)).astype(np.float32)
    masks = np.arange(14)[None, :] < np.array([14, 9, 4])[:, None]
    bank = banks["front_gmap_feats"]
    m = masks if masked else None
    ref = JaxFrontDoor(jm.config).apply(
        {"params": params["params"]["front_global_encoder"]},
        jnp.asarray(local), jnp.asarray(bank),
        None if m is None else jnp.asarray(m))
    with torch.no_grad():
        out = tm.front_global_encoder(
            torch.from_numpy(local),
            torch.from_numpy(np.ascontiguousarray(bank)),
            None if m is None else torch.from_numpy(m))
    _close(out, ref)
