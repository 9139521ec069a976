"""Key audit of the port: the names and shapes of the port's
`state_dict()` at the full R2R widths, plain and causal, against the
reference checkpoint's key snapshots (tests/fixtures/ref_ckpt_keys_*.txt,
as tests/test_ckpt_audit.py audits the JAX package), and
`params_from_flax` over the JAX package's parameter tree of the causal
configuration.

A reference key the port lacks must be one that
`scripts/audit_ckpt_keys.py` `expected_unused` lists for that
configuration (parameters the reference's forward never reads).  The port
builds `front_txt_encoder` as the reference does, so it has every key the
JAX package lacks there.  The models are built on the meta device: shapes
only, no memory."""
import os
import sys

import numpy as np
import pytest
import jax
import torch

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.train.params import init_goat_params as jax_init
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import CAUSAL, TINY
from vln_goat_tpu_torch.models.goat import GoatModel
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
from audit_ckpt_keys import expected_unused  # noqa: E402


def _fixture(name):
    out = {}
    with open(os.path.join(HERE, "fixtures", name)) as f:
        for line in f:
            key, _, shape = line.strip().partition(" ")
            out[key] = tuple(int(d) for d in shape.split(",") if d)
    return out


def _port_shapes(**flags):
    with torch.device("meta"):
        model = GoatModel(GoatConfig.for_dataset("r2r", **flags))
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("causal,fixture", [
    (True, "ref_ckpt_keys_causal.txt"),
    (False, "ref_ckpt_keys_plain.txt"),
])
def test_state_dict_matches_reference_keys(causal, fixture):
    ref = _fixture(fixture)
    port = _port_shapes(**(CAUSAL if causal else {}))
    extra = sorted(set(port) - set(ref))
    assert not extra, f"port keys the reference lacks: {extra[:8]}"
    for k, shape in port.items():
        assert shape == ref[k], (k, shape, ref[k])
    exp = [s.replace("/", ".") for s in expected_unused(causal=causal)]
    missing = [k for k in set(ref) - set(port)
               if not any(s in k for s in exp)]
    assert not missing, f"reference keys the port lacks: {missing[:8]}"
    assert any(k.startswith("front_txt_encoder.") for k in port) == causal


def test_params_from_flax_fills_every_causal_parameter():
    """The JAX tree of the causal config (shapes from jax.eval_shape of
    its own init, at the tiny widths) fills every port parameter once;
    only front_txt_encoder, which flax never materialises because nothing
    calls it, stays for the port's own init."""
    cfg = {**TINY, **CAUSAL}
    tree = jax.eval_shape(lambda: jax_init(JaxModel(JaxConfig(**cfg)),
                                           jax.random.PRNGKey(0)))
    flat = flatten(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                tree["params"]))
    sd = params_from_flax(flat)
    with torch.device("meta"):
        port = GoatModel(GoatConfig(**cfg)).state_dict()
    left = set(port) - set(sd)
    assert left and all(k.startswith("front_txt_encoder.") for k in left)
    assert set(sd) <= set(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    # each JAX leaf lands in exactly one port tensor
    assert sum(v.size for v in flat.values()) == \
        sum(v.numel() for v in sd.values())
