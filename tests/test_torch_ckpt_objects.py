"""Parameters across packages for the new heads: a REVERIE, a SOON and an
`extract_cfp_features` model (the small configuration of
test_torch_reverie_model.py), and `Critic`, exactly (float32 copies and
transposes):

- JAX -> port: `params_from_flax` of the JAX package's initial parameters
  loads strictly into the port's model (every object embedding, og_head,
  the tim_* modules and the raw tim_*_attn vectors included);
- port -> reference .pt -> port: `save_reference_checkpoint`, then
  `load_reference` into a model of other weights, gives back the same
  tensors, no key missing or extra;
- reference .pt -> JAX: the JAX package's `torch_to_flax` of the port's
  file is the JAX tree the weights came from;
- JAX .pt -> port: a file of the JAX package's `flax_to_torch` loads into
  the port equal to `params_from_flax`;
- `Critic`: the JAX module's parameters through `params_from_flax` into the
  port's (state2value.0 / .3), the same values on one input (1e-6), and
  back through `torch_to_flax`."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import Critic as JaxCritic
from vln_goat_tpu.train.checkpoint import flax_to_torch
from vln_goat_tpu.train.checkpoint import load_reference_checkpoint as \
    jax_load_reference
from vln_goat_tpu.train.checkpoint import torch_to_flax
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import build_model
from vln_goat_tpu_torch.models.goat import Critic
from vln_goat_tpu_torch.train import checkpoint as ck
from test_torch_reverie_model import OBJ, SMALL, small_pair

CASES = {"reverie": ("reverie", OBJ), "soon": ("soon", OBJ),
         "cfp": ("r2r", dict(mode="extract_cfp_features"))}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    dataset, kw = CASES[request.param]
    return (dataset, kw) + small_pair(dataset, **kw)


def test_reference_pt_round_trip(pair, tmp_path):
    dataset, kw, _, params, tm = pair
    path = str(tmp_path / "latest_dict.pt")
    ck.save_reference_checkpoint(tm, path, 3)
    other = build_model(GoatConfig.for_dataset(dataset, **SMALL, **kw),
                        "cpu", seed=1)
    missing, extra = ck.load_reference(other, path, strict=True)
    assert missing == [] and extra == []
    for k, v in tm.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    # the JAX package reads the port's file back into its own tree
    back = ck.flatten(torch_to_flax(jax_load_reference(path))["params"])
    ref = ck.flatten(params["params"])
    assert set(back) == set(ref)
    for k, v in ref.items():
        assert np.array_equal(np.asarray(back[k]), np.asarray(v)), k


def test_jax_pt_loads_into_port(pair, tmp_path):
    dataset, kw, _, params, tm = pair
    path = str(tmp_path / "jax.pt")
    torch.save({"vln_bert": {"epoch": 1, "state_dict": {
        k: torch.from_numpy(np.array(v))
        for k, v in flax_to_torch(params).items()}}}, path)
    other = build_model(GoatConfig.for_dataset(dataset, **SMALL, **kw),
                        "cpu", seed=2)
    missing, extra = ck.load_reference(other, path, strict=True)
    assert missing == [] and extra == []
    want = ck.params_from_flax(ck.flatten(params["params"]))
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_critic_round_trip(rng):
    jc = JaxCritic(JaxConfig(**SMALL))
    x = rng.standard_normal((4, 32)).astype(np.float32)
    params = jc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    sd = ck.params_from_flax(ck.flatten(params["params"]))
    assert set(sd) == {"state2value.0.weight", "state2value.0.bias",
                       "state2value.3.weight", "state2value.3.bias"}
    tc = Critic(GoatConfig(**SMALL))
    tc.load_state_dict(sd, strict=True)
    tc.eval()
    with torch.no_grad():
        out = tc(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jc.apply(
        params, jnp.asarray(x))), atol=1e-6)
    back = ck.flatten(torch_to_flax(
        {k: v.numpy() for k, v in tc.state_dict().items()})["params"])
    for k, v in ck.flatten(params["params"]).items():
        assert np.array_equal(np.asarray(back[k]), np.asarray(v)), k
