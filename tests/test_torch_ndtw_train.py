"""The port's RxR train step with the nDTW expert against the JAX
package's `make_train_step`, on the small RxR rig of
test_torch_reverie_rollout.py (`obj_rig("rxr", expert_policy="ndtw")`,
every dropout at 0), the Gumbel draw substituted on both sides: "dagger"
with the port's vectorized and per-step teachers, loss, il_loss,
sample_loss and grad_norm to a relative 1e-4, every parameter's gradient
at atol 1e-5 / rtol 1e-3 (the checks of test_torch_reverie_train.py)."""
import pytest

from test_torch_reverie_rollout import obj_rig
from test_torch_reverie_train import _check, _pair


@pytest.fixture(scope="module")
def rxr():
    return obj_rig("rxr", expert_policy="ndtw", batch_size=6, seed=3)


def test_rxr_dagger_step_matches_jax(rxr):
    _check(*_pair(rxr, "dagger", rxr["jbatch"], rxr["tbatch"],
                  (True, False)), objects=False)
