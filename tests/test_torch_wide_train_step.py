"""The port's DAgger train step at head width 256 against the JAX
package's, every attention on the fused route: the tiny configuration of
tests/test_torch_train_step.py widened to hidden 256 in one head of 256
and two language layers, both packages' fused gate at a query-length
threshold of 1.  The JAX model runs `pallas_fused_qkv_mha` in interpret
mode (as its own kernel tests run it); the port's wrapper takes its plain
version on the CPU, and on the card the DH 256 instances of the attention
cores (tests/test_torch_kernel_cuda.py, chip_smoke.py phases 3 (n) and
5 (w)).  One step at the "auto" teacher horizon from the same weights and
batch, the Gumbel draws fixed on both sides, held at
test_torch_train_step.py's tolerances: loss, il_loss, sample_loss and
grad_norm to a relative 1e-4, every gradient at atol 1e-5 / rtol 1e-3,
the sampled actions exactly."""
import inspect

import numpy as np
import pytest
import jax  # noqa: F401  (JAX on the CPU before the rig compiles)
import torch

from vln_goat_tpu_torch import entry
from vln_goat_tpu_torch.ops import attention
from vln_goat_tpu_torch.ops.attention import HEAD_DIMS, on_wide_core
import test_torch_train_step as T

WIDE = dict(hidden_size=256, num_attention_heads=1, intermediate_size=512,
            num_l_layers=2)


@pytest.fixture(scope="module")
def wide_pair():
    """One DAgger step of each package (`test_torch_train_step.run_pair`)
    at WIDE, and the head widths of the port's fused attention calls."""
    widths = []
    plain = attention.fused_qkv_mha_plain

    def counted(*a, **k):
        call = inspect.signature(plain).bind(*a, **k)
        call.apply_defaults()
        widths.append(call.arguments["wq"].shape[1]
                      // call.arguments["num_heads"])
        return plain(*a, **k)

    # torch on one thread: under xdist the workers share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(entry, "TINY", {**entry.TINY, **WIDE,
                                   "fused_attn_min_lq": 1})
        mp.setenv("GOAT_PALLAS_MIN_LQ", "1")
        state, tbatcher = entry.build_train_flagship(
            "cpu", tiny=True, batch_size=T.B, dropout=False)
        sd = state.model.state_dict()
        jro, params, jbatcher = T._jax_rig(sd, use_pallas_attention=True,
                                           **WIDE)
        _, jbatch = jbatcher.next_batch()
        _, tbatch = tbatcher.next_batch()
        for k, v in jbatch.items():
            assert np.array_equal(np.asarray(v), tbatch[k].numpy()), k
        noise = np.random.default_rng(5).gumbel(size=(T.B, 16 + 2)).astype(
            np.float32)
        rigs = dict(jro=jro, params=params, jbatch=jbatch, tbatch=tbatch,
                    sd=sd, noise=noise)
        mp.setattr(attention, "fused_qkv_mha_plain", counted)
        pair = T.run_pair(rigs, "dagger", "auto")
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    pair["widths"] = widths
    return pair


def test_metrics_match(wide_pair):
    T.test_metrics_match(wide_pair)


def test_grads_match(wide_pair):
    T.test_grads_match(wide_pair)


def test_actions_identical(wide_pair):
    T.test_actions_identical(wide_pair)


def test_every_attention_is_fused_at_256(wide_pair):
    """The port's step ran its attention through the fused wrapper, every
    call at head width 256: an instance of the cores, not the wide-head
    core."""
    assert len(wide_pair["widths"]) > 0
    assert set(wide_pair["widths"]) == {256}
    assert 256 in HEAD_DIMS and not on_wide_core(256)
