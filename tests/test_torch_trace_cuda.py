"""Every synchronisation of an update with the card goes through the
port's `read` (`utils.logger`): one small fine-tune update and one small
pretraining update of each task run under
`torch.cuda.set_sync_debug_mode("error")`, which `read` lifts around its
own copy, so that any other synchronising call raises.  Needs an NVIDIA
card; run there with

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_trace_cuda.py -m cuda
"""
import math

import pytest
import torch

from vln_goat_tpu_torch.utils.logger import is_read, records
import torch_trace_rig as rig

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def reads_of(rec):
    return sum(n for p, (_, n) in rec.items() if is_read(p))


def test_finetune_update_syncs_only_in_read(card):
    state, batch, gen = rig.finetune(card)
    state.step_fn(state, batch, gen)          # builds the kernels
    torch.cuda.synchronize()
    records().clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = state.step_fn(state, batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    (rec,) = records()
    steps = int(m["sample_steps"]) + int(m["teacher_steps"])
    assert rec["update/sample/step"][1] == int(m["sample_steps"])
    assert reads_of(rec) >= steps
    assert math.isfinite(m["loss"].item())


def test_pretrain_updates_sync_only_in_read(card, tmp_path):
    state, steps, batches, _ = rig.pretrain(tmp_path, card)
    gen = torch.Generator(device=card).manual_seed(0)
    for task in rig.TASKS:                    # builds the kernels
        steps[task](state, batches[task], gen)
    torch.cuda.synchronize()
    records().clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = [steps[task](state, batches[task], gen) for task in rig.TASKS]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(records()) == len(rig.TASKS)
    for rec, m in zip(records(), out):
        # the fused AdamW clips on the card: no read of the norm
        assert rec["update/optimizer/fused_adamw"][1] == 1
        assert reads_of(rec) == 0
        assert math.isfinite(m["loss"].item())
