"""The float64 witness of the train step's gradient comparison
(`vln_goat_tpu_torch/tools/gate_witness.py`) on the CPU, at the test
configuration: the comparison chip_smoke.py phase 5 gates on, the ReLU
decisions it pins, and the eager model behind float64 entry points
against the float32 step."""
import math

import numpy as np
import pytest
import torch
from torch import nn

from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import TINY, build_train_flagship
from vln_goat_tpu_torch.models.layers import ClsPrediction
from vln_goat_tpu_torch.tools.gate_witness import (compare_routes,
                                                    in_float64, pin_relus,
                                                    record_relus, worst_grad)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: under xdist each worker shares the cores with
    the others, and torch's thread pool spinning against them makes these
    small steps ten times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_worst_grad_scales():
    """Each gradient is held at its own largest magnitude, a bias of
    NOISE_GRAD_BIASES at its weight's; a difference on a zero gradient
    is infinitely far."""
    ref = {"a.weight": torch.tensor([2.0, -4.0]),
           "a.key.weight": torch.tensor([10.0]),
           "a.key.bias": torch.tensor([0.0])}
    got = {"a.weight": torch.tensor([2.0, -3.6]),
           "a.key.weight": torch.tensor([10.0]),
           "a.key.bias": torch.tensor([0.5])}
    assert worst_grad(got, ref) == pytest.approx((0.1, "a.weight"))
    got["a.key.bias"] = torch.tensor([2.0])
    assert worst_grad(got, ref) == pytest.approx((0.2, "a.key.bias"))
    ref["b.weight"], got["b.weight"] = torch.zeros(1), torch.ones(1)
    assert worst_grad(got, ref) == (math.inf, "b.weight")


@pytest.mark.parametrize("causal", [False, True])
def test_float64_witness_tracks_the_float32_step(causal):
    """On the CPU (no kernels) the plain route, the eager step and the
    float64 model each repeat themselves bit for bit, take the eager
    step's actions and loss, and their gradients agree within a tenth of
    the card's gate (1e-3 of each gradient's largest magnitude): at the
    test configuration no pre-activation lies within rounding of a
    ReLU's kink."""
    rows = compare_routes("cpu", causal, tiny=True)
    assert set(rows) == {"plain", "eager", "float64"}
    loss = rows["eager"][0]
    for name, (l, same, again, eager, f64, pin) in rows.items():
        assert same, name
        assert l == pytest.approx(loss, rel=1e-5), name
        assert again[0] == 0.0, name
        assert eager[0] < 1e-4 and f64[0] < 1e-4, name
        # no decision within rounding of a kink here: pinning them to the
        # eager step's changes nothing
        assert pin[0] == 0 and pin[1] == 0.0 and pin[2] < 1e-4, name
        assert pin[3][0] == pytest.approx(eager[0], abs=1e-7), name
    assert rows["eager"][3][0] == 0.0 and rows["float64"][4][0] == 0.0
    assert rows["eager"][5][2] == 0.0 and rows["eager"][5][3][0] == 0.0
    # float64 is another computation than eager's float32, here too
    assert rows["float64"][5][2] > 0.0
    # float64 is another computation than eager's float32
    assert rows["float64"][3][0] > 0.0


def test_float64_model_computes_in_float64():
    """`in_float64` turns the parameters to float64 and keeps float32 at
    the model's entry points."""
    state, batcher = build_train_flagship("cpu", tiny=True, batch_size=2,
                                          dropout=False)
    in_float64(state.model)
    assert all(p.dtype == torch.float64 for p in state.model.parameters())
    _, batch = batcher.next_batch()
    out = state.model.forward_text(batch["txt_ids"], batch["txt_masks"])
    assert out.dtype == torch.float32


class _Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.head = ClsPrediction(GoatConfig(**TINY))


def _z(head, x):
    return head.head.net[0](x)


def test_pin_relus_takes_the_recorded_decisions():
    """A step pinned to another's ReLU decisions keeps the units that step
    kept, z * (z_seen > 0), in value and in gradient; it counts the units
    whose own decision differs and the largest |z - z_seen| among them."""
    torch.manual_seed(0)
    model = _Head()
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((3, 5, 32)), dtype=torch.float32)
    seen, hooks = record_relus(model)
    model.head(x)
    model.head(x[:, :2])
    for h in hooks:
        h.remove()
    assert [z.shape for z in seen["head"]] == [(3, 5, 32), (3, 2, 32)]
    z0 = seen["head"][0]
    assert torch.equal(z0, _z(model, x).detach())

    # the same input again: the pinned head is the head, bit for bit
    stats, hooks = pin_relus(model, seen)
    x1 = x.clone().requires_grad_(True)
    out = model.head(x1)
    model.head(x[:, :2])
    for h in hooks:
        h.remove()
    ref_in = x.clone().requires_grad_(True)
    ref = model.head(ref_in)
    assert torch.equal(out, ref)
    out.sum().backward()
    ref.sum().backward()
    assert torch.equal(x1.grad, ref_in.grad)
    assert stats == {"calls": 2, "flips": 0, "dist": 0.0, "dev": 0.0}

    # another input: the units the recorded call kept pass, the others
    # give 0, whatever the new z's sign
    x2 = x + 0.05 * torch.tensor(rng.standard_normal(x.shape),
                                 dtype=torch.float32)
    z2 = _z(model, x2).detach()
    flip = (z2 > 0) != (z0 > 0)
    assert int(flip.sum()) > 0
    relu_out = {}
    hooks = [model.head.net[2].register_forward_pre_hook(
        lambda mod, inp: relu_out.setdefault("out", inp[0].detach()))]
    stats, pins = pin_relus(model, seen)
    model.head(x2)
    for h in hooks + pins:
        h.remove()
    assert torch.equal(relu_out["out"], z2 * (z0 > 0))
    assert stats["calls"] == 1 and stats["flips"] == int(flip.sum())
    assert stats["dist"] == pytest.approx(
        float((z2 - z0)[flip].abs().max()))
    assert stats["dev"] == pytest.approx(float((z2 - z0).abs().max()))


def test_pin_relus_refuses_calls_it_did_not_see():
    """A call past the recorded ones, or of another shape, raises."""
    model = _Head()
    x = torch.ones(2, 4, 32)
    seen, hooks = record_relus(model)
    model.head(x)
    for h in hooks:
        h.remove()
    _, hooks = pin_relus(model, seen)
    with pytest.raises(AssertionError, match="not recorded"):
        model.head(x[:, :3])
    for h in hooks:
        h.remove()
    _, hooks = pin_relus(model, seen)
    model.head(x)
    with pytest.raises(AssertionError, match="call 1"):
        model.head(x)
    for h in hooks:
        h.remove()
