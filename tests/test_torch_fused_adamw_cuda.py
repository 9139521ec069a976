"""The fused AdamW's kernels (`ops/csrc/adamw.cu` through `ops.optim`) on
the card:

- the update is bit-equal to the plain version (`clip_adamw_plain`, the
  loops' operations run by torch on the card) given the kernel's norm,
  over three updates of both optimizers' leaf sets at the benchmark's
  model sizes (`perfbench/configs/goat-r2r.json`): the fine-tune `AdamW`
  over the causal R2R model's trainable parameters and the pretraining
  adamw chain over the pretraining model's leaves (decay mask, the
  in_proj q / k / v row blocks), with some leaves without a gradient, the
  clip engaged on every update or on none; and a fine-tune `AdamW` over
  float32 and float64 leaves of odd sizes (two groups, one norm);
- the norm is within 1.5e-7 of the float64 norm of the same gradients and
  the same bits on a rerun.  The float32 squares are within 2^-24 of the
  exact ones, all of one sign, so their sum is within 2^-24 (the float64
  sums add some 2e-8 at 2e8 terms), its square root within half that, and
  the rounding to float32 adds 2^-24: 1.0e-7 at most;
- one update of each job (the tracer's rig) launches the norm once and the
  update once, inside the span `fused_adamw`, and makes no synchronisation
  with the card inside the optimizer (`set_sync_debug_mode("error")`);
- two Adam steps of the speaker at its published width (its chain has no
  clip: one update launch a step, no norm) are bit-equal to the plain
  version on copies of the same leaves, gradients and moments.

Needs an NVIDIA card; run there with

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_fused_adamw_cuda.py -m cuda
"""
import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vln_goat_tpu_torch.config import GoatConfig, PretrainConfig
from vln_goat_tpu_torch.models.goat import GoatModel
from vln_goat_tpu_torch.rollout.env import make_synthetic_dataset
from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan
from vln_goat_tpu_torch.speaker.model import SpeakerConfig
from vln_goat_tpu_torch.speaker.speaker import Speaker, speaker_batch
from vln_goat_tpu_torch.ops import optim
from vln_goat_tpu_torch.pretrain.model import GoatPretrainModel
from vln_goat_tpu_torch.pretrain.train import (PretrainState,
                                               make_pretrain_optimizer)
from vln_goat_tpu_torch.train import trainer as T
from vln_goat_tpu_torch.utils.logger import records
import torch_trace_rig as rig

pytestmark = pytest.mark.cuda

CFG = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                  / "configs" / "goat-r2r.json").read_text())
UPDATES = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def filled(model, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g, device="cuda"))
    return model


def finetune_model():
    gcfg = GoatConfig.for_dataset(CFG["dataset"], **CFG["model"],
                                  **CFG["finetune_flags"])
    with torch.device("meta"):
        model = GoatModel(gcfg)
    return filled(model.to_empty(device="cuda"), 0)


def pretrain_model():
    pt = CFG["pretrain"]
    gcfg = GoatConfig.for_dataset(CFG["dataset"], **CFG["model"])
    with torch.device("meta"):
        model = GoatPretrainModel(gcfg, tuple(pt["tasks"]),
                                  pt["mrc_prob_dim"])
    return filled(model.to_empty(device="cuda"), 1)


def grads_of(params, step, scale):
    """Seeded gradients, None on every eleventh leaf."""
    g = torch.Generator(device="cuda").manual_seed(100 + step)
    return [None if i % 11 == 5 else
            scale * torch.randn(p.shape, generator=g, device="cuda",
                                dtype=p.dtype)
            for i, p in enumerate(params)]


def plain_with(norm):
    """`clip_adamw_` replaced by the plain version clipping by `norm`."""
    def fn(groups, max_norm=None, clip_at_max=False):
        return optim.clip_adamw_plain(groups, max_norm, clip_at_max, norm)
    return fn


def launched(fn):
    before = dict(optim.launches)
    out = fn()
    return out, {k: optim.launches[k] - before[k] for k in before}


def with_norm(fn, monkeypatch):
    """fn() -> the norm the kernels clipped by (`clip_adamw_`'s result),
    and the launches."""
    seen, real = [], optim.clip_adamw_

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    with monkeypatch.context() as m:
        m.setattr(optim, "clip_adamw_", spy)
        _, n = launched(fn)
    (norm,) = seen
    return norm, n


def assert_bits(a, b, what):
    assert a.dtype == b.dtype and torch.equal(a, b), \
        (what, (a.double() - b.double()).abs().max().item())


def finetune_case(params, max_norm, scale, monkeypatch, groups=1):
    twin = [p.detach().clone() for p in params]
    opt_k, _ = T.make_optimizer(params, lr=2e-5, weight_decay=0.01)
    opt_q, _ = T.make_optimizer(twin, lr=2e-5, weight_decay=0.01)
    for step in range(UPDATES):
        grads = grads_of(params, step, scale)
        for p, q, g in zip(params, twin, grads):
            p.grad, q.grad = g, None if g is None else g.clone()
        norm, n = launched(lambda: opt_k.step(max_norm=max_norm))
        assert n == {"norm": 1, "update": groups}
        assert (norm.item() > max_norm) == (scale == 1.0)
        with monkeypatch.context() as m:
            m.setattr(optim, "clip_adamw_", plain_with(norm))
            opt_q.step(max_norm=max_norm)
        for i, (p, q) in enumerate(zip(params, twin)):
            assert_bits(p, q, (step, i, "p"))
            for k in ("mu", "nu"):
                assert_bits(opt_k.state[p][k], opt_q.state[q][k], (step, i, k))
        # the step leaves the gradients as they were
        for p, g in zip(params, grads):
            assert p.grad is g


@pytest.mark.parametrize("scale", [1.0, 1e-4])
def test_finetune_kernel_equals_plain(card, scale, monkeypatch):
    model = finetune_model()
    params = [p for p in model.parameters() if p.requires_grad]
    finetune_case(params, CFG["finetune"]["grad_clip"], scale, monkeypatch)


def test_float64_and_odd_sizes(card, monkeypatch):
    """Two groups (float32, float64: the gate witness's float64 model), odd
    sizes and views that start 4 bytes into their storage."""
    g = torch.Generator(device="cuda").manual_seed(7)
    params = []
    for n, dtype in [(1, torch.float32), (7, torch.float64),
                     (8195, torch.float32), (3, torch.float64),
                     (40001, torch.float64), (513, torch.float32)]:
        base = torch.randn(n + 1, generator=g, device="cuda", dtype=dtype)
        params.append(base[1:])
    finetune_case(params, 4.0, 1.0, monkeypatch, groups=2)


@pytest.mark.parametrize("scale", [1.0, 1e-5])
def test_pretrain_kernel_equals_plain(card, scale, monkeypatch):
    model = pretrain_model()
    twin = copy.deepcopy(model)
    pt = CFG["pretrain"]
    pcfg = PretrainConfig(tasks=tuple(pt["tasks"]),
                          learning_rate=pt["learning_rate"],
                          warmup_steps=pt["warmup_steps"],
                          num_train_steps=pt["num_train_steps"],
                          grad_norm=pt["grad_norm"], optim=pt["optim"],
                          betas=tuple(pt["betas"]),
                          weight_decay=pt["weight_decay"])
    sk = PretrainState(model, make_pretrain_optimizer(pcfg, model))
    sq = PretrainState(twin, make_pretrain_optimizer(pcfg, twin))
    assert any(leaf.rows is not None for leaf in sk.leaves)
    params = list(model.parameters())
    for step in range(UPDATES):
        grads = grads_of(params, step, scale)
        for p, q, g in zip(params, twin.parameters(), grads):
            p.grad, q.grad = g, None if g is None else g.clone()
        norm, n = with_norm(lambda: sk.apply(sk.leaf_grads()), monkeypatch)
        assert n == {"norm": 1, "update": 1}
        assert (norm.item() >= pt["grad_norm"]) == (scale == 1.0)
        with monkeypatch.context() as m:
            m.setattr(optim, "clip_adamw_", plain_with(norm))
            sq.apply(sq.leaf_grads())
        for i, (p, q) in enumerate(zip(params, twin.parameters())):
            assert_bits(p, q, (step, i, "p"))
        (ak, _, _), (aq, _, _) = sk.opt_state[1], sq.opt_state[1]
        assert ak["count"] == aq["count"] == step + 1
        for k in ("mu", "nu"):
            for i, (x, y) in enumerate(zip(ak[k], aq[k])):
                assert_bits(x, y, (step, i, k))


def test_norm_against_float64_and_rerun(card):
    """The norm of one fine-tune step over the benchmark model's gradients,
    twice, each on fresh copies of the parameters."""
    model = finetune_model()
    params = [p for p in model.parameters() if p.requires_grad]
    grads = grads_of(params, 0, 1.0)
    norms = []
    for _ in range(2):
        twin = [p.detach().clone() for p in params]
        for q, g in zip(twin, grads):
            q.grad = g
        opt, _ = T.make_optimizer(twin, lr=2e-5, weight_decay=0.01)
        norm, n = launched(lambda: opt.step(max_norm=40.0))
        assert n == {"norm": 1, "update": 1}
        norms.append(norm)
        del twin, opt
    norm = norms[0]
    assert norm.dtype == torch.float32 and norm.dim() == 0
    assert torch.equal(norm, norms[1])
    exact = torch.sqrt(sum(g.double().square().sum() for g in grads
                           if g is not None))
    rel = abs(norm.double() - exact).item() / exact.item()
    assert rel <= 1.5e-7, rel


def test_speaker_step_equals_plain(card, monkeypatch):
    """Two steps of `Speaker.make_train_step` (gradients from
    `torch.autograd.grad`, in whatever layout it leaves them) at the
    speaker's published width and R2R's 15 path steps / 60 tokens: each
    step's `clip_adamw_` call is held against `clip_adamw_plain` on copies
    of its leaves and moments."""
    graphs = {g.scan_id: g for g in [make_synthetic_scan("sp0", seed=3),
                                     make_synthetic_scan("sp1", seed=4)]}
    offsets, total = {}, 0
    for sid, g in graphs.items():
        offsets[sid], total = total, total + g.num_vps
    feats = np.random.default_rng(0).standard_normal(
        (total, 36, 768)).astype(np.float32)
    items = make_synthetic_dataset(graphs, 16, vocab_size=500, seed=5)
    sp = Speaker(SpeakerConfig(vocab_size=500), "cuda", seed=0)
    batch = speaker_batch(sp, graphs, feats, offsets, items, 15, 60)
    step, _ = sp.make_train_step(lr=1e-4)
    real, calls = optim.clip_adamw_, []

    def held(groups, max_norm=None, clip_at_max=False):
        twins = [dataclasses.replace(
            grp, params=[p.clone() for p in grp.params],
            mus=[m.clone() for m in grp.mus],
            nus=[v.clone() for v in grp.nus]) for grp in groups]
        norm, n = launched(lambda: real(groups, max_norm, clip_at_max))
        assert max_norm is None and norm is None
        assert n == {"norm": 0, "update": 1}
        optim.clip_adamw_plain(twins, max_norm, clip_at_max)
        for grp, tw in zip(groups, twins):
            for k in ("params", "mus", "nus"):
                for i, (a, b) in enumerate(zip(getattr(grp, k),
                                               getattr(tw, k))):
                    assert_bits(a, b, (len(calls), i, k))
        calls.append(sum(len(grp.params) for grp in groups))
        return norm

    monkeypatch.setattr(optim, "clip_adamw_", held)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        loss = step(batch, gen)
        assert torch.isfinite(loss)
    assert calls == [len(list(sp.model.parameters()))] * 2


def strict(fn):
    """fn under `set_sync_debug_mode("error")`: a synchronisation raises."""
    def run(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return run


def test_finetune_step_two_launches_no_sync(card, monkeypatch):
    state, batch, gen = rig.finetune(card)
    state.step_fn(state, batch, gen)          # builds the kernels
    monkeypatch.setattr(T, "apply_update", strict(T.apply_update))
    records().clear()
    _, n = launched(lambda: state.step_fn(state, batch, gen))
    assert n == {"norm": 1, "update": 1}
    (rec,) = records()
    assert rec["update/optimizer/fused_adamw"][1] == 1
    assert "update/optimizer/read" not in rec


def test_pretrain_steps_two_launches_no_sync(card, tmp_path, monkeypatch):
    state, steps, batches, _ = rig.pretrain(tmp_path, card)
    gen = torch.Generator(device=card).manual_seed(0)
    for task in rig.TASKS:                    # builds the kernels
        steps[task](state, batches[task], gen)
    monkeypatch.setattr(PretrainState, "apply", strict(PretrainState.apply))
    records().clear()
    for task in rig.TASKS:
        _, n = launched(lambda: steps[task](state, batches[task], gen))
        assert n == {"norm": 1, "update": 1}
    assert len(records()) == len(rig.TASKS)
    for rec in records():
        assert rec["update/optimizer/fused_adamw"][1] == 1
        assert "update/optimizer/read" not in rec
