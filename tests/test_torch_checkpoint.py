"""The port's checkpoints (train/checkpoint.py).

- Train state: 4 steps straight against 2 steps, `save_train_state`, a
  fresh build, `load_train_state` and 2 more steps (the batcher moved past
  the first 2 batches, as the CLI's resume does): the weights, AdamW's
  exp_avg / exp_avg_sq / step, the counts and the generator are bitwise
  equal.  Dropout on.  Also with a learning-rate schedule, gradient
  accumulation and the finite guard.
- Reference .pt files, both ways, exactly: one written by the JAX CLI's
  `_save_torch` (its flax_to_torch) loads into the port equal to
  `params_from_flax` of the same parameters, no key missing or extra; one
  written by the port (`save_reference_checkpoint`) goes through the JAX
  package's `torch_to_flax(load_reference_checkpoint(...))` and gives back
  the JAX parameters it came from.
- Key audit: the keys the port writes, at the full R2R widths, plain and
  causal, are reference keys of the same shapes
  (tests/fixtures/ref_ckpt_keys_*.txt), and a file with every reference
  key leaves no port key missing; the reference keys the port does not
  take are the buffers `strip_prefixes` drops and those
  `scripts/audit_ckpt_keys.py` `expected_unused` lists.
"""
import os

import numpy as np
import pytest
import jax
import torch

from vln_goat_tpu import cli as jcli
from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.train.checkpoint import load_reference_checkpoint as \
    jax_load_reference
from vln_goat_tpu.train.checkpoint import torch_to_flax
from vln_goat_tpu.train.params import init_goat_params as jax_init
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import CAUSAL, TINY, build_model, \
    build_train_flagship
from vln_goat_tpu_torch.models.goat import GoatModel
from vln_goat_tpu_torch.train import checkpoint as ck
from vln_goat_tpu_torch.train.trainer import init_train_state
from test_torch_ckpt_keys import _fixture, expected_unused
from test_torch_gate_witness import one_thread  # noqa: F401


def _state(sched):
    state, batcher = build_train_flagship("cpu", tiny=True, batch_size=4,
                                          remat="none")
    if sched:
        state = init_train_state(
            state.model, state.rollout, teacher_horizon="auto",
            remat="none", lr_sch="linear", warmup_steps=1, total_steps=6,
            accumulate_steps=2, finite_guard=True)
    return state, batcher


def _snapshot(state, gen):
    opt = state.optimizer
    adam = [(st["step"], st["mu"].clone(), st["nu"].clone())
            for st in (opt.state[p] for p in opt.params())]
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            adam, state.step, state.scheduler.last_epoch,
            [g["lr"] for g in opt.param_groups], gen.get_state())


@pytest.mark.parametrize("sched", [False, True])
def test_train_state_resumes_bit_for_bit(tmp_path, sched):
    state, batcher = _state(sched)
    gen = torch.Generator().manual_seed(3)
    for _ in range(4):
        state.step_fn(state, batcher.next_batch()[1], gen)
    want = _snapshot(state, gen)

    state, batcher = _state(sched)
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        state.step_fn(state, batcher.next_batch()[1], gen)
    ck.save_train_state(str(tmp_path / "ts"), state, gen, 2)
    assert ck.is_train_state_dir(str(tmp_path / "ts"))
    assert not ck.is_train_state_dir(str(tmp_path))

    state, batcher = _state(sched)
    gen = torch.Generator().manual_seed(99)
    assert ck.load_train_state(str(tmp_path / "ts"), state, gen) == 2
    for _ in range(2):
        batcher.next_batch()
    for _ in range(2):
        state.step_fn(state, batcher.next_batch()[1], gen)
    got = _snapshot(state, gen)
    for k, v in want[0].items():
        assert torch.equal(got[0][k], v), k
    assert len(got[1]) == len(want[1])
    for (s1, m1, v1), (s2, m2, v2) in zip(got[1], want[1]):
        assert s1 == s2 and torch.equal(m1, m2) and torch.equal(v1, v2)
    assert got[2:5] == want[2:5]
    assert torch.equal(got[5], want[5])


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(JaxModel(JaxConfig(**TINY)), jax.random.PRNGKey(0))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v)})
    return out


def test_jax_written_pt_loads_into_port(tmp_path, jax_params):
    path = str(tmp_path / "jax.pt")
    jcli._save_torch(jax_params, path, 7)
    model = build_model(GoatConfig(**TINY), "cpu", seed=5)
    missing, extra = ck.load_reference(model, path)
    assert missing == [] and extra == []
    want = ck.params_from_flax(jax_params)
    sd = model.state_dict()
    assert set(want) == set(sd)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def test_port_written_pt_loads_into_jax(tmp_path, jax_params):
    model = build_model(GoatConfig(**TINY), "cpu", seed=5)
    model.load_state_dict(ck.params_from_flax(jax_params))
    path = str(tmp_path / "port.pt")
    ck.save_reference_checkpoint(model, path, 3)
    blob = torch.load(path, weights_only=False)
    assert blob["vln_bert"]["epoch"] == 3
    back = _flat(torch_to_flax(jax_load_reference(path))["params"])
    want = _flat(jax_params["params"])
    assert set(back) == set(want)
    for k, v in want.items():
        assert np.array_equal(back[k], v), k
    # and back into the port: the same tensors
    fresh = build_model(GoatConfig(**TINY), "cpu", seed=6)
    assert ck.load_reference(fresh, path) == ([], [])
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.mark.parametrize("causal,fixture", [
    (True, "ref_ckpt_keys_causal.txt"),
    (False, "ref_ckpt_keys_plain.txt"),
])
def test_reference_key_audit(causal, fixture):
    ref = _fixture(fixture)
    with torch.device("meta"):
        model = GoatModel(GoatConfig.for_dataset(
            "r2r", **(CAUSAL if causal else {})))
    written = ck.reference_state_dict(model)
    for key, v in written.items():
        k = ck.strip_prefixes(key)
        assert k in ref and tuple(v.shape) == ref[k], key
    loaded = {"vln_bert." + k: torch.empty(shape, device="meta")
              for k, shape in ref.items()}
    _, missing, extra = ck.merge_loaded(model.state_dict(), loaded)
    assert missing == []
    exp = [s.replace("/", ".") for s in expected_unused(causal=causal)]
    assert all(any(s in k for s in exp) for k in extra), extra
    dropped = {k for k in ref if ck.strip_prefixes(k) is None}
    assert len(extra) + len(dropped) + len(written) == len(ref)
