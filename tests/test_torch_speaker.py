"""The port's speaker (`speaker/`) against the JAX package's, on the CPU,
at the tiny config of tests/test_speaker.py (vocabulary 32, features
16 + 8, hidden 32, word 16, 2 heads of 8, one layer), the JAX weights
carried across by `speaker_params_from_flax`:

- every JAX parameter lands on one port parameter of the same size;
- the deterministic teacher-forced loss within 1e-5 of JAX's, every
  gradient within 1e-4 of its largest magnitude (float32; the sums run in
  another order);
- greedy tokens equal; a sampled decode equal when the port draws the
  Gumbel noise that jax.random.categorical adds under the JAX decode's
  key splits (substituted for its `gumbel_noise`); the shared feature
  noise (`featdropmask`) as JAX's;
- one Adam step (optax.adam's arithmetic): parameters within 1e-5;
- a reference-format Transpeaker .pt (the {"transpeaker": {"state_dict"}}
  wrapper, "module." keys, the sinusoid buffers and a "progress" entry)
  loads into both packages with every parameter covered, and the port's
  own .pt loads into the JAX package;
- `swap_instructions` and `shared_drop_mask` (the keep share within 4
  binomial standard deviations of 1 - rate, the kept scale 1 / (1 -
  rate)).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.rollout.env import make_synthetic_dataset
from vln_goat_tpu.sim.graph_sim import make_synthetic_scan
from vln_goat_tpu.speaker import backtranslate as jbt
from vln_goat_tpu.speaker.model import SpeakerConfig as JaxSpeakerConfig
from vln_goat_tpu.speaker.speaker import Speaker as JaxSpeaker
from vln_goat_tpu.speaker.speaker import build_path_batch as jax_path_batch
from vln_goat_tpu.train.checkpoint import (load_reference_speaker as
                                           jax_load_reference_speaker,
                                           speaker_torch_to_flax)
from vln_goat_tpu_torch.speaker import backtranslate as pbt
from vln_goat_tpu_torch.speaker import speaker as pspeaker
from vln_goat_tpu_torch.speaker.model import SpeakerConfig
from vln_goat_tpu_torch.speaker.speaker import (Speaker, build_path_batch,
                                                speaker_batch, to_device)
from vln_goat_tpu_torch.train import checkpoint as ck
from test_torch_gate_witness import one_thread  # noqa: F401

TINY = dict(vocab_size=32, feature_size=16 + 8, image_feat_size=16,
            hidden_size=32, word_size=16, head_dim=8, num_heads=2,
            num_layers=1, ff_dim=32, dropout=0.0, feat_dropout=0.0,
            max_decode=10)
LOSS_RTOL, GRAD_TOL, STEP_ATOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(scope="module")
def rig():
    scans = [make_synthetic_scan("sp0", num_vps=10, seed=3)]
    graphs = {g.scan_id: g for g in scans}
    feats = np.random.default_rng(0).standard_normal(
        (scans[0].num_vps, 36, 16)).astype(np.float32)
    data = make_synthetic_dataset(graphs, 4, vocab_size=30,
                                  path_len=(3, 4), max_instr_len=16, seed=4)
    items = [{**d, "path_local": [graphs[d["scan"]].index[v]
                                  for v in d["path"]]} for d in data]
    fb = jax_path_batch(graphs, feats, {"sp0": 0}, items, max_steps=4,
                        angle_feat_size=8, image_feat_size=16)
    jcfg = JaxSpeakerConfig(**TINY)
    rng = np.random.default_rng(1)
    toks = np.zeros((len(items), 9), np.int32)
    for i in range(len(items)):
        n = int(rng.integers(3, 6))
        toks[i, 0] = jcfg.bos_id
        toks[i, 1:1 + n] = rng.integers(3, 30, n)
        toks[i, 1 + n] = jcfg.eos_id
    jbatch = {**jax.tree.map(jnp.asarray, fb), "tokens": jnp.asarray(toks)}
    jsp = JaxSpeaker(jcfg, rng=jax.random.PRNGKey(2))
    sp = Speaker(SpeakerConfig(**TINY), "cpu")
    sp.model.load_state_dict(ck.speaker_params_from_flax(
        jax.device_get(jsp.params)), strict=True)
    # the port finds each step's local index from the viewpoint ids
    pb = build_path_batch(graphs, feats, {"sp0": 0}, data, max_steps=4,
                          angle_feat_size=8, image_feat_size=16)
    for k in fb:
        np.testing.assert_array_equal(pb[k], fb[k])
    return dict(jsp=jsp, sp=sp, jbatch=jbatch, graphs=graphs, feats=feats,
                data=data, path_batch=pb,
                batch=to_device({**pb, "tokens": toks}, "cpu"))


def _grad_check(got, ref):
    for k, r in ref.items():
        r = r.numpy()
        scale = max(float(np.abs(r).max()), 1e-12)
        err = float(np.abs(got[k].numpy() - r).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def test_params_covered(rig):
    flat = ck.flatten(jax.device_get(rig["jsp"].params))
    sd = rig["sp"].model.state_dict()
    assert set(ck.speaker_params_from_flax(flat)) == set(sd)
    assert sum(v.size for v in flat.values()) == \
        sum(v.numel() for v in sd.values())


def test_speaker_batch(rig):
    # the CLI's batch: the path features at the speaker's widths, and each
    # instruction as <BOS>, its first max_len - 1 ids, <EOS>, then pad
    sp, data = rig["sp"], rig["data"]
    got = speaker_batch(sp, rig["graphs"], rig["feats"], {"sp0": 0}, data,
                        max_steps=4, max_len=6)
    for k, v in rig["path_batch"].items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    c = sp.cfg
    for row, it in zip(got["tokens"].numpy(), data):
        enc = [c.bos_id] + list(it["instr_encoding"])[:5] + [c.eos_id]
        np.testing.assert_array_equal(row, enc + [c.pad_id] * (7 - len(enc)))
    assert "tokens" not in speaker_batch(sp, rig["graphs"], rig["feats"],
                                         {"sp0": 0}, data, max_steps=4)


def test_loss_and_grads(rig):
    jsp, sp = rig["jsp"], rig["sp"]
    jl, jg = jax.value_and_grad(lambda p: jsp.loss_fn(
        p, rig["jbatch"], None, deterministic=True))(jsp.params)
    params = list(sp.model.parameters())
    loss = sp.loss_fn(rig["batch"])
    grads = torch.autograd.grad(loss, params)
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= LOSS_RTOL * abs(float(jl))
    names = [n for n, _ in sp.model.named_parameters()]
    _grad_check(dict(zip(names, grads)),
                ck.speaker_params_from_flax(jax.device_get(jg)))


def test_greedy_and_sampled_decode(rig, monkeypatch):
    jsp, sp = rig["jsp"], rig["sp"]
    ref = np.asarray(jsp.infer(jsp.params, rig["jbatch"]))
    got = sp.infer(rig["batch"]).numpy()
    np.testing.assert_array_equal(got, ref)
    # the noise jax.random.categorical adds under the decode's key splits
    key = jax.random.PRNGKey(7)
    B, V, L = ref.shape[0], TINY["vocab_size"], TINY["max_decode"]
    noise = []
    for _ in range(L):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(k, (B, V), jnp.float32)))
    ref = np.asarray(jsp.infer(jsp.params, rig["jbatch"],
                               rng=jax.random.PRNGKey(7), sample=True))
    draws = iter(noise)
    monkeypatch.setattr(pspeaker, "gumbel_noise",
                        lambda g, shape, device: torch.from_numpy(
                            next(draws)))
    got = sp.infer(rig["batch"], sample=True).numpy()
    np.testing.assert_array_equal(got, ref)
    # back-translation's shared feature noise on the image columns
    mask = (np.arange(16) % 3 != 0).astype(np.float32) * 1.5
    ref = np.asarray(jsp.infer(jsp.params, rig["jbatch"],
                               featdropmask=jnp.asarray(mask)))
    got = sp.infer(rig["batch"], featdropmask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_adam_step(rig):
    jsp = rig["jsp"]
    step, opt_state = jsp.make_train_step(lr=1e-3)
    jp, _, jl = step(jsp.params, opt_state, rig["jbatch"],
                     jax.random.PRNGKey(0))
    sp = Speaker(SpeakerConfig(**TINY), "cpu")
    sp.model.load_state_dict(rig["sp"].model.state_dict())
    pstep, _ = sp.make_train_step(lr=1e-3)
    loss = pstep(rig["batch"], torch.Generator().manual_seed(0))
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    ref = ck.speaker_params_from_flax(jax.device_get(jp))
    for k, v in sp.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=k)


def test_reference_pt_both_ways(rig, tmp_path):
    jparams = jax.device_get(rig["jsp"].params)
    sd = ck.speaker_params_from_flax(jparams)
    ref_sd = {"module." + k: v for k, v in sd.items()}
    for side, d in (("encoder", 32), ("decoder", 16)):
        ref_sd[f"module.{side}.pos_emb.pe"] = torch.zeros(1, 100, d)
    ref_sd["module.progress"] = torch.zeros(1)
    path = str(tmp_path / "transpeaker.pt")
    torch.save({"transpeaker": {"epoch": 3, "state_dict": ref_sd,
                                "optimizer": {}}}, path)
    got = ck.load_reference_speaker(path)
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    tree, skipped = speaker_torch_to_flax(jax_load_reference_speaker(path))
    assert len(skipped) == 3
    flat = ck.flatten(jparams)
    back = ck.flatten(tree)
    assert set(back) == {k.split("/", 1)[1] for k in flat}
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k.split("/", 1)[1]], v)
    # the port's own .pt into the JAX package, every parameter covered
    ours = str(tmp_path / "ours.pt")
    ck.save_reference_speaker(rig["sp"].model, ours, epoch=1)
    tree, skipped = speaker_torch_to_flax(jax_load_reference_speaker(ours))
    assert skipped == []
    back = ck.flatten(tree)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k.split("/", 1)[1]], v)


def test_swap_instructions_and_drop_mask():
    items = [dict(instr_id=str(i), instr_encoding=[0, 5, 2]) for i in
             range(3)]
    toks = np.array([[7, 8, 2, 9, 0], [4, 4, 4, 4, 4], [2, 0, 0, 0, 0]])
    assert pbt.swap_instructions(items, toks, eos_id=2, bos_id=31) == \
        jbt.swap_instructions(items, toks, eos_id=2, bos_id=31)
    assert pbt.swap_instructions(items, toks, eos_id=2) == \
        jbt.swap_instructions(items, toks, eos_id=2)
    n, rate = 20000, 0.4
    m = pbt.shared_drop_mask(torch.Generator().manual_seed(0), n, rate)
    kept = m[m > 0]
    sd = (n * rate * (1 - rate)) ** 0.5
    assert abs(kept.numel() - n * (1 - rate)) <= 4 * sd
    assert torch.all(kept == np.float32(1.0) / np.float32(1.0 - rate))
    assert set(torch.unique(m).tolist()) == {0.0, float(kept[0])}
