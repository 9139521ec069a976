"""The port's fine-tune CLI (`python -m vln_goat_tpu_torch.cli`) at the
real command surface, on the CPU (`--device cpu`), at the JAX package's
CLI-test widths (hidden 32, 2 heads, tests/test_cli.py's `_tiny`):

- train on `--synthetic`, then `--mode valid --submit` from its
  `ckpt_latest`: checkpoints, metrics and submissions written, the
  reference .pt of `--save_torch_ckpt` loadable back bit for bit;
- a run stopped after one iteration and resumed from
  `train_state_latest` continues the iteration count and ends on the
  uninterrupted run's parameters (atol 1e-7, as the JAX package's
  test_cli_resume_continues_iteration holds its own);
- the non-synthetic path on reference-format fixture files (connectivity,
  annotations, HDF5 features with EnvEdit features, the candidate cache,
  the z-dict TSVs), train and valid;
- `--device cuda` without a card raises.
The validation against the JAX CLI is test_torch_cli_jax.py; more than
one process is test_torch_dist_cli.py.
"""
import json
import os

import numpy as np
import pytest
import torch

from vln_goat_tpu_torch import cli
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import build_model
from vln_goat_tpu_torch.train import checkpoint as ck
from test_torch_formats import DF, write_fixture
from test_torch_gate_witness import one_thread  # noqa: F401

COMMON = ["--num_l_layers", "1", "--num_pano_layers", "1",
          "--num_x_layers", "1", "--image_feat_size", "16",
          "--num_nodes", "12", "--batch_size", "2",
          "--max_action_len", "3", "--max_instr_len", "16",
          "--train_alg", "imitation", "--lr", "1e-4", "--device", "cpu"]


def tiny(monkeypatch, config=GoatConfig):
    """GoatConfig.for_dataset at the CLI tests' widths (tests/test_cli.py
    `_tiny`)."""
    orig = config.for_dataset.__func__

    def small(cls, dataset, **kw):
        kw.update(hidden_size=32, num_attention_heads=2,
                  intermediate_size=64, vocab_size=64,
                  max_position_embeddings=64)
        return orig(cls, dataset, **kw)

    monkeypatch.setattr(config, "for_dataset", classmethod(small))


def test_train_then_valid_submit(tmp_path, monkeypatch):
    tiny(monkeypatch)
    out = str(tmp_path / "run")
    cli.main(["--mode", "train", "--synthetic", "--output_dir", out,
              "--iters", "2", "--log_every", "1", "--save_torch_ckpt",
              "--remat", "model"] + COMMON)
    for name in ("ckpt_latest", "ckpt_best_val_unseen"):
        assert os.path.exists(os.path.join(out, name, ck.PARAMS_FILE))
    assert ck.is_train_state_dir(os.path.join(out, "train_state_latest"))
    lines = [json.loads(line) for line in
             open(os.path.join(out, "metrics.jsonl"))]
    assert [d["step"] for d in lines if "train/loss" in d] == [1, 2]
    assert all(np.isfinite(d["train/loss"]) for d in lines
               if "train/loss" in d)
    assert os.listdir(os.path.join(out, "tb"))
    params = ck.load_params(os.path.join(out, "ckpt_latest"))
    model = build_model(GoatConfig.for_dataset(
        "r2r", num_l_layers=1, num_pano_layers=1, num_x_layers=1,
        image_feat_size=16), "cpu")
    assert ck.load_reference(model, os.path.join(out, "latest_dict.pt")) \
        == ([], [])
    for k, v in params.items():
        assert torch.equal(model.state_dict()[k], v), k

    cli.main(["--mode", "valid", "--synthetic", "--output_dir", out,
              "--submit", "--resume_file",
              os.path.join(out, "ckpt_latest")] + COMMON)
    for split in ("val_train_seen", "val_seen", "val_unseen"):
        subs = json.load(open(os.path.join(out, f"submit_{split}.json")))
        assert len(subs) == 16 and "trajectory" in subs[0]
    assert "val_unseen" in open(os.path.join(out, "valid.log")).read()


def test_resume_continues_iteration(tmp_path, monkeypatch):
    tiny(monkeypatch)
    common = COMMON + ["--train_alg", "dagger", "--remat", "full"]
    a, b = str(tmp_path / "A"), str(tmp_path / "B")
    cli.main(["--mode", "train", "--synthetic", "--output_dir", a,
              "--iters", "2", "--log_every", "1"] + common)
    cli.main(["--mode", "train", "--synthetic", "--output_dir", b,
              "--iters", "1", "--log_every", "1"] + common)
    cli.main(["--mode", "train", "--synthetic", "--output_dir", b,
              "--iters", "2", "--log_every", "1", "--resume_file",
              os.path.join(b, "train_state_latest")] + common)
    assert "resumed train state" in open(os.path.join(b, "train.log")).read()
    pa = ck.load_train_state_params(os.path.join(a, "train_state_latest"))
    pb = ck.load_train_state_params(os.path.join(b, "train_state_latest"))
    assert pa.keys() == pb.keys()
    for k, v in pa.items():
        np.testing.assert_allclose(pb[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-7, err_msg=k)
    steps = [json.loads(line)["step"] for line in
             open(os.path.join(b, "metrics.jsonl"))]
    assert steps[0] == 1 and steps[-1] == 2


def test_nonsynthetic_train_and_valid(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    from vln_goat_tpu.tools.zdict import save_img_zdict_tsv, \
        save_instr_zdict_tsv

    fx = write_fixture(tmp_path / "fx")
    rng = np.random.default_rng(0)
    instr = str(tmp_path / "instr_z.tsv")
    lm = {f"lm{i}": rng.standard_normal(32).astype(np.float32)
          for i in range(3)}
    dr = {f"dr{i}": rng.standard_normal(32).astype(np.float32)
          for i in range(2)}
    save_instr_zdict_tsv(instr, lm, dr, {k: 1 / 3 for k in lm},
                         {k: 1 / 2 for k in dr})
    img = str(tmp_path / "img_z.tsv")
    save_img_zdict_tsv(img, {f"room{i}": rng.standard_normal(DF).astype(
        np.float32) for i in range(4)}, {f"room{i}": 0.25 for i in range(4)})
    files = ["--anno_dir", fx["anno"], "--connectivity_dir", fx["conn"],
             "--img_ft_file", fx["h5"], "--aug_ft_file", fx["h5"],
             "--scanvp_cands_file", fx["cands"],
             "--hidden_size", "32", "--num_attention_heads", "2",
             "--intermediate_size", "64", "--num_l_layers", "1",
             "--num_pano_layers", "1", "--num_x_layers", "1",
             "--image_feat_size", str(DF), "--batch_size", "4",
             "--num_nodes", "16", "--max_action_len", "6",
             "--max_instr_len", "12", "--dropout", "0", "--device", "cpu"]
    files += ["--instr_zdict_file", instr, "--img_zdict_file", img,
              "--do_back_img", "--do_back_txt"]
    out = str(tmp_path / "out")
    cli.main(["--mode", "train", "--iters", "2", "--log_every", "2",
              "--output_dir", out, "--remat", "none"] + files)
    lines = [json.loads(line) for line in
             open(os.path.join(out, "metrics.jsonl"))]
    assert np.isfinite(lines[0]["train/loss"])
    cli.main(["--mode", "valid", "--submit", "--output_dir", out,
              "--resume_file", os.path.join(out, "train_state_latest")]
             + files)
    subs = json.load(open(os.path.join(out, "submit_test.json")))
    assert len(subs) == 6 and all(s["trajectory"] for s in subs)


def test_aug_interleave_fused(tmp_path, monkeypatch):
    """`--aug synthetic` without a speaker: one train and one aug update
    per group, their gradients accumulated into one step, the fused DAgger
    step drawing two minibatches of each."""
    tiny(monkeypatch)
    out = str(tmp_path / "aug")
    common = [a for a in COMMON if a != "imitation"]
    common[common.index("--train_alg") + 1:
           common.index("--train_alg") + 1] = ["dagger_fused"]
    cli.main(["--mode", "train", "--synthetic", "--output_dir", out,
              "--iters", "2", "--log_every", "2", "--aug", "synthetic",
              "--aug_times", "1", "--accumulate_grad", "--remat", "none"]
             + common)
    lines = [json.loads(line) for line in
             open(os.path.join(out, "metrics.jsonl"))]
    assert lines[0]["step"] == 2 and np.isfinite(lines[0]["train/loss"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_device_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--mode", "valid", "--synthetic", "--output_dir",
                  str(tmp_path)] + COMMON[:-2])
