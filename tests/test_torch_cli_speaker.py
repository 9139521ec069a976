"""The port's fine-tune CLI in the speaker's modes, on the CPU at the CLI
tests' widths (test_torch_cli.py `tiny`; the speaker at the navigator's
vocabulary and image features, its own widths):

- `--mode speaker --synthetic` for a few iterations: the BLEU-4 / SPICE
  gate logged, `speaker_best` written (the port's parameter file);
- `--use_transpeaker --speaker_ckpt_file <that speaker_best>` with `--aug
  synthetic` for 2 iterations (the fused DAgger step, both halves
  re-captioned in one pass), and with the same speaker as a reference
  Transpeaker .pt; a .pt that leaves a parameter uncovered is refused.
"""
import json
import os

import numpy as np
import pytest
import torch

from vln_goat_tpu_torch import cli
from vln_goat_tpu_torch.speaker.speaker import Speaker
from vln_goat_tpu_torch.train import checkpoint as ck
from test_torch_cli import COMMON, tiny
from test_torch_gate_witness import one_thread  # noqa: F401


def _losses(out):
    return [json.loads(line)["train/loss"]
            for line in open(os.path.join(out, "metrics.jsonl"))
            if "train/loss" in line]


def test_speaker_then_backtranslation(tmp_path, monkeypatch):
    tiny(monkeypatch)
    out = str(tmp_path / "spk")
    sp = cli.main(["--mode", "speaker", "--synthetic", "--output_dir", out,
                   "--speaker_iters", "3", "--log_every", "10",
                   "--speaker_lr", "1e-3"] + COMMON)
    assert isinstance(sp, Speaker) and sp.cfg.vocab_size == 64
    log = open(os.path.join(out, "speaker.log")).read().splitlines()
    assert len(log) == 3 and all("bleu4" in x and "spice" in x for x in log)
    best = os.path.join(out, "speaker_best")
    saved = ck.load_params(best)
    assert set(saved) == set(sp.model.state_dict())

    recaptioned = []
    orig = cli.recaption

    def spy(rt, speaker, items, seed):
        new, noise = orig(rt, speaker, items, seed)
        recaptioned.append((len(items), new, noise))
        return new, noise

    monkeypatch.setattr(cli, "recaption", spy)
    common = [a for a in COMMON if a != "imitation"]
    common[common.index("--train_alg") + 1:
           common.index("--train_alg") + 1] = ["dagger_fused"]
    run = str(tmp_path / "bt")
    cli.main(["--mode", "train", "--synthetic", "--output_dir", run,
              "--iters", "2", "--log_every", "2", "--aug", "synthetic",
              "--use_transpeaker", "--speaker_ckpt_file", best,
              "--remat", "none"] + common)
    assert np.isfinite(_losses(run)).all()
    # one aug update of the group, both fused halves in one speaker pass
    assert len(recaptioned) == 1
    n, items, noise = recaptioned[0]
    assert n == 4 and len(items) == 4
    assert all(it["instr_encoding"][0] == sp.cfg.bos_id for it in items)
    assert noise.shape == (16,) and set(noise.unique().tolist()) <= \
        {0.0, float(np.float32(1) / np.float32(0.6))}

    # the same speaker as a reference Transpeaker .pt
    pt = str(tmp_path / "transpeaker.pt")
    ck.save_reference_speaker(sp.model, pt)
    run2 = str(tmp_path / "bt_pt")
    cli.main(["--mode", "train", "--synthetic", "--output_dir", run2,
              "--iters", "2", "--log_every", "2", "--aug", "synthetic",
              "--use_transpeaker", "--speaker_ckpt_file", pt,
              "--remat", "none"] + common)
    assert _losses(run2) == _losses(run)
    blob = torch.load(pt, weights_only=False)
    blob["transpeaker"]["state_dict"].pop("projection.weight")
    torch.save(blob, pt)
    with pytest.raises(ValueError, match="uncovered"):
        cli.main(["--mode", "train", "--synthetic", "--output_dir", run2,
                  "--iters", "2", "--log_every", "2", "--aug", "synthetic",
                  "--use_transpeaker", "--speaker_ckpt_file", pt] + common)


def test_aug_batch_keeps_each_half_gt_path(tmp_path, monkeypatch):
    # fused halves drawn from two length buckets: each half's gt paths stay
    # whole (both built at the widest cap), whichever bucket came last
    tiny(monkeypatch)
    args = cli.parse_args(["--mode", "train", "--synthetic", "--output_dir",
                           str(tmp_path), "--bucket_caps", "4,8",
                           "--aug", "synthetic"] + COMMON
                          + ["--max_action_len", "10"])
    rt = cli.build_runtime(args)
    batcher = rt["batchers"]["aug"]

    def draw(pred):
        for _ in range(100):
            got = batcher.next_minibatch()
            if pred(max(len(it["path"]) for it in got)):
                return got
        raise AssertionError("no such minibatch")

    # the long half first, then a short one: the last draw sets the
    # batcher's own cap to the short bucket's
    items = draw(lambda n: n > 4) + draw(lambda n: n <= 4)
    batch = cli.aug_batch(rt, batcher, None, items, 0, fused=True)
    assert batch["gt_len"].tolist() == [len(it["path"]) for it in items]
    assert "feat_noise" not in batch
