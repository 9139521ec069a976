"""The port's fine-tune CLI over two processes on the CPU (`--num_processes
2 --device cpu --synthetic`, gloo), each rank a spawned process running
`cli.main` at the CLI tests' widths (test_torch_cli.py `tiny`), each
rank's `--output_dir` its own:

- 2 train iterations at batch 4 (2 rows a rank), validation after each,
  then `--mode valid --submit` from rank 0's `ckpt_latest`: rank 0 writes
  the checkpoints, the train state, the logs, the metrics and the
  submissions, rank 1 no file at all;
- the submitted predictions, gathered over the ranks' shards of each
  validation split, equal a one-process `valid --submit` of the same
  checkpoint as sets;
- a batch of 3 does not divide over 2 processes: the JAX CLI's message is
  printed and every rank trains on the whole batch;
- the pretraining CLI (`vln_goat_tpu_torch.pretrain.cli`, MLM / SAP / CFP
  at test_torch_pretrain_cli.py's tiny widths, every dropout 0, batch 6,
  3 rows a rank): rank 0 alone writes, and its logged train losses and
  validation scores equal a one-process run's within 1e-5 relative."""
import json
import os

import numpy as np
import pytest

from vln_goat_tpu_torch import cli
from vln_goat_tpu_torch.pretrain import cli as pretrain_cli
import torch_dist_rig as R
from test_torch_cli import COMMON, tiny
from test_torch_gate_witness import one_thread  # noqa: F401
from torch_pretrain_rig import TINY

SPLITS = ("val_train_seen", "val_seen", "val_unseen")


def _argv(batch_size):
    common = list(COMMON)
    common[common.index("--batch_size") + 1] = str(batch_size)
    return common


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    train = str(root / "train_{rank}")
    valid = str(root / "valid_{rank}")
    odd = str(root / "odd_{rank}")
    ckpt = os.path.join(str(root / "train_0"), "ckpt_latest")
    model_json = root / "tiny.json"
    model_json.write_text(json.dumps(dict(TINY,
                                          max_position_embeddings=128)))
    pretrain = ["--synthetic", "--device", "cpu", "--model_config",
                str(model_json), "--tasks", "mlm", "sap", "cfp",
                "--train_batch_size", "6", "--max_txt_len", "32",
                "--max_steps_traj", "6", "--max_gmap", "32",
                "--num_train_steps", "4", "--valid_steps", "2",
                "--log_steps", "1", "--learning_rate", "1e-4",
                "--warmup_steps", "0"]
    plan = [
        ("cli", ["--mode", "train", "--synthetic", "--output_dir", train,
                 "--iters", "2", "--log_every", "1"] + _argv(4),
         R.free_port()),
        ("cli", ["--mode", "valid", "--synthetic", "--output_dir", valid,
                 "--submit", "--resume_file", ckpt] + _argv(4),
         R.free_port()),
        ("cli", ["--mode", "train", "--synthetic", "--output_dir", odd,
                 "--iters", "1", "--log_every", "1"] + _argv(3),
         R.free_port()),
        ("pretrain", pretrain + ["--output_dir",
                                 str(root / "pretrain_{rank}")],
         R.free_port()),
    ]
    outs = R.run_ranks(R.cli_runs, 2, plan, group=False)
    pretrain_cli.main(pretrain + ["--output_dir", str(root / "pretrain")])
    return dict(root=root, outs=outs, ckpt=ckpt)


def test_only_rank_0_writes(runs):
    root = runs["root"]
    for run in ("train", "valid", "odd", "pretrain"):
        assert R.listing(str(root / f"{run}_1")) == [], run
    files = R.listing(str(root / "train_0"))
    for name in ("args.json", "train.log", "metrics.jsonl",
                 "ckpt_latest/params.pt", "ckpt_best_val_unseen/params.pt"):
        assert name in files or any(f.startswith(name.split("/")[0] + "/")
                                    for f in files), name
    assert any(f.startswith("train_state_latest/") for f in files)
    lines = [json.loads(x) for x in
             open(str(root / "train_0" / "metrics.jsonl"))]
    assert [d["step"] for d in lines if "train/loss" in d] == [1, 2]
    assert {f"submit_{s}.json" for s in SPLITS} <= \
        set(R.listing(str(root / "valid_0")))


def test_submissions_equal_one_process(runs, tmp_path, monkeypatch):
    tiny(monkeypatch)
    out = str(tmp_path / "one")
    cli.main(["--mode", "valid", "--synthetic", "--output_dir", out,
              "--submit", "--resume_file", runs["ckpt"]] + _argv(4))
    for split in SPLITS:
        def preds(d):
            with open(os.path.join(d, f"submit_{split}.json")) as f:
                return {json.dumps(p, sort_keys=True) for p in json.load(f)}

        two = preds(str(runs["root"] / "valid_0"))
        assert len(two) == 16, split          # both shards of 8, gathered
        assert two == preds(out), split


def test_indivisible_batch_message(runs):
    for rank_out in runs["outs"]:
        assert "[train] 2 devices but batch_size 3 not divisible" \
            in rank_out[2]
        assert "not divisible" not in rank_out[0]
    assert "iter 1: loss" in runs["outs"][0][2]


def test_pretrain_cli_matches_one_process(runs):
    root = runs["root"]
    files = R.listing(str(root / "pretrain_0"))
    assert "pretrain.log" in files and "args.json" in files
    assert any(f.startswith("ckpt_latest/") for f in files)

    def rows(d):
        return [json.loads(x) for x in open(os.path.join(d,
                                                         "metrics.jsonl"))]

    two, one = rows(str(root / "pretrain_0")), rows(str(root / "pretrain"))
    assert [r["step"] for r in two] == [r["step"] for r in one]
    assert any(k.startswith("val_unseen/") for r in two for k in r)
    for a, b in zip(two, one):
        assert set(a) == set(b)
        for k, v in b.items():
            np.testing.assert_allclose(a[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
