"""One small update of each job of the port, for the tracer's tests on
the CPU (test_torch_trace.py) and on the card (test_torch_trace_cuda.py);
imports nothing of JAX.

- fine-tuning: the DAgger update of `entry.build_train_flagship(tiny=True)`
  at batch 4;
- pretraining: the pretrain CLI's `--synthetic` world and model
  (`pretrain.cli.build`) at the test widths, batch 4, one batch per task
  made as the CLI's feed makes it (`make_batch_np`, `batch_to_device`).
"""
import json

import torch

from vln_goat_tpu_torch import entry
from vln_goat_tpu_torch.config import PretrainConfig
from vln_goat_tpu_torch.pretrain import cli as pcli
from vln_goat_tpu_torch.pretrain.train import (PretrainState,
                                               make_pretrain_optimizer,
                                               make_pretrain_steps)

TASKS = ("mlm", "sap", "cfp")
TINY = dict(num_l_layers=1, num_x_layers=1, num_pano_layers=1,
            hidden_size=32, num_attention_heads=2, intermediate_size=64,
            vocab_size=64, max_position_embeddings=128, image_feat_size=16)


def finetune(device, seed: int = 0):
    """(state, batch, generator) of one tiny DAgger update."""
    state, batcher = entry.build_train_flagship(device, tiny=True,
                                                batch_size=4)
    _, batch = batcher.next_batch()
    return state, batch, torch.Generator(device=device).manual_seed(seed)


def pretrain_args(tmp_path, device, *extra):
    """The pretrain CLI's arguments at the test widths."""
    model_json = tmp_path / "tiny.json"
    model_json.write_text(json.dumps(TINY))
    return pcli.parse_args(
        ["--synthetic", "--model_config", str(model_json), "--tasks",
         *TASKS, "--train_batch_size", "4", "--max_txt_len", "32",
         "--max_steps_traj", "6", "--max_gmap", "32", "--device", device,
         "--warmup_steps", "0", *extra])


def pretrain(tmp_path, device):
    """(state, steps {task: step}, batches {task: batch on the device},
    the CLI's runtime)."""
    args = pretrain_args(tmp_path, device)
    rt = pcli.build(args)
    model = rt["model"]
    pcfg = PretrainConfig(
        tasks=TASKS, mix_ratio=(1, 1, 1), train_batch_size=4,
        learning_rate=1e-4, num_train_steps=100, warmup_steps=0)
    state = PretrainState(model, make_pretrain_optimizer(pcfg, model))
    steps = make_pretrain_steps(model, TASKS)
    batches = {t: pcli.batch_to_device(pcli.make_batch_np(
        rt["builder"], rt["items"]["train"], 4, 0, "train", t, i),
        rt["device"]) for i, t in enumerate(TASKS)}
    return state, steps, batches, rt
