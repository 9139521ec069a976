"""One pretraining batch as a pure function of (seed, split, task, step),
and its copy to the device (frozen from the port's `pretrain/cli.py`
`make_batch_np` and `batch_to_device`)."""
from __future__ import annotations

import zlib

import numpy as np
import torch


def make_batch_np(builder, pool_items, B: int, seed: int,
                  split: str, task: str, step: int):
    rng = np.random.default_rng(
        (seed, zlib.crc32(split.encode()), zlib.crc32(task.encode()), step))
    chunk = [pool_items[i] for i in rng.integers(0, len(pool_items), B)]
    return builder.build_batch(chunk, task, rng=rng)


def batch_to_device(batch, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
