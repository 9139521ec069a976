"""The data-parallel group and the batch split of the port (counterpart of
vln_goat_tpu/parallel/mesh.py).

The JAX package runs a 1-D ('dp',) mesh over its devices: batches sharded
on the leading axis, parameters replicated, and XLA derives the gradient
all-reduce from the sharding.  The port's counterpart of a device is a
process of a torch.distributed group (`parallel.distributed`): `Mesh` is
that 1-D ('dp',) group, this process's rank in it, its size and the
device the rank runs on.  `shard_batch` gives the rank its rows of the
global batch by the JAX rule, `replicate_tree` copies rank 0's model to
every rank, and the train steps average the gradients over the group
after the backward (`distributed.all_reduce_grads`).

The reference's only live distribution strategy is single-node DDP over
NCCL; GOAT (~160M parameters at hidden 768) is far below the size where
tensor or pipeline sharding pays, so data parallelism is the strategy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..device import resolve
from . import distributed as pdist


@dataclass(frozen=True)
class Mesh:
    """A 1-D ('dp',) data-parallel group: this process's `rank` among
    `size` processes, running on `device`."""

    rank: int
    size: int
    device: torch.device


def make_mesh(device="cuda") -> Mesh:
    """The data-parallel group of this process (one process without a
    process group), on `device` (the card unless told otherwise)."""
    return Mesh(pdist.process_index(), pdist.process_count(),
                resolve(device))


# leaves every rank holds whole whatever their leading size: the shared
# back-translation noise [Df] (one vector for the whole batch)
REPLICATED = ("feat_noise",)
# the leaf whose leading size is the batch's: an episode batch's, a
# pretraining batch's
BATCH_KEYS = ("scan_idx", "txt_ids")


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """The rank's contiguous rows (tensors or numpy arrays) of every leaf
    whose leading size is the batch's B (`scan_idx`'s, as at the JAX
    package's mesh.py:42-44, or a pretraining batch's `txt_ids`'), B /
    size of them; every other leaf (a bank of its own size) and
    `feat_noise` whole.  Sharding is layout
    only in JAX, here it is the rank's share of the work: each loss of the
    port is written so that the mean over ranks of the shares is the
    global batch's.  A mesh of one (or None) gives the batch back as it
    is.  Raises when B does not divide by the group's size."""
    if mesh is None or mesh.size <= 1:
        return batch
    key = next((k for k in BATCH_KEYS if k in batch), None)
    if key is None:
        raise ValueError("shard_batch: no scan_idx or txt_ids leaf to take "
                         "the batch size from")
    B = int(batch[key].shape[0])
    if B % mesh.size:
        raise ValueError(f"batch of {B} does not divide over {mesh.size} "
                         "processes")
    per = B // mesh.size
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per

    def put(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == B:
            return x[lo:hi]
        return x

    return {k: v if k in REPLICATED else put(v) for k, v in batch.items()}


@torch.no_grad()
def replicate_tree(module: torch.nn.Module) -> torch.nn.Module:
    """`module`'s parameters and buffers as rank 0 holds them, on every
    rank (broadcast in place); the module itself."""
    if pdist.active():
        for t in list(module.parameters()) + list(module.buffers()):
            pdist.broadcast_tensor(t.data, src=0)
    return module
