"""Multi-process runtime of the port over torch.distributed (counterpart of
vln_goat_tpu/parallel/distributed.py).

Reference: map_nav_src/utils/distributed.py, an NCCL process group,
pickled-object all_gather, reduce_dict, merge_dist_results, and
rank-sharded validation (main_nav.py:132 + env.py:126-134).

- `init_distributed`: a process group over a tcp:// rendezvous at the
  coordinator's address, nccl when the run's device is CUDA and gloo on the
  CPU (or the backend asked for), with a finite timeout so that a lost peer
  raises instead of hanging;
- `all_gather_objects` / `merge_dist_results`: the validation predictions
  of every rank (torch.distributed.all_gather_object);
- `all_reduce_grads`, `all_reduce_sum`, `reduce_metrics`: what XLA gives
  the JAX package from the batch sharding.  Each rank's loss is its share
  of the global batch's (see parallel/mesh.py), so the mean over ranks of
  its gradients is the global loss's gradient, and the mean of its metrics
  the global metric.

Without a process group every one of these is the identity and runs no
collective; a group of one process runs them, and they change nothing.
"""
from __future__ import annotations

import datetime
import zlib
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from ..device import resolve

DEFAULT_TIMEOUT_S = 600.0


def active() -> bool:
    """True when this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     timeout_s: Optional[float] = None,
                     always: bool = False) -> bool:
    """Joins the process group of `num_processes` processes as rank
    `process_id`, rendezvous at tcp://`coordinator_address` (host:port);
    False, and no group, for one process or fewer unless `always` (a
    group of one, whose collectives run).  backend: nccl where `device` is
    a CUDA device (made the current one first), gloo on the CPU; gloo
    also takes CUDA tensors, through the host.  A collective waits at most
    `timeout_s` (DEFAULT_TIMEOUT_S unless given) for the other ranks.
    Raises before any rendezvous when `device` names a card and none is
    present."""
    n = 1 if num_processes is None else int(num_processes)
    if n <= 1 and not always:
        return False
    dev = resolve(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=max(n, 1), rank=int(process_id or 0),
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S
                                   if timeout_s is None else timeout_s))
    return True


def rank_device(device="cuda", process_id: int = 0) -> str:
    """The device of process `process_id`: `device` itself, but for a CUDA
    device without an index, the card `process_id` modulo the cards
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and \
            torch.cuda.is_available():
        return f"cuda:{process_id % torch.cuda.device_count()}"
    return str(dev)


def shutdown() -> None:
    """Leaves the process group, if any."""
    if active():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def process_index() -> int:
    return dist.get_rank() if active() else 0


def rank_seed(seed: int, rank: Optional[int] = None) -> int:
    """The seed of rank `rank`'s draws in a run seeded `seed`: `seed` on
    rank 0, a hash of (seed, rank) on the others."""
    rank = process_index() if rank is None else rank
    if rank == 0:
        return seed
    return zlib.crc32(f"{seed}:{rank}".encode()) & 0x7FFFFFFF


def collective_device() -> torch.device:
    """Where a small collective's tensor lives: the current card under
    nccl, the host under gloo."""
    if active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_data_for_process(data: List, t_split: Optional[int] = None,
                           n_splits: Optional[int] = None) -> List:
    """Rank-sharded validation data (sel_data_idxs slicing,
    r2r/env.py:126-134): contiguous equal slices, the remainder to the
    last rank."""
    t = process_index() if t_split is None else t_split
    n = process_count() if n_splits is None else n_splits
    if n <= 1:
        return data
    per = len(data) // n
    start = per * t
    end = None if t == n - 1 else start + per
    return data[start:end]


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable `obj`, in rank order."""
    if not active():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def merge_dist_results(results: List[List]) -> List:
    """Flatten per-process prediction lists (utils/distributed.py:160)."""
    out = []
    for r in results:
        out.extend(r)
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over every rank, in place (a count, or a metric's
    numerator or denominator); `t` itself without a group."""
    if active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Replaces the gradient of every parameter in `params` by its mean
    over the ranks: one flattened bucket per (dtype, device), one
    all-reduce each, a missing gradient taken as zero on every rank (so
    every parameter leaves with a gradient, a view into its bucket).  The
    ranks must pass the same parameters in the same order."""
    if not active():
        return
    world = dist.get_world_size()
    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for p in params:
        buckets.setdefault((p.dtype, p.device), []).append(p)
    for ps in buckets.values():
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in ps])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        if world > 1:
            flat.div_(world)
        off = 0
        for p in ps:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p)
            off += n


def reduce_metrics(metrics: Dict[str, torch.Tensor],
                   sums: Iterable[str] = (),
                   maxes: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """The metrics of one step over every rank: the keys in `sums` summed
    (counts), those in `maxes` their largest value, every other the mean
    over ranks, which is the weighted mean when every rank holds as many
    rows (`mesh.shard_batch`'s even split, or the whole batch on every
    rank).  One all-reduce for the sums and means, in float64, and one for
    the maxima; each value comes back in its dtype."""
    if not active() or not metrics:
        return metrics
    world = dist.get_world_size()
    sums, maxes = set(sums), set(maxes)
    keys = list(metrics)
    metrics = {k: torch.as_tensor(v) for k, v in metrics.items()}
    dev = collective_device()
    out = dict(metrics)
    for group, op in (([k for k in keys if k not in maxes],
                       dist.ReduceOp.SUM),
                      ([k for k in keys if k in maxes], dist.ReduceOp.MAX)):
        if not group:
            continue
        vals = torch.stack([metrics[k].detach().to(dev, torch.float64)
                            .reshape(()) for k in group])
        dist.all_reduce(vals, op=op)
        for i, k in enumerate(group):
            v = vals[i]
            if op == dist.ReduceOp.SUM and k not in sums and world > 1:
                v = v / world
            out[k] = v.to(metrics[k].device, metrics[k].dtype)
    return out


def broadcast_tensor(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """`t` as rank `src` holds it, in place on every rank."""
    if active():
        dist.broadcast(t, src=src)
    return t


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank `src`'s picklable `obj` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


class _GatherRows(torch.autograd.Function):
    """[B, ...] on each rank -> [world x B, ...], rank r's rows at r x B,
    by one all-reduce of a zero-filled buffer (so it runs on nccl and on
    gloo, CUDA tensors included).  Backward: the sum over ranks of the
    gathered gradient, rank r's rows."""

    @staticmethod
    def forward(ctx, x):
        world, rank = dist.get_world_size(), dist.get_rank()
        B = x.shape[0]
        buf = x.new_zeros((world * B,) + tuple(x.shape[1:]))
        buf[rank * B:(rank + 1) * B] = x
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        ctx.rows = (rank * B, (rank + 1) * B)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        lo, hi = ctx.rows
        return g[lo:hi]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `x` (equal counts), rank-major, differentiable:
    the gradient reaching a rank's rows is the sum of every rank's
    gradient of them (torch.distributed.nn.functional.all_gather's rule).
    `x` itself without a group."""
    if not active():
        return x
    return _GatherRows.apply(x)
