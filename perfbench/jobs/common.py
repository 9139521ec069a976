"""What the jobs share: the device's description, the clock around a
window, snapshots and the context the per-layer readers get."""
from __future__ import annotations

import gc
import os
import resource
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .. import roofline


def resolve(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def full_precision(tf32: bool = False) -> None:
    """float32 products in float32 on the card, or with `tf32` in TF32
    (the control's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def launches(attention) -> Dict[str, int]:
    """The port's K1, K2 (a) and K2 (b) launch counters."""
    return dict(fwd=attention.fused_qkv_mha.launches,
                attn=attention.attention_backward.launches,
                proj=attention.projection_backward.launches)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def device_info(dev: torch.device, peak: int) -> dict:
    if dev.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                    count=1, memory_peak_bytes=peak)
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=peak)


def free() -> None:
    """Collects the cycles a train state holds and returns the cached
    blocks to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def cpu_copy(ts) -> List[torch.Tensor]:
    return [t.detach().to("cpu", copy=True) for t in ts]


def find_first_moment(opt_state) -> Optional[list]:
    """The `mu` list of an optimizer chain's state (the pretrain
    optimizer's nested lists and dicts)."""
    if isinstance(opt_state, dict):
        if "mu" in opt_state:
            return opt_state["mu"]
        opt_state = list(opt_state.values())
    if isinstance(opt_state, (list, tuple)):
        for s in opt_state:
            mu = find_first_moment(s)
            if mu is not None:
                return mu
    return None


@dataclass
class Window:
    """The measured window: updates, examples, host seconds, each
    update's wait for its batch, and whatever the job records per
    update."""

    seconds: float = 0.0
    updates: int = 0
    examples: int = 0
    failed: int = 0
    feed_s: List[float] = field(default_factory=list)
    per_update: List[dict] = field(default_factory=list)


class Clock:
    """Host clock of a window that starts after a synchronise and runs
    whole updates until `seconds` have passed, ending on a synchronise;
    `host()` describes what the host did meanwhile."""

    def __init__(self, dev: torch.device, seconds: float):
        self.dev, self.limit = dev, seconds
        sync(dev)
        self.usage0, self.load0 = resource.getrusage(resource.RUSAGE_SELF), \
            os.getloadavg()
        self.t0 = time.perf_counter()

    def done(self) -> bool:
        return time.perf_counter() - self.t0 >= self.limit

    def stop(self) -> float:
        sync(self.dev)
        self.seconds = time.perf_counter() - self.t0
        self.usage1 = resource.getrusage(resource.RUSAGE_SELF)
        return self.seconds

    def host(self) -> str:
        """The process's CPU seconds and context switches over the window,
        the host's load average at its ends, its cores and PyTorch's
        threads: what a run that is uniformly slow had against it."""
        a, b = self.usage0, self.usage1
        return (f"host: process CPU {b.ru_utime - a.ru_utime:.2f} s user + "
                f"{b.ru_stime - a.ru_stime:.2f} s system in "
                f"{self.seconds:.2f} s; involuntary switches "
                f"{b.ru_nivcsw - a.ru_nivcsw}, voluntary "
                f"{b.ru_nvcsw - a.ru_nvcsw}; load average "
                f"{self.load0[0]:.2f} -> {os.getloadavg()[0]:.2f}; cores "
                f"{len(os.sched_getaffinity(0))}, torch threads "
                f"{torch.get_num_threads()}")


@dataclass
class Context:
    """What a per-layer reader finds: the job, the untraced window, the
    traced stretch of the device alone (`trace.Trace`), its updates and
    their launches, the least time of those launches, the stretch traced
    with the host's operator calls and its updates, and the model FLOPs of
    the window."""

    job: str
    window: Window
    trace: object = None
    traced_updates: int = 0
    host_trace: object = None
    host_traced_updates: int = 0
    launches: Dict[str, int] = field(default_factory=dict)
    expected_launches: int = -1
    least_s: Optional[float] = None
    window_flops: Optional[float] = None
    peak_flop_per_s: float = roofline.PEAK_F32_WORK_FLOP_PER_S



def outcome(cell: dict, ok: bool, nums: Dict[str, float], win: Window,
            peak: int, dev: torch.device, ctx: Context,
            end_to_end: Dict[str, float]) -> dict:
    """A job's result: the checks against the cell's limits, the device,
    the end-to-end numbers, the readers' context and, where the run
    traced, the device's busy and window seconds and the breakdown."""
    limits = cell["workload"]["limits"]
    out = dict(ok=ok, attempted=win.updates, failed=win.failed,
               device=device_info(dev, peak), ctx=ctx,
               end_to_end=end_to_end,
               checks=[(k, float(nums.get(k, float("inf"))), float(lim))
                       for k, lim in limits.items()])
    if ctx.trace is not None:
        from ..trace import breakdown
        out["device"].update(busy_s=ctx.trace.busy_s,
                             window_s=ctx.trace.window_s)
        out["breakdown"] = breakdown(ctx.trace, ctx.host_trace)
    return out
