"""A traced stretch of updates under `torch.profiler` and what the
per-layer metrics read from it.

`device_work` is frozen from `chip_smoke.py` (:2699): the device's
kernels, copies and sets, without the host ranges the profiler mirrors
onto the device timeline.  The profiler may lose device events (ROADMAP
F7); the harness prints the trace's K1 count beside the port's own launch
counter so that a loss shows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

# library GEMMs by name: cuBLAS's SIMT and tensor-core kernels and the
# CUTLASS kernels it runs (the port's own GEMM kernels are K1 / K2's)
_GEMM_KEYS = ("sgemm", "xmma_gemm", "gemmk1", "gemv")


def is_library_gemm(name: str) -> bool:
    n = name.lower()
    if "gemm_jobs_kernel" in n or n.startswith("void gemm_kernel"):
        return False
    return (any(k in n for k in _GEMM_KEYS) or n.startswith("nvjet")
            or ("cutlass" in n and "gemm" in n))


@dataclass
class Trace:
    """What one profiled stretch holds: its length, the merged device-busy
    time, device time and launches by kernel name, the idle gaps labelled
    by what the host ran, and the aten calls."""

    window_s: float = 0.0
    busy_s: float = 0.0
    device_s: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    aten_calls: int = 0

    def time_of(self, pred: Callable[[str], bool]) -> float:
        return sum(v for k, v in self.device_s.items() if pred(k))

    def count_of(self, pred: Callable[[str], bool]) -> int:
        return sum(v for k, v in self.counts.items() if pred(k))


def device_work(events):
    cuda = torch.autograd.DeviceType.CUDA
    host = {e.name() for e in events if e.device_type() != cuda}
    return [(e.name(), e.start_ns(), e.end_ns()) for e in events
            if e.device_type() == cuda and e.name() not in host]


def _label(cpu, t_ns: int) -> str:
    """The benchmark's own span and the innermost aten call the host was
    in at `t_ns`: "span/op", "span" or "host"."""
    span, op, op_len = None, None, None
    for name, s, e in cpu:
        if s > t_ns:
            break
        if e < t_ns:
            continue
        if name.startswith("perfbench."):
            span = name[len("perfbench."):]
        elif name.startswith("aten::") and (op_len is None or e - s < op_len):
            op, op_len = name, e - s
    parts = [p for p in (span, op) if p]
    return "/".join(parts) if parts else "host"


def profile(fn: Callable[[], None], host: bool = True,
            n_gaps: int = 10) -> Trace:
    """Runs fn() under torch.profiler and reads the trace: the device's
    activity alone, or with `host` the host's operator calls too (which
    slow the host down, so a stretch without them gives the device's
    busy share)."""
    from torch.profiler import ProfilerActivity, profile as _profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with _profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    tr = Trace()
    if not events:
        return tr
    cuda = torch.autograd.DeviceType.CUDA
    cpu = sorted(((e.name(), e.start_ns(), e.end_ns()) for e in events
                  if e.device_type() != cuda), key=lambda x: x[1])
    tr.aten_calls = sum(1 for n, _, _ in cpu if n.startswith("aten::"))
    lo = min(e.start_ns() for e in events)
    hi = max(e.end_ns() for e in events)
    tr.window_s = (hi - lo) / 1e9
    spans = []
    for name, s, e in device_work(events):
        spans.append((s, e))
        tr.device_s[name] = tr.device_s.get(name, 0.0) + (e - s) / 1e9
        tr.counts[name] = tr.counts.get(name, 0) + 1
    if not spans:
        return tr
    spans.sort()
    merged = [list(spans[0])]
    for s, e in spans[1:]:
        if s > merged[-1][1]:
            merged.append([s, e])
        else:
            merged[-1][1] = max(merged[-1][1], e)
    tr.busy_s = sum(e - s for s, e in merged) / 1e9
    gaps = [(merged[0][0] - lo, lo)] + [
        (b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])] + [
        (hi - merged[-1][1], merged[-1][1])]
    gaps.sort(key=lambda g: -g[0])
    tr.gaps = [(_label(cpu, start + length // 2), length / 1e9)
               for length, start in gaps[:n_gaps] if length > 0]
    return tr


def stretches(run_one: Callable[[], object], n: int):
    """Two traced stretches of n updates each (`run_one` runs one and
    returns its record): the first with the device's activity alone, the
    second with the host's operator calls.  -> (device trace, its
    records, host trace, its records); on a machine without a card the
    updates run untraced and the traces are None."""
    dev_recs: list = []
    host_recs: list = []

    def stretch(recs):
        return lambda: recs.extend(run_one() for _ in range(n))

    if not torch.cuda.is_available():
        stretch(dev_recs)()
        stretch(host_recs)()
        return None, dev_recs, None, host_recs
    dev = profile(stretch(dev_recs), host=False)
    host = profile(stretch(host_recs), host=True)
    return dev, dev_recs, host, host_recs


def breakdown(dev: Trace, host: Trace, n: int = 10) -> dict:
    """The device operations that took most time (device stretch) and the
    longest idle gaps by what the host was doing (host stretch)."""
    return dict(
        device_ops=[[k, v] for k, v in sorted(
            dev.device_s.items(), key=lambda kv: -kv[1])[:n]],
        idle_gaps=[[k, v] for k, v in host.gaps[:n]])
