"""Logging / observability.

Reference: map_nav_src/utils/logger.py (write_to_record_file :8) and
pretrain_src/utils/logger.py (RunningMeter EMA :70-95, TB_LOGGER
tensorboardX wrapper :27-65).  tensorboardX isn't in this image;
MetricsLogger writes JSON-lines instead (same scalars, greppable, and
convertible to TB offline).

Spans and reads inside the port (`Tracer`; the module's `span`, `read`,
`records` and `summary` act on the process's tracer, `TRACER`):

- `span(name)` times host code with `time.perf_counter_ns` under its path:
  the names of the spans open on its thread joined by "/", e.g.
  `update/sample/step`.  While a `torch.profiler` records, it also opens
  `torch.profiler.record_function("goat.<name>")`, which puts the span on
  the profiler's clock beside the kernels it launched; otherwise it makes
  no `RecordFunction`.
- `read(tensor)` is the one way the port turns a device tensor into a
  Python bool, int or float inside an update: a span named `read`, so that
  every read is timed and counted where it happens.  Under
  `torch.cuda.set_sync_debug_mode` it lifts the mode around its own copy,
  so that any other synchronisation of an update shows.
- The span `update`, opened with no span open on its thread (the train
  steps open it), collects one record, {path: [host ns, calls]}: every span
  that closes while it is open, on any thread (the pretrain feed's
  prefetch thread, autograd's), and every span that closed since the
  previous record (a CLI's loss fetch).  `records()` is a deque of the
  last `RECORDS` records.  A span's self time is its ns less those of the
  paths one level below it.
"""
from __future__ import annotations

import json
import math
import os
import threading
from collections import deque
from time import perf_counter_ns
from typing import Deque, Dict, Iterable, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


def write_to_record_file(data: str, file_path: Optional[str],
                         verbose: bool = True):
    if verbose:
        print(data, flush=True)
    if file_path:
        with open(file_path, "a") as f:
            f.write(data + "\n")


class RunningMeter:
    """EMA loss meter ignoring NaNs (pretrain_src/utils/logger.py:70-95)."""

    def __init__(self, name: str, val: Optional[float] = None,
                 smooth: float = 0.99):
        self._name = name
        self._sm = smooth
        self._val = val

    def __call__(self, value: float):
        if math.isnan(value):
            return
        self._val = value if self._val is None else (
            value * (1 - self._sm) + self._val * self._sm)

    @property
    def val(self) -> float:
        return self._val if self._val is not None else 0.0

    @property
    def name(self) -> str:
        return self._name


class MetricsLogger:
    """JSON-lines scalar logger (TB_LOGGER equivalent).  When `tb_dir` is
    given, every scalar is mirrored into a real TensorBoard events file
    (utils/tb.py — dependency-free writer), matching the reference's
    SummaryWriter/TensorboardLogger output
    (map_nav_src/r2r/main_nav.py:13, pretrain_src/utils/logger.py:27-65)."""

    def __init__(self, path: Optional[str], tb_dir: Optional[str] = None):
        self.path = path
        self.step = 0
        self.tb = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if tb_dir:
            from .tb import TensorBoardWriter
            self.tb = TensorBoardWriter(tb_dir)

    def set_step(self, step: int):
        self.step = step

    def log_scalar_dict(self, scalars: Dict[str, float], prefix: str = ""):
        if not self.path and not self.tb:
            return
        rec = {"step": self.step}
        for k, v in scalars.items():
            rec[(prefix + "/" + k) if prefix else k] = float(v)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.tb:
            for k, v in rec.items():
                if k != "step":
                    self.tb.add_scalar(k, v, self.step)
            self.tb.flush()


RECORDS = 4096
# spans kept unfolded while no update closes (a decode-only process)
_FOLD_AT = 1 << 16


class _Stack(threading.local):
    def __init__(self):
        self.paths: List[str] = []     # of the spans open on the thread


class _Span:
    __slots__ = ("tracer", "name", "stack", "path", "t0", "rf")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.stack = stack = self.tracer._stack.paths
        self.path = path = \
            f"{stack[-1]}/{self.name}" if stack else self.name
        stack.append(path)
        # whether a torch.profiler records: one attribute read
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(
                "goat." + self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        tracer = self.tracer
        tracer._closed.append((self.path, ns))
        if not self.stack:
            if self.path == "update":
                tracer._records.append(tracer._take())
            elif len(tracer._closed) > _FOLD_AT:
                tracer._fold()
        return False


class Tracer:
    """Spans, reads and the records of updates (the module docstring).

    A closing span appends (path, ns) to one list (an atomic append: any
    thread, no lock); the update that closes next sums what the list holds
    into its record.  A span that another thread closes after that goes
    into the next record."""

    def __init__(self, maxlen: int = RECORDS):
        self._records: Deque[Dict[str, List[int]]] = deque(maxlen=maxlen)
        self._stack = _Stack()
        self._closed: List[tuple] = []
        self._folded: Dict[str, List[int]] = {}
        self._lock = threading.Lock()

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def read(self, t: torch.Tensor):
        """t.item() inside a span `read`."""
        with _Span(self, "read"):
            mode = torch.cuda.get_sync_debug_mode() if t.is_cuda else 0
            if not mode:
                return t.item()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return t.item()
            finally:
                torch.cuda.set_sync_debug_mode(mode)

    def records(self) -> Deque[Dict[str, List[int]]]:
        return self._records

    def _take(self) -> Dict[str, List[int]]:
        """{path: [ns, calls]} of the spans closed since the last take."""
        with self._lock:
            closed = self._closed
            n = len(closed)
            chunk = closed[:n]
            del closed[:n]     # what another thread appends meanwhile stays
            rec, self._folded = self._folded, {}
        for path, ns in chunk:
            e = rec.get(path)
            if e is None:
                rec[path] = [ns, 1]
            else:
                e[0] += ns
                e[1] += 1
        return rec

    def _fold(self) -> None:
        """Sums the closed spans into the next record's start, so that a
        process that runs no update keeps a bounded list."""
        rec = self._take()
        with self._lock:
            for path, (ns, n) in self._folded.items():
                e = rec.setdefault(path, [0, 0])
                e[0] += ns
                e[1] += n
            self._folded = rec


def is_read(path: str) -> bool:
    return path == "read" or path.endswith("/read")


def summary(recs: Iterable[Dict[str, List[int]]]) -> Dict[str, float]:
    """Per update, over `recs`: the host ms of each span path but the
    reads (`<path>_ms`, inclusive), and the reads' count (`reads`) and ms
    (`read_ms`)."""
    recs = list(recs)
    out: Dict[str, float] = {"reads": 0.0, "read_ms": 0.0}
    for rec in recs:
        for path, (ns, n) in rec.items():
            if is_read(path):
                out["reads"] += n
                out["read_ms"] += ns / 1e6
            else:
                key = f"{path}_ms"
                out[key] = out.get(key, 0.0) + ns / 1e6
    return {k: v / max(len(recs), 1) for k, v in out.items()}


TRACER = Tracer()
span, read, records = TRACER.span, TRACER.read, TRACER.records
