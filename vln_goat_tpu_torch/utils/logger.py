"""Logging / observability.

Reference: map_nav_src/utils/logger.py (write_to_record_file :8, Timer
:28-57) and pretrain_src/utils/logger.py (RunningMeter EMA :70-95,
TB_LOGGER tensorboardX wrapper :27-65).  tensorboardX isn't in this image;
MetricsLogger writes JSON-lines instead (same scalars, greppable, and
convertible to TB offline).  `torch.profiler` hooks replace line_profiler
(counterpart of vln_goat_tpu/utils/logger.py, whose hooks are
`jax.profiler`'s).
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Dict, Optional


def write_to_record_file(data: str, file_path: Optional[str],
                         verbose: bool = True):
    if verbose:
        print(data, flush=True)
    if file_path:
        with open(file_path, "a") as f:
            f.write(data + "\n")


class Timer:
    def __init__(self):
        self.cul = 0.0
        self.start_t = 0.0
        self.iter = 0

    def reset(self):
        self.cul = 0.0
        self.iter = 0

    def tic(self):
        self.start_t = time.time()

    def toc(self):
        delta = time.time() - self.start_t
        self.cul += delta
        self.iter += 1
        return delta

    def show(self, total: Optional[float] = None) -> str:
        if total:
            return f"{self.cul:.2f}s ({self.cul / total * 100:.1f}%)"
        return f"{self.cul:.2f}s / {self.iter} iters"


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


_profiler = None


def start_profiler_trace(log_dir: str):
    """A torch.profiler trace of the host and the card (replaces the
    commented line_profiler hook on rollout, r2r/agent.py:9,447), written
    to `log_dir` as a TensorBoard trace when stopped."""
    import torch

    global _profiler
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    _profiler.start()


def stop_profiler_trace():
    global _profiler
    if _profiler is not None:
        _profiler.stop()
        _profiler = None
