"""Build and load the port's CUDA kernels.

Each source `ops/csrc/<name>.cu` has a plain C interface.  It is compiled
with nvcc into a shared library under `vln_goat_tpu_torch/build/` at first
use and loaded with ctypes.  The library's name carries a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source is rebuilt.  nvcc writes to a
temporary name that is then renamed into place: a build that was cut off
leaves no file that a later build would wait on or load.

Nothing here runs at import time: `load` is called by the kernel wrappers
when they are first given a CUDA tensor; `load_all` compiles every kernel
up front, one nvcc process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
KERNELS = ("fused_qkv_mha", "fused_qkv_mha_bwd", "mha", "adamw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": wall time of nvcc, "log": its output (ptxas report)}
build_log: Dict[str, dict] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _compile(names: Sequence[str]) -> None:
    """Compile the named kernels, one nvcc process each, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in names:
            path = library_path(name)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, path, tmp, proc, time.perf_counter()))
        for name, path, tmp, proc, t0 in jobs:
            out, _ = proc.communicate(timeout=600)
            build_log[name] = {"seconds": time.perf_counter() - t0,
                               "log": out}
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            os.replace(tmp, path)
    finally:
        for _, _, tmp, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load_all() -> None:
    """Compile every kernel that has no current library, in parallel, and
    load them all."""
    _compile([n for n in KERNELS if not library_path(n).exists()])
    for name in KERNELS:
        load(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, compiled first if it has no
    current library."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            _compile([name])
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
