"""ctypes bindings for the port's native runtime (`native/csrc/goat_native.cpp`,
the port's copy of the JAX package's csrc/goat_native.cpp).

The library is compiled at first use with g++ and the flags of the JAX
package's csrc/Makefile (`-O3 -fPIC -std=c++17 -Wall -shared`) into
`vln_goat_tpu_torch/build/`, the directory of the port's CUDA builds
(`ops._build`): its name carries a hash of the source and the flags, g++
writes a temporary name that is renamed into place, so an edited source is
rebuilt and a cut-off build leaves nothing a later one would load.
Nothing is built at import time.

`available()` says whether the library loaded.  Without g++ it is False
and every caller keeps its Python path (`sim/graph_sim.py`'s numpy APSP,
`eval/bleu.py`, `tools/kmeans.py`, `data/token_block.py`'s numpy path);
with g++ a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "goat_native.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib: Optional[ctypes.CDLL] = None


def library_path(build_dir: Optional[Path] = None) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return Path(build_dir or BUILD_DIR) / f"libgoat_native_{digest[:16]}.so"


def compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile the library into `build_dir` (BUILD_DIR by default) unless
    a current one is there; its path.  Raises RuntimeError with the
    compiler's output when the build fails."""
    path = library_path(build_dir)
    if path.exists():
        return path
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler: install g++ or set CXX")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n"
                               f"{proc.stdout}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        if not library_path().exists() and compiler() is None:
            return None
        lib = ctypes.CDLL(str(build()))
        lib.bucket_by_size.restype = ctypes.c_int
        lib.token_block_slices.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    """True when the library is loaded (built first where a compiler is
    present; a failed build raises)."""
    return _load() is not None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: no C++ compiler")
    return lib


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _i64(a):
    return np.ascontiguousarray(a, np.int64)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def apsp(V: int, edges: np.ndarray, weights: np.ndarray
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """edges [E, 2] int, weights [E] -> (dist [V, V] f32, hops, nexthop
    i32): Dijkstra from every source over the undirected graph."""
    lib = _need()
    edges = np.asarray(edges).reshape(-1, 2)
    ea, eb = _i32(edges[:, 0]), _i32(edges[:, 1])
    w = _f32(weights)
    dist = np.empty((V, V), np.float32)
    hops = np.empty((V, V), np.int32)
    nexthop = np.empty((V, V), np.int32)
    lib.apsp(V, len(edges), _ptr(ea), _ptr(eb), _ptr(w), _ptr(dist),
             _ptr(hops), _ptr(nexthop))
    return dist, hops, nexthop


def nearest_view(heading: np.ndarray, elev: np.ndarray) -> np.ndarray:
    """The nearest of the 36 discretized views to each direction."""
    lib = _need()
    h, e = _f32(np.ravel(heading)), _f32(np.ravel(elev))
    out = np.empty(h.shape, np.int32)
    lib.nearest_view(len(h), _ptr(h), _ptr(e), _ptr(out))
    return out.reshape(np.shape(heading))


def bleu_stats(hyp: np.ndarray, refs: list, max_n: int = 4):
    """-> (clipped [max_n] i64, totals [max_n] i64, closest_ref_len) of
    one hypothesis against its references."""
    lib = _need()
    hyp = _i32(hyp)
    ref_lens = _i32([len(r) for r in refs])
    flat = _i32(np.concatenate([np.asarray(r, np.int32) for r in refs])
                if refs else np.zeros(0, np.int32))
    clipped = np.zeros(max_n, np.int64)
    totals = np.zeros(max_n, np.int64)
    closest = np.zeros(1, np.int32)
    lib.bleu_stats(len(hyp), _ptr(hyp), len(refs), _ptr(ref_lens),
                   _ptr(flat), max_n, _ptr(clipped), _ptr(totals),
                   _ptr(closest))
    return clipped, totals, int(closest[0])


def edit_distance_batch(a_list: list, b_list: list) -> np.ndarray:
    """Levenshtein distance of each pair (a_list[i], b_list[i])."""
    lib = _need()
    B = len(a_list)
    maxa = max((len(a) for a in a_list), default=1) or 1
    maxb = max((len(b) for b in b_list), default=1) or 1
    a = np.zeros((B, maxa), np.int32)
    b = np.zeros((B, maxb), np.int32)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for i, (x, y) in enumerate(zip(a_list, b_list)):
        a[i, :len(x)] = x
        b[i, :len(y)] = y
        la[i], lb[i] = len(x), len(y)
    out = np.empty(B, np.int32)
    lib.edit_distance_batch(B, maxa, maxb, _ptr(a), _ptr(la), _ptr(b),
                            _ptr(lb), _ptr(out))
    return out


def bucket_by_size(sizes: np.ndarray, max_tokens: int,
                   max_items: int = 1 << 30) -> np.ndarray:
    """Greedy batch ids: items in order, a batch closed when its count
    times its largest size would pass max_tokens or its count
    max_items."""
    lib = _need()
    s = _i32(sizes)
    out = np.empty(len(s), np.int32)
    lib.bucket_by_size(len(s), _ptr(s), max_tokens, max_items, _ptr(out))
    return out


def kmeans_lloyd(x: np.ndarray, centers: np.ndarray,
                 iters: int = 50) -> Tuple[np.ndarray, np.ndarray]:
    """`iters` Lloyd iterations from `centers` -> (centers, assignment)."""
    lib = _need()
    x = _f32(x)
    centers = _f32(centers).copy()
    assign = np.empty(len(x), np.int32)
    lib.kmeans_lloyd(x.shape[0], x.shape[1], centers.shape[0], iters,
                     _ptr(x), _ptr(centers), _ptr(assign))
    return centers, assign


TB_MODES = {"none": 0, None: 0, "complete": 1, "complete_doc": 2, "eos": 3}


def token_block_slices(sizes: np.ndarray, block_size: int,
                       break_mode: str = "none",
                       document_sep_len: int = 1,
                       block_multiple_min: int = 1,
                       block_multiple_max: int = 1,
                       block_sizes: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """Token-block slicing (fairseq token_block_utils_fast
    _get_slice_indices_fast): -> [n_blocks, 2] int64 (start, end)."""
    lib = _need()
    if break_mode not in TB_MODES:
        raise ValueError(f"invalid break_mode {break_mode}")
    s = _i64(sizes)
    bs_arr = _i64(block_sizes) if block_sizes is not None else None
    args = (len(s), _ptr(s), TB_MODES[break_mode], ctypes.c_int64(block_size),
            ctypes.c_int64(document_sep_len), block_multiple_min,
            block_multiple_max, _ptr(bs_arr) if bs_arr is not None else None)
    n = lib.token_block_slices(*args, None, 0)
    out = np.empty((n, 2), np.int64)
    lib.token_block_slices(*args, _ptr(out), n)
    return out


def block_to_dataset_index(sizes: np.ndarray,
                           slices: np.ndarray) -> np.ndarray:
    """(start_ds_idx, start_offset, end_ds_idx) per block
    (_get_block_to_dataset_index_fast)."""
    lib = _need()
    s = _i64(sizes)
    sl = _i64(np.asarray(slices).reshape(-1, 2))
    out = np.empty((len(sl), 3), np.int64)
    lib.block_to_dataset_index(len(s), _ptr(s), len(sl), _ptr(sl), _ptr(out))
    return out
