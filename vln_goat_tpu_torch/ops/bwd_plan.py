"""Launch plan of the projection backward, K2 (b) (`csrc/fused_qkv_mha_bwd.cu`
`fused_qkv_mha_bwd_proj`).

The kernel runs a table of GEMM jobs in one launch: dx = dq Wq^T,
dy = dk Wk^T + dv Wv^T, and the three weight gradients dW = x^T dq
(y^T dk, y^T dv), each split over its B*L rows into slices (split-K) whose
partial tiles a second launch adds in ascending slice order.  This module
decides, from the shapes alone, how many slices each weight gradient takes,
in which order the jobs run, and where the partials lie in the scratch
buffer; the wrapper allocates that buffer and passes the few integers to
the C entry point.  It runs on the CPU, so the tests reach it there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# gemm_tf32x3.cuh's block tile: output rows, output columns, depth chunk
TILE_M, TILE_N, TILE_K = 128, 128, 32
SMS = 132                  # streaming multiprocessors of an H100 SXM
WAVES = 2                  # weight-gradient blocks per SM to aim for
HSUM_THREADS = 256         # elements per block of the dbias head sum
# the C entry point's job ids
JOB_IDS = {"dx": 0, "dy": 1, "dwq": 2, "dwk": 3, "dwv": 4, "hsum": 5}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Job:
    """One job of the launch: an [m, n] output over a depth of k, cut into
    `splits` slices of `kc` (slice s covers depth [s kc, min((s+1) kc, k)));
    `blocks` blocks.  The head sum has m = n = k = 0 and one block per
    HSUM_THREADS elements."""
    name: str
    m: int
    n: int
    k: int
    splits: int
    kc: int
    blocks: int

    @property
    def tiles(self) -> int:
        return _cdiv(self.m, TILE_M) * _cdiv(self.n, TILE_N)


@dataclass(frozen=True)
class ProjPlan:
    jobs: Tuple[Job, ...]          # in launch order, longest first
    splits: Tuple[int, int, int]   # slices of dWq, dWk, dWv
    kc: Tuple[int, int, int]       # rows per slice
    wofs: Tuple[int, int, int]     # scratch offset (floats) of each partial dW
    bofs: Tuple[int, int, int]     # scratch offset of each partial db
    scratch_floats: int
    blocks: int


def weight_splits(rows: int, D: int, HD: int) -> Tuple[int, int]:
    """(slices, rows per slice) of one weight gradient over `rows` rows:
    the fewest slices for which the three weight gradients' blocks fill
    WAVES waves of SMS SMs, each slice a whole number of depth chunks, no
    slice empty."""
    tiles = _cdiv(D, TILE_M) * _cdiv(HD, TILE_N)
    return split_depth(rows, max(1, _cdiv(WAVES * SMS, 3 * tiles)))


def split_depth(k: int, want: int) -> Tuple[int, int]:
    """(slices, depth per slice) of a depth k cut into at most `want`
    slices of whole depth chunks, none empty."""
    s = max(1, min(want, _cdiv(k, TILE_K)))
    kc = _cdiv(_cdiv(k, s), TILE_K) * TILE_K
    return _cdiv(k, kc), kc


def proj_plan(B: int, Lq: int, Lk: int, D: int, HD: int,
              need_dx: bool = True, need_dy: bool = True,
              hsum: bool = False) -> ProjPlan:
    """The plan of one projection-backward call: x [B, Lq, D], y [B, Lk, D],
    weights [D, HD]; dx and dy only when asked for, the dbias head sum of a
    [B, 1, Lq, Lk] bias when `hsum`."""
    gemms = []
    if need_dx:
        gemms.append(Job("dx", B * Lq, D, HD, 1, _cdiv(HD, TILE_K) * TILE_K,
                         _cdiv(B * Lq, TILE_M) * _cdiv(D, TILE_N)))
    if need_dy:
        gemms.append(Job("dy", B * Lk, D, 2 * HD, 1,
                         _cdiv(2 * HD, TILE_K) * TILE_K,
                         _cdiv(B * Lk, TILE_M) * _cdiv(D, TILE_N)))
    splits, kcs, wofs, bofs = [], [], [], []
    off = 0
    tiles = _cdiv(D, TILE_M) * _cdiv(HD, TILE_N)
    for name, rows in (("dwq", B * Lq), ("dwk", B * Lk), ("dwv", B * Lk)):
        s, kc = weight_splits(rows, D, HD)
        gemms.append(Job(name, D, HD, rows, s, kc, tiles * s))
        splits.append(s)
        kcs.append(kc)
        wofs.append(off)
        off += s * D * HD
    for s in splits:
        bofs.append(off)
        off += s * HD
    # longest first (the depth a block walks); ties keep dx, dy, dWq, dWk,
    # dWv order
    jobs = sorted(gemms, key=lambda j: -j.kc)
    if hsum:
        jobs.append(Job("hsum", 0, 0, 0, 1, 0,
                        _cdiv(B * Lq * Lk, HSUM_THREADS)))
    return ProjPlan(tuple(jobs), tuple(splits), tuple(kcs), tuple(wofs),
                    tuple(bofs), off, sum(j.blocks for j in jobs))
