"""Launch plans of the GEMM jobs of the projection backward, K2 (b)
(`csrc/fused_qkv_mha_bwd.cu` `fused_qkv_mha_bwd_proj`), and of the q / k / v
projection of K1 and K2 (a) (`csrc/qkv_proj.cuh` `qkv_jobs`).

The projection backward runs a table of GEMM jobs in one launch: dx = dq
Wq^T, dy = dk Wk^T + dv Wv^T, and the three weight gradients dW = x^T dq
(y^T dk, y^T dv), each split over its B*L rows into slices (split-K) whose
partial tiles a second launch adds in ascending slice order.  This module
decides, from the shapes alone, how many slices each weight gradient takes,
in which order the jobs run, and where the partials lie in the scratch
buffer; the wrapper allocates that buffer and passes the few integers to
the C entry point.  It runs on the CPU, so the tests reach it there.

The plan is per GEMM core.  The float32-accurate core
(`csrc/gemm_tf32x3.cuh`) walks 32-deep chunks of 128 x 128 tiles and gives
each work unit (a tile of one slice of one job) a block of its own; the
bf16 core (`csrc/gemm_bf16.cuh`) walks 64-deep chunks (one 128-byte
swizzle row of bf16) of 128 x 256 tiles and launches one persistent block
per SM (the C side sizes that grid) that takes units u, u + grid, ... in
launch order.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

# the GEMM cores' block tiles: output rows, output columns, depth chunk
# (gemm_tf32x3.cuh 128 x 128 x 32, gemm_bf16.cuh 128 x 256 x 64; the
# wrapper holds them to the C constants).  The bf16 tile is 256 wide
# because it measured faster than 128 on an H100 80GB HBM3 at 700 W: K1's
# q / k / v projection 0.0509 -> 0.0434 ms a launch over the bench build's
# mix, dx / dy 0.0242 / 0.0369 -> 0.0177 / 0.0260 ms (chip_smoke.py
# phase 3 (bf16) parts)
TILE_M, TILE_N, TILE_K = 128, 128, 32
TILE_N_BF16, TILE_K_BF16 = 256, 64
CHUNK = {"tf32x3": TILE_K, "bf16": TILE_K_BF16}
WIDTH = {"tf32x3": TILE_N, "bf16": TILE_N_BF16}
SMS = 132                  # streaming multiprocessors of an H100 SXM
# weight-gradient units per SM to aim for: two waves of the 3xTF32 core's
# blocks; one round of the bf16 core's persistent blocks, whose units are
# twice as wide
WAVES = 2
WAVES_BF16 = 1
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
        return self.blocks // self.splits


@dataclass(frozen=True)
class ProjPlan:
    jobs: Tuple[Job, ...]          # in launch order, longest first
    splits: Tuple[int, int, int]   # slices of dWq, dWk, dWv
    kc: Tuple[int, int, int]       # rows per slice
    wofs: Tuple[int, int, int]     # scratch offset (floats) of each partial dW
    bofs: Tuple[int, int, int]     # scratch offset of each partial db
    scratch_floats: int
    blocks: int                    # work units of the launch


def weight_splits(rows: int, D: int, HD: int,
                  core: str = "tf32x3") -> Tuple[int, int]:
    """(slices, rows per slice) of one weight gradient over `rows` rows on
    `core`: the fewest slices for which the three weight gradients' units
    fill WAVES (bf16: WAVES_BF16) waves of SMS SMs, each slice a whole
    number of the core's depth chunks, no slice empty."""
    tiles = _cdiv(D, TILE_M) * _cdiv(HD, WIDTH[core])
    waves = WAVES if core == "tf32x3" else WAVES_BF16
    return split_depth(rows, max(1, _cdiv(waves * SMS, 3 * tiles)),
                       CHUNK[core])


def split_depth(k: int, want: int, chunk: int = TILE_K) -> Tuple[int, int]:
    """(slices, depth per slice) of a depth k cut into at most `want`
    slices of whole depth chunks of `chunk`, none empty."""
    s = max(1, min(want, _cdiv(k, chunk)))
    kc = _cdiv(_cdiv(k, s), chunk) * chunk
    return _cdiv(k, kc), kc


@lru_cache(maxsize=256)
def proj_plan(B: int, Lq: int, Lk: int, D: int, HD: int,
              need_dx: bool = True, need_dy: bool = True,
              hsum: bool = False, core: str = "tf32x3") -> ProjPlan:
    """The plan of one projection-backward call on `core` ("tf32x3" or
    "bf16"): x [B, Lq, D], y [B, Lk, D], weights [D, HD]; dx and dy only
    when asked for, the dbias head sum of a [B, 1, Lq, Lk] bias when
    `hsum`.  Cached: a train step asks for the same few shapes again
    and again, and the plan is immutable."""
    ck, tn = CHUNK[core], WIDTH[core]
    gemms = []
    if need_dx:
        gemms.append(Job("dx", B * Lq, D, HD, 1, _cdiv(HD, ck) * ck,
                         _cdiv(B * Lq, TILE_M) * _cdiv(D, tn)))
    if need_dy:
        gemms.append(Job("dy", B * Lk, D, 2 * HD, 1, _cdiv(2 * HD, ck) * ck,
                         _cdiv(B * Lk, TILE_M) * _cdiv(D, tn)))
    splits, kcs, wofs, bofs = [], [], [], []
    off = 0
    tiles = _cdiv(D, TILE_M) * _cdiv(HD, tn)
    for name, rows in (("dwq", B * Lq), ("dwk", B * Lk), ("dwv", B * Lk)):
        s, kc = weight_splits(rows, D, HD, core)
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

