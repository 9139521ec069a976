"""The projection backward's launch plan (`ops/bwd_plan.py`) and the
backward's choice of gradients (`ops/attention.py` `backward_needs`), on
the CPU: both decide, in Python, what the CUDA kernels of
`csrc/fused_qkv_mha_bwd.cu` run.  The plan is per GEMM core: the bf16
core's slices are whole 64-deep chunks, and its persistent blocks walk the
units in launch order (the `test_bf16_*` cases, with a model of that
schedule here).

The plan is held to what the kernel relies on: each output tile of each
job is written by one block, each of a weight gradient's rows lies in one
slice and the slices are added in ascending order, the longest jobs run
first, the weight gradients alone fill two waves of an H100's 132 SMs,
and the scratch regions of the partial sums tile the buffer the wrapper
allocates (`plan.scratch_floats` floats) without overlap."""
import pytest
import torch

from vln_goat_tpu_torch.ops.attention import backward_needs, gemm_tf32x3
from vln_goat_tpu_torch.ops.bwd_plan import (HSUM_THREADS, JOB_IDS, SMS,
                                             TILE_K, TILE_K_BF16, TILE_M,
                                             TILE_N, TILE_N_BF16, Job,
                                             proj_plan, split_depth)

D = HD = 768
# (B, Lq, Lk): the train step's shapes at batch 64 (the plain
# configuration's text, map and local self-attention, the causal one's
# bank cross-attentions and front-door self-attention), R2R's longest
# instruction at the decode batch, and ragged row counts
SHAPES = [(64, 60, 60), (64, 50, 50), (64, 54, 54), (64, 60, 36),
          (64, 60, 47), (64, 60, 24), (64, 50, 24), (64, 54, 24),
          (64, 50, 50), (8, 200, 200), (3, 7, 33), (1, 1, 1), (5, 61, 29)]
TRAIN = {s for s in SHAPES if s[0] == 64} | {(8, 200, 200)}


# the bench build's launch mix of one DAgger step (3 steps, plain and
# causal; chip_smoke.py phase 5 (g)): (B, Lq, Lk) -> K1 launches
BENCH_MIX = {(64, 60, 60): 36, (64, 60, 36): 3, (64, 60, 47): 3,
             (64, 60, 24): 3, (64, 50, 50): 420, (64, 54, 54): 420,
             (64, 50, 24): 60, (64, 54, 24): 60}


def qkv_jobs(B, Lq, Lk, tile_n=TILE_N_BF16):
    """The q / k / v projection jobs of one bf16 K1 launch (or K2 (a)'s
    recompute) as `csrc/qkv_proj.cuh` lays them out: [B*Lq, HD] and twice
    [B*Lk, HD] over a depth of D, in 128 x tile_n tiles."""
    return tuple(Job(name, rows, HD, D, 1, D,
                     -(-rows // TILE_M) * -(-HD // tile_n))
                 for name, rows in (("q", B * Lq), ("k", B * Lk),
                                    ("v", B * Lk)))


def unit_chunks(jobs):
    """The 64-deep chunks each GEMM work unit walks, in launch order (job
    by job; slice s of a job's tiles after slice s - 1's)."""
    out = []
    for j in jobs:
        if j.name == "hsum":
            continue
        for s in range(j.splits):
            depth = min(j.k, (s + 1) * j.kc) - s * j.kc
            out += [-(-depth // TILE_K_BF16)] * j.tiles
    return out


def persistent_blocks(units):
    """The bf16 core's persistent schedule: min(SMS, units) blocks, block
    b taking units b, b + grid, ... in launch order."""
    grid = min(SMS, len(units))
    return [units[b::grid] for b in range(grid)]


def _blocks(plan):
    """Decode every block of the launch as the kernel does: the job whose
    range holds it, then slice = local // tiles, tile = local % tiles."""
    out, b0 = [], 0
    for job in plan.jobs:
        for local in range(job.blocks):
            if job.name == "hsum":
                out.append((job.name, 0, local))
            else:
                out.append((job.name, local // job.tiles, local % job.tiles))
        b0 += job.blocks
    assert b0 == plan.blocks
    return out


@pytest.mark.parametrize("B,Lq,Lk", SHAPES)
def test_plan_covers_every_tile_and_row_once(B, Lq, Lk):
    plan = proj_plan(B, Lq, Lk, D, HD, hsum=True)
    assert plan.jobs[-1].name == "hsum"
    seen = {}
    for name, s, tile in _blocks(plan):
        seen.setdefault(name, []).append((s, tile))
    for job in plan.jobs:
        got = seen[job.name]
        assert len(got) == len(set(got)), job.name
        if job.name == "hsum":
            assert len(got) * HSUM_THREADS >= B * Lq * Lk > \
                (len(got) - 1) * HSUM_THREADS
            continue
        tiles_m = -(-job.m // TILE_M)
        tiles_n = -(-job.n // TILE_N)
        assert set(got) == {(s, t) for s in range(job.splits)
                            for t in range(tiles_m * tiles_n)}
        # rows: slice s takes [s kc, min((s+1) kc, k)); each row once, in
        # ascending slice order, every slice a whole number of depth chunks
        # and none empty
        assert job.kc % TILE_K == 0
        rows = []
        for s in range(job.splits):
            lo, hi = s * job.kc, min((s + 1) * job.kc, job.k)
            assert hi > lo
            rows += range(lo, hi)
        assert rows == list(range(job.k))
    assert {j.name for j in plan.jobs} == set(JOB_IDS)


@pytest.mark.parametrize("B,Lq,Lk", SHAPES)
def test_plan_runs_longest_first_and_fills_the_card(B, Lq, Lk):
    plan = proj_plan(B, Lq, Lk, D, HD)
    # the depth one block walks, descending; ties in job-id order
    keys = [(-j.kc, JOB_IDS[j.name]) for j in plan.jobs]
    assert keys == sorted(keys)
    dw = [j for j in plan.jobs if j.name.startswith("dw")]
    if (B, Lq, Lk) in TRAIN:
        assert sum(j.blocks for j in dw) >= 2 * SMS
    # no more slices than two waves need: one fewer would not fill them
    for j in dw:
        if j.splits > 1:
            assert 3 * j.tiles * (j.splits - 1) < 2 * SMS


@pytest.mark.parametrize("B,Lq,Lk", SHAPES)
def test_plan_scratch_is_what_the_wrapper_allocates(B, Lq, Lk):
    plan = proj_plan(B, Lq, Lk, D, HD)
    regions = []
    for g in range(3):
        regions.append((plan.wofs[g], plan.splits[g] * D * HD))
        regions.append((plan.bofs[g], plan.splits[g] * HD))
    regions.sort()
    end = 0
    for start, size in regions:
        assert start == end and start % 4 == 0     # 16-byte aligned, packed
        end = start + size
    assert end == plan.scratch_floats
    assert plan.splits == tuple(j.splits for name in ("dwq", "dwk", "dwv")
                                for j in plan.jobs if j.name == name)


@pytest.mark.parametrize("need_dx,need_dy", [(True, False), (False, True),
                                             (False, False)])
def test_plan_leaves_out_unasked_input_grads(need_dx, need_dy):
    plan = proj_plan(64, 60, 24, D, HD, need_dx, need_dy)
    names = {j.name for j in plan.jobs}
    assert ("dx" in names) == need_dx and ("dy" in names) == need_dy
    assert {"dwq", "dwk", "dwv"} <= names


@pytest.mark.parametrize("K,splits", [(1, 1), (33, 2), (100, 3), (3840, 3),
                                      (3200, 5), (64, 9)])
def test_split_depth_slices(K, splits):
    """`split_depth`, which the GEMM core and the weight gradients share:
    at most `splits` slices, each a whole number of depth chunks but the
    last, none empty, covering the depth once in ascending order."""
    S, kc = split_depth(K, splits)
    assert 1 <= S <= splits and kc % TILE_K == 0
    bounds = [(s * kc, min((s + 1) * kc, K)) for s in range(S)]
    assert all(hi > lo for lo, hi in bounds)
    assert [r for lo, hi in bounds for r in range(lo, hi)] == list(range(K))


def test_gemm_core_refuses_cpu_tensors():
    """The GEMM core alone is card-only: it has no plain version."""
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        gemm_tf32x3(a, a.t())


class _Bias:
    def __init__(self, *shape):
        self.shape = shape

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("needs,bias,want", [
    ((True,) * 9, _Bias(2, 1, 5, 5), (True, True, True, False)),
    ((True,) * 9, _Bias(2, 12, 5, 5), (True, True, True, True)),
    ((True, False) + (True,) * 7, None, (True, False, False, False)),
    ((False, True) + (True,) * 6 + (False,), _Bias(2, 1, 1, 5),
     (False, True, False, False)),
    ((True, True) + (False,) * 7, _Bias(2, 12, 5, 5),
     (True, True, False, False))])
def test_backward_needs(needs, bias, want):
    """dx / dy / the bias gradient only for an input that needs one (a
    causal bank's y does not); the bias gradient per head for a bias with
    the heads' dimension, else summed over the heads."""
    assert backward_needs(needs + (False, False, False), bias, 12) == want


@pytest.mark.parametrize("B,Lq,Lk", SHAPES)
def test_bf16_plan_covers_every_tile_and_row_once_in_whole_chunks(B, Lq,
                                                                   Lk):
    """The bf16 core's plan: every tile of every slice once, each
    weight gradient's rows once in ascending slices of whole 64-deep
    chunks (none empty), longest jobs first, the head sum last."""
    plan = proj_plan(B, Lq, Lk, D, HD, hsum=True, core="bf16")
    assert plan.jobs[-1].name == "hsum"
    seen = {}
    for name, s, tile in _blocks(plan):
        seen.setdefault(name, []).append((s, tile))
    for job in plan.jobs[:-1]:
        tiles = -(-job.m // TILE_M) * -(-job.n // TILE_N_BF16)
        assert sorted(seen[job.name]) == [(s, t) for s in range(job.splits)
                                          for t in range(tiles)]
        assert job.kc % TILE_K_BF16 == 0
        bounds = [(s * job.kc, min((s + 1) * job.kc, job.k))
                  for s in range(job.splits)]
        assert all(hi > lo for lo, hi in bounds)
        assert [r for lo, hi in bounds for r in range(lo, hi)] == \
            list(range(job.k))
    keys = [(-j.kc, JOB_IDS[j.name]) for j in plan.jobs[:-1]]
    assert keys == sorted(keys)


@pytest.mark.parametrize("B,Lq,Lk", sorted(BENCH_MIX))
def test_bf16_persistent_schedule_at_the_train_mix(B, Lq, Lk):
    """At the bench build's shapes the persistent blocks take every unit
    once in launch order, in as many rounds as units per block rounded up,
    and, the jobs running longest first, the longest block walks at most
    one unit's chunks more than the mean (a list schedule's bound); the
    q / k / v launch has 270, 225 or 243 units of 128 x 256 at text60,
    gmap50, local54."""
    for jobs in (qkv_jobs(B, Lq, Lk),
                 proj_plan(B, Lq, Lk, D, HD, core="bf16").jobs):
        units = unit_chunks(jobs)
        assert len(units) == sum(j.blocks for j in jobs if j.name != "hsum")
        blocks = persistent_blocks(units)
        assert sorted(w for b in blocks for w in b) == sorted(units)
        assert max(len(b) for b in blocks) == -(-len(units) // len(blocks))
        assert max(sum(b) for b in blocks) <= \
            sum(units) / len(blocks) + max(units)
    want = {(64, 60, 60): 270, (64, 50, 50): 225, (64, 54, 54): 243}
    if (B, Lq, Lk) in want:
        assert len(unit_chunks(qkv_jobs(B, Lq, Lk))) == want[(B, Lq, Lk)]


def test_bf16_tile_width_halves_the_rounds_at_the_train_mix():
    """The kernel's 256-wide tile (chosen by its measured time, see
    `ops/bwd_plan.py`) takes the q / k / v launch at gmap50 and local54,
    the bulk of the bench build's K1 launches, to two rounds of 132
    blocks, where 128-wide tiles (450 and 486 units) take four."""
    for B, Lq, Lk in ((64, 50, 50), (64, 54, 54)):
        for tile_n, want in ((TILE_N_BF16, 2), (128, 4)):
            units = unit_chunks(qkv_jobs(B, Lq, Lk, tile_n))
            assert max(len(b) for b in persistent_blocks(units)) == want
    assert TILE_N_BF16 == 256


@pytest.mark.parametrize("K,splits", [(1, 1), (33, 2), (100, 3), (3840, 3),
                                      (3200, 5), (64, 9), (3456, 3)])
def test_bf16_split_depth_slices(K, splits):
    """`split_depth` with the bf16 core's 64-deep chunks."""
    S, kc = split_depth(K, splits, TILE_K_BF16)
    assert 1 <= S <= splits and kc % TILE_K_BF16 == 0
    bounds = [(s * kc, min((s + 1) * kc, K)) for s in range(S)]
    assert all(hi > lo for lo, hi in bounds)
    assert [r for lo, hi in bounds for r in range(lo, hi)] == list(range(K))
