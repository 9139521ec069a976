"""A numpy model of how the bf16 GEMM core (`ops/csrc/gemm_bf16.cuh`) lays
its operands out in shared memory and how wgmma reads them back, on the
CPU.

Three parts, each modelled from its definition rather than from the
kernel's code:

- TMA's 128-byte swizzle: a box is written row after row (128 bytes a
  row), and the 16-byte piece at byte address a lands at
  a ^ (((a >> 7) & 7) << 4) (bits 4-6 XOR bits 7-9);
- the kernel's boxes: a K-major operand chunk (depth the unit stride) is
  one box of 64 depth values x its rows (BM of A, BN of B); an MN-major
  one (rows the unit stride) is a box of 64 rows x 64 depth rows for each
  64 of its rows, MN_BLOCK bytes apart;
- wgmma's descriptors in the 128-byte swizzle mode (the canonical layouts
  CUTLASS's `make_gmma_desc` documents): K-major, row i of the 8-row atom
  128 bytes apart, atoms SBO apart, 16 contiguous depth values a product;
  MN-major, 64 contiguous rows, blocks of 64 rows LBO apart, depth rows
  128 bytes apart, atoms of 8 depth rows SBO apart.  The swizzle is
  applied to the address the descriptor gives.

The constants (SBO, LBO, the start-address step of a 16-deep product, the
half offset, the warpgroup's row offset) are read from the header, so the
model holds the kernel's own numbers: reading each warpgroup's A and the
whole B of every 16-deep product back through the descriptors gives the
plain gather of the tile.  The direct route's placement (`sw_offset`,
transcribed) is held to TMA's."""
import re
from pathlib import Path

import numpy as np
import pytest

HEADER = (Path(__file__).resolve().parent.parent / "vln_goat_tpu_torch"
          / "ops" / "csrc" / "gemm_bf16.cuh")


def _constants():
    """Every namespace-level `constexpr int` of the header, evaluated in
    order."""
    text = re.sub(r"//[^\n]*", "", HEADER.read_text())
    env = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", text, re.M):
        for part in decl.split(","):
            name, expr = (s.strip() for s in part.split("=", 1))
            env[name] = int(eval(expr, {}, dict(env)))  # noqa: S307
    return env


C = _constants()


def _swizzle(addr):
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_place(tile, kmajor):
    """Shared memory (element slots of 2 bytes) of one operand chunk
    tile[r, k] (BM rows of A or BN of B, BK depth) as the kernel's TMA
    boxes leave it."""
    rows, depth = tile.shape
    smem = np.full(rows * depth, -1, dtype=np.int64)
    if kmajor:
        boxes = [(0, tile)]                          # box row r: tile[r, :]
    else:
        boxes = [(h * C["MN_BLOCK"], tile[64 * h:64 * h + 64].T)
                 for h in range(rows // 64)]         # box row k: tile[h, k]
    for base, box in boxes:
        for br in range(box.shape[0]):
            for bc in range(box.shape[1]):
                addr = base + br * C["SW_ROW"] + 2 * bc
                smem[_swizzle(addr) // 2] = box[br, bc]
    return smem


def _wgmma_read(smem, start, lbo, sbo, kmajor, rows):
    """The rows x 16 operand one wgmma reads through a descriptor at byte
    `start` (relative to a 1024-byte aligned base)."""
    out = np.empty((rows, 16), dtype=np.int64)
    for i in range(rows):
        for kk in range(16):
            if kmajor:
                logical = start + (i % 8) * C["SW_ROW"] + (i // 8) * sbo \
                    + 2 * kk
            else:
                logical = start + 2 * (i % 64) + (i // 64) * lbo \
                    + (kk % 8) * C["SW_ROW"] + (kk // 8) * sbo
            out[i, kk] = smem[_swizzle(logical) // 2]
    return out


def _sw_offset(kmajor, r, k):
    """gemm_bf16.cuh `sw_offset`, transcribed: where the direct route
    writes element (r, k)."""
    if kmajor:
        return r * C["SW_ROW"] + (((k >> 3) ^ (r & 7)) << 4) + (k & 7) * 2
    return (r >> 6) * C["MN_BLOCK"] + k * C["SW_ROW"] \
        + ((((r & 63) >> 3) ^ (k & 7)) << 4) + (r & 7) * 2


def _tile(rows):
    rng = np.random.default_rng(0)
    return rng.permutation(rows * C["BK"]).reshape(rows, C["BK"])


def test_chunk_is_one_swizzle_row_and_tiles_are_atom_aligned():
    """A 64-deep bf16 chunk row is one 128-byte swizzle row, and every
    base the descriptors start from (stage, operand, half, warpgroup) is
    a multiple of the 1024-byte atom, as the swizzle's address bits need."""
    assert C["BK"] * 2 == C["SW_ROW"] == 128 and C["SW_ATOM"] == 1024
    for size in (C["A_BYTES"], C["B_BYTES"], C["STAGE_BYTES"], C["MN_BLOCK"],
                 64 * C["SW_ROW"]):
        assert size % C["SW_ATOM"] == 0
    assert C["A_BYTES"] == C["BM"] * C["BK"] * 2
    assert C["B_BYTES"] == C["BN"] * C["BK"] * 2
    assert C["STAGE_BYTES"] == C["A_BYTES"] + C["B_BYTES"]


@pytest.mark.parametrize("rows", ["BM", "BN"])
@pytest.mark.parametrize("kmajor", [True, False])
def test_direct_route_writes_where_tma_writes(kmajor, rows):
    tile = _tile(C[rows])
    smem = _tma_place(tile, kmajor)
    assert (smem >= 0).all()                  # the boxes fill the chunk
    for r in range(C[rows]):
        for k in range(C["BK"]):
            assert smem[_sw_offset(kmajor, r, k) // 2] == tile[r, k]


@pytest.mark.parametrize("operand", ["a", "b"])
@pytest.mark.parametrize("kmajor", [True, False])
def test_descriptors_read_back_the_tile(operand, kmajor):
    """Every 16-deep product's view of A (each warpgroup's 64 rows, at the
    warpgroup's offset) and of B (all BN columns) through the kernel's
    descriptor constants is the plain gather of the tile."""
    tile = _tile(C["BM"] if operand == "a" else C["BN"])
    smem = _tma_place(tile, kmajor)
    lbo = C["LBO_K"] if kmajor else C["LBO_MN"]
    step = C["K16_STEP_K"] if kmajor else C["K16_STEP_MN"]
    parts = [(wg * 64 * C["SW_ROW"], slice(64 * wg, 64 * wg + 64), 64)
             for wg in range(C["CONSUMERS"])] if operand == "a" \
        else [(0, slice(0, C["BN"]), C["BN"])]
    for off, rows, n in parts:
        for k16 in range(C["BK"] // 16):
            got = _wgmma_read(smem, off + k16 * step, lbo, C["SBO"], kmajor,
                              n)
            np.testing.assert_array_equal(
                got, tile[rows, 16 * k16:16 * k16 + 16])


def test_descriptor_fields_fit():
    """The descriptor's 14-bit fields hold the strides in 16-byte units,
    and the ring with its barriers fits a block's 227 KB."""
    for v in (C["SBO"], C["LBO_MN"], C["LBO_K"]):
        assert v % 16 == 0 and 0 < v >> 4 < 1 << 14
    assert C["STAGES"] * C["STAGE_BYTES"] + 2 * C["SW_ATOM"] < 227 * 1024
