"""The shared-memory layouts of the bf16 attention cores written for
Hopper (`ops/csrc/attn_sm90.cuh`, under `attn_fwd_sm90.cuh` and
`attn_bwd_sm90.cuh`) and how wgmma reads them back, on the CPU, through the
model of TMA's 128-byte swizzle and of wgmma's descriptors in
tests/test_torch_swizzle.py.

A tile is 64 rows of one head (queries, keys, rows of dO) of 64 head
columns in bf16, one TMA box, row r at 128 r bytes.  An operand of head
width dh takes ceil(dh / 64) tiles, tile j the box at head column 64 j:
two at 128, three and four at 192 and 256, and at 32 one whose columns
past 32 are zeros (TMA's fill of a
box past the tensor's extent, and the direct route's), which the products
over the head dimension add as zeros and the outputs never store.  The
cores read one tile both ways:

- K-major, rows as m or n and the head dimension as the depth: q and k in
  s = q k^T, dO and v in dp = dO v^T;
- MN-major, rows as the depth and the head dimension as n: v in o += p v,
  k in dq = ds k, dO and q in dv += p^T dO and dk += ds^T q;

and the backward core writes pd and ds from registers as [q][key] tiles
in the same swizzled form, read MN-major as the A operand (m = key,
depth = q).  The
register A operand of o += p v and dq = ds k is the accumulator of the
score tile in place (`to_a`): modelled from the two fragment layouts PTX
defines.  The constants are read from the header."""
import re
from pathlib import Path

import numpy as np
import pytest

from test_torch_swizzle import C as GEMM, _sw_offset, _tma_place, \
    _wgmma_read

HEADER = (Path(__file__).resolve().parent.parent / "vln_goat_tpu_torch"
          / "ops" / "csrc" / "attn_sm90.cuh")


def _constants():
    text = re.sub(r"//[^\n]*", "", HEADER.read_text())
    env = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", text, re.M):
        for part in decl.split(","):
            name, expr = (s.strip() for s in part.split("=", 1))
            env[name] = int(eval(expr, {}, dict(env)))  # noqa: S307
    return env


A = _constants()
T, DH = A["TILE"], A["TW"]     # a tile's rows and head columns
HEAD_DIMS = (32, 64, 128, 192, 256)


def _tile():
    return np.random.default_rng(1).permutation(T * DH).reshape(T, DH)


def test_tile_is_one_box_of_whole_swizzle_rows():
    assert A["ROW_BYTES"] == GEMM["SW_ROW"] == 128 and DH * 2 == 128
    assert A["TILE_BYTES"] == T * A["ROW_BYTES"]
    assert A["TILE_BYTES"] % A["ALIGN"] == 0 and A["ALIGN"] == GEMM["SW_ATOM"]
    assert A["K16_K"] == GEMM["K16_STEP_K"]
    assert A["K16_MN"] == GEMM["K16_STEP_MN"]


def test_direct_route_writes_where_tma_writes():
    """The producer's ordinary loads (`load_direct`: `sw_offset`, K-major,
    row r, column d) land where the tile's TMA box puts them."""
    tile = _tile()
    smem = _tma_place(tile, kmajor=True)
    for r in range(T):
        for d in range(DH):
            assert smem[_sw_offset(True, r, d) // 2] == tile[r, d]


def test_k_major_reading():
    """q k^T: each 16-deep step reads columns 16k..16k+15 of all 64 rows."""
    tile = _tile()
    smem = _tma_place(tile, kmajor=True)
    for k16 in range(DH // 16):
        got = _wgmma_read(smem, k16 * A["K16_K"], GEMM["LBO_K"],
                          GEMM["SBO"], True, T)
        np.testing.assert_array_equal(got, tile[:, 16 * k16:16 * k16 + 16])


def test_mn_major_reading_of_the_same_tile():
    """p v, ds k, p^T dO, ds^T q: the same placement read MN-major gives
    B(depth = row, n = column): step k reads rows 16k..16k+15."""
    tile = _tile()
    smem = _tma_place(tile, kmajor=True)
    for k16 in range(T // 16):
        got = _wgmma_read(smem, k16 * A["K16_MN"], GEMM["LBO_MN"],
                          GEMM["SBO"], False, DH)
        np.testing.assert_array_equal(got, tile[16 * k16:16 * k16 + 16].T)


def _fragment_rows_cols(lane, warp):
    """(row, column) of accumulator element idx < 32 of wgmma m64n64 for a
    thread: rows 16 warp + g (+8 for idx % 4 >= 2), columns
    8 (idx // 4) + 2 t + idx % 2 (g = lane // 4, t = lane % 4)."""
    g, t = lane // 4, lane % 4
    return [(16 * warp + g + (8 if idx % 4 >= 2 else 0),
             8 * (idx // 4) + 2 * t + idx % 2) for idx in range(32)]


def _a_fragment(lane, warp, k16):
    """(row, depth) of the 8 values of a thread's A fragment of 16-deep
    step k16 (four registers of two, m16n8k16's layout per warp): (g, 2t),
    (g, 2t+1), (g+8, 2t), (g+8, 2t+1), (g, 2t+8), (g, 2t+9), (g+8, 2t+8),
    (g+8, 2t+9)."""
    g, t = lane // 4, lane % 4
    out = []
    for reg in range(4):
        row = 16 * warp + g + (8 if reg % 2 else 0)
        col = 16 * k16 + 2 * t + (8 if reg >= 2 else 0)
        out += [(row, col), (row, col + 1)]
    return out


@pytest.mark.parametrize("warp", range(4))
def test_accumulator_becomes_the_a_operand(warp):
    """`to_a`: register j of step k packs accumulator elements
    8k + 2j and 8k + 2j + 1, which hold the (row, depth) the A fragment
    wants there."""
    for lane in range(32):
        acc = _fragment_rows_cols(lane, warp)
        for k16 in range(4):
            want = _a_fragment(lane, warp, k16)
            got = [acc[8 * k16 + 2 * j + e] for j in range(4)
                   for e in range(2)]
            assert got == want


def test_pd_and_ds_tiles_read_as_transposed_a():
    """The backward core stores a thread's elements (row q, key
    8c + 2t + e) as pairs at q * 128 + ((c ^ (q % 8)) << 4) + 4 t; read
    MN-major (m = key, depth = q) each 16-deep step gives rows
    16k..16k+15 of the [q][key] tile, transposed: the A operand of p^T dO
    and ds^T q."""
    vals = _tile()                       # [q][key]
    smem = np.full(T * DH, -1, dtype=np.int64)
    for warp in range(4):
        for lane in range(32):
            t = lane % 4
            for idx, (q, key) in enumerate(_fragment_rows_cols(lane, warp)):
                c, e = idx // 4, idx % 2
                assert key == 8 * c + 2 * t + e
                off = q * A["ROW_BYTES"] + ((c ^ (q % 8)) << 4) + 4 * t + 2 * e
                assert off == _sw_offset(True, q, key)
                smem[off // 2] = vals[q, key]
    assert (smem >= 0).all()
    for k16 in range(T // 16):
        got = _wgmma_read(smem, k16 * A["K16_MN"], GEMM["LBO_MN"],
                          GEMM["SBO"], False, T)
        np.testing.assert_array_equal(got, vals[16 * k16:16 * k16 + 16].T)


# ---------------------------------------------------------------------------
# Head widths 32 and 128: an operand's tiles as its boxes (or the direct
# route) leave them, read by the products over the head dimension (K-major,
# the depth) and the products whose n is the head dimension (MN-major)


def _box(head, l0, d0):
    """TMA's box (d0, l0) of 64 x 64 over one head's [L, dh] rows: the
    elements past L or past dh arrive as zeros."""
    L, dh = head.shape
    box = np.zeros((T, DH), dtype=head.dtype)
    rows, cols = min(T, L - l0), min(DH, dh - d0)
    if rows > 0 and cols > 0:
        box[:rows, :cols] = head[l0:l0 + rows, d0:d0 + cols]
    return box


def _tiles(head, l0=0):
    """Shared memory of each tile of an operand (`load_tiles`, TMA)."""
    dh = head.shape[1]
    return [_tma_place(_box(head, l0, DH * j), kmajor=True)
            for j in range(-(-dh // DH))]


def _k_major(tiles):
    """The operand as the products over the head dimension read it: the
    16-deep steps of tile 0, then of tile 1 -> [64, 64 NT]."""
    return np.concatenate(
        [_wgmma_read(sm, k16 * A["K16_K"], GEMM["LBO_K"], GEMM["SBO"], True, T)
         for sm in tiles for k16 in range(DH // 16)], axis=1)


def _mn_major(sm):
    """A tile read MN-major: B [depth = row, n = head column] -> [64, 64]."""
    return np.concatenate(
        [_wgmma_read(sm, k16 * A["K16_MN"], GEMM["LBO_MN"], GEMM["SBO"],
                     False, DH).T for k16 in range(T // 16)], axis=0)


def _head(L, dh, seed):
    return np.random.default_rng(seed).integers(-8, 9, (L, dh))


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("L", [64, 50])
def test_products_over_the_head_dimension(dh, L):
    """s = q k^T (and dp = dO v^T): the sum of the tiles' products over
    their 16-deep steps is the product over the whole head width; the
    zero columns of a 32-wide operand's tile add nothing, and rows past L
    are zero."""
    q, k = _head(L, dh, 2), _head(L, dh, 3)
    qa, ka = _k_major(_tiles(q)), _k_major(_tiles(k))
    assert qa.shape == (T, DH * -(-dh // DH))
    np.testing.assert_array_equal(qa[:L, :dh], q)
    assert (qa[:, dh:] == 0).all() and (qa[L:] == 0).all()
    np.testing.assert_array_equal((qa @ ka.T)[:L, :L], q @ k.T)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_products_whose_n_is_the_head_dimension(dh):
    """o = p v, dq = ds k, dv = pd^T dO, dk = ds^T q: tile j read MN-major
    is B of accumulator j, columns 64 j .. 64 j + 63 of the head; the
    columns the kernels store (64 j + 8 c + 2 t, below dh) are the
    product's, the rest (at 32) zeros."""
    v = _head(T, dh, 4)
    p = np.random.default_rng(5).integers(-4, 5, (T, T))
    outs = [p @ _mn_major(sm) for sm in _tiles(v)]
    stored = np.concatenate(outs, axis=1)
    np.testing.assert_array_equal(stored[:, :dh], p @ v)
    assert (stored[:, dh:] == 0).all()
    # the stores' columns: tile j, block c of 8, pair 2 t, below dh
    cols = sorted(DH * j + 8 * c + 2 * t + e for j in range(len(outs))
                  for c in range(8) for t in range(4) for e in range(2)
                  if DH * j + 8 * c < dh)
    assert cols == list(range(dh))


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_direct_route_writes_where_tma_writes_at_any_width(dh):
    """`load_direct(dst + j TILE_BYTES, ..., l0, 64 j, dh)`: zeros past L
    and past dh, everything else where the box puts it."""
    head = _head(40, dh, 6)
    for j, sm in enumerate(_tiles(head)):
        direct = np.full(T * DH, -1, dtype=np.int64)
        for r in range(T):
            for d in range(DH):
                ok = r < 40 and DH * j + d < dh
                direct[_sw_offset(True, r, d) // 2] = \
                    head[r, DH * j + d] if ok else 0
        np.testing.assert_array_equal(direct, sm)


def test_head_widths_are_the_kernels():
    """The set the header dispatches on is the wrappers' HEAD_DIMS."""
    from vln_goat_tpu_torch.ops.attention import HEAD_DIMS as WRAPPER
    text = (HEADER.parent / "head_dims.cuh").read_text()
    dims = re.search(r"DIMS\[COUNT\] = \{([^}]*)\}", text).group(1)
    cases = [int(c) for c in re.findall(r"case (\d+):", text)]
    assert tuple(int(d) for d in dims.split(",")) == WRAPPER == HEAD_DIMS
    assert tuple(cases) == HEAD_DIMS
