// Building blocks of the bf16 attention cores written for Hopper: the
// forward (attn_fwd_sm90.cuh: K1 bf16's attention and the bf16 K3) and the
// backward (attn_bwd_sm90.cuh: K2 (a) bf16's attention).
//
// - Tiles: 64 rows (queries, keys, or rows of dO) of one head, 64 head
//   columns (TW) of 64 bf16 = 128 bytes each, in shared memory in TMA's
//   128-byte swizzle: row r at r * 128 bytes, its 16-byte pieces permuted
//   by XOR with r mod 8 (gemm_bf16.cuh `sw_offset`, K-major form).  An
//   operand of head width DH (head_dims.cuh: 32, 64, 128, 192 or 256)
//   takes NT = ceil(DH / 64) tiles, tile j its columns [64 j, 64 j + 64):
//   two at 128, three and four at 192 and 256; at 32 one tile whose columns past 32 are zeros (TMA's fill of a
//   box past the tensor's extent, or the direct route's), so the products
//   over the head dimension add zeros and the columns past 32 of an
//   output are never stored.  One tile is read by wgmma
//   both as a K-major operand (its rows are m or n, the head dimension the
//   depth: q and k in s = q k^T) and as an MN-major one (its rows are the
//   depth: v in p v, k in dq = ds k), through the descriptors of
//   gemm_bf16.cuh; tests/test_torch_swizzle.py models both readings.
// - Operands: q, k, v and dO as [B, L, H, dh] through four element
//   strides (`Heads`).  Where TMA can describe one (the head dimension the
//   unit stride, the others multiples of 16 bytes, a 16-byte aligned base),
//   a tile is one 4-D box (dh, L, H, B) = (64, 64, 1, 1) of its tensor
//   map at (64 j, l0, h, b), rows past L and columns past dh arriving as
//   zeros; otherwise the producer warp loads
//   it with ordinary loads into the same swizzled layout (the "direct"
//   route, as gemm_bf16.cuh's).  A launch takes one route for all its
//   operands and reports it (`last_route`).
// - Products: wgmma.m64n64k16 with both operands in shared memory, or
//   with A from registers (a score tile converted to bf16 in place: the
//   accumulator's fragment of two neighbouring 8-column blocks is the A
//   fragment of one 16-deep step).
// - A warpgroup of four consumer warps computes; one producer warp keeps
//   the loads ahead of it, signalling full barriers (bytes counted by
//   TMA) and waiting on empty ones, every wait bounded (gemm_bf16.cuh
//   `bar_wait` traps after about 2^28 polls).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "gemm_bf16.cuh"
#include "head_dims.cuh"

namespace attn_sm90 {
// internal linkage: each library that includes this has its own kernels
// and launch state
namespace {

using gemm_bf16::bar_arrive;
using gemm_bf16::bar_arrive_tx;
using gemm_bf16::bar_init;
using gemm_bf16::bar_wait;
using gemm_bf16::bf16;
using gemm_bf16::sw_desc;
using gemm_bf16::sw_offset;
using tf32x3::smem_addr;

constexpr int TW = 64;                  // head columns of a tile
constexpr int TILE = 64;                // rows of a tile, keys of a key tile
constexpr int ROW_BYTES = TW * 2;       // one swizzle row
constexpr int TILE_BYTES = TILE * ROW_BYTES;   // 8 KB, atom aligned
constexpr int CONSUMERS = 128;          // one warpgroup
constexpr int THREADS = CONSUMERS + 32; // and the producer warp
constexpr int ALIGN = 1024;             // the swizzle atom
// start-address step of one 16-deep product: 16 head columns of a K-major
// tile (32 bytes), or 16 rows of an MN-major one
constexpr int K16_K = 32;
constexpr int K16_MN = 16 * ROW_BYTES;
static_assert(ROW_BYTES == gemm_bf16::SW_ROW, "a tile row is a swizzle row");
static_assert(K16_K == gemm_bf16::K16_STEP_K &&
                  K16_MN == gemm_bf16::K16_STEP_MN,
              "the GEMM core's descriptor steps");

// tiles of an operand of head width dh
__host__ __device__ constexpr int tiles_of(int dh) {
  return (dh + TW - 1) / TW;
}

// element (b, l, h, d) at p[b sb + l sl + h sh + d sd], l < L
struct Heads {
  const bf16* p;
  long long sb, sl, sh, sd;
  int L;
};

// ---------------------------------------------------------------------------
// Loads (producer warp)

// box (d0, l0, h, b) of a 4-D tensor map into dst, completing on bar
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          int d0, int l0, int h, int b,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(d0), "r"(l0), "r"(h), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// The warp writes rows [l0, l0 + 64), head columns [d0, d0 + 64) of head
// (b, h) of o (head width dh) into dst in the swizzled layout, zeros past
// L and past dh (the direct route).
__device__ __forceinline__ void load_direct(unsigned char* dst,
                                            const Heads& o, int b, int h,
                                            int l0, int d0, int dh) {
  const int lane = threadIdx.x % 32;
  const bf16 zero = __float2bfloat16(0.f);
  const bf16* base = o.p + (long long)b * o.sb + (long long)h * o.sh;
  for (int e = lane; e < TILE * TW; e += 32) {
    const int r = e / TW, d = e % TW;
    const bf16 v = l0 + r < o.L && d0 + d < dh
        ? base[(long long)(l0 + r) * o.sl + (long long)(d0 + d) * o.sd]
        : zero;
    *reinterpret_cast<bf16*>(dst + sw_offset(true, r, d)) = v;
  }
}

// The producer warp fills the NT tiles of each of N operands of head
// width DH (operand i from o[i], map[i], rows from l0[i], its tile j into
// dst[i] + j TILE_BYTES) and signals `bar` once they have all landed.
template <int N, int DH>
__device__ __forceinline__ void load_tiles(unsigned char* const* dst,
                                           const Heads* const* o,
                                           const CUtensorMap* const* map,
                                           const int* l0, int b, int h,
                                           bool tma, uint64_t* bar) {
  constexpr int NT = tiles_of(DH);
  const int lane = threadIdx.x % 32;
  if (tma) {
    if (lane == 0) {
      bar_arrive_tx(bar, N * NT * TILE_BYTES);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          tma_load4(dst[i] + j * TILE_BYTES, map[i], TW * j, l0[i], h, b,
                    bar);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      load_direct(dst[i] + j * TILE_BYTES, *o[i], b, h, l0[i], TW * j, DH);
  // the stores, visible to wgmma's async proxy, then one arrival
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) bar_arrive(bar);
}

// ---------------------------------------------------------------------------
// wgmma m64n64k16, f32 += bf16 x bf16

#define ATTN_SM90_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ATTN_SM90_D32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d += A B, A (64 x 16) and B (16 x 64) from shared memory; TA / TB: the
// operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float d[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ATTN_SM90_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : ATTN_SM90_D8(0), ATTN_SM90_D8(8), ATTN_SM90_D8(16), ATTN_SM90_D8(24)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A B, A (64 x 16) from registers (each warp's 16 rows as the
// m16n8k16 A fragment), B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float d[32], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ATTN_SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : ATTN_SM90_D8(0), ATTN_SM90_D8(8), ATTN_SM90_D8(16), ATTN_SM90_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}
#undef ATTN_SM90_D8
#undef ATTN_SM90_D32

__device__ __forceinline__ uint64_t desc(uint32_t addr, int mn) {
  return sw_desc(addr, mn ? gemm_bf16::LBO_MN : gemm_bf16::LBO_K);
}

// d += A B over a depth of 64, A and B 64 x 64 tiles at shared addresses
// a and b (TA / TB: read MN-major)
template <int TA, int TB>
__device__ __forceinline__ void tile_ss(float d[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_ss<TA, TB>(d, desc(a + k * (TA ? K16_MN : K16_K), TA),
                     desc(b + k * (TB ? K16_MN : K16_K), TB));
}

// d += A B over a depth of 64, A in registers (a[k]: the fragment of depth
// 16k..16k+15), B a tile at b (TB: read MN-major)
template <int TB>
__device__ __forceinline__ void tile_rs(float d[32], uint32_t a[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_rs<TB>(d, a[k], desc(b + k * (TB ? K16_MN : K16_K), TB));
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float d[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void zero(float d[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}
// the four consumer warps meet (named barrier 1; the producer warp is not
// in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// The A fragments of a 64 x 64 accumulator tile (rows m, columns the depth
// of the next product), rounded to bf16: the fragment of depth step k is
// the accumulator's 8-column blocks 2k and 2k+1.  With `lo`, the rounding
// error of each value as a second bf16 term (hi + lo carries 16 bits).
__device__ __forceinline__ void to_a(const float d[32], uint32_t a[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[k][j] = gemm_bf16::pack2(d[8 * k + 2 * j], d[8 * k + 2 * j + 1]);
}
__device__ __forceinline__ void to_a_lo(const float d[32], uint32_t a[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = d[8 * k + 2 * j], x1 = d[8 * k + 2 * j + 1];
      a[k][j] = gemm_bf16::pack2(
          x0 - __bfloat162float(__float2bfloat16(x0)),
          x1 - __bfloat162float(__float2bfloat16(x1)));
    }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// The additive bias of a row at key kj through its key stride sk, the key
// clamped into the row: a key past Lk reads the row's last one (its score
// is -inf whatever the bias), so the load needs no branch.  The caller
// points the row of a query past Lq at the last query's row the same way.
template <class BiasT>
__device__ __forceinline__ float bias_at(const BiasT* row, int kj, int Lk,
                                         long long sk) {
  return to_f(row[(long long)min(kj, Lk - 1) * sk]);
}

// The softmax runs in log2 units: scores times log2(e), 2^x on the SFU
// (ex2.approx.ftz: about 2^-22 relative error, 0 for -inf), which takes a
// third of the instructions of expf on the cores' elementwise path.
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Host side

// Encodes o, of head width dh, as a 4-D tensor map (dh, L, H, B) with
// (64, 64, 1, 1) boxes if TMA can describe it; returns whether it did.
__host__ inline bool encode(CUtensorMap* slot, const Heads& o, int B, int H,
                            int dh) {
  const gemm_bf16::EncodeTiled fn = gemm_bf16::encoder();
  if (fn == nullptr || o.sd != 1 || ((uintptr_t)o.p & 15) != 0) return false;
  const long long n[3] = {o.L, H, B};
  const long long s[3] = {o.sl, o.sh, o.sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // a dimension of extent 1 is never stepped: any valid stride will do
    const long long bytes = n[i] == 1 ? 16 : s[i] * 2;
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= (1ll << 40)) return false;
    strides[i] = (cuuint64_t)bytes;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)o.L, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint32_t box[4] = {TW, TILE, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(slot, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)o.p, dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The route of this library's last attention launch: 1 every operand by
// TMA, 0 loaded directly, -1 none yet.
__host__ inline int& last_route() {
  static int route = -1;
  return route;
}

// Resident blocks of `Kernel` on one SM at `smem` bytes, once per device.
template <auto Kernel>
__host__ inline int blocks_per_sm(int smem) {
  constexpr int MAX_DEVICES = 64;
  static int count[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 1;
  if (count[dev] == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count[dev], Kernel,
                                                    THREADS, smem) !=
          cudaSuccess)
    return 1;
  return count[dev] > 0 ? count[dev] : 1;
}

}  // namespace
}  // namespace attn_sm90
