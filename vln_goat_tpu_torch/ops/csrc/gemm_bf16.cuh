// Tensor-core GEMM core of the fused attention in bfloat16: bf16 operands,
// float32 sums, as the JAX package's bf16 model computes its products
// (`_bdot(..., dt=bf16)` with preferred_element_type=float32,
// vln_goat_tpu/ops/attention.py:120-137).
//
// `gemm_kernel`: one persistent launch over a table of
// GEMM jobs C = A B (+ bias), written for Hopper:
//   * one block per SM walks the launch's work units (a 128 x 256 output
//     tile of one split-K slice of one job, then the elementwise head-sum
//     units) in the planned order, unit u on block u % grid, so one tile's
//     epilogue overlaps the next tile's loads.  The tile is 256 wide
//     because it ran faster than a 128-wide one on the card
//     (ops/bwd_plan.py TILE_N_BF16): a 64-deep chunk of a 128 x 256 tile
//     moves 48 KB for 4.2 MFLOP, a 128 x 128 one 32 KB for 2.1;
//   * a producer warp brings 64-deep chunks of A and B (64 bf16 = 128
//     bytes, one row of the 128-byte swizzle) into a ring of STAGES stages
//     with TMA (`cp.async.bulk.tensor.2d`, one tensor map per operand,
//     encoded on the host), signalling a full barrier per stage and
//     waiting on an empty one; out-of-bounds rows and depth arrive as zeros,
//     which replaces per-element limits at the ragged edges;
//   * two consumer warpgroups, 64 rows of the tile each, read both
//     operands from the stage with `wgmma.mma_async m64n256k16` through
//     128-byte-swizzled descriptors, K-major or MN-major (the transpose
//     bits), so no operand passes through registers or a transpose pass;
//     one chunk's products stay in flight while the next chunk's are
//     issued (`wgmma.wait_group 1`), and the stage they leave is released;
//   * `setmaxnreg` moves registers from the producer to the consumers.
//   An operand TMA cannot describe (a stride that is not a multiple of 16
//   bytes, a base that is not 16-byte aligned, neither stride the unit) is
//   loaded by the producer warp with ordinary loads into the same swizzled
//   stage, arriving on the same barrier: the "direct" route, which
//   `launch` reports beside the TMA route.
//   A job may split its depth into slices (split-K: slice s writes its
//   partial tile at c + s c_split, added by the caller in a fixed order),
//   may take its depth from two segments with their own operands
//   (dy = dk Wk^T + dv Wv^T), adds an optional bias in the epilogue, writes
//   C as float32 or rounded to bf16 (`c_bf16`), and may write the column
//   sums of B over its slice (the bias gradient db = 1^T dq beside
//   dW = x^T dq), read from the swizzled stage.  No atomics: two launches
//   give the same bits.
//
// wgmma's sums over a 16-deep step are exact for bf16 operands up to the
// tensor cores' truncated accumulation, which gemm_tf32x3.cuh's note
// describes and which applies here unchanged.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tf32x3.cuh"

namespace gemm_bf16 {

using bf16 = __nv_bfloat16;
using tf32x3::smem_addr;

// two floats rounded to bf16 (to nearest) in one 32-bit word, lo first
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Block level
//
// Internal linkage: each library that includes this has its own kernel and
// its own launch state (the shared-memory attribute set once per device,
// the route of the last launch); a template's or an inline function's
// static would otherwise be one object across the libraries loaded in a
// process.
namespace {

// 128 x 256 output tiles (the plan's tile, ops/bwd_plan.py TILE_N_BF16)
// over 64-deep chunks; STAGES chunks of A and B in flight
constexpr int BM = 128, BN = 256, BK = 64;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                 // warpgroups of 64 x 256
constexpr int THREADS = 128 * (CONSUMERS + 1);   // and a producer warpgroup
constexpr int HSUM_THREADS = 128 * CONSUMERS;    // elements a head-sum unit
constexpr int MAX_JOBS = 5;
constexpr int MAX_MAPS = 12;                 // tensor maps of a launch
// The 128-byte swizzle: a chunk row of 64 bf16 is 128 bytes, its 16-byte
// pieces permuted by XOR with the row's index mod 8, in atoms of 8 rows.
constexpr int SW_ROW = 128;
constexpr int SW_ATOM = 8 * SW_ROW;
// An operand's chunk in a stage: K-major, its rows (BM of A, BN of B) of
// 64 depth values; MN-major, blocks of 64 rows (m or n), each 64 depth
// rows of 128 B, one after the other.
constexpr int A_BYTES = BM * BK * 2;         // 16 KB
constexpr int B_BYTES = BN * BK * 2;         // 32 KB
constexpr int MN_BLOCK = BK * SW_ROW;        // 8 KB: one block of 64 rows
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;   // A, then B
// Descriptor strides (bytes): SBO from one 8-row atom to the next along
// the non-contiguous dimension (1024 in both forms); LBO between the
// 64-wide blocks of an MN-major operand (K-major: unused, 16).
constexpr int SBO = SW_ATOM;
constexpr int LBO_MN = MN_BLOCK;
constexpr int LBO_K = 16;
// start-address step of one 16-deep product: 16 values along a K-major
// row (32 B, inside the swizzle atom), or 16 depth rows of an MN-major
// chunk (2 atoms)
constexpr int K16_STEP_K = 32;
constexpr int K16_STEP_MN = 16 * SW_ROW;
constexpr size_t smem_bytes(int stages) {
  return SW_ATOM                             // room to align the ring
         + stages * STAGE_BYTES              // the ring
         + 2 * stages * sizeof(uint64_t);    // full and empty barriers
}
constexpr size_t SMEM_BYTES = smem_bytes(STAGES);

// element (r, k) at p[r * sr + k * sk]: r is A's row m or B's column n
struct Operand {
  const bf16* p;
  long long sr, sk;
  int kmajor;   // the depth is the unit stride, or neither stride is
  int map;      // its tensor map in the launch, or -1: loaded directly
};

struct Seg {
  Operand a, b;
  int k;
};

struct GemmJob {
  Seg seg[2];
  int nseg;            // two only with seg[0].k % BK == 0
  int m, n;
  int tiles_m, tiles_n;
  int splits, kc;      // slice s: depth [s kc, min((s+1) kc, K)), kc % BK == 0
  void* c;             // C(m, n) of slice s at c[s c_split + m c_sm + n c_sn]
  int c_bf16;          // C in bf16 (rounded to nearest), else float32
  int c_pair;          // two neighbouring columns stored as one word
  long long c_sm, c_sn, c_split;
  const bf16* bias;    // [n] added in the epilogue, or null
  float* colsum;       // [n] of slice s at colsum + s n, or null
  int block0, blocks;  // the job's work units (tiles x slices) in the launch
};

// The launch's argument, a __grid_constant__ kernel parameter (the tensor
// maps must lie in parameter, constant or global memory).
struct Params {
  CUtensorMap map[MAX_MAPS];
  GemmJob job[MAX_JOBS];
  int njobs;
  int gemm_units;      // GEMM work units; the head-sum units follow
  int units;
  // dbias[b, 0, q, k] = sum over h of ds[b, h, q, k] (fixed order)
  const float* ds;
  float* dbias;
  int H;
  long long hsum_qk;   // Lq * Lk
  long long hsum_n;    // B * Lq * Lk (0: none)
};

__host__ inline Operand make_operand(const void* p, long long sr,
                                     long long sk) {
  Operand o;
  o.p = (const bf16*)p;
  o.sr = sr;
  o.sk = sk;
  o.kmajor = sk == 1 || sr != 1;
  o.map = -1;
  return o;
}

__host__ inline void set_job(GemmJob& j, int m, int n, int k_total,
                             int splits, int kc, void* c, int c_bf16,
                             long long c_sm, long long c_sn,
                             long long c_split) {
  j.nseg = 0;
  j.m = m;
  j.n = n;
  j.tiles_m = (m + BM - 1) / BM;
  j.tiles_n = (n + BN - 1) / BN;
  j.splits = splits;
  j.kc = kc > 0 ? kc : ((k_total + BK - 1) / BK) * BK;
  j.c = c;
  j.c_bf16 = c_bf16;
  const size_t es = c_bf16 ? sizeof(bf16) : sizeof(float);
  j.c_pair = c_sn == 1 && c_sm % 2 == 0 && c_split % 2 == 0 &&
             (uintptr_t)c % (2 * es) == 0;
  j.c_sm = c_sm;
  j.c_sn = c_sn;
  j.c_split = c_split;
  j.bias = nullptr;
  j.colsum = nullptr;
  j.blocks = j.tiles_m * j.tiles_n * splits;
}

__host__ inline void add_seg(GemmJob& j, Operand a, Operand b, int k) {
  j.seg[j.nseg].a = a;
  j.seg[j.nseg].b = b;
  j.seg[j.nseg].k = k;
  ++j.nseg;
}

// ---------------------------------------------------------------------------
// PTX helpers: barriers, TMA, wgmma

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Waits for the phase of `bar` after `parity` to complete.  A wait that
// outlasts about 2^28 polls (seconds) traps: a pipeline fault then ends
// the launch with an error instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// box of `map` at (c0 innermost, c1) into dst, completing bytes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at smem address `addr`
// (the atoms 1024-byte aligned; base offset 0)
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, int lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(SBO >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// byte offset of element (r, k) of an operand chunk, where TMA's 128-byte
// swizzle puts it (and where the direct route writes it)
__device__ __forceinline__ int sw_offset(bool kmajor, int r, int k) {
  if (kmajor)
    return r * SW_ROW + ((((k >> 3) ^ (r & 7))) << 4) + (k & 7) * 2;
  return (r >> 6) * MN_BLOCK + k * SW_ROW +
         (((((r & 63) >> 3) ^ (k & 7))) << 4) + (r & 7) * 2;
}

// d[128] += A (64 x 16, descriptor da) B (16 x 256, descriptor db); TA /
// TB: the operand is MN-major (transposed)
#define GEMM_BF16_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float d[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : GEMM_BF16_D8(0), GEMM_BF16_D8(8), GEMM_BF16_D8(16),
        GEMM_BF16_D8(24), GEMM_BF16_D8(32), GEMM_BF16_D8(40),
        GEMM_BF16_D8(48), GEMM_BF16_D8(56), GEMM_BF16_D8(64),
        GEMM_BF16_D8(72), GEMM_BF16_D8(80), GEMM_BF16_D8(88),
        GEMM_BF16_D8(96), GEMM_BF16_D8(104), GEMM_BF16_D8(112),
        GEMM_BF16_D8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
#undef GEMM_BF16_D8

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float d[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the four 16-deep products of one chunk: A at smem address a (this
// warpgroup's 64 rows), B at b
template <int TA, int TB>
__device__ __forceinline__ void chunk_mma(float d[128], uint32_t a,
                                          uint32_t b) {
  constexpr int sa = TA ? K16_STEP_MN : K16_STEP_K;
  constexpr int sb = TB ? K16_STEP_MN : K16_STEP_K;
#pragma unroll
  for (int k16 = 0; k16 < BK / 16; ++k16)
    wgmma_256<TA, TB>(d, sw_desc(a + k16 * sa, TA ? LBO_MN : LBO_K),
                      sw_desc(b + k16 * sb, TB ? LBO_MN : LBO_K));
}

// ---------------------------------------------------------------------------
// The persistent kernel

// Work unit u < gemm_units of the launch: its job, slice, tile origin and
// depth range [kbeg, kend).
struct Unit {
  int job, s, tm, m0, n0, kbeg, kend;
};

__device__ __forceinline__ Unit unit_of(const Params& P, int u) {
  Unit w;
  w.job = 0;
#pragma unroll
  for (int i = 1; i < MAX_JOBS; ++i)
    if (i < P.njobs && u >= P.job[i].block0) w.job = i;
  const GemmJob& j = P.job[w.job];
  const int local = u - j.block0, tiles = j.tiles_m * j.tiles_n;
  w.s = local / tiles;
  const int tile = local % tiles;
  w.tm = tile / j.tiles_n;
  w.m0 = w.tm * BM;
  w.n0 = (tile % j.tiles_n) * BN;
  const int K = j.seg[0].k + (j.nseg == 2 ? j.seg[1].k : 0);
  w.kbeg = w.s * j.kc;
  w.kend = min(K, w.kbeg + j.kc);
  return w;
}

// the segment that holds depth k of the job, and k's offset in it
__device__ __forceinline__ int seg_of(const GemmJob& j, int k, int& base) {
  if (j.nseg == 2 && k >= j.seg[0].k) {
    base = j.seg[0].k;
    return 1;
  }
  base = 0;
  return 0;
}

// The producer warp's share of one operand's chunk: rows [r0, r0 + R)
// (limit rlim), depth [k0, k0 + 64) of the segment (limit klim).  A TMA
// operand is left to lane 0 after the barrier's byte count is set (its
// bytes returned); a direct one is written here by the warp's lanes.
template <int R>
__device__ __forceinline__ int load_direct(unsigned char* dst,
                                           const Operand& o, int r0,
                                           int rlim, int k0, int klim) {
  if (o.map >= 0) return R * BK * 2;
  const int lane = threadIdx.x % 32;
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = lane; e < R * BK; e += 32) {
    const int r = o.kmajor ? e / BK : e % R;
    const int k = o.kmajor ? e % BK : e / R;
    const int gr = r0 + r, gk = k0 + k;
    const bf16 v = gr < rlim && gk < klim
        ? o.p[(long long)gr * o.sr + (long long)gk * o.sk] : zero;
    *reinterpret_cast<bf16*>(dst + sw_offset(o.kmajor, r, k)) = v;
  }
  return 0;
}

// TMA loads of an operand's chunk of R rows: one box K-major, R / 64
// boxes MN-major
template <int R>
__device__ __forceinline__ void load_tma(const Params& P, unsigned char* dst,
                                         const Operand& o, int r0, int k0,
                                         uint64_t* bar) {
  if (o.map < 0) return;
  const CUtensorMap* m = &P.map[o.map];
  if (o.kmajor) {
    tma_load(dst, m, k0, r0, bar);
  } else {
#pragma unroll
    for (int h = 0; h < R / 64; ++h)
      tma_load(dst + h * MN_BLOCK, m, r0 + 64 * h, k0, bar);
  }
}

// A template (of the ring's depth, STAGES) so that only a library that
// launches it compiles it.
template <int NSTAGES>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ Params P) {
  constexpr int STAGES = NSTAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_raw + SW_ATOM - 1) & ~(uintptr_t)(SW_ATOM - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: its first warp fills the ring, STAGES chunks ahead
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x % 32;
    int it = 0;
    for (int u = blockIdx.x; u < P.gemm_units; u += gridDim.x) {
      const Unit w = unit_of(P, u);
      const GemmJob& j = P.job[w.job];
      for (int k = w.kbeg; k < w.kend; k += BK, ++it) {
        const int st = it % STAGES;
        bar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        int base;
        const Seg& sg = j.seg[seg_of(j, k, base)];
        const int klim = min(w.kend, base + sg.k) - base;
        unsigned char* a = ring + st * STAGE_BYTES;
        unsigned char* b = a + A_BYTES;
        const int bytes =
            load_direct<BM>(a, sg.a, w.m0, j.m, k - base, klim) +
            load_direct<BN>(b, sg.b, w.n0, j.n, k - base, klim);
        if (bytes < STAGE_BYTES) {
          // the direct route's stores, visible to wgmma's async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
        }
        if (lane == 0) {
          if (bytes) {
            bar_arrive_tx(&full[st], bytes);
            load_tma<BM>(P, a, sg.a, w.m0, k - base, &full[st]);
            load_tma<BN>(P, b, sg.b, w.n0, k - base, &full[st]);
          } else {
            bar_arrive(&full[st]);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x, ctid = tid % 128;   // tid: B's column
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = wg * 64 + (warp % 4) * 16;
  int it = 0;
  for (int u = blockIdx.x; u < P.units; u += gridDim.x) {
    if (u >= P.gemm_units) {
      // head-sum unit: e = b * QK + qk; ds[b, h, q, k] at (b H + h) QK + qk
      const long long e =
          (long long)(u - P.gemm_units) * HSUM_THREADS + tid;
      if (e < P.hsum_n) {
        const long long QK = P.hsum_qk;
        const float* src = P.ds + (e / QK) * P.H * QK + e % QK;
        float acc = 0.f;
        for (int h = 0; h < P.H; ++h) acc += src[h * QK];
        P.dbias[e] = acc;
      }
      continue;
    }
    const Unit w = unit_of(P, u);
    const GemmJob& j = P.job[w.job];
    const bool colsum = j.colsum != nullptr && w.tm == 0;
    float csum = 0.f;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    fence_acc(d);
    int prev = -1;
    for (int k = w.kbeg; k < w.kend; k += BK, ++it) {
      const int st = it % STAGES;
      bar_wait(&full[st], (it / STAGES) & 1);
      int base;
      const Seg& sg = j.seg[seg_of(j, k, base)];
      const unsigned char* a = ring + st * STAGE_BYTES;
      const unsigned char* b = a + A_BYTES;
      if (colsum) {
        // the chunk's 64 depth rows of column tid, in order
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk)
          csum += __bfloat162float(*reinterpret_cast<const bf16*>(
              b + sw_offset(sg.b.kmajor, tid, kk)));
      }
      const uint32_t sa = smem_addr(a) + wg * (64 * SW_ROW);
      const uint32_t sb = smem_addr(b);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      if (sg.a.kmajor) {
        if (sg.b.kmajor) chunk_mma<0, 0>(d, sa, sb);
        else chunk_mma<0, 1>(d, sa, sb);
      } else {
        if (sg.b.kmajor) chunk_mma<1, 0>(d, sa, sb);
        else chunk_mma<1, 1>(d, sa, sb);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous chunk's products are done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(d);
      if (prev >= 0 && ctid == 0) bar_arrive(&empty[prev]);
      prev = st;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    if (prev >= 0 && ctid == 0) bar_arrive(&empty[prev]);

#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = w.m0 + wm + g + 8 * h;
        const int gn = w.n0 + 8 * i + 2 * t;
        if (gm >= j.m || gn >= j.n) continue;
        float v0 = d[4 * i + 2 * h], v1 = d[4 * i + 2 * h + 1];
        if (j.bias != nullptr) {
          v0 += __bfloat162float(j.bias[gn]);
          if (gn + 1 < j.n) v1 += __bfloat162float(j.bias[gn + 1]);
        }
        const long long o = (long long)w.s * j.c_split +
                             (long long)gm * j.c_sm + (long long)gn * j.c_sn;
        if (j.c_bf16) {
          bf16* c = static_cast<bf16*>(j.c) + o;
          if (j.c_pair && gn + 1 < j.n) {
            *reinterpret_cast<__nv_bfloat162*>(c) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            c[0] = __float2bfloat16(v0);
            if (gn + 1 < j.n) c[j.c_sn] = __float2bfloat16(v1);
          }
        } else {
          float* c = static_cast<float*>(j.c) + o;
          if (j.c_pair && gn + 1 < j.n) {
            *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
          } else {
            c[0] = v0;
            if (gn + 1 < j.n) c[j.c_sn] = v1;
          }
        }
      }
    }
    if (colsum && w.n0 + tid < j.n)
      j.colsum[(long long)w.s * j.n + w.n0 + tid] = csum;
  }
}

// ---------------------------------------------------------------------------
// Host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// lookup (so the library needs no link against libcuda); null if missing
__host__ inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Encodes operand o (rows, depth k), loaded `box_rows` rows at a time, as
// tensor map `slot` if TMA can describe it: one unit stride, the other a
// multiple of 16 bytes, a 16-byte aligned base.  Returns whether it did.
__host__ inline bool encode(CUtensorMap* slot, const Operand& o,
                            long long rows, long long k, int box_rows) {
  const EncodeTiled fn = encoder();
  const long long other = o.sk == 1 ? o.sr : o.sk;
  if (fn == nullptr || (o.sk != 1 && o.sr != 1) ||
      ((uintptr_t)o.p & 15) != 0 || (other * 2) % 16 != 0 || other <= 0 ||
      other * 2 >= (1ll << 40))
    return false;
  // K-major: dims (depth, rows), box 64 x box_rows; MN-major: dims (rows,
  // depth), box 64 x 64, loaded box_rows / 64 times
  const cuuint64_t dims[2] = {
      (cuuint64_t)(o.kmajor ? k : rows), (cuuint64_t)(o.kmajor ? rows : k)};
  const cuuint64_t strides[1] = {(cuuint64_t)(other * 2)};
  const cuuint32_t box[2] = {64, (cuuint32_t)(o.kmajor ? box_rows : BK)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(slot, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)o.p, dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device, looked up once per device
__host__ inline int sm_count() {
  constexpr int MAX_DEVICES = 64;
  static int count[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 0 || dev >= MAX_DEVICES) dev = 0;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 1;
  return count[dev];
}

// The route of the last launch of this library's bf16 core: 1 every
// operand through TMA, 0 at least one loaded directly, -1 none yet.
__host__ inline int& last_route() {
  static int route = -1;
  return route;
}

// Numbers the jobs' units, encodes a tensor map for each operand TMA can
// describe, and launches gemm_kernel on min(SMs, units) blocks on
// `stream`.  Returns cudaGetLastError() (0: nothing to launch).  A
// template, as the kernel is, so that only a library that calls it
// compiles the kernel.
template <int NSTAGES = STAGES>
__host__ inline int launch(Params& P, cudaStream_t stream) {
  int units = 0, maps = 0, direct = 0;
  for (int i = 0; i < P.njobs; ++i) {
    GemmJob& j = P.job[i];
    j.block0 = units;
    units += j.blocks;
    for (int s = 0; s < j.nseg; ++s) {
      Seg& sg = j.seg[s];
      Operand* ops[2] = {&sg.a, &sg.b};
      const int rows[2] = {j.m, j.n}, box[2] = {BM, BN};
      for (int q = 0; q < 2; ++q) {
        ops[q]->map = -1;
        if (maps < MAX_MAPS &&
            encode(&P.map[maps], *ops[q], rows[q], sg.k, box[q]))
          ops[q]->map = maps++;
        else
          direct = 1;
      }
    }
  }
  P.gemm_units = units;
  units += (int)((P.hsum_n + HSUM_THREADS - 1) / HSUM_THREADS);
  P.units = units;
  if (units == 0) return 0;
  const cudaError_t e =
      tf32x3::smem_limit<gemm_kernel<NSTAGES>>((int)smem_bytes(NSTAGES));
  if (e != cudaSuccess) return (int)e;
  const int grid = units < sm_count() ? units : sm_count();
  gemm_kernel<NSTAGES><<<grid, THREADS, smem_bytes(NSTAGES), stream>>>(P);
  last_route() = direct ? 0 : 1;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gemm_bf16
