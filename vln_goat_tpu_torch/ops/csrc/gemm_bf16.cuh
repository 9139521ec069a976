// Tensor-core GEMM core of the fused attention in bfloat16: bf16 operands,
// float32 sums, as the JAX package's bf16 model computes its products
// (`_bdot(..., dt=bf16)` with preferred_element_type=float32,
// vln_goat_tpu/ops/attention.py:120-137).
//
// The bf16 counterpart of gemm_tf32x3.cuh, with the same two levels and the
// same job table, so qkv_proj.cuh and the kernels run either core:
//
// - fragment level: `warp_mma_16x32`, a warp's 16 x 32 tile over a depth
//   of 64 on `mma.sync.aligned.m16n8k16` bf16 fragments.  The operands are
//   read through accessors that return float and are rounded to bf16 to
//   nearest when the fragment is built: values that already are bf16 pass
//   exactly, float32 ones (the probabilities p before p v, the score
//   gradients ds) take the JAX package's cast before the product.  Each
//   16-deep step's product starts from zero and is added into the float32
//   accumulator, as in gemm_tf32x3.cuh.
// - block level: `gemm_block`, one 128 x 128 output tile of a job
//   C = A B (+ bias) over a range of the depth, two warpgroups of 64 x 128
//   on `wgmma.mma_async.m64n128k16.f32.bf16.bf16`: one product per 16-deep
//   step where the 3xTF32 split takes three per 8-deep step, and no
//   big/small split.  A (bf16) is read from shared memory into registers,
//   whatever its layout.  B is read by wgmma from shared memory in the
//   K-major core-matrix layout (8 rows of 16 bytes, LBO 128 B along K, SBO
//   512 B to the next 8 rows, no swizzle).  A B whose depth is the unit
//   stride (the projections' weights, `lin.weight.t()`) is copied by
//   cp.async straight into that layout, with no pass over it; a B whose
//   columns are the unit stride (dx = dq Wq^T, dW = x^T dq) is staged as
//   it lies and transposed into it once per chunk.  The two-stage cp.async
//   ring, the split-K slices, the two-segment depth, the bias epilogue and
//   the column sums of B are gemm_tf32x3.cuh's.  The epilogue writes C as
//   float32 or rounds it to bf16 (`c_bf16`).
//
// Operands need one unit stride, the other a multiple of 8 elements and a
// 16-byte aligned base for the 16-byte copies; anything else is loaded
// element by element.
//
// wgmma's sums over a 16-deep step are exact for bf16 operands up to the
// tensor cores' truncated accumulation, which gemm_tf32x3.cuh's note
// describes and which applies here unchanged.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tf32x3.cuh"

namespace gemm_bf16 {

using bf16 = __nv_bfloat16;
using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::smem_addr;

// ---------------------------------------------------------------------------
// Fragment level

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b for one m16n8k16 bf16 fragment triple
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[ni] += A[m0 : m0+16, 0:64] B[0:64, n0 + 8 ni : n0 + 8 ni + 8] for
// ni < 4, A(m, k) and B(k, n) read through the accessors as float and
// rounded to bf16.  Fragment layout of m16n8k16 (g = lane / 4,
// t = lane % 4): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); b0 (2t..2t+1, g), b1 (2t+8..2t+9, g); c as m16n8k8.
template <class AF, class BF>
__device__ __forceinline__ void warp_mma_16x32(float acc[4][4], AF a, BF b,
                                               int m0, int n0) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < 64; k0 += 16) {
    uint32_t af[4];
    af[0] = pack2(a(m0 + g, k0 + 2 * t), a(m0 + g, k0 + 2 * t + 1));
    af[1] = pack2(a(m0 + g + 8, k0 + 2 * t), a(m0 + g + 8, k0 + 2 * t + 1));
    af[2] = pack2(a(m0 + g, k0 + 2 * t + 8), a(m0 + g, k0 + 2 * t + 9));
    af[3] = pack2(a(m0 + g + 8, k0 + 2 * t + 8),
                  a(m0 + g + 8, k0 + 2 * t + 9));
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + 8 * ni + g;
      uint32_t bf[2];
      bf[0] = pack2(b(k0 + 2 * t, n), b(k0 + 2 * t + 1, n));
      bf[1] = pack2(b(k0 + 2 * t + 8, n), b(k0 + 2 * t + 9, n));
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(part, af, bf);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] += part[e];
    }
  }
}

// An element of either type as float, for the accessors of the products.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// The fragment product of the element type T: float32 operands in the
// 3xTF32 split (gemm_tf32x3.cuh), bf16 ones on bf16 fragments.
template <class T, class AF, class BF>
__device__ __forceinline__ void warp_mma(float acc[4][4], AF a, BF b, int m0,
                                         int n0) {
  if constexpr (sizeof(T) == 4) tf32x3::warp_mma_16x32(acc, a, b, m0, n0);
  else warp_mma_16x32(acc, a, b, m0, n0);
}

// ---------------------------------------------------------------------------
// Block level

// 128 x 128 output tiles, 32-deep chunks (the plan's tile, ops/bwd_plan.py),
// two chunks in flight; two warpgroups of 64 x 128 each
constexpr int BM = tf32x3::BM, BN = tf32x3::BN, BK = tf32x3::BK;
constexpr int STAGES = 2, THREADS = tf32x3::THREADS;
constexpr int LDK = BK + 8;          // staged row with k contiguous (80 B)
constexpr int LDR = BM + 8;          // staged row with the rows contiguous
static_assert(BM == BN, "one staging stride serves A and B");
constexpr int A_STAGE = BM * LDK > BK * LDR ? BM * LDK : BK * LDR;
constexpr int B_RAW = BK * LDR;      // a B chunk whose columns are unit stride
constexpr int B_CORE = BN * BK;      // a B chunk in wgmma's layout
constexpr int CS_PARTS = THREADS / BN;
constexpr size_t SMEM_BYTES =
    STAGES * (A_STAGE + B_RAW + B_CORE) * sizeof(bf16) +
    CS_PARTS * BN * sizeof(float);
// core matrices: 8 rows x 16 bytes; BK / 8 of them along K per 8 rows
constexpr int CORE_ROW = BK * 8;     // elements from one 8-row group to the next

// element (r, k) at p[r * sr + k * sk]: r is A's row m or B's column n
struct Operand {
  const bf16* p;
  long long sr, sk;
  int vec;   // 16-byte copies: unit stride, other stride % 8 == 0, aligned
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
  long long c_sm, c_sn, c_split;
  const bf16* bias;    // [n] added in the epilogue, or null
  float* colsum;       // [n] of slice s at colsum + s n, or null
  int block0, blocks;  // the job's blocks in the launch
};

__host__ inline Operand make_operand(const void* p, long long sr,
                                     long long sk) {
  Operand o;
  o.p = (const bf16*)p;
  o.sr = sr;
  o.sk = sk;
  const bool aligned = ((uintptr_t)p & 15) == 0;
  o.vec = aligned && ((sk == 1 && sr % 8 == 0) || (sk != 1 && sr == 1 &&
                                                    sk % 8 == 0));
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

// K-major: the depth is the unit stride, or neither is
__device__ __forceinline__ bool k_major(const Operand& o) {
  return o.sk == 1 || o.sr != 1;
}

// offset of element (r, k) of a chunk in the core-matrix layout
__device__ __forceinline__ int core_at(int r, int k) {
  return (r >> 3) * CORE_ROW + (k >> 3) * 64 + (r & 7) * 8 + (k & 7);
}

// Loads the R x BK chunk at rows r0, depth k0 (limits rlim, klim; zeros
// past them).  K-major operands go to `kdst`: laid out s[r * LDK + k], or,
// with `core`, in the core-matrix layout; the others to `rdst` laid out
// s[k * LDR + r].  16-byte copies where the operand allows them (async),
// element loads otherwise.
template <int R>
__device__ __forceinline__ void load_chunk(bf16* kdst, bf16* rdst,
                                           const Operand& o, int r0,
                                           int rlim, int k0, int klim,
                                           bool core) {
  constexpr int CH = R * BK / 8;      // 8-element pieces
  const bf16 zero = __float2bfloat16(0.f);
  if (k_major(o)) {
    for (int c = threadIdx.x; c < CH; c += THREADS) {
      const int r = c / (BK / 8), k = (c % (BK / 8)) * 8;
      const int gr = r0 + r, gk = k0 + k;
      int nk = gr < rlim ? klim - gk : 0;
      nk = nk < 0 ? 0 : (nk > 8 ? 8 : nk);
      const bf16* src = o.p + (long long)gr * o.sr + (long long)gk * o.sk;
      bf16* d = kdst + (core ? core_at(r, k) : r * LDK + k);
      if (o.vec) {
        cp_async16(d, nk ? src : o.p, 2 * nk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = e < nk ? src[e * o.sk] : zero;
      }
    }
  } else {
    for (int c = threadIdx.x; c < CH; c += THREADS) {
      const int k = c / (R / 8), r = (c % (R / 8)) * 8;
      const int gr = r0 + r, gk = k0 + k;
      int nr = gk < klim ? rlim - gr : 0;
      nr = nr < 0 ? 0 : (nr > 8 ? 8 : nr);
      const bf16* src = o.p + gr + (long long)gk * o.sk;
      bf16* d = rdst + k * LDR + r;
      if (o.vec) {
        cp_async16(d, nr ? src : o.p, 2 * nr);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = e < nr ? src[e] : zero;
      }
    }
  }
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

// d[64] += A (registers, m64 x k16 fragment of this warp's 16 rows) times
// B (shared memory through desc, k16 x n128, K-major, no swizzle)
__device__ __forceinline__ void wgmma_128(float d[64], const uint32_t a[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Descriptor of the K-major core-matrix layout without swizzle: the next
// core matrix along K 128 bytes on (LBO 8 x 16 B), the next 8-row group
// BK / 8 x 128 = 512 bytes on (SBO 32 x 16 B).
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)8 << 16) |
         ((uint64_t)(CORE_ROW * sizeof(bf16) / 16) << 32);
}

// A's fragment of one 16-deep step (k16 < BK / 16) for this warp's rows,
// from the staged chunk (K-major s[r * LDK + k], else s[k * LDR + r])
template <bool AK>
__device__ __forceinline__ void a_frag(uint32_t af[4], const bf16* a, int wm,
                                       int k16) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k = 16 * k16 + 2 * t;
  auto pair = [&](int r, int kk) -> uint32_t {
    if (AK) return *reinterpret_cast<const uint32_t*>(a + r * LDK + kk);
    __nv_bfloat162 v;
    v.x = a[kk * LDR + r];
    v.y = a[(kk + 1) * LDR + r];
    return *reinterpret_cast<const uint32_t*>(&v);
  };
  af[0] = pair(wm + g, k);
  af[1] = pair(wm + g + 8, k);
  af[2] = pair(wm + g, k + 8);
  af[3] = pair(wm + g + 8, k + 8);
}

// One block computes tile `tile` of slice `s` of job `j` (j in shared
// memory); smem holds SMEM_BYTES.  Per chunk: A and a K-major B arrive by
// cp.async (B straight into wgmma's layout), a B with unit-stride columns
// is transposed into it, each warp reads its 16 rows of A into registers,
// and each warpgroup issues one m64n128k16 product per 16-deep step into
// its 64 float32 accumulators; the next chunk's cp.async overlaps them.
__device__ __forceinline__ void gemm_block(const GemmJob& j, int s, int tile,
                                           unsigned char* smem_raw) {
  const int tm = tile / j.tiles_n, tn = tile % j.tiles_n;
  const int m0 = tm * BM, n0 = tn * BN;
  const int K = j.seg[0].k + (j.nseg == 2 ? j.seg[1].k : 0);
  const int kbeg = s * j.kc;
  const int kend = min(K, kbeg + j.kc);
  const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Braw = As + STAGES * A_STAGE;
  bf16* Bcore = Braw + STAGES * B_RAW;
  float* red = reinterpret_cast<float*>(Bcore + STAGES * B_CORE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 4) * 64 + (warp % 4) * 16;
  const bool colsum = j.colsum != nullptr && tm == 0;
  const int cs_n = tid % BN, cs_part = tid / BN;
  constexpr int CS_ROWS = BK / CS_PARTS;
  float csum = 0.f;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  auto load = [&](int kt) {
    const int k = kbeg + kt * BK;
    int base;
    const Seg& sg = j.seg[seg_of(j, k, base)];
    const int klim = min(kend, base + sg.k) - base;
    const int st = kt % STAGES;
    load_chunk<BM>(As + st * A_STAGE, As + st * A_STAGE, sg.a, m0, j.m,
                   k - base, klim, false);
    load_chunk<BN>(Bcore + st * B_CORE, Braw + st * B_RAW, sg.b, n0, j.n,
                   k - base, klim, true);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_async_commit();

    int base;
    const Seg& sg = j.seg[seg_of(j, kbeg + kt * BK, base)];
    const bf16* a = As + (kt % STAGES) * A_STAGE;
    const bf16* braw = Braw + (kt % STAGES) * B_RAW;
    bf16* bcore = Bcore + (kt % STAGES) * B_CORE;
    const bool bk = k_major(sg.b);
    if (!bk) {
      // B chunk [k][n] -> core matrices, one 16-byte row (8 k of one n)
      // a thread at a time
      for (int c = tid; c < BN * BK / 8; c += THREADS) {
        const int n = c % BN, k = (c / BN) * 8;
        __align__(16) bf16 row[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) row[e] = braw[(k + e) * LDR + n];
        *reinterpret_cast<uint4*>(bcore + core_at(n, k)) =
            *reinterpret_cast<const uint4*>(row);
      }
      __syncthreads();
    }
    if (colsum) {
#pragma unroll
      for (int k = 0; k < CS_ROWS; ++k) {
        const int kk = cs_part * CS_ROWS + k;
        csum += __bfloat162float(bk ? bcore[core_at(cs_n, kk)]
                                    : braw[kk * LDR + cs_n]);
      }
    }
    uint32_t af[BK / 16][4];
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
      if (k_major(sg.a)) a_frag<true>(af[k16], a, wm, k16);
      else a_frag<false>(af[k16], a, wm, k16);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    tf32x3::fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16)
      wgmma_128(d, af[k16], wg_desc(bcore + 128 * k16));   // 2 core matrices
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    tf32x3::fence_acc(d);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gm = m0 + wm + g + (e >= 2 ? 8 : 0);
      const int gn = n0 + 8 * i + 2 * t + (e & 1);
      if (gm < j.m && gn < j.n) {
        const float v = d[4 * i + e] +
            (j.bias != nullptr ? __bfloat162float(j.bias[gn]) : 0.f);
        const long long o =
            (long long)s * j.c_split + (long long)gm * j.c_sm +
            (long long)gn * j.c_sn;
        if (j.c_bf16) static_cast<bf16*>(j.c)[o] = __float2bfloat16(v);
        else static_cast<float*>(j.c)[o] = v;
      }
    }
  }
  if (colsum) {
    red[cs_part * BN + cs_n] = csum;
    __syncthreads();
    if (tid < BN && n0 + tid < j.n) {
      float sum = red[tid];
#pragma unroll
      for (int p = 1; p < CS_PARTS; ++p) sum += red[p * BN + tid];
      j.colsum[(long long)s * j.n + n0 + tid] = sum;
    }
  }
}

}  // namespace gemm_bf16
