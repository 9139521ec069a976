// Tensor-core GEMM core of the fused attention, float32-accurate.
//
// Products run on the tensor cores with TF32 operands in the 3xTF32
// split: each operand x is cut into big = cvt.rna.tf32(x) and
// small = cvt.rna.tf32(x - big), and a product is small*big + big*small +
// big*big, accumulated in float32 registers.  The dropped small*small term
// is below float32 rounding, so the result keeps float32 accuracy at three
// times the tensor-core work (495 TFLOP/s of TF32 on an H100 SXM is 165
// TFLOP/s of float32-accurate products, against 67 on the CUDA cores).
//
// Two levels:
//
// - fragment level: `split_tf32`, `mma3` and `warp_mma_16x32`, a warp's
//   16 x 32 tile over a depth of 64 (or of a head width) on
//   `mma.sync.aligned.m16n8k8`, with operands read from shared memory
//   through accessors (the attention backward's five products in
//   fused_qkv_mha_bwd.cu, the attention forward's two in attn_fwd.cuh);
// - block level: `gemm_block`, one 128 x 128 output tile of a job
//   C = A B (+ bias) over a range of the depth, two warpgroups of 64 x 128
//   on `wgmma.mma_async.m64n128k8` (A from registers, B from shared
//   memory).  A and B are read through element strides, so transposed
//   weights and the weight-gradient products (x^T dq) need no copy: a
//   two-stage cp.async ring brings 32-deep chunks of A and B into shared
//   memory as they lie (16-byte copies where the unit stride and alignment
//   allow it, 4-byte otherwise, the unit stride along the padded shared
//   memory row), and a conversion pass writes B's chunk once per block into
//   the big and small K-major layouts wgmma reads, whatever B's layout.
//   A job may split its depth into slices (split-K: slice s writes its
//   partial tile at c + s * c_split, and the caller adds the slices in a
//   second pass), may take its depth from two segments with their own
//   operands (dy = dk Wk^T + dv Wv^T), may add a bias in the epilogue, and
//   may write the column sums of B over its slice (the bias gradient
//   db = 1^T dq beside dW = x^T dq).  qkv_proj.cuh launches tables of jobs
//   (the q / k / v projections of the forward and of the backward's
//   recompute, the backward's dx, dy and dW).
//
// The tensor cores round the sums inside a wgmma toward zero: over a depth
// of 768 in one accumulator (288 wgmma steps) the block-level products
// drift about 1e-5 relative, ten times a float32 GEMM's error, inside
// every gate the kernels are held to.  Summing each 32-deep chunk in an
// accumulator of its own and adding it in float32 brings that to float32's
// error, but takes 64 more registers a thread, one block per SM instead
// of two, and a third more time (PERF.md §6).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// Raises Kernel's dynamic shared-memory limit to `bytes` on the current
// device, once per device: the attribute holds per device, and setting it
// at a device's first launch keeps the call out of the CUDA graphs
// captured after.  A race sets it twice, which is harmless.
template <auto Kernel>
__host__ inline cudaError_t smem_limit(int bytes) {
  constexpr int MAX_DEVICES = 64;
  static bool set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < MAX_DEVICES && set[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev >= 0 && dev < MAX_DEVICES) set[dev] = true;
  return e;
}

// ---------------------------------------------------------------------------
// PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// copies `bytes` (0..16) of src to dst and zero-fills the rest of 16
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// copies 4 bytes, or writes a zero when bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a b for one m16n8k8 TF32 fragment triple
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in the 3xTF32 split, the small terms first
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4],
                                     const uint32_t as[4],
                                     const uint32_t bb[2],
                                     const uint32_t bs[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// acc[ni] += A[m0 : m0+16, 0:DEPTH] B[0:DEPTH, n0 + 8 ni : n0 + 8 ni + 8]
// for ni < 4, A(m, k) and B(k, n) read through the accessors; DEPTH a
// multiple of 8 (64 unless given: a head width of 32 or 128 for the
// products over the head dimension).  Each 8-deep
// step's three products start from zero and are added into acc in
// float32, rounding to nearest: the tensor cores' own sums round toward
// zero, and over the depth of a score row (64) or of p v (up to 256 keys)
// that drift would be several times float32's error.  Fragment
// layout of m16n8k8 (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); b0 (t, g), b1 (t+4, g); c0, c1 (g, 2t, 2t+1),
// c2, c3 (g+8, 2t, 2t+1).
template <int DEPTH = 64, class AF, class BF>
__device__ __forceinline__ void warp_mma_16x32(float acc[4][4], AF a, BF b,
                                               int m0, int n0) {
  static_assert(DEPTH % 8 == 0, "whole 8-deep steps");
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < DEPTH; k0 += 8) {
    uint32_t ab[4], as[4];
    split_tf32(a(m0 + g, k0 + t), ab[0], as[0]);
    split_tf32(a(m0 + g + 8, k0 + t), ab[1], as[1]);
    split_tf32(a(m0 + g, k0 + t + 4), ab[2], as[2]);
    split_tf32(a(m0 + g + 8, k0 + t + 4), ab[3], as[3]);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      uint32_t bb[2], bs[2];
      split_tf32(b(k0 + t, n0 + 8 * ni + g), bb[0], bs[0]);
      split_tf32(b(k0 + t + 4, n0 + 8 * ni + g), bb[1], bs[1]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(part, ab, as, bb, bs);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] += part[e];
    }
  }
}

// ---------------------------------------------------------------------------
// Block level

// 128 x 128 output tiles, 32-deep chunks, two chunks in flight; two
// warpgroups of 64 x 128 each
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 2, THREADS = 256;
constexpr int LDK = BK + 4;      // row of a chunk stored with k contiguous
constexpr int A_STAGE = BM * LDK;    // >= BK * (BM + 8)
constexpr int B_STAGE = BN * LDK;    // >= BK * (BN + 8)
constexpr int CS_PARTS = THREADS / BN;   // column-sum parts, BK / CS_PARTS rows
// the converted B chunk (big and small), the raw stages, the column sums
constexpr int SMEM_FLOATS =
    2 * BN * BK + STAGES * (A_STAGE + B_STAGE) + CS_PARTS * BN;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);


// element (r, k) at p[r * sr + k * sk]: r is A's row m or B's column n
struct Operand {
  const float* p;
  long long sr, sk;
  int vec;   // 16-byte copies: unit stride, other stride % 4 == 0, aligned
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
  float* c;            // C(m, n) of slice s at c[s c_split + m c_sm + n c_sn]
  long long c_sm, c_sn, c_split;
  const float* bias;   // [n] added in the epilogue, or null
  float* colsum;       // [n] of slice s at colsum + s n, or null
  int block0, blocks;  // the job's blocks in the launch
};

__host__ inline Operand make_operand(const void* p, long long sr,
                                     long long sk) {
  Operand o;
  o.p = (const float*)p;
  o.sr = sr;
  o.sk = sk;
  const bool aligned = ((uintptr_t)p & 15) == 0;
  o.vec = aligned && ((sk == 1 && sr % 4 == 0) || (sk != 1 && sr == 1 &&
                                                    sk % 4 == 0));
  return o;
}

__host__ inline void set_job(GemmJob& j, int m, int n, int k_total,
                             int splits, int kc, float* c, long long c_sm,
                             long long c_sn, long long c_split) {
  j.nseg = 0;
  j.m = m;
  j.n = n;
  j.tiles_m = (m + BM - 1) / BM;
  j.tiles_n = (n + BN - 1) / BN;
  j.splits = splits;
  j.kc = kc > 0 ? kc : ((k_total + BK - 1) / BK) * BK;
  j.c = c;
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

// A chunk of R rows x BK depth: K-major s[r * LDK + k] unless the rows are
// the unit stride, then R-major s[k * (R + 8) + r].
__device__ __forceinline__ bool k_major(const Operand& o) {
  return o.sk == 1 || o.sr != 1;
}

template <int R>
__device__ __forceinline__ void load_chunk(float* s, const Operand& o,
                                           int r0, int rlim, int k0,
                                           int klim) {
  constexpr int CH = R * BK / 4;
  if (k_major(o)) {
#pragma unroll
    for (int c = threadIdx.x; c < CH; c += THREADS) {
      const int r = c / (BK / 4), k = (c % (BK / 4)) * 4;
      const int gr = r0 + r, gk = k0 + k;
      int nk = gr < rlim ? klim - gk : 0;
      nk = nk < 0 ? 0 : (nk > 4 ? 4 : nk);
      const float* src = o.p + (long long)gr * o.sr + (long long)gk * o.sk;
      float* d = s + r * LDK + k;
      if (o.vec) {
        cp_async16(d, nk ? src : o.p, 4 * nk);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(d + e, e < nk ? src + e * o.sk : o.p, e < nk ? 4 : 0);
      }
    }
  } else {
#pragma unroll
    for (int c = threadIdx.x; c < CH; c += THREADS) {
      const int k = c / (R / 4), r = (c % (R / 4)) * 4;
      const int gr = r0 + r, gk = k0 + k;
      int nr = gk < klim ? rlim - gr : 0;
      nr = nr < 0 ? 0 : (nr > 4 ? 4 : nr);
      const float* src = o.p + gr + (long long)gk * o.sk;
      float* d = s + k * (R + 8) + r;
      if (o.vec) {
        cp_async16(d, nr ? src : o.p, 4 * nr);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(d + e, e < nr ? src + e : o.p, e < nr ? 4 : 0);
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

// d[64] += A (registers, m64 x k8 fragment of this warp's 16 rows) times
// B (shared memory through desc, k8 x n128, K-major, no swizzle)
__device__ __forceinline__ void wgmma_128(float d[64], const uint32_t a[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

// Descriptor of a K-major operand without swizzle, laid out as 8 x 4
// core matrices of 128 bytes, the BK / 4 of one 8-row group in a row: the
// next core matrix along K 128 bytes on (LBO 8 x 16 B), the next 8-row
// group BK / 4 x 128 = 1024 bytes on (SBO 64 x 16 B).
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)8 << 16) |
         ((uint64_t)(BK / 4 * 8) << 32);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
__device__ __forceinline__ void fence_acc(float d[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <bool AK>
__device__ __forceinline__ void a_frags(uint32_t ab[BK / 8][4],
                                        uint32_t as[BK / 8][4],
                                        const float* a, int wm) {
  constexpr int ars = AK ? LDK : 1, aks = AK ? 1 : BM + 8;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* pa = a + (wm + g) * ars + t * aks;
#pragma unroll
  for (int k8 = 0; k8 < BK / 8; ++k8) {
    const float* p = pa + 8 * k8 * aks;
    split_tf32(p[0], ab[k8][0], as[k8][0]);
    split_tf32(p[8 * ars], ab[k8][1], as[k8][1]);
    split_tf32(p[4 * aks], ab[k8][2], as[k8][2]);
    split_tf32(p[8 * ars + 4 * aks], ab[k8][3], as[k8][3]);
  }
}

// One block computes tile `tile` of slice `s` of job `j` (j in shared
// memory); smem holds SMEM_FLOATS floats.  Per chunk: the raw chunk of B is
// converted once into big and small TF32 copies laid out for wgmma, each
// warp splits its 16 rows of A into registers, and each warpgroup issues
// small*big, big*small and big*big per 8-deep step (m64n128k8) into its 64
// float32 accumulators; the next chunk's cp.async overlaps the products.
__device__ __forceinline__ void gemm_block(const GemmJob& j, int s, int tile,
                                           float* smem) {
  const int tm = tile / j.tiles_n, tn = tile % j.tiles_n;
  const int m0 = tm * BM, n0 = tn * BN;
  const int K = j.seg[0].k + (j.nseg == 2 ? j.seg[1].k : 0);
  const int kbeg = s * j.kc;
  const int kend = min(K, kbeg + j.kc);
  const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  uint32_t* Bb = reinterpret_cast<uint32_t*>(smem);  // [BN/8][BK/4][8][4]
  uint32_t* Bsm = Bb + BN * BK;
  float* As = reinterpret_cast<float*>(Bsm + BN * BK);
  float* Bs = As + STAGES * A_STAGE;
  float* red = Bs + STAGES * B_STAGE;

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
    load_chunk<BM>(As + st * A_STAGE, sg.a, m0, j.m, k - base, klim);
    load_chunk<BN>(Bs + st * B_STAGE, sg.b, n0, j.n, k - base, klim);
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
    const float* a = As + (kt % STAGES) * A_STAGE;
    const float* b = Bs + (kt % STAGES) * B_STAGE;
    const int brs = k_major(sg.b) ? LDK : 1;
    const int bks = k_major(sg.b) ? 1 : BN + 8;
    // B chunk -> big and small TF32 copies, one 8 x 4 core matrix a warp
#pragma unroll
    for (int i = 0; i < BN * BK / THREADS; ++i) {
      const unsigned c = warp + 8 * i;    // core matrix (n / 8, k / 4)
      const int n = (c / (BK / 4)) * 8 + (lane >> 2);
      const int k = (c % (BK / 4)) * 4 + (lane & 3);
      uint32_t big, small;
      split_tf32(b[n * brs + k * bks], big, small);
      Bb[c * 32 + lane] = big;
      Bsm[c * 32 + lane] = small;
    }
    if (colsum) {
#pragma unroll
      for (int k = 0; k < CS_ROWS; ++k)
        csum += b[cs_n * brs + (cs_part * CS_ROWS + k) * bks];
    }
    uint32_t ab[BK / 8][4], as[BK / 8][4];
    if (k_major(sg.a)) a_frags<true>(ab, as, a, wm);
    else a_frags<false>(ab, as, a, wm);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {
      const uint64_t db = wg_desc(Bb + 64 * k8), ds = wg_desc(Bsm + 64 * k8);
      wgmma_128(d, as[k8], db);
      wgmma_128(d, ab[k8], ds);
      wgmma_128(d, ab[k8], db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
  }
  cp_async_wait<0>();

  float* c = j.c + (long long)s * j.c_split;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gm = m0 + wm + g + (e >= 2 ? 8 : 0);
      const int gn = n0 + 8 * i + 2 * t + (e & 1);
      if (gm < j.m && gn < j.n)
        c[(long long)gm * j.c_sm + (long long)gn * j.c_sn] =
            d[4 * i + e] + (j.bias != nullptr ? j.bias[gn] : 0.f);
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

}  // namespace tf32x3
