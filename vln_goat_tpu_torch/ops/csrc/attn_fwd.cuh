// Attention forward over projected heads on tensor-core fragments, shared
// by the fused forward (fused_qkv_mha.cu, over its projection scratch) and
// the attention-only kernel (mha.cu, over the caller's views).  The kernel
// is a template over the element type T of q, k, v, the bias and the
// output: float (products in the float32-accurate 3xTF32 split) or bf16
// (products on bf16 m16n8k16 fragments with float32 sums, gemm_bf16.cuh;
// the scores, bias, softmax and dropout stay float32 and p is rounded to
// bf16 before p v, as the JAX package's bf16 kernel casts it; the output
// is rounded to bf16).
//
// For batch row b and head h:
//
//   s = q k^T * scale + bias[b, h]
//   p = softmax(s) along the keys (row max subtracted, float32)
//   p = keep(seed[b], b, h, q, k) ? p * inv_keep : 0     (with seeds only)
//   out[b, :, h*dh:(h+1)*dh] = p v
//
// q, k and v are read through four element strides each (batch, position,
// head, column), the additive bias through four (0 on a broadcast
// dimension, null for none); out is [B, Lq, H*dh] contiguous.
//
// One block per (batch row, head), 256 threads.  The block stages the
// head's K and V once (cp.async, rows past Lk zero-filled) and walks its
// query tiles of 64 rows.  Per tile: s = q k^T on mma.sync m16n8k8
// fragments (`warp_mma_16x32` of the element type's core, each of 8 warps
// a 16 x 32 piece of every 64-key chunk) into a 64 x Lk score
// tile in shared memory; four threads per row take the max, the
// exponentials, the sum and the keep mask of dropout_hash.cuh at each
// (q, k), in the plain version's order of operations; then out = p v on
// fragments, the 64-key chunks added into one accumulator.  The whole
// score row stays in shared memory (no online max and sum): up to
// Lk = 256 the head's K, V, a query tile and the 64 x 256 score tile fit
// in one block's 227 KB, the softmax needs no rescaling, and the only
// shapes past 64 keys are decode's (text200, batch 8: 96 blocks, one per
// SM anyway).  Shared memory in float: 70 KB at Lk <= 64 (every train
// shape), so three blocks share an SM (at most 85 registers a thread),
// 222 KB at Lk = 256; bf16 stages K, V and q in half of that.
// Row strides 68 for q and k (read along rows by the fragments), 72 for v
// (read along columns), 4 past a multiple of 64 for the scores: no bank
// conflicts in the float fragment reads.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "gemm_bf16.cuh"
#include "gemm_tf32x3.cuh"

namespace attn_fwd {
// internal linkage: each library that includes this has its own kernel
namespace {

constexpr int DH = 64;          // head width the kernel is written for
constexpr int TQ = 64;          // query rows per tile
constexpr int KC = 64;          // keys per chunk of the products
constexpr int THREADS = 256;     // 8 warps; four threads per query row
constexpr int MAX_LK = 256;
// row stride of q and k in shared memory: 68 floats, 72 bf16 (a 16-byte
// multiple for the copies)
template <class T>
constexpr int LDQ = sizeof(T) == 4 ? DH + 4 : DH + 8;
constexpr int LDV = DH + 8;     // row stride of v
static_assert(THREADS == 4 * TQ, "the softmax takes four threads a row");

struct Strides {
  long long b, l, h, d;
};

using bf16 = gemm_bf16::bf16;
using gemm_bf16::to_f;
using gemm_bf16::warp_mma;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <class T>
struct Args {
  const T* q;
  Strides qs;
  const T* k;
  Strides ks;
  const T* v;
  Strides vs;
  const T* bias;      // bias[b sb + h sh + q sq + k sk], or null
  long long sb, sh, sq, sk;
  const int* seeds;   // [B], or null: no dropout
  unsigned int thresh;
  float inv_keep;
  T* out;             // [B, Lq, H*DH]
  int Lq, Lk, H;
  float scale;
};

__host__ __device__ inline int lk_padded(int Lk) {
  return ((Lk + KC - 1) / KC) * KC;
}

template <class T>
__host__ inline size_t smem_bytes(int Lk) {
  const int lp = lk_padded(Lk);
  return sizeof(T) * ((size_t)lp * (LDQ<T> + LDV) + (size_t)TQ * LDQ<T>) +
         sizeof(float) * (size_t)TQ * (lp + 4);
}

// s[r * ld + c] = base[(r0 + r) sl + c sd] for r < rows, c < DH; rows at
// or past lim are zero.  Asynchronous: the caller commits and waits.  In
// bf16, strides that allow no 16-byte copy are loaded element by element.
template <class T>
__device__ __forceinline__ void load_rows(T* s, int ld, const T* base,
                                          long long sl, long long sd, int r0,
                                          int rows, int lim) {
  constexpr int V = 16 / sizeof(T);      // elements per 16-byte copy
  const bool vec = sd == 1 && sl % V == 0 && ((uintptr_t)base & 15) == 0;
  for (int c = threadIdx.x; c < rows * (DH / V); c += THREADS) {
    const int r = c / (DH / V), k = (c % (DH / V)) * V;
    const bool ok = r0 + r < lim;
    const T* src =
        ok ? base + (long long)(r0 + r) * sl + (long long)k * sd : base;
    T* d = s + r * ld + k;
    if (vec) {
      tf32x3::cp_async16(d, src, ok ? 16 : 0);
    } else if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tf32x3::cp_async4(d + e, ok ? src + e * sd : base, ok ? 4 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) d[e] = ok ? src[e * sd] : T(0.f);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 3) attn_fwd_kernel(
    const Args<T> A) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int Lq = A.Lq, Lk = A.Lk;
  const int lp = lk_padded(Lk), ldp = lp + 4;
  T* Ks = reinterpret_cast<T*>(attn_smem);                 // [lp][LDQ]
  T* Vs = Ks + lp * LDQ<T>;                                // [lp][LDV]
  T* Qs = Vs + lp * LDV;                                   // [TQ][LDQ]
  float* Ps = reinterpret_cast<float*>(Qs + TQ * LDQ<T>);  // [TQ][ldp]

  const T* qb = A.q + (long long)b * A.qs.b + (long long)h * A.qs.h;
  const T* kb = A.k + (long long)b * A.ks.b + (long long)h * A.ks.h;
  const T* vb = A.v + (long long)b * A.vs.b + (long long)h * A.vs.h;
  const T* bias_bh = A.bias != nullptr
      ? A.bias + (long long)b * A.sb + (long long)h * A.sh : nullptr;
  const uint32_t seed = A.seeds != nullptr ? (uint32_t)A.seeds[b] : 0u;
  const long long HD = (long long)A.H * DH;
  T* ob = A.out + (long long)b * Lq * HD + (long long)h * DH;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % 4) * 16, wn = (warp / 4) * 32;

  load_rows(Ks, LDQ<T>, kb, A.ks.l, A.ks.d, 0, lp, Lk);
  load_rows(Vs, LDV, vb, A.vs.l, A.vs.d, 0, lp, Lk);
  for (int q0 = 0; q0 < Lq; q0 += TQ) {
    __syncthreads();      // the last tile's reads of Qs and Ps are done
    load_rows(Qs, LDQ<T>, qb, A.qs.l, A.qs.d, q0, TQ, Lq);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();
    __syncthreads();

    // raw scores q k^T, one 64-key chunk at a time
    for (int c0 = 0; c0 < lp; c0 += KC) {
      float acc[4][4] = {};
      const T* kc = Ks + c0 * LDQ<T>;
      warp_mma<T>(
          acc, [Qs](int r, int c) { return to_f(Qs[r * LDQ<T> + c]); },
          [kc](int c, int n) { return to_f(kc[n * LDQ<T> + c]); }, wm, wn);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = wm + g + (e >= 2 ? 8 : 0);
          const int c = c0 + wn + 8 * ni + 2 * t;
          *reinterpret_cast<float2*>(Ps + r * ldp + c) =
              make_float2(acc[ni][e], acc[ni][e + 1]);
        }
    }
    __syncthreads();

    // four threads per row, each taking every fourth key: scale, bias,
    // softmax (max and sum over the four by shuffles), keep mask; zeros
    // past Lk and in rows past Lq, so the product below adds nothing for
    // them.  Every row of the tile at once, so the latency of the loads,
    // shuffles and exponentials of one row hides behind the others'.
    {
      const int r = tid / 4, part = tid % 4, qi = q0 + r;
      const int nk = qi < Lq ? Lk : 0;    // keys this row takes
      float* prow = Ps + r * ldp;
      const T* brow = bias_bh != nullptr
          ? bias_bh + (long long)qi * A.sq : nullptr;
      float m = -INFINITY;
      for (int j = part; j < nk; j += 4) {
        float v = prow[j] * A.scale;
        if (brow != nullptr) v += to_f(brow[(long long)j * A.sk]);
        prow[j] = v;
        m = fmaxf(m, v);
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
      for (int j = part; j < nk; j += 4) {
        const float e = expf(prow[j] - m);
        prow[j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      for (int j = part; j < lp; j += 4) {
        float p = 0.f;
        if (j < nk) {
          p = prow[j] / sum;
          if (A.seeds != nullptr)
            p = dropout_bits(seed, b, h, qi, j) >= A.thresh ? p * A.inv_keep
                                                            : 0.f;
        }
        prow[j] = p;
      }
    }
    __syncthreads();

    // out tile = p v, the key chunks added in order into one accumulator
    float acc[4][4] = {};
    for (int c0 = 0; c0 < lp; c0 += KC) {
      const float* pc = Ps + c0;
      const T* vc = Vs + c0 * LDV;
      warp_mma<T>(
          acc, [pc, ldp](int r, int c) { return pc[r * ldp + c]; },
          [vc](int c, int n) { return to_f(vc[c * LDV + n]); }, wm, wn);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int qi = q0 + wm + g + (e >= 2 ? 8 : 0);
        const int col = wn + 8 * ni + 2 * t;
        if (qi < Lq)
          store2(ob + (long long)qi * HD + col, acc[ni][e], acc[ni][e + 1]);
      }
  }
}

// Launches attn_fwd_kernel on `stream` for B batch rows and returns
// cudaGetLastError(); shapes it does not take return cudaErrorInvalidValue
// without launching.
template <class T>
inline int launch(const Args<T>& A, int B, cudaStream_t stream) {
  if (B < 1 || A.Lq < 1 || A.Lk < 1 || A.Lk > MAX_LK || A.H < 1 ||
      A.H > 65535)
    return (int)cudaErrorInvalidValue;
  // at the largest Lk's size, once per device
  const cudaError_t e =
      tf32x3::smem_limit<attn_fwd_kernel<T>>((int)smem_bytes<T>(MAX_LK));
  if (e != cudaSuccess) return (int)e;
  attn_fwd_kernel<T>
      <<<dim3(B, A.H), THREADS, smem_bytes<T>(A.Lk), stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace attn_fwd
