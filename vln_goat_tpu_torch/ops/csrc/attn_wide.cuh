// Attention over heads wider than 256 columns, forward and backward, in
// float32 and in bf16: the third core under every attention entry (K1's
// attention in fused_qkv_mha.cu, K2 (a)'s in fused_qkv_mha_bwd.cu, K3 in
// mha.cu) for the head widths past head_dims.cuh's widest instance.  The
// instanced cores (attn_fwd.cuh, attn_bwd_kernel, attn_fwd_sm90.cuh,
// attn_bwd_sm90.cuh) keep the widths of head_dims::DIMS; a width past
// them that is a multiple of head_dims::WIDE_STEP runs here, any head
// count, any key length.  It computes what those cores compute, for
// batch row b, head h and query i:
//
//   s[j] = q_i . k_j * scale + bias[b, h or 0, i, j]
//   p[j] = exp(s[j] - max) / sum            (float32)
//   p[j] = keep(b, h, i, j) ? p[j] * inv_keep : 0    (dropout_hash.cuh)
//   out[b, i, h*dh:(h+1)*dh] = sum_j p[j] v_j
//
// Design: the head is taken as a run-time count of 128-column pieces
// (PIECE; the last one partial).  One warp owns one query row (forward,
// and the backward's row pass) or one key row (the backward's column
// pass); its lanes stride the head's columns, so every dot product over
// the whole head (q . k, dO . v) is a warp sum over all the pieces.  A
// row's max and sum come from one pass over the keys; then each output
// piece is written by a pass of its own that recomputes the scores and
// probabilities, since the registers hold one piece of output (4 columns
// a lane) and not the whole head.  Everything sums in float32 on the CUDA
// cores; nothing is staged in shared memory.  This is the simple kernel
// that is right, not a fast one: a head of P pieces costs about P + 1
// times the score products of one pass.  Since the instanced cores took
// the widths 192 and 256 onto the tensor cores, it serves only heads past
// 256 (320, 384, ...), which no configuration of the repo uses.
//
// bf16 (ROUND_P): q, k, v, dO and the bias are bf16 inputs taken exactly
// into float32; the dropped probabilities are rounded to bf16 before p v
// (and before dv's p^T dO), as the JAX bf16 kernel casts them; the outputs
// are rounded once.  The bf16 K3 keeps p in float32 (its TPU kernel does).
//
// Backward (K2 (a)): two launches on one stream.
//   1. rows: per (b, h, i) the max m, the sum l, and
//      delta = sum_j p_ij dp_ij, where dp_ij = keep ? dO_i . v_j * inv_keep
//      : 0 (the gradient of the probabilities before dropout), kept in
//      stats [B, H, Lq, 3]; then ds_ij = p_ij (dp_ij - delta) (written when
//      asked, float32) and dq_i = scale sum_j ds_ij k_j, piece by piece.
//   2. columns: per (b, h, j), from the rows' statistics,
//      dv_j = sum_i pd_ij dO_i and dk_j = scale sum_i ds_ij q_i, piece by
//      piece.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace attn_wide {
// internal linkage: each library that includes this has its own kernels
namespace {

constexpr int PIECE = 128;             // output columns of one pass
constexpr int PER_LANE = PIECE / 32;   // of them in one lane's registers
constexpr int WARPS = 4;               // rows of one block, a warp each
constexpr int THREADS = 32 * WARPS;

// A tensor of heads [B, L, H, dh] through four element strides.
template <class T>
struct Heads {
  const T* p;
  long long sb, sl, sh, sd;
  __device__ __forceinline__ const T* row(int b, int l, int h) const {
    return p + b * sb + l * sl + h * sh;
  }
};

template <class T, class BiasT>
struct Params {
  Heads<T> q, k, v;
  Heads<T> o;           // dO (backward only)
  const BiasT* bias;    // through (sb, sh, sq, sk), or null
  long long sb, sh, sq, sk;
  const int* seeds;     // [B], or null: no dropout
  unsigned int thresh;
  float inv_keep;
  T* out;               // forward: [B, Lq, H*dh]
  T* dq;                // backward: [B, Lq, H*dh]
  T* dk;                // [B, Lk, H*dh]
  T* dv;
  float* ds;            // [B, H, Lq, Lk], or null
  float* stats;         // [B, H, Lq, 3]: m, l, delta
  int B, Lq, Lk, H, dh;
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// a . b over dh columns (the lanes stride them), summed over the warp
template <class T>
__device__ __forceinline__ float dot(const T* a, long long sa, const T* b,
                                     long long sb, int dh) {
  float acc = 0.f;
  for (int c = threadIdx.x % 32; c < dh; c += 32)
    acc = fmaf(ld(a + c * sa), ld(b + c * sb), acc);
  return warp_sum(acc);
}

template <class T, class BiasT>
__device__ __forceinline__ float score(const Params<T, BiasT>& P, int b,
                                       int h, int i, int j) {
  float s = dot(P.q.row(b, i, h), P.q.sd, P.k.row(b, j, h), P.k.sd, P.dh) *
            P.scale;
  if (P.bias != nullptr)
    s += ld(P.bias + b * P.sb + h * P.sh + i * P.sq + j * P.sk);
  return s;
}

// exp(s - m) / l, 0 for a score of -inf
__device__ __forceinline__ float prob(float s, float m, float inv_l) {
  return s == -INFINITY ? 0.f : expf(s - m) * inv_l;
}

// the row's max and sum over its keys, online
template <class T, class BiasT>
__device__ __forceinline__ void row_stats(const Params<T, BiasT>& P, int b,
                                          int h, int i, float& m, float& l) {
  m = -INFINITY;
  l = 0.f;
  for (int j = 0; j < P.Lk; ++j) {
    const float s = score(P, b, h, i, j);
    if (s == -INFINITY) continue;
    const float mn = fmaxf(m, s);
    l = l * expf(m - mn) + expf(s - mn);
    m = mn;
  }
}

// Splits a warp's global row index into (b, h, row); false past the end.
__device__ __forceinline__ bool warp_row(int B, int H, int L, int& b, int& h,
                                         int& r) {
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= (long long)B * H * L) return false;
  r = (int)(w % L);
  const long long bh = w / L;
  h = (int)(bh % H);
  b = (int)(bh / H);
  return true;
}

template <class T, class BiasT, bool ROUND_P>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const Params<T, BiasT> P) {
  int b, h, i;
  if (!warp_row(P.B, P.H, P.Lq, b, h, i)) return;
  const int lane = threadIdx.x % 32;
  float m, l;
  row_stats(P, b, h, i, m, l);
  const float inv_l = 1.f / l;
  const uint32_t drow =
      P.seeds != nullptr ? dropout_row((uint32_t)P.seeds[b], b, h, i) : 0u;
  T* out = P.out + ((long long)b * P.Lq + i) * P.H * P.dh + (long long)h * P.dh;
  for (int c0 = 0; c0 < P.dh; c0 += PIECE) {
    float acc[PER_LANE] = {};
    for (int j = 0; j < P.Lk; ++j) {
      float p = prob(score(P, b, h, i, j), m, inv_l);
      if (P.seeds != nullptr)
        p = dropout_bits_at(drow, j) >= P.thresh ? p * P.inv_keep : 0.f;
      if (ROUND_P) p = round_bf16(p);
      const T* vj = P.v.row(b, j, h);
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        const int c = c0 + lane + 32 * e;
        if (c < P.dh) acc[e] = fmaf(p, ld(vj + c * P.v.sd), acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int c = c0 + lane + 32 * e;
      if (c < P.dh) st(out + c, acc[e]);
    }
  }
}

// gradient of the probabilities before dropout, from dO_i . v_j
template <class T, class BiasT>
__device__ __forceinline__ float dprob(const Params<T, BiasT>& P, int b,
                                       int h, int i, int j, bool keep) {
  const float g = dot(P.o.row(b, i, h), P.o.sd, P.v.row(b, j, h), P.v.sd,
                      P.dh);
  return keep ? g * P.inv_keep : 0.f;
}

template <class T, class BiasT>
__global__ void __launch_bounds__(THREADS)
    bwd_rows_kernel(const Params<T, BiasT> P) {
  int b, h, i;
  if (!warp_row(P.B, P.H, P.Lq, b, h, i)) return;
  const int lane = threadIdx.x % 32;
  float m, l;
  row_stats(P, b, h, i, m, l);
  const float inv_l = 1.f / l;
  const uint32_t drow =
      P.seeds != nullptr ? dropout_row((uint32_t)P.seeds[b], b, h, i) : 0u;
  auto kept = [&](int j) {
    return P.seeds == nullptr || dropout_bits_at(drow, j) >= P.thresh;
  };
  float delta = 0.f;
  for (int j = 0; j < P.Lk; ++j) {
    const float p = prob(score(P, b, h, i, j), m, inv_l);
    delta = fmaf(p, dprob(P, b, h, i, j, kept(j)), delta);
  }
  float* stats = P.stats + (((long long)b * P.H + h) * P.Lq + i) * 3;
  if (lane == 0) {
    stats[0] = m;
    stats[1] = l;
    stats[2] = delta;
  }
  float* ds = P.ds != nullptr
      ? P.ds + (((long long)b * P.H + h) * P.Lq + i) * P.Lk : nullptr;
  T* dq = P.dq + ((long long)b * P.Lq + i) * P.H * P.dh + (long long)h * P.dh;
  for (int c0 = 0; c0 < P.dh; c0 += PIECE) {
    float acc[PER_LANE] = {};
    for (int j = 0; j < P.Lk; ++j) {
      const float p = prob(score(P, b, h, i, j), m, inv_l);
      const float g = p * (dprob(P, b, h, i, j, kept(j)) - delta);
      if (c0 == 0 && ds != nullptr && lane == 0) ds[j] = g;
      const T* kj = P.k.row(b, j, h);
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        const int c = c0 + lane + 32 * e;
        if (c < P.dh) acc[e] = fmaf(g, ld(kj + c * P.k.sd), acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int c = c0 + lane + 32 * e;
      if (c < P.dh) st(dq + c, acc[e] * P.scale);
    }
  }
}

template <class T, class BiasT, bool ROUND_P>
__global__ void __launch_bounds__(THREADS)
    bwd_cols_kernel(const Params<T, BiasT> P) {
  int b, h, j;
  if (!warp_row(P.B, P.H, P.Lk, b, h, j)) return;
  const int lane = threadIdx.x % 32;
  const float* stats = P.stats + ((long long)b * P.H + h) * P.Lq * 3;
  const long long HD = (long long)P.H * P.dh;
  T* dk = P.dk + ((long long)b * P.Lk + j) * HD + (long long)h * P.dh;
  T* dv = P.dv + ((long long)b * P.Lk + j) * HD + (long long)h * P.dh;
  for (int c0 = 0; c0 < P.dh; c0 += PIECE) {
    float ak[PER_LANE] = {}, av[PER_LANE] = {};
    for (int i = 0; i < P.Lq; ++i) {
      const float m = stats[i * 3], l = stats[i * 3 + 1];
      const float delta = stats[i * 3 + 2];
      const float p = prob(score(P, b, h, i, j), m, 1.f / l);
      const bool keep =
          P.seeds == nullptr ||
          dropout_bits((uint32_t)P.seeds[b], b, h, i, j) >= P.thresh;
      float pd = keep ? p * P.inv_keep : 0.f;
      if (ROUND_P) pd = round_bf16(pd);
      const float g = p * (dprob(P, b, h, i, j, keep) - delta);
      const T* qi = P.q.row(b, i, h);
      const T* oi = P.o.row(b, i, h);
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        const int c = c0 + lane + 32 * e;
        if (c < P.dh) {
          ak[e] = fmaf(g, ld(qi + c * P.q.sd), ak[e]);
          av[e] = fmaf(pd, ld(oi + c * P.o.sd), av[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int c = c0 + lane + 32 * e;
      if (c < P.dh) {
        st(dk + c, ak[e] * P.scale);
        st(dv + c, av[e]);
      }
    }
  }
}

__host__ inline bool takes(int B, int L1, int L2, int H, int dh) {
  return B >= 1 && L1 >= 1 && L2 >= 1 && H >= 1 && dh >= 1 &&
         (long long)B * H * (L1 > L2 ? L1 : L2) < (1ll << 36);
}

__host__ inline unsigned int grid(long long rows) {
  return (unsigned int)((rows + WARPS - 1) / WARPS);
}

// The forward on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue without launching for shapes it does not take.
template <class T, class BiasT, bool ROUND_P>
__host__ inline int forward(const Params<T, BiasT>& P, cudaStream_t stream) {
  if (!takes(P.B, P.Lq, P.Lk, P.H, P.dh) || P.out == nullptr)
    return (int)cudaErrorInvalidValue;
  fwd_kernel<T, BiasT, ROUND_P>
      <<<grid((long long)P.B * P.H * P.Lq), THREADS, 0, stream>>>(P);
  return (int)cudaGetLastError();
}

// The backward's two launches on `stream` (stats: scratch of B H Lq 3
// floats); returns the first CUDA error.
template <class T, class BiasT, bool ROUND_P>
__host__ inline int backward(const Params<T, BiasT>& P,
                             cudaStream_t stream) {
  if (!takes(P.B, P.Lq, P.Lk, P.H, P.dh) || P.stats == nullptr ||
      P.dq == nullptr || P.dk == nullptr || P.dv == nullptr)
    return (int)cudaErrorInvalidValue;
  bwd_rows_kernel<T, BiasT>
      <<<grid((long long)P.B * P.H * P.Lq), THREADS, 0, stream>>>(P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_cols_kernel<T, BiasT, ROUND_P>
      <<<grid((long long)P.B * P.H * P.Lk), THREADS, 0, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace attn_wide
