// Attention forward over projected heads on tensor-core fragments in
// float32, shared by the fused forward (fused_qkv_mha.cu, over its
// projection scratch) and the attention-only kernel (mha.cu, over the
// caller's views); products in the float32-accurate 3xTF32 split.  The
// bf16 builds run the Hopper core of attn_fwd_sm90.cuh instead.  A
// template of the head width DH, built for each width of head_dims.cuh.
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
// head's keys and values in blocks of up to KB = 256 (128 at DH = 128;
// cp.async, rows past Lk zero-filled) and walks its query tiles of 64
// rows.  Per tile and key block: s = q k^T on mma.sync m16n8k8 fragments
// (gemm_tf32x3.cuh `warp_mma_16x32` over a depth of DH, each of 8 warps a
// 16 x 32 piece of every 64-key chunk) into a 64 x KB score tile in shared
// memory; four threads per row take the max, the exponentials, the sum
// and the keep mask of dropout_hash.cuh at each (q, k); then out += p v on
// fragments, the 64-key chunks added into one accumulator: the 64 x DH
// output is 4 DH / 32 pieces of 16 x 32, one a warp at DH = 64, two at
// DH = 128, one for each of warps 0-3 at DH = 32.
// - Up to KB keys (one key block: every train and decode shape) the
//   whole score row is in the tile, so the softmax is the plain version's
//   order of operations: p = exp(s - max) / sum, then the keep mask.  The
//   head's K and V are staged once for all its query tiles.
// - Past KB keys the row's max m and sum l run over the key blocks (the
//   online softmax): a block's p = exp(s - m) unnormalised, the
//   accumulator rescaled by exp(m_old - m_new) before the block's p v, and
//   divided by l after the last block.  K and V are staged block by block
//   for each query tile.
// Shared memory at DH = 64: 71 KB at Lk <= 64 (every train shape), so
// three blocks share an SM (at most 85 registers a thread), 222 KB from
// Lk = 256 on; at DH = 32 less; at DH = 128 118 KB at Lk <= 64 and 200 KB
// from Lk = 128 on, one block an SM.  Row strides DH + 4 for q and k (read
// along rows by the fragments), DH + 8 for v (read along columns), 4 past
// a multiple of 64 for the scores: no bank conflicts in the fragment
// reads.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "gemm_tf32x3.cuh"
#include "head_dims.cuh"

namespace attn_fwd {
// internal linkage: each library that includes this has its own kernel
namespace {

constexpr int TQ = 64;          // query rows per tile
constexpr int KC = 64;          // keys per chunk of the products
constexpr int THREADS = 256;     // 8 warps; four threads per query row
constexpr int KB = 256;          // keys per block of the score tile
constexpr int KB_WIDE = 128;     // the same at DH = 128 (shared memory)
static_assert(THREADS == 4 * TQ, "the softmax takes four threads a row");

// The constants of head width DH: keys per block of the score tile, row
// strides of q and k and of v in shared memory, the output's 16 x 32
// pieces a warp holds, and the blocks an SM is to hold.
template <int DH>
struct Shape {
  static_assert(DH % 32 == 0, "whole 32-column pieces");
  static constexpr int KB = DH > 64 ? KB_WIDE : attn_fwd::KB;
  static constexpr int LDQ = DH + 4;
  static constexpr int LDV = DH + 8;
  static constexpr int PIECES = 4 * DH / 32;     // of the 64 x DH output
  static constexpr int NP = (PIECES + 7) / 8;    // a warp's
  static constexpr int MIN_BLOCKS = DH > 64 ? 1 : 3;
};

struct Strides {
  long long b, l, h, d;
};

using tf32x3::warp_mma_16x32;

struct Args {
  const float* q;
  Strides qs;
  const float* k;
  Strides ks;
  const float* v;
  Strides vs;
  const float* bias;  // bias[b sb + h sh + q sq + k sk], or null
  long long sb, sh, sq, sk;
  const int* seeds;   // [B], or null: no dropout
  unsigned int thresh;
  float inv_keep;
  float* out;         // [B, Lq, H*DH]
  int Lq, Lk, H;
  float scale;
};

// keys of the staged block, padded to whole chunks: all of them up to KB
template <int DH>
__host__ __device__ inline int block_padded(int Lk) {
  constexpr int KB = Shape<DH>::KB;
  return (((Lk < KB ? Lk : KB) + KC - 1) / KC) * KC;
}

// K, V, a query tile, the score tile, and per row the rescale factor and
// the sum's inverse of the online softmax
template <int DH>
__host__ inline size_t smem_bytes(int Lk) {
  using S = Shape<DH>;
  const int bp = block_padded<DH>(Lk);
  return sizeof(float) * ((size_t)bp * (S::LDQ + S::LDV) +
                           (size_t)TQ * S::LDQ + (size_t)TQ * (bp + 4) +
                           2 * (size_t)TQ);
}

// s[r * ld + c] = base[(r0 + r) sl + c sd] for r < rows, c < DH; rows at
// or past lim are zero.  Asynchronous: the caller commits and waits.
template <int DH>
__device__ __forceinline__ void load_rows(float* s, int ld, const float* base,
                                          long long sl, long long sd, int r0,
                                          int rows, int lim) {
  constexpr int V = 4;                   // floats per 16-byte copy
  const bool vec = sd == 1 && sl % V == 0 && ((uintptr_t)base & 15) == 0;
  for (int c = threadIdx.x; c < rows * (DH / V); c += THREADS) {
    const int r = c / (DH / V), k = (c % (DH / V)) * V;
    const bool ok = r0 + r < lim;
    const float* src =
        ok ? base + (long long)(r0 + r) * sl + (long long)k * sd : base;
    float* d = s + r * ld + k;
    if (vec) {
      tf32x3::cp_async16(d, src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tf32x3::cp_async4(d + e, ok ? src + e * sd : base, ok ? 4 : 0);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, Shape<DH>::MIN_BLOCKS)
    attn_fwd_kernel(const Args A) {
  using S = Shape<DH>;
  constexpr int KB = S::KB, LDQ = S::LDQ, LDV = S::LDV, NP = S::NP;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int Lq = A.Lq, Lk = A.Lk;
  const int bp = block_padded<DH>(Lk), ldp = bp + 4;
  const int nblk = (Lk + KB - 1) / KB;
  float* Ks = reinterpret_cast<float*>(attn_smem);   // [bp][LDQ]
  float* Vs = Ks + bp * LDQ;                         // [bp][LDV]
  float* Qs = Vs + bp * LDV;                         // [TQ][LDQ]
  float* Ps = Qs + TQ * LDQ;                         // [TQ][ldp]
  float* Al = Ps + TQ * ldp;                         // [TQ] rescale factor
  float* Li = Al + TQ;                               // [TQ] 1 / sum

  const float* qb = A.q + (long long)b * A.qs.b + (long long)h * A.qs.h;
  const float* kb = A.k + (long long)b * A.ks.b + (long long)h * A.ks.h;
  const float* vb = A.v + (long long)b * A.vs.b + (long long)h * A.vs.h;
  const float* bias_bh = A.bias != nullptr
      ? A.bias + (long long)b * A.sb + (long long)h * A.sh : nullptr;
  const uint32_t seed = A.seeds != nullptr ? (uint32_t)A.seeds[b] : 0u;
  const long long HD = (long long)A.H * DH;
  float* ob = A.out + (long long)b * Lq * HD + (long long)h * DH;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // the score chunk's piece (rows wm, keys wn), and the rows of every
  // output piece of the warp; output piece i: columns wo(i), held by the
  // warp when on(i)
  const int wm = (warp % 4) * 16, wn = (warp / 4) * 32;
  auto wo = [warp](int i) { return ((warp + 8 * i) / 4) * 32; };
  auto on = [warp](int i) { return warp + 8 * i < S::PIECES; };

  if (nblk == 1) {
    load_rows<DH>(Ks, LDQ, kb, A.ks.l, A.ks.d, 0, bp, Lk);
    load_rows<DH>(Vs, LDV, vb, A.vs.l, A.vs.d, 0, bp, Lk);
  }
  for (int q0 = 0; q0 < Lq; q0 += TQ) {
    __syncthreads();      // the last tile's reads of Qs, Ks, Vs, Ps are done
    load_rows<DH>(Qs, LDQ, qb, A.qs.l, A.qs.d, q0, TQ, Lq);
    // the softmax threads' row (four a row) and its running max and sum
    const int r = tid / 4, part = tid % 4, qi = q0 + r;
    float m_run = -INFINITY, l_run = 0.f;
    float acc[NP][4][4] = {};
    for (int kb0 = 0; kb0 < Lk; kb0 += KB) {
      const int nb = min(KB, Lk - kb0);   // keys of this block
      if (nblk > 1) {
        if (kb0 > 0) __syncthreads();     // the last block's p v is done
        load_rows<DH>(Ks, LDQ, kb, A.ks.l, A.ks.d, kb0, bp, Lk);
        load_rows<DH>(Vs, LDV, vb, A.vs.l, A.vs.d, kb0, bp, Lk);
      }
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      __syncthreads();

      // raw scores q k^T, one 64-key chunk at a time
      for (int c0 = 0; c0 < bp; c0 += KC) {
        float sa[4][4] = {};
        const float* kc = Ks + c0 * LDQ;
        warp_mma_16x32<DH>(
            sa, [Qs](int rr, int c) { return Qs[rr * LDQ + c]; },
            [kc](int c, int n) { return kc[n * LDQ + c]; }, wm, wn);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int rr = wm + g + (e >= 2 ? 8 : 0);
            const int c = c0 + wn + 8 * ni + 2 * t;
            *reinterpret_cast<float2*>(Ps + rr * ldp + c) =
                make_float2(sa[ni][e], sa[ni][e + 1]);
          }
      }
      __syncthreads();

      // four threads per row, each taking every fourth key: scale, bias,
      // softmax (max and sum over the four by shuffles), keep mask; zeros
      // past the block's keys and in rows past Lq, so the product below
      // adds nothing for them.  Every row of the tile at once, so the
      // latency of the loads, shuffles and exponentials of one row hides
      // behind the others'.
      {
        const int nk = qi < Lq ? nb : 0;    // keys this row takes
        float* prow = Ps + r * ldp;
        const float* brow = bias_bh != nullptr
            ? bias_bh + (long long)qi * A.sq + (long long)kb0 * A.sk
            : nullptr;
        float m = -INFINITY;
        for (int j = part; j < nk; j += 4) {
          float v = prow[j] * A.scale;
          if (brow != nullptr) v += brow[(long long)j * A.sk];
          prow[j] = v;
          m = fmaxf(m, v);
        }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        // one block: the max of the whole row.  Several: the running max,
        // the factor that rescales what was summed before (a row that is
        // -inf so far keeps a 0 sum and no NaN)
        float norm = 1.f;
        if (nblk > 1) {
          const float m_new = fmaxf(m_run, m);
          m = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - m);
          m_run = m_new;
          l_run *= alpha;
          if (part == 0) Al[r] = alpha;
        }
        float sum = 0.f;
        for (int j = part; j < nk; j += 4) {
          const float e = expf(prow[j] - m);
          prow[j] = e;
          sum += e;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (nblk == 1) {
          norm = sum;
        } else {
          l_run += sum;
          if (part == 0 && kb0 + KB >= Lk) Li[r] = 1.f / l_run;
        }
        for (int j = part; j < bp; j += 4) {
          float p = 0.f;
          if (j < nk) {
            p = nblk == 1 ? prow[j] / norm : prow[j];
            if (A.seeds != nullptr)
              p = dropout_bits(seed, b, h, qi, kb0 + j) >= A.thresh
                  ? p * A.inv_keep : 0.f;
          }
          prow[j] = p;
        }
      }
      __syncthreads();

      // past the first key block, the output so far rescaled to the new
      // max; then out += p v, the key chunks added in order
      if (kb0 > 0) {
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][ni][e] *= Al[wm + g + (e >= 2 ? 8 : 0)];
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (!on(i)) continue;
        for (int c0 = 0; c0 < bp; c0 += KC) {
          const float* pc = Ps + c0;
          const float* vc = Vs + c0 * LDV;
          warp_mma_16x32(
              acc[i], [pc, ldp](int rr, int c) { return pc[rr * ldp + c]; },
              [vc](int c, int n) { return vc[c * LDV + n]; }, wm, wo(i));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (!on(i)) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int rr = wm + g + (e >= 2 ? 8 : 0), qo = q0 + rr;
          const int col = wo(i) + 8 * ni + 2 * t;
          const float f = nblk > 1 ? Li[rr] : 1.f;
          if (qo < Lq)
            *reinterpret_cast<float2*>(ob + (long long)qo * HD + col) =
                make_float2(acc[i][ni][e] * f, acc[i][ni][e + 1] * f);
        }
    }
  }
}

// Launches attn_fwd_kernel of head width dh on `stream` for B batch rows
// and returns cudaGetLastError(); shapes it does not take (a head width
// outside head_dims.cuh's set among them) return cudaErrorInvalidValue
// without launching.
inline int launch(const Args& A, int B, int dh, cudaStream_t stream) {
  if (B < 1 || A.Lq < 1 || A.Lk < 1 || A.H < 1 || A.H > 65535)
    return (int)cudaErrorInvalidValue;
  return head_dims::dispatch(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    // at the largest block's size, once per device
    const cudaError_t e = tf32x3::smem_limit<attn_fwd_kernel<DH>>(
        (int)smem_bytes<DH>(Shape<DH>::KB));
    if (e != cudaSuccess) return (int)e;
    attn_fwd_kernel<DH>
        <<<dim3(B, A.H), THREADS, smem_bytes<DH>(A.Lk), stream>>>(A);
    return (int)cudaGetLastError();
  });
}

}  // namespace
}  // namespace attn_fwd
