// Fused q/k/v projections + multi-head attention, backward, in float32 and
// in bf16.
//
// Replaces the TPU kernel `_fa_bwd_kernel` (vln_goat_tpu/ops/attention.py:181),
// launched by the custom-VJP rule `_fa_bwd_rule` (:316) of `_fused_attn`
// (:233).  Like it, the backward saves no probabilities from the forward:
// it recomputes q, k, v and the softmax, regenerates the dropout mask from
// the per-row seeds (dropout_hash.cuh), and then computes
//
//   dv = pd^T dO          dpd = dO v^T        dp = keep ? dpd / (1 - rate) : 0
//   ds = p * (dp - rowsum(dp * p))            (p undropped, pd dropped)
//   dq = scale ds k       dk = scale ds^T q
//   dx = dq Wq^T          dy = dk Wk^T + dv Wv^T
//   dW = x^T dq (y^T dk, y^T dv) and db = column sums, over all B*L rows
//   dbias = ds per head, or its sum over the heads for a [B,1,Lq,Lk] bias
//
// What bounds it on an H100.  Operations: at the train step's shapes
// (B = 64, L = 50-60, D = H*dh = 768) the three recomputed projections and
// the six projection-backward products (dx, dy twice, dW three times) are
// 3.8-4.5 GFLOP each, against about
// 7 MB of weights and 10-35 MB of activations; the attention products are
// a tenth of that.  Every product runs on the tensor cores through
// gemm_tf32x3.cuh in the float32-accurate 3xTF32 split, whose peak is a
// third of the 495 TFLOP/s of TF32: the GEMMs on wgmma (m64n128k8, A split
// in registers, B split once per chunk into shared memory), the attention
// products on mma.sync m16n8k8 fragments.  On the card the GEMM core
// reaches a fraction of that peak (PERF.md §5): its operand loads from L2
// and its per-chunk conversion run in turn with the products inside a
// block, and two blocks per SM overlap them; TMA loads and a deeper,
// warp-specialised pipeline are the next step.
//
// (a) attention backward, two kernels per call:
//   1. the recompute: q = x Wq + bq, k = y Wk + bk, v = y Wv + bv as three
//      jobs of one GEMM launch (128 x 128 tiles, a cp.async ring), into
//      scratch of B (Lq + 2 Lk) H dh floats that the wrapper frees on
//      return: the jobs of qkv_proj.cuh through which the forward
//      (fused_qkv_mha.cu) projects, so both see the same q, k, v.
//      Recomputing inside each (batch row, head) block instead would
//      re-read the weights' head slice for every batch row and keep the
//      attention blocks on the small 64-wide products; one GEMM over all
//      rows keeps the tensor cores on 128 x 128 tiles.
//   2. attn_bwd_kernel, one block per (batch row, head) over that scratch.
//      Keys go in chunks of 64, queries in tiles of 64; K, V, Q and dO are
//      staged into shared memory by cp.async.  For each (key chunk, query
//      tile) the block computes s = q k^T and dpd = dO v^T, a warp per row
//      turns them into pd and ds, and then dq = ds k, dk += ds^T q and
//      dv += pd^T dO, all five on 3xTF32 fragments (8 warps of 16 x 32).
//      dk and dv stay in registers across the query tiles and are written
//      once per key chunk.  With one key chunk (Lk <= 64, every train
//      shape) a query tile holds whole rows, so the softmax statistics come
//      from the tile itself; with more, a first sweep over the chunks keeps
//      each row's running max, sum and rowsum(dp * p) online and leaves them
//      in a small scratch [B, H, Lq, 3], and dq is added chunk after chunk
//      by the one block that owns it; so it takes any Lk.  A template of
//      the head width DH (head_dims.cuh: 32, 64, 128): the products over
//      the head dimension run DH deep, and each 64 x DH result is
//      4 DH / 32 pieces of 16 x 32 over the 8 warps.  Shared memory:
//      105 KB at DH = 64, two blocks per SM (at DH = 128 166 KB, one).
//      The recompute, and (b), only see the projections' width H dh.
// (b) projection backward, two kernels per call:
//   1. one GEMM launch over a table of jobs whose order and depth split the
//      wrapper plans (ops/bwd_plan.py `proj_plan`): dx = dq Wq^T, dy as one
//      two-segment sum, and dWq, dWk, dWv split over the B*L rows into S
//      slices each (split-K, S = 3 at the train shapes), so that the weight
//      gradients' 3 x 36 tiles fill two waves of 132 SMs instead of each
//      walking 3840 rows alone.  Each slice writes its partial tile, and
//      the column sums of its dq (dk, dv) rows, the bias gradient's share,
//      to scratch; the longest jobs come first, and the sum of ds over the
//      heads for a [B,1,Lq,Lk] bias comes last, a coalesced elementwise job.
//   2. splitk_reduce_kernel adds the S partial tiles and bias sums of each
//      weight in ascending slice order, elementwise in the gradient's own
//      memory order.
// No atomics anywhere: two launches on the same inputs give bitwise-equal
// outputs.
//
// bf16 (the `_bf16` entries; the JAX kernel at x.dtype = bf16, whose
// products take bf16 operands with float32 sums, `_bdot(dt=dt)` :200-225):
// x, y, the weights, the biases, the additive bias and dO in bf16.  (a)
// recomputes q, k, v through the bf16 projection jobs (bf16 scratch, as the
// forward), then runs the Hopper attention backward of attn_bwd_sm90.cuh
// (TMA-fed 64-row tiles, its five products on wgmma, scores and their
// gradients in registers, any Lk): p, dp and ds stay float32 and are
// rounded to bf16 where they enter a product (pd before pd^T dO, ds before
// ds k and ds^T q); dq, dk and dv are written in bf16, the operands of
// every product after them (past 64 keys dq is summed over the key tiles in
// a float32 scratch and rounded once, after the last, as the JAX kernel's
// one float32 product over all keys, :216); ds is written in float32.  (b)
// runs dx, dy and the split-K weight gradients on the bf16 core
// (gemm_bf16.cuh: persistent, TMA-fed, wgmma from shared memory; slices of
// whole 64-deep chunks) with float32 partial sums and the same fixed-order
// reduction, which rounds dW and db to bf16 (the weights' dtype,
// :338-341); dx and dy are rounded to bf16 (x.dtype).  db sums the bf16 dq
// (dk, dv), where the JAX kernel sums its float32 dq.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "gemm_bf16.cuh"
#include "gemm_tf32x3.cuh"
#include "attn_bwd_sm90.cuh"
#include "head_dims.cuh"
#include "qkv_proj.cuh"

namespace {

using bf16 = gemm_bf16::bf16;
using qkv_proj::Jobs;
using qkv_proj::launch_jobs;
using qkv_proj::MAX_JOBS;

constexpr int KC = 64;          // keys per chunk in (a)
constexpr int TQ = 64;          // query rows per tile in (a)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LDP = KC + 4;     // row stride of (a)'s float score tiles

// (a)'s float32 build at head width DH: the row stride of the K, V, Q and
// dO tiles, their shared memory with the two score tiles', the 16 x 32
// pieces of a 64 x DH result a warp holds, and the blocks an SM is to hold
template <int DH>
struct AttnShape {
  static_assert(DH % 32 == 0, "whole 32-column pieces");
  static constexpr int LDT = DH + 4;
  static constexpr size_t SMEM_BYTES =
      (4 * (size_t)TQ * LDT + 2 * (size_t)TQ * LDP) * sizeof(float);
  static constexpr int PIECES = 4 * DH / 32;
  static constexpr int NP = (PIECES + WARPS - 1) / WARPS;
  static constexpr int MIN_BLOCKS = DH > 64 ? 1 : 2;
};

using tf32x3::warp_mma_16x32;

// ---------------------------------------------------------------------------
// (b) second pass: out[i] = sum over s < splits of part[s * n + i], written
// as T

struct Reduce {
  const float* part[6];
  void* out[6];
  int n[6];
  int splits[6];
  int block0[6];
  int count;
};

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v.z, v.w);
}

template <class T>
__global__ void __launch_bounds__(THREADS) splitk_reduce_kernel(
    const Reduce R) {
  int r = 0;
#pragma unroll
  for (int i = 1; i < 6; ++i)
    if (i < R.count && (int)blockIdx.x >= R.block0[i]) r = i;
  const int i4 = ((blockIdx.x - R.block0[r]) * THREADS + threadIdx.x) * 4;
  const int n = R.n[r];
  if (i4 >= n) return;
  const float4* p = reinterpret_cast<const float4*>(R.part[r] + i4);
  float4 acc = p[0];
  for (int s = 1; s < R.splits[r]; ++s) {
    const float4 v = p[(long long)s * (n / 4)];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  store4(static_cast<T*>(R.out[r]) + i4, acc);
}

// ---------------------------------------------------------------------------
// (a) attention backward over projected q, k, v

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// s[r * (DH + 4) + c] = base[(r0 + r) * stride + c] for r < 64, c < DH;
// rows at or past lim are zero.  Asynchronous: the caller commits and
// waits.
template <int DH>
__device__ __forceinline__ void load_rows(float* s, const float* base,
                                          long long stride, int r0,
                                          int lim) {
  constexpr int LDT = AttnShape<DH>::LDT;
  const bool vec = ((uintptr_t)base & 15) == 0 && stride % 4 == 0;
  for (int c = threadIdx.x; c < 64 * (DH / 4); c += THREADS) {
    const int r = c / (DH / 4), k = (c % (DH / 4)) * 4;
    const bool ok = r0 + r < lim;
    const float* src = ok ? base + (long long)(r0 + r) * stride + k : base;
    float* d = s + r * LDT + k;
    if (vec) {
      tf32x3::cp_async16(d, src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tf32x3::cp_async4(d + e, ok ? src + e : base, ok ? 4 : 0);
    }
  }
}

struct AttnArgs {
  const float* q;     // [B, Lq, H*dh]
  const float* k;     // [B, Lk, H*dh]
  const float* v;
  const float* bias;  // through (sb, sh, sq, sk), or null
  long long sb, sh, sq, sk;
  const int* seeds;   // [B], or null: no dropout
  unsigned int thresh;
  float inv_keep;
  const float* dout;  // [B, Lq, H*dh]
  float* dq;
  float* dk;
  float* dv;
  float* ds;          // [B, H, Lq, Lk], or null
  float* stats;       // [B, H, Lq, 3] when Lk > KC
  int Lq, Lk, H;
  float scale;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, AttnShape<DH>::MIN_BLOCKS)
    attn_bwd_kernel(const AttnArgs A) {
  using S = AttnShape<DH>;
  constexpr int L = S::LDT, NP = S::NP;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  float* Ks = reinterpret_cast<float*>(attn_smem);   // [KC][L]  key chunk
  float* Vs = Ks + KC * L;                   // [KC][L]
  float* Qs = Vs + KC * L;                   // [TQ][L]  query tile
  float* Os = Qs + TQ * L;                   // [TQ][L]  dO tile
  float* Ps = Os + TQ * L;                   // [TQ][LDP] s, then pd
  float* Ss = Ps + TQ * LDP;                 // [TQ][LDP]  dpd, then ds

  const int b = blockIdx.x, h = blockIdx.y;
  const int Lq = A.Lq, Lk = A.Lk, H = A.H;
  const long long HD = (long long)H * DH;
  const int col0 = h * DH;
  const float* qb = A.q + (long long)b * Lq * HD + col0;
  const float* kb = A.k + (long long)b * Lk * HD + col0;
  const float* vb = A.v + (long long)b * Lk * HD + col0;
  const float* ob = A.dout + (long long)b * Lq * HD + col0;
  const float* bias_bh = A.bias != nullptr
      ? A.bias + (long long)b * A.sb + (long long)h * A.sh : nullptr;
  const uint32_t seed = A.seeds != nullptr ? (uint32_t)A.seeds[b] : 0u;
  float* stats = A.stats != nullptr
      ? A.stats + ((long long)b * H + h) * Lq * 3 : nullptr;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // a score tile's piece (rows wm, keys wn), and the rows of every piece
  // of a 64 x DH result the warp holds: piece i, columns wo(i), when on(i)
  const int wm = (warp % 4) * 16, wn = (warp / 4) * 32;
  auto wo = [warp](int i) { return ((warp + WARPS * i) / 4) * 32; };
  auto on = [warp](int i) { return warp + WARPS * i < S::PIECES; };
  const int nch = (Lk + KC - 1) / KC, ntile = (Lq + TQ - 1) / TQ;

  // accessors of a staged operand tile (stride L) or score tile (stride
  // LDP), row-major or transposed
  auto rowmajor = [](const float* s) {
    return [s](int r, int c) { return s[r * L + c]; };
  };
  auto transposed = [](const float* s) {
    return [s](int r, int c) { return s[c * L + r]; };
  };
  auto score_rows = [](const float* s) {
    return [s](int r, int c) { return s[r * LDP + c]; };
  };
  auto score_cols = [](const float* s) {
    return [s](int r, int c) { return s[c * LDP + r]; };
  };
  // Ps <- q k^T (raw), Ss <- dO v^T, for the staged tile and chunk
  auto scores = [&]() {
    float a1[4][4] = {}, a2[4][4] = {};
    warp_mma_16x32<DH>(a1, rowmajor(Qs), transposed(Ks), wm, wn);
    warp_mma_16x32<DH>(a2, rowmajor(Os), transposed(Vs), wm, wn);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm + g + (e >= 2 ? 8 : 0);
        const int c = wn + 8 * ni + 2 * t + (e & 1);
        Ps[r * LDP + c] = a1[ni][e];
        Ss[r * LDP + c] = a2[ni][e];
      }
  };
  // lane's two keys of row r at chunk c0: scaled score (-inf past Lk) and
  // dp (dropout applied), and the keep flags
  auto row_vals = [&](int r, int qi, int c0, float s[2], float dp[2],
                      bool keep[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int jl = lane + 32 * i, j = c0 + jl;
      keep[i] = true;
      s[i] = -INFINITY;
      dp[i] = 0.f;
      if (j < Lk) {
        s[i] = Ps[r * LDP + jl] * A.scale;
        if (bias_bh != nullptr)
          s[i] += bias_bh[(long long)qi * A.sq + (long long)j * A.sk];
        dp[i] = Ss[r * LDP + jl];
        if (A.seeds != nullptr) {
          keep[i] = dropout_bits(seed, b, h, qi, j) >= A.thresh;
          dp[i] = keep[i] ? dp[i] * A.inv_keep : 0.f;
        }
      }
    }
  };

  // first sweep, only with more than one key chunk: per row the running
  // max m, sum l of exp(s - m) and sum of exp(s - m) dp, left in stats as
  // (m, l, rowsum(p dp))
  if (nch > 1) {
    for (int it = 0; it < ntile; ++it) {
      const int q0 = it * TQ;
      float rm[TQ / WARPS], rl[TQ / WARPS], rd[TQ / WARPS];
#pragma unroll
      for (int i = 0; i < TQ / WARPS; ++i) {
        rm[i] = -INFINITY;
        rl[i] = 0.f;
        rd[i] = 0.f;
      }
      for (int c = 0; c < nch; ++c) {
        __syncthreads();
        if (c == 0) {
          load_rows<DH>(Qs, qb, HD, q0, Lq);
          load_rows<DH>(Os, ob, HD, q0, Lq);
        }
        load_rows<DH>(Ks, kb, HD, c * KC, Lk);
        load_rows<DH>(Vs, vb, HD, c * KC, Lk);
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<0>();
        __syncthreads();
        scores();
        __syncthreads();
#pragma unroll
        for (int i = 0; i < TQ / WARPS; ++i) {
          const int r = warp * (TQ / WARPS) + i, qi = q0 + r;
          if (qi >= Lq) continue;
          float s[2], dp[2];
          bool keep[2];
          row_vals(r, qi, c * KC, s, dp, keep);
          const float m = fmaxf(rm[i], warp_max(fmaxf(s[0], s[1])));
          const float f = rm[i] == -INFINITY ? 0.f : expf(rm[i] - m);
          const float e0 = expf(s[0] - m), e1 = expf(s[1] - m);
          rl[i] = rl[i] * f + warp_sum(e0 + e1);
          rd[i] = rd[i] * f + warp_sum(e0 * dp[0] + e1 * dp[1]);
          rm[i] = m;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < TQ / WARPS; ++i) {
          const int qi = q0 + warp * (TQ / WARPS) + i;
          if (qi < Lq) {
            stats[qi * 3] = rm[i];
            stats[qi * 3 + 1] = rl[i];
            stats[qi * 3 + 2] = rd[i] / rl[i];
          }
        }
      }
    }
  }

  for (int c = 0; c < nch; ++c) {
    const int c0 = c * KC;
    float dka[NP][4][4] = {}, dva[NP][4][4] = {};
    for (int it = 0; it < ntile; ++it) {
      const int q0 = it * TQ;
      __syncthreads();
      if (it == 0) {
        load_rows<DH>(Ks, kb, HD, c0, Lk);
        load_rows<DH>(Vs, vb, HD, c0, Lk);
      }
      load_rows<DH>(Qs, qb, HD, q0, Lq);
      load_rows<DH>(Os, ob, HD, q0, Lq);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      __syncthreads();
      scores();
      __syncthreads();
      // a warp per row: Ps <- pd, Ss <- ds
#pragma unroll 1
      for (int i = 0; i < TQ / WARPS; ++i) {
        const int r = warp * (TQ / WARPS) + i, qi = q0 + r;
        if (qi >= Lq) {
          Ps[r * LDP + lane] = Ps[r * LDP + lane + 32] = 0.f;
          Ss[r * LDP + lane] = Ss[r * LDP + lane + 32] = 0.f;
          continue;
        }
        float s[2], dp[2];
        bool keep[2];
        row_vals(r, qi, c0, s, dp, keep);
        float m, l, dsum;
        if (nch == 1) {
          m = warp_max(fmaxf(s[0], s[1]));
          const float e0 = expf(s[0] - m), e1 = expf(s[1] - m);
          l = warp_sum(e0 + e1);
          dsum = warp_sum(e0 * dp[0] + e1 * dp[1]) / l;
        } else {
          m = stats[qi * 3];
          l = stats[qi * 3 + 1];
          dsum = stats[qi * 3 + 2];
        }
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int jl = lane + 32 * i2, j = c0 + jl;
          const float p = expf(s[i2] - m) / l;
          const float pd =
              A.seeds != nullptr ? (keep[i2] ? p * A.inv_keep : 0.f) : p;
          const float dsv = p * (dp[i2] - dsum);
          Ps[r * LDP + jl] = j < Lk ? pd : 0.f;
          Ss[r * LDP + jl] = j < Lk ? dsv : 0.f;
          if (A.ds != nullptr && j < Lk)
            A.ds[(((long long)b * H + h) * Lq + qi) * Lk + j] = dsv;
        }
      }
      __syncthreads();
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) {
        if (!on(pi)) continue;
        // dq (tile rows) = scale ds k, added over the key chunks in dq
        float dqa[4][4] = {};
        warp_mma_16x32(dqa, score_rows(Ss), rowmajor(Ks), wm, wo(pi));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + wm + g + (e >= 2 ? 8 : 0);
            const int col = wo(pi) + 8 * ni + 2 * t + (e & 1);
            if (qi < Lq) {
              const long long i =
                  ((long long)b * Lq + qi) * HD + col0 + col;
              const float v = dqa[ni][e] * A.scale;
              A.dq[i] = c == 0 ? v : A.dq[i] + v;
            }
          }
        // the tile's share of dv = pd^T dO and dk = ds^T q (keys x dh)
        warp_mma_16x32(dva[pi], score_cols(Ps), rowmajor(Os), wm, wo(pi));
        warp_mma_16x32(dka[pi], score_cols(Ss), rowmajor(Qs), wm, wo(pi));
      }
    }
#pragma unroll
    for (int pi = 0; pi < NP; ++pi) {
      if (!on(pi)) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c0 + wm + g + (e >= 2 ? 8 : 0);
          const int col = wo(pi) + 8 * ni + 2 * t + (e & 1);
          if (j < Lk) {
            const long long o = ((long long)b * Lk + j) * HD + col0 + col;
            A.dk[o] = dka[pi][ni][e] * A.scale;
            A.dv[o] = dva[pi][ni][e];
          }
        }
    }
  }
}

}  // namespace

namespace {

// The attention backward of head width dh over a recompute scratch laid
// out as bwd_attn's (q, then k and v).
template <class T>
int bwd_core(const void* qkv, const void* bias, long long sb, long long sh,
             long long sq, long long sk, const void* seeds,
             unsigned int thresh, float inv_keep, const void* dout, void* dq,
             void* dk, void* dv, void* ds, void* stats, void* dq_acc, int B,
             int Lq, int Lk, int H, int dh, float scale, cudaStream_t st) {
  constexpr bool BF16 = sizeof(T) == 2;
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || (Lk > KC && stats == nullptr) ||
      (BF16 && Lk > KC && dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const int HD = H * dh;
  const T* qs = (const T*)qkv;
  const T* ks = qs + (long long)B * Lq * HD;
  const T* vs = ks + (long long)B * Lk * HD;
  if constexpr (BF16) {
    // the Hopper core, over the scratch and dO as [B, L, H, dh] heads
    attn_bwd_sm90::Params P;
    P.q = {qs, (long long)Lq * HD, HD, dh, 1, Lq};
    P.k = {ks, (long long)Lk * HD, HD, dh, 1, Lk};
    P.v = {vs, (long long)Lk * HD, HD, dh, 1, Lk};
    P.o = {(const T*)dout, (long long)Lq * HD, HD, dh, 1, Lq};
    P.bias = (const T*)bias;
    P.sb = sb;
    P.sh = sh;
    P.sq = sq;
    P.sk = sk;
    P.seeds = (const int*)seeds;
    P.thresh = thresh;
    P.inv_keep = inv_keep;
    P.dq = (T*)dq;
    P.dk = (T*)dk;
    P.dv = (T*)dv;
    P.ds = (float*)ds;
    P.stats = (float*)stats;
    P.dq_acc = (float*)dq_acc;
    P.H = H;
    P.scale = scale;
    return attn_bwd_sm90::launch(P, B, dh, st);
  } else {
    AttnArgs A;
    A.q = qs;
    A.k = ks;
    A.v = vs;
    A.bias = (const T*)bias;
    A.sb = sb;
    A.sh = sh;
    A.sq = sq;
    A.sk = sk;
    A.seeds = (const int*)seeds;
    A.thresh = thresh;
    A.inv_keep = inv_keep;
    A.dout = (const T*)dout;
    A.dq = (T*)dq;
    A.dk = (T*)dk;
    A.dv = (T*)dv;
    A.ds = (float*)ds;
    A.stats = Lk > KC ? (float*)stats : nullptr;
    A.Lq = Lq;
    A.Lk = Lk;
    A.H = H;
    A.scale = scale;
    return head_dims::dispatch(dh, [&](auto w) {
      constexpr int DH = decltype(w)::value;
      constexpr int smem = (int)AttnShape<DH>::SMEM_BYTES;
      const cudaError_t e = tf32x3::smem_limit<attn_bwd_kernel<DH>>(smem);
      if (e != cudaSuccess) return (int)e;
      attn_bwd_kernel<DH><<<dim3(B, H), THREADS, smem, st>>>(A);
      return (int)cudaGetLastError();
    });
  }
}

template <class Core>
int bwd_attn(const void* x, const void* y, const void* wq, long long wq_sd,
             long long wq_so, const void* bq, const void* wk, long long wk_sd,
             long long wk_so, const void* bk, const void* wv, long long wv_sd,
             long long wv_so, const void* bv, const void* bias, long long sb,
             long long sh, long long sq, long long sk, const void* seeds,
             unsigned int thresh, float inv_keep, const void* dout, void* dq,
             void* dk, void* dv, void* ds, void* qkv, void* stats,
             void* dq_acc, int B, int Lq, int Lk, int D, int H, int dh,
             float scale, void* stream) {
  using T = typename Core::T;
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || D < 1 || dh < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * dh;
  T* qs = (T*)qkv;
  const void* w[3] = {wq, wk, wv};
  const long long sd[3] = {wq_sd, wk_sd, wv_sd}, so[3] = {wq_so, wk_so, wv_so};
  const void* bb[3] = {bq, bk, bv};
  Jobs<Core> J;
  qkv_proj::qkv_jobs(J, x, y, w, sd, so, bb, qs, B, Lq, Lk, D, HD);
  const int rc = launch_jobs(J, st);
  if (rc != 0) return rc;
  return bwd_core<T>(qkv, bias, sb, sh, sq, sk, seeds, thresh, inv_keep, dout,
                     dq, dk, dv, ds, stats, dq_acc, B, Lq, Lk, H, dh, scale,
                     st);
}

template <class Core>
int bwd_proj(const void* x, const void* y, const void* wq, long long wq_sd,
             long long wq_so, const void* wk, long long wk_sd,
             long long wk_so, const void* wv, long long wv_sd,
             long long wv_so, const void* dq, const void* dk, const void* dv,
             void* dx, void* dy, void* scratch, const long long* dw_sd,
             const long long* dw_so, const int* splits, const int* kc,
             const long long* wofs, const long long* bofs, const void* ds,
             void* dbias, const int* order, int njobs, int blocks, int B,
             int Lq, int Lk, int D, int H, int dh, void* stream) {
  constexpr int BK = Core::BK;   // the plan cuts slices in whole chunks
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || D < 1 || dh < 1 || njobs < 0 ||
      njobs > MAX_JOBS + 1)
    return (int)cudaErrorInvalidValue;
  const int HD = H * dh;
  const int Mq = B * Lq, Mk = B * Lk;
  const void* src[3] = {x, y, y};
  const void* grad[3] = {dq, dk, dv};
  const int rows[3] = {Mq, Mk, Mk};
  float* sc = (float*)scratch;
  Jobs<Core> J = {};
  for (int i = 0; i < njobs; ++i) {
    const int id = order[i];
    if (id == 5) {
      if (i != njobs - 1 || ds == nullptr || dbias == nullptr)
        return (int)cudaErrorInvalidValue;
      J.ds = (const float*)ds;
      J.dbias = (float*)dbias;
      J.H = H;
      J.hsum_qk = (long long)Lq * Lk;
      J.hsum_n = (long long)B * Lq * Lk;
      continue;
    }
    if (id < 0 || id > 4 || J.njobs == MAX_JOBS)
      return (int)cudaErrorInvalidValue;
    typename Core::Job& j = J.job[J.njobs++];
    if (id == 0) {
      Core::job(j, Mq, D, HD, 1, 0, dx, D, 1, 0);
      add_seg(j, Core::operand(dq, HD, 1), Core::operand(wq, wq_sd, wq_so),
              HD);
    } else if (id == 1) {
      Core::job(j, Mk, D, 2 * HD, 1, 0, dy, D, 1, 0);
      if (HD % BK != 0) return (int)cudaErrorInvalidValue;
      add_seg(j, Core::operand(dk, HD, 1), Core::operand(wk, wk_sd, wk_so),
              HD);
      add_seg(j, Core::operand(dv, HD, 1), Core::operand(wv, wv_sd, wv_so),
              HD);
    } else {
      const int g = id - 2;
      if (kc[g] % BK != 0 || kc[g] < BK ||
          (long long)splits[g] * kc[g] < rows[g] ||
          (long long)(splits[g] - 1) * kc[g] >= rows[g])
        return (int)cudaErrorInvalidValue;
      // dW[d, o] = sum over rows r of src[r, d] grad[r, o], float32 slices
      Core::job(j, D, HD, rows[g], splits[g], kc[g], sc + wofs[g], dw_sd[g],
                dw_so[g], (long long)D * HD, 0);
      add_seg(j, Core::operand(src[g], 1, D), Core::operand(grad[g], 1, HD),
              rows[g]);
      j.colsum = sc + bofs[g];
    }
  }
  int total = 0;
  for (int i = 0; i < J.njobs; ++i) total += J.job[i].blocks;
  total += (int)((J.hsum_n + THREADS - 1) / THREADS);
  if (total != blocks) return (int)cudaErrorInvalidConfiguration;
  return launch_jobs(J, (cudaStream_t)stream);
}

template <class T>
int bwd_reduce(const void* scratch, void* dwq, void* dwk, void* dwv,
               void* dbq, void* dbk, void* dbv, const int* splits,
               const long long* wofs, const long long* bofs, int D, int H,
               int dh, void* stream) {
  const int HD = H * dh;
  const float* sc = (const float*)scratch;
  void* dw[3] = {dwq, dwk, dwv};
  void* db[3] = {dbq, dbk, dbv};
  Reduce R = {};
  int blocks = 0;
  auto add = [&](const float* part, void* out, int n, int s) {
    if (n % 4 != 0 || ((uintptr_t)part & 15) ||
        ((uintptr_t)out & (4 * sizeof(T) - 1)))
      return false;
    R.part[R.count] = part;
    R.out[R.count] = out;
    R.n[R.count] = n;
    R.splits[R.count] = s;
    R.block0[R.count] = blocks;
    blocks += (n / 4 + THREADS - 1) / THREADS;
    ++R.count;
    return true;
  };
  for (int g = 0; g < 3; ++g) {
    if (splits[g] <= 0) continue;
    if (!add(sc + wofs[g], dw[g], D * HD, splits[g]) ||
        !add(sc + bofs[g], db[g], HD, splits[g]))
      return (int)cudaErrorInvalidValue;
  }
  if (blocks == 0) return 0;
  splitk_reduce_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(R);
  return (int)cudaGetLastError();
}

template <class Core>
int bwd_gemm(const void* a, long long a_sm, long long a_sk, const void* b,
             long long b_sk, long long b_sn, const void* bias, void* c,
             void* colsum, int m, int n, int k, int splits, int kc,
             void* stream) {
  if (m < 1 || n < 1 || k < 1 || splits < 1 || kc % Core::BK != 0 ||
      (long long)splits * kc < k || (long long)(splits - 1) * kc >= k)
    return (int)cudaErrorInvalidValue;
  Jobs<Core> J = {};
  J.njobs = 1;
  typename Core::Job& j = J.job[0];
  Core::job(j, m, n, k, splits, kc, c, n, 1, (long long)m * n, 0);
  add_seg(j, Core::operand(a, a_sm, a_sk), Core::operand(b, b_sn, b_sk), k);
  j.bias = (const typename Core::T*)bias;
  j.colsum = (float*)colsum;
  return launch_jobs(J, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

#define ATTN_ARGS                                                            \
  const void *x, const void *y, const void *wq, long long wq_sd,            \
      long long wq_so, const void *bq, const void *wk, long long wk_sd,      \
      long long wk_so, const void *bk, const void *wv, long long wv_sd,      \
      long long wv_so, const void *bv, const void *bias, long long sb,       \
      long long sh, long long sq, long long sk, const void *seeds,           \
      unsigned int thresh, float inv_keep, const void *dout, void *dq,       \
      void *dk, void *dv, void *ds, void *qkv, void *stats, void *dq_acc,    \
      int B, int Lq, int Lk, int D, int H, int dh, float scale, void *stream
#define ATTN_NAMES                                                           \
  x, y, wq, wq_sd, wq_so, bq, wk, wk_sd, wk_so, bk, wv, wv_sd, wv_so, bv,    \
      bias, sb, sh, sq, sk, seeds, thresh, inv_keep, dout, dq, dk, dv, ds,   \
      qkv, stats, dq_acc, B, Lq, Lk, D, H, dh, scale, stream
#define PROJ_ARGS                                                            \
  const void *x, const void *y, const void *wq, long long wq_sd,            \
      long long wq_so, const void *wk, long long wk_sd, long long wk_so,     \
      const void *wv, long long wv_sd, long long wv_so, const void *dq,      \
      const void *dk, const void *dv, void *dx, void *dy, void *scratch,     \
      const long long *dw_sd, const long long *dw_so, const int *splits,     \
      const int *kc, const long long *wofs, const long long *bofs,           \
      const void *ds, void *dbias, const int *order, int njobs, int blocks,  \
      int B, int Lq, int Lk, int D, int H, int dh, void *stream
#define PROJ_NAMES                                                           \
  x, y, wq, wq_sd, wq_so, wk, wk_sd, wk_so, wv, wv_sd, wv_so, dq, dk, dv,    \
      dx, dy, scratch, dw_sd, dw_so, splits, kc, wofs, bofs, ds, dbias,      \
      order, njobs, blocks, B, Lq, Lk, D, H, dh, stream
#define REDUCE_ARGS                                                          \
  const void *scratch, void *dwq, void *dwk, void *dwv, void *dbq,          \
      void *dbk, void *dbv, const int *splits, const long long *wofs,        \
      const long long *bofs, int D, int H, int dh, void *stream
#define REDUCE_NAMES \
  scratch, dwq, dwk, dwv, dbq, dbk, dbv, splits, wofs, bofs, D, H, dh, stream
#define GEMM_ARGS                                                            \
  const void *a, long long a_sm, long long a_sk, const void *b,             \
      long long b_sk, long long b_sn, const void *bias, void *c,             \
      void *colsum, int m, int n, int k, int splits, int kc, void *stream
#define GEMM_NAMES \
  a, a_sm, a_sk, b, b_sk, b_sn, bias, c, colsum, m, n, k, splits, kc, stream

// (a) Launches the recompute GEMM and attn_bwd_kernel of head width dh (of
// head_dims.cuh's set) on `stream`; returns the first CUDA error (another
// width: cudaErrorInvalidValue).  x [B, Lq, D], y [B, Lk, D], weights
// [D, H*dh]
// through strides, biases [H*dh], additive bias through four strides (null:
// none), seeds int32 [B] (null: no dropout), dO [B, Lq, H*dh]; scratch qkv
// of B (Lq + 2 Lk) H*dh elements and, when Lk > 64, stats of B H Lq 3
// floats (and for `_bf16` dq_acc of B Lq H*dh floats, else null); writes
// dq [B, Lq, H*dh], dk, dv [B, Lk, H*dh] and, if ds is not null, ds
// [B, H, Lq, Lk] (float32).  The `_bf16` entry takes every tensor but ds,
// stats and dq_acc in bf16.
int fused_qkv_mha_bwd_attn(ATTN_ARGS) {
  return bwd_attn<qkv_proj::Tf32x3>(ATTN_NAMES);
}

int fused_qkv_mha_bwd_attn_bf16(ATTN_ARGS) {
  return bwd_attn<qkv_proj::Bf16>(ATTN_NAMES);
}

// (a)'s second launch alone in bf16 (the attention core of
// attn_bwd_sm90.cuh over a scratch filled as the recompute fills it,
// fused_qkv_mha_proj_bf16 of fused_qkv_mha.cu): exported for timing the
// core apart from the recompute; the wrapper calls the whole of (a).
// Arguments as fused_qkv_mha_bwd_attn_bf16's.
int fused_qkv_mha_bwd_core_bf16(const void* qkv, const void* bias,
                                long long sb, long long sh, long long sq,
                                long long sk, const void* seeds,
                                unsigned int thresh, float inv_keep,
                                const void* dout, void* dq, void* dk,
                                void* dv, void* ds, void* stats,
                                void* dq_acc, int B, int Lq, int Lk, int H,
                                int dh, float scale, void* stream) {
  return bwd_core<bf16>(qkv, bias, sb, sh, sq, sk, seeds, thresh, inv_keep,
                        dout, dq, dk, dv, ds, stats, dq_acc, B, Lq, Lk, H,
                        dh, scale, (cudaStream_t)stream);
}

// (b) Launches the projection-backward GEMM jobs on `stream` and returns
// cudaGetLastError().  From dq [B, Lq, H*dh] and dk, dv [B, Lk, H*dh]
// (written by (a)), x, y and the weights (through strides).  `order` lists
// `njobs` job ids, longest first: 0 dx [B, Lq, D] = dq Wq^T, 1 dy [B, Lk, D]
// = dk Wk^T + dv Wv^T, 2-4 the partial weight gradients of q, k, v, 5 the
// head sum dbias [B, 1, Lq, Lk] of ds [B, H, Lq, Lk] (last).  Weight g
// splits its rows into splits[g] slices of kc[g] rows; slice s writes its
// partial gradient, in the memory order of the weight's gradient (strides
// dw_sd[g], dw_so[g]), at scratch + wofs[g] + s D H*dh, and its column sums
// at scratch + bofs[g] + s H*dh (float32 floats).  `blocks` is the launch's
// block count as the plan has it: the call fails when the table gives
// another.  The `_bf16` entry takes x, y, the weights, dq, dk, dv, dx and
// dy in bf16 (scratch, ds and dbias stay float32).
int fused_qkv_mha_bwd_proj(PROJ_ARGS) {
  return bwd_proj<qkv_proj::Tf32x3>(PROJ_NAMES);
}

int fused_qkv_mha_bwd_proj_bf16(PROJ_ARGS) {
  return bwd_proj<qkv_proj::Bf16>(PROJ_NAMES);
}

// (b) second pass: for each weight g with splits[g] > 0, dW_g (D * H*dh
// elements in its own memory order) and db_g (H*dh) = the sums over the
// slices, in ascending order, of the partials that fused_qkv_mha_bwd_proj
// left at scratch + wofs[g] and + bofs[g]; float32, or rounded to bf16 by
// the `_bf16` entry.
int fused_qkv_mha_bwd_reduce(REDUCE_ARGS) {
  return bwd_reduce<float>(REDUCE_NAMES);
}

int fused_qkv_mha_bwd_reduce_bf16(REDUCE_ARGS) {
  return bwd_reduce<bf16>(REDUCE_NAMES);
}

// The GEMM core alone, for its tests: slice s < splits of C = A B (+ bias)
// over depth [s kc, min((s+1) kc, k)) into c [splits, m, n] and the column
// sums of B over the slice into colsum [splits, n] (null: none), both
// float32.  A(m, k) at a[m a_sm + k a_sk], B(k, n) at b[k b_sk + n b_sn];
// A, B and the bias float32 (3xTF32 core) or, for `_bf16`, bf16 (bf16
// core).
int fused_qkv_mha_bwd_gemm(GEMM_ARGS) {
  return bwd_gemm<qkv_proj::Tf32x3>(GEMM_NAMES);
}

int fused_qkv_mha_bwd_gemm_bf16(GEMM_ARGS) {
  return bwd_gemm<qkv_proj::Bf16>(GEMM_NAMES);
}

// Dynamic shared memory of the GEMM launch and of attn_bwd_kernel at head
// width dh, bytes, and of their bf16 builds (0 for the attention kernels
// at a width outside head_dims.cuh's set).
void fused_qkv_mha_bwd_smem(int dh, int* out) {
  out[0] = (int)tf32x3::SMEM_BYTES;
  out[2] = (int)gemm_bf16::SMEM_BYTES;
  out[1] = out[3] = 0;
  head_dims::dispatch(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    out[1] = (int)AttnShape<DH>::SMEM_BYTES;
    out[3] = (int)attn_bwd_sm90::smem_bytes<DH>();
    return 0;
  });
}

// The head widths the attention kernels are compiled for (the first n into
// out), so the wrapper can check a call's; returns how many there are.
int fused_qkv_mha_bwd_head_dims(int* out, int n) {
  return head_dims::query(out, n);
}

// GEMM tiles (rows, columns, depth chunk) of the 3xTF32 core, then of the
// bf16 core, so the wrapper's plan can check that it tiles as the kernels
// do.
void fused_qkv_mha_bwd_tile(int* out) {
  out[0] = tf32x3::BM;
  out[1] = tf32x3::BN;
  out[2] = tf32x3::BK;
  out[3] = gemm_bf16::BM;
  out[4] = gemm_bf16::BN;
  out[5] = gemm_bf16::BK;
}

// The route of this library's last bf16 GEMM launch: 1 every operand by
// TMA, 0 at least one loaded directly, -1 no launch yet.
int fused_qkv_mha_bwd_bf16_route(void) { return gemm_bf16::last_route(); }

// The route of this library's last bf16 attention backward launch
// (attn_bwd_sm90.cuh): 1 q, k, v and dO by TMA, 0 loaded directly, -1 none
// yet.
int fused_qkv_mha_bwd_attn_route(void) { return attn_sm90::last_route(); }

}  // extern "C"
