// Fused q/k/v projections + multi-head attention, backward, float32.
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
// in two kernels, one launch each:
//
// (a) attn_bwd_kernel, one block per (batch row, head).  The block projects
//     its head's K and V for all Lk <= 256 keys into shared memory (as the
//     forward does), then walks the queries in tiles of 32 rows: it
//     projects the tile's q, loads its dO, and each warp recomputes one
//     query row's scores, softmax, mask and ds (one key per lane and 32-key
//     group), writing pd and ds for the tile to shared memory.  Two small
//     block-wide products follow: dq for the tile, and the tile's share of
//     dk and dv, which the block adds into its own rows of dk / dv in
//     device memory (written by the first tile, added by the later ones, in
//     tile order).  Shared memory: K, V (Lk x 65 floats each), q and dO
//     tiles, pd and ds tiles: 215 KB at Lk = 256.  Outputs dq, dk, dv
//     [B, L, H*dh] and, only when the bias needs a gradient, ds
//     [B, H, Lq, Lk].
// (b) proj_bwd_kernel, one launch over a table of jobs: five tiled GEMMs
//     (dx, dy as one two-term sum, dWq, dWk, dWv; 64 x 64 output tiles, a
//     4 x 4 register tile per thread, depth chunks of 32), the three bias
//     column sums, and the sum of ds over the heads for a [B,1,Lq,Lk] bias.
//     The TPU kernel accumulates the weight gradients across its sequential
//     grid; here every output element belongs to one thread of one block,
//     which loops over all B*L rows itself in a fixed order.  No atomics:
//     two launches on the same inputs give bitwise-equal outputs.
//
// What bounds it on an H100.  Like the forward, operations: the recomputed
// projections plus five GEMMs of the same size (dx, dy twice, dW three
// times) against a few MB of activations and 7 MB of weights.  This first
// version runs them on the float32 CUDA cores (no tensor cores, no
// TMA/wgmma), and (a) recomputes its head's K and V in every block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int DH = 64;          // head width the kernel is written for
constexpr int TQ = 32;          // query rows per tile in (a)
constexpr int TILE = 64;        // rows per projection tile / GEMM tile edge
constexpr int TD = 32;          // depth of one projection / GEMM chunk
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LK = 256;
constexpr int KSTR = DH + 1;    // padded row strides in shared memory
constexpr int ASTR = TILE + 1;

__host__ __device__ inline int lk_padded(int Lk) {
  return ((Lk + TILE - 1) / TILE) * TILE;
}

// floats of dynamic shared memory that attn_bwd_kernel needs for Lk keys:
// Ks, Vs [lp][KSTR]; Qs, dOs [TQ][KSTR]; then one region that holds the
// pd and ds tiles [TQ][lp] or, while projecting, the operand chunks
__host__ inline size_t attn_smem_floats(int Lk) {
  const size_t lp = lk_padded(Lk);
  const size_t pds = 2 * TQ * lp;
  const size_t proj = 2 * (size_t)TD * ASTR;
  return 2 * lp * KSTR + 2 * (size_t)TQ * KSTR + (pds > proj ? pds : proj);
}

// dst[r * dstr + c] = src[row0 + r, :] . W[:, col0 + c] + bias[col0 + c]
// for r < 16 * RI, c < 64; rows at or past nrows read as zero.  W[d, o]
// lies at w[d * sd + o * so].  The forward kernel's projection, for 32
// (RI = 2) or 64 (RI = 4) rows.  Ends with a block-wide barrier.
template <int RI>
__device__ void project_tile(const float* __restrict__ src, int nrows,
                             int row0, int D, const float* __restrict__ w,
                             long long sd, long long so,
                             const float* __restrict__ bias, int col0,
                             float* As, float* Bs, float* dst, int dstr) {
  constexpr int ROWS = 16 * RI;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[RI][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += TD) {
    for (int i = tid; i < ROWS * TD; i += THREADS) {
      const int r = i / TD, k = i % TD;
      const int row = row0 + r;
      As[k * ASTR + r] =
          row < nrows ? src[(long long)row * D + d0 + k] : 0.f;
    }
    if (sd == 1) {
      for (int i = tid; i < TILE * TD; i += THREADS) {
        const int c = i / TD, k = i % TD;
        Bs[k * ASTR + c] = w[(long long)(d0 + k) + (long long)(col0 + c) * so];
      }
    } else {
      for (int i = tid; i < TILE * TD; i += THREADS) {
        const int k = i / TILE, c = i % TILE;
        Bs[k * ASTR + c] =
            w[(long long)(d0 + k) * sd + (long long)(col0 + c) * so];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TD; ++k) {
      float a[RI], b[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = As[k * ASTR + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k * ASTR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[(ty + 16 * i) * dstr + tx + 16 * j] =
          acc[i][j] + bias[col0 + tx + 16 * j];
}

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

__global__ void __launch_bounds__(THREADS)
attn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ wq, long long wq_sd,
                long long wq_so, const float* __restrict__ bq,
                const float* __restrict__ wk, long long wk_sd,
                long long wk_so, const float* __restrict__ bk,
                const float* __restrict__ wv, long long wv_sd,
                long long wv_so, const float* __restrict__ bv,
                const float* __restrict__ bias, long long sb, long long sh,
                long long sq, long long sk, const int* __restrict__ seeds,
                unsigned int thresh, float inv_keep,
                const float* __restrict__ dout, float* __restrict__ dq,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ ds_out, int Lq, int Lk, int D, int H,
                float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int lp = lk_padded(Lk);
  float* Ks = smem;                    // [lp][KSTR]
  float* Vs = Ks + lp * KSTR;          // [lp][KSTR]
  float* Qs = Vs + lp * KSTR;          // [TQ][KSTR]
  float* Os = Qs + TQ * KSTR;          // [TQ][KSTR]  dO tile
  float* Pd = Os + TQ * KSTR;          // [TQ][lp]    dropped probabilities
  float* Ss = Pd + TQ * lp;            // [TQ][lp]    ds
  float* As = Pd;                      // projection chunks (alias Pd/Ss)
  float* Bs = As + TD * ASTR;

  const float* xb = x + (long long)b * Lq * D;
  const float* yb = y + (long long)b * Lk * D;
  const int col0 = h * DH;
  const long long HD = (long long)H * DH;

  for (int r0 = 0; r0 < Lk; r0 += TILE) {
    project_tile<4>(yb, Lk, r0, D, wk, wk_sd, wk_so, bk, col0, As, Bs,
                    Ks + r0 * KSTR, KSTR);
    project_tile<4>(yb, Lk, r0, D, wv, wv_sd, wv_so, bv, col0, As, Bs,
                    Vs + r0 * KSTR, KSTR);
  }

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float* bias_bh =
      bias != nullptr ? bias + (long long)b * sb + (long long)h * sh : nullptr;
  const uint32_t seed = seeds != nullptr ? (uint32_t)seeds[b] : 0u;

  for (int q0 = 0; q0 < Lq; q0 += TQ) {
    // the epilogue writes of the K/V projections, and the previous tile's
    // reads of Qs/Os/Pd/Ss, are behind this barrier
    __syncthreads();
    project_tile<2>(xb, Lq, q0, D, wq, wq_sd, wq_so, bq, col0, As, Bs, Qs,
                    KSTR);
    for (int i = tid; i < TQ * DH; i += THREADS) {
      const int r = i / DH, c = i % DH;
      const int qi = q0 + r;
      Os[r * KSTR + c] =
          qi < Lq ? dout[((long long)b * Lq + qi) * HD + col0 + c] : 0.f;
    }
    __syncthreads();

    for (int r = warp; r < TQ; r += WARPS) {
      const int qi = q0 + r;
      float* prow = Pd + r * lp;
      float* srow = Ss + r * lp;
      if (qi >= Lq) {                    // uniform across the warp
        for (int j = lane; j < Lk; j += 32) prow[j] = srow[j] = 0.f;
        continue;
      }
      float s[MAX_LK / 32], g[MAX_LK / 32];
      float m = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < MAX_LK / 32; ++jj) {
        const int j = lane + 32 * jj;
        float v = -INFINITY, dpd = 0.f;
        if (j < Lk) {
          float acc = 0.f;
#pragma unroll 16
          for (int d = 0; d < DH; ++d) {
            acc = fmaf(Qs[r * KSTR + d], Ks[j * KSTR + d], acc);
            dpd = fmaf(Os[r * KSTR + d], Vs[j * KSTR + d], dpd);
          }
          v = acc * scale;
          if (bias_bh != nullptr)
            v += bias_bh[(long long)qi * sq + (long long)j * sk];
        }
        s[jj] = v;
        g[jj] = dpd;
        m = fmaxf(m, v);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < MAX_LK / 32; ++jj) {
        const int j = lane + 32 * jj;
        const float e = j < Lk ? expf(s[jj] - m) : 0.f;
        s[jj] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      // s <- p (undropped), g <- dp, and the row's sum of dp * p
      float dot = 0.f;
#pragma unroll
      for (int jj = 0; jj < MAX_LK / 32; ++jj) {
        const int j = lane + 32 * jj;
        if (j < Lk) {
          const float p = s[jj] / sum;
          float pd = p, dp = g[jj];
          if (seeds != nullptr) {
            const bool keep = dropout_bits(seed, b, h, qi, j) >= thresh;
            pd = keep ? p * inv_keep : 0.f;
            dp = keep ? dp * inv_keep : 0.f;
          }
          s[jj] = p;
          g[jj] = dp;
          prow[j] = pd;
          dot = fmaf(dp, p, dot);
        }
      }
      dot = warp_sum(dot);
#pragma unroll
      for (int jj = 0; jj < MAX_LK / 32; ++jj) {
        const int j = lane + 32 * jj;
        if (j < Lk) {
          const float dsv = s[jj] * (g[jj] - dot);
          srow[j] = dsv;
          if (ds_out != nullptr)
            ds_out[(((long long)b * H + h) * Lq + qi) * Lk + j] = dsv;
        }
      }
    }
    __syncthreads();

    // dq for the tile's rows: scale * ds K
    for (int i = tid; i < TQ * DH; i += THREADS) {
      const int r = i / DH, c = i % DH;
      const int qi = q0 + r;
      if (qi >= Lq) continue;
      const float* srow = Ss + r * lp;
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(srow[j], Ks[j * KSTR + c], acc);
      dq[((long long)b * Lq + qi) * HD + col0 + c] = acc * scale;
    }
    // the tile's share of dv = pd^T dO and dk = scale ds^T q
    for (int i = tid; i < Lk * DH; i += THREADS) {
      const int j = i / DH, c = i % DH;
      float av = 0.f, ak = 0.f;
#pragma unroll 8
      for (int r = 0; r < TQ; ++r) {
        av = fmaf(Pd[r * lp + j], Os[r * KSTR + c], av);
        ak = fmaf(Ss[r * lp + j], Qs[r * KSTR + c], ak);
      }
      const long long o = ((long long)b * Lk + j) * HD + col0 + c;
      if (q0 == 0) {
        dv[o] = av;
        dk[o] = ak * scale;
      } else {
        dv[o] += av;
        dk[o] += ak * scale;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (b) projection backward: a table of jobs, one launch.

constexpr int MAX_GEMMS = 5;

// C[m, n] = sum over segments s of sum_k A_s[m, k] B_s[k, n], each operand
// read through element strides; C written through (c_sm, c_sn).
struct Gemm {
  const float* a[2];
  long long a_sm[2], a_sk[2];
  const float* b[2];
  long long b_sk[2], b_sn[2];
  int k[2];
  int nseg;
  float* c;
  long long c_sm, c_sn;
  int m, n;
  int tiles_n;       // output tiles along n
  int tile0;         // first block of this job
};

struct Jobs {
  Gemm g[MAX_GEMMS];
  int ngemm;
  // bias gradients: dst[i][o] = sum over rows[i] rows of src[i][row, o]
  const float* col_src[3];
  float* col_dst[3];
  int col_rows[3];
  int ncols;         // H*dh
  int col_tile0;     // first block of the column sums (ceil(ncols/THREADS) per bias)
  // dbias[b, 0, q, k] = sum over h of ds[b, h, q, k] (fixed order)
  const float* ds;
  float* dbias;
  int H;
  long long hsum_qk;  // Lq * Lk
  long long hsum_n;   // B * Lq * Lk (0: no bias gradient)
  int hsum_tile0;
  int blocks;
};

__device__ void gemm_tile(const Gemm& G, int tile, float* As, float* Bs) {
  const int tm = tile / G.tiles_n, tn = tile % G.tiles_n;
  const int m0 = tm * TILE, n0 = tn * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < G.nseg; ++s) {
    const float* A = G.a[s];
    const float* Bm = G.b[s];
    const long long asm_ = G.a_sm[s], ask = G.a_sk[s];
    const long long bsk = G.b_sk[s], bsn = G.b_sn[s];
    const int K = G.k[s];
    for (int k0 = 0; k0 < K; k0 += TD) {
      // A chunk [TILE m][TD k] -> As[k][m]; walk the unit stride
      if (ask == 1) {
        for (int i = tid; i < TILE * TD; i += THREADS) {
          const int r = i / TD, k = i % TD;
          const int gm = m0 + r, gk = k0 + k;
          As[k * ASTR + r] = (gm < G.m && gk < K)
              ? A[(long long)gm * asm_ + gk] : 0.f;
        }
      } else {
        for (int i = tid; i < TILE * TD; i += THREADS) {
          const int k = i / TILE, r = i % TILE;
          const int gm = m0 + r, gk = k0 + k;
          As[k * ASTR + r] = (gm < G.m && gk < K)
              ? A[(long long)gm * asm_ + (long long)gk * ask] : 0.f;
        }
      }
      // B chunk [TD k][TILE n] -> Bs[k][n]
      if (bsn == 1) {
        for (int i = tid; i < TILE * TD; i += THREADS) {
          const int k = i / TILE, c = i % TILE;
          const int gk = k0 + k, gn = n0 + c;
          Bs[k * ASTR + c] = (gk < K && gn < G.n)
              ? Bm[(long long)gk * bsk + gn] : 0.f;
        }
      } else {
        for (int i = tid; i < TILE * TD; i += THREADS) {
          const int c = i / TD, k = i % TD;
          const int gk = k0 + k, gn = n0 + c;
          Bs[k * ASTR + c] = (gk < K && gn < G.n)
              ? Bm[(long long)gk * bsk + (long long)gn * bsn] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < TD; ++k) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k * ASTR + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[k * ASTR + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= G.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < G.n) G.c[(long long)gm * G.c_sm + (long long)gn * G.c_sn] =
          acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS) proj_bwd_kernel(const Jobs J) {
  __shared__ float As[TD * ASTR];
  __shared__ float Bs[TD * ASTR];
  const int blk = blockIdx.x;
  if (blk < J.col_tile0) {
    int g = 0;
    while (g + 1 < J.ngemm && blk >= J.g[g + 1].tile0) ++g;
    gemm_tile(J.g[g], blk - J.g[g].tile0, As, Bs);
  } else if (blk < J.hsum_tile0) {
    const int per = (J.ncols + THREADS - 1) / THREADS;
    const int which = (blk - J.col_tile0) / per;
    const int o = ((blk - J.col_tile0) % per) * THREADS + threadIdx.x;
    if (o >= J.ncols) return;
    const float* src = J.col_src[which];
    float acc = 0.f;
    for (int r = 0; r < J.col_rows[which]; ++r)
      acc += src[(long long)r * J.ncols + o];
    J.col_dst[which][o] = acc;
  } else {
    const long long e =
        (long long)(blk - J.hsum_tile0) * THREADS + threadIdx.x;
    if (e >= J.hsum_n) return;
    // e = b * QK + qk; ds[b, h, q, k] lies at (b * H + h) * QK + qk
    const long long QK = J.hsum_qk;
    const float* src = J.ds + (e / QK) * J.H * QK + e % QK;
    float acc = 0.f;
    for (int h = 0; h < J.H; ++h) acc += src[h * QK];
    J.dbias[e] = acc;
  }
}

void set_gemm(Gemm& g, int m, int n, float* c, long long c_sm,
              long long c_sn) {
  g.m = m;
  g.n = n;
  g.c = c;
  g.c_sm = c_sm;
  g.c_sn = c_sn;
  g.nseg = 0;
  g.tiles_n = (n + TILE - 1) / TILE;
}

void add_segment(Gemm& g, const void* a, long long a_sm, long long a_sk,
                 const void* b, long long b_sk, long long b_sn, int k) {
  const int s = g.nseg++;
  g.a[s] = (const float*)a;
  g.a_sm[s] = a_sm;
  g.a_sk[s] = a_sk;
  g.b[s] = (const float*)b;
  g.b_sk[s] = b_sk;
  g.b_sn[s] = b_sn;
  g.k[s] = k;
}

}  // namespace

extern "C" {

// (a) Launches attn_bwd_kernel on `stream` and returns cudaGetLastError().
// x [B, Lq, D], y [B, Lk, D], weights [D, H*dh] through strides, biases
// [H*dh], additive bias through four strides (null: none), seeds int32
// [B] (null: no dropout), dO [B, Lq, H*dh]; writes dq [B, Lq, H*dh],
// dk, dv [B, Lk, H*dh] and, if ds is not null, ds [B, H, Lq, Lk].
int fused_qkv_mha_bwd_attn(
    const void* x, const void* y,
    const void* wq, long long wq_sd, long long wq_so, const void* bq,
    const void* wk, long long wk_sd, long long wk_so, const void* bk,
    const void* wv, long long wv_sd, long long wv_so, const void* bv,
    const void* bias, long long sb, long long sh, long long sq, long long sk,
    const void* seeds, unsigned int thresh, float inv_keep,
    const void* dout, void* dq, void* dk, void* dv, void* ds,
    int B, int Lq, int Lk, int D, int H, float scale, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Lk > MAX_LK || H < 1 || D < TD ||
      D % TD != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(attn_smem_floats(MAX_LK) * sizeof(float)));
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = attn_smem_floats(Lk) * sizeof(float);
  const dim3 grid(B, H);
  attn_bwd_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y,
      (const float*)wq, wq_sd, wq_so, (const float*)bq,
      (const float*)wk, wk_sd, wk_so, (const float*)bk,
      (const float*)wv, wv_sd, wv_so, (const float*)bv,
      (const float*)bias, sb, sh, sq, sk, (const int*)seeds, thresh,
      inv_keep, (const float*)dout, (float*)dq, (float*)dk, (float*)dv,
      (float*)ds, Lq, Lk, D, H, scale);
  return (int)cudaGetLastError();
}

// (b) Launches proj_bwd_kernel on `stream` and returns cudaGetLastError().
// From dq [B, Lq, H*dh] and dk, dv [B, Lk, H*dh] (written by (a)), x, y and
// the weights (through strides): dx [B, Lq, D], dy [B, Lk, D], the weight
// gradients (through the strides given for them), the bias gradients
// [H*dh] and, if dbias is not null, dbias [B, 1, Lq, Lk] = the sum over
// heads of ds [B, H, Lq, Lk].
int fused_qkv_mha_bwd_proj(
    const void* x, const void* y,
    const void* wq, long long wq_sd, long long wq_so,
    const void* wk, long long wk_sd, long long wk_so,
    const void* wv, long long wv_sd, long long wv_so,
    const void* dq, const void* dk, const void* dv,
    void* dx, void* dy,
    void* dwq, long long dwq_sd, long long dwq_so,
    void* dwk, long long dwk_sd, long long dwk_so,
    void* dwv, long long dwv_sd, long long dwv_so,
    void* dbq, void* dbk, void* dbv, const void* ds, void* dbias,
    int B, int Lq, int Lk, int D, int H, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const int HD = H * DH;
  const int Mq = B * Lq, Mk = B * Lk;
  Jobs J;
  Gemm* g = J.g;
  set_gemm(g[0], Mq, D, (float*)dx, D, 1);                    // dx = dq Wq^T
  add_segment(g[0], dq, HD, 1, wq, wq_so, wq_sd, HD);
  set_gemm(g[1], Mk, D, (float*)dy, D, 1);                    // dy
  add_segment(g[1], dk, HD, 1, wk, wk_so, wk_sd, HD);
  add_segment(g[1], dv, HD, 1, wv, wv_so, wv_sd, HD);
  set_gemm(g[2], D, HD, (float*)dwq, dwq_sd, dwq_so);         // x^T dq
  add_segment(g[2], x, 1, D, dq, HD, 1, Mq);
  set_gemm(g[3], D, HD, (float*)dwk, dwk_sd, dwk_so);         // y^T dk
  add_segment(g[3], y, 1, D, dk, HD, 1, Mk);
  set_gemm(g[4], D, HD, (float*)dwv, dwv_sd, dwv_so);         // y^T dv
  add_segment(g[4], y, 1, D, dv, HD, 1, Mk);
  J.ngemm = MAX_GEMMS;
  int blocks = 0;
  for (int i = 0; i < J.ngemm; ++i) {
    g[i].tile0 = blocks;
    blocks += ((g[i].m + TILE - 1) / TILE) * g[i].tiles_n;
  }
  J.col_tile0 = blocks;
  J.col_src[0] = (const float*)dq;
  J.col_src[1] = (const float*)dk;
  J.col_src[2] = (const float*)dv;
  J.col_dst[0] = (float*)dbq;
  J.col_dst[1] = (float*)dbk;
  J.col_dst[2] = (float*)dbv;
  J.col_rows[0] = Mq;
  J.col_rows[1] = Mk;
  J.col_rows[2] = Mk;
  J.ncols = HD;
  blocks += 3 * ((HD + THREADS - 1) / THREADS);
  J.hsum_tile0 = blocks;
  J.ds = (const float*)ds;
  J.dbias = (float*)dbias;
  J.H = H;
  J.hsum_qk = (long long)Lq * Lk;
  J.hsum_n = dbias != nullptr ? (long long)B * Lq * Lk : 0;
  blocks += (int)((J.hsum_n + THREADS - 1) / THREADS);
  J.blocks = blocks;
  proj_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(J);
  return (int)cudaGetLastError();
}

// Head width the kernels are compiled for, so the wrapper can check it.
int fused_qkv_mha_bwd_head_dim(void) { return DH; }

// Largest key length the attention backward takes.
int fused_qkv_mha_bwd_max_lk(void) { return MAX_LK; }

}  // extern "C"
