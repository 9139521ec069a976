// Fused q/k/v projections + multi-head attention, forward, float32.
//
// Replaces the TPU kernel `_fa_fwd_kernel` (vln_goat_tpu/ops/attention.py:169),
// launched by `_fa_call` (:251) behind `pallas_fused_qkv_mha` (:347).  It
// computes, for every batch row b and head h:
//
//   q = x[b] Wq[:, h] + bq[h]    k = y[b] Wk[:, h] + bk[h]    v = y[b] Wv[:, h] + bv[h]
//   s = q k^T / sqrt(dh) + bias[b, h or 0]
//   p = softmax(s) along the keys (row max subtracted, float32)
//   p = keep(b, h, q, k) ? p / (1 - rate) : 0      (training dropout)
//   out[b, :, h*dh:(h+1)*dh] = p v
//
// Layouts: x [B, Lq, D] and y [B, Lk, D] contiguous; each weight is the
// [D, H*dh] matrix of the JAX package, read through two element strides so
// that a torch Linear weight ([H*dh, D] row-major) is taken as it lies;
// biases [H*dh]; the additive bias is read through four element strides
// (0 on a broadcast dimension); out [B, Lq, H*dh] contiguous.
//
// Design.  One block per (batch row, head, tile of 64 query rows).  The
// block projects its 64 query rows and all Lk key/value rows of its head
// into shared memory (tiled over D in chunks of 32, a 4x4 register tile per
// thread), then each warp takes query rows one at a time: scores in
// registers (one key per lane and 32-key group), warp-shuffle max and sum,
// probabilities through a per-warp row of shared memory, and each lane
// writes two of the 64 output columns.  Lk <= 256, so K and V of one head
// fit in shared memory (about 170 KB at Lk = 256).
//
// Dropout (`_fa_probs` :149-166): with per-row seeds the normalised
// probabilities pass through the counter-based keep mask of
// dropout_hash.cuh, keyed by seed[b] with the counter (b, h, q, k), so the
// backward kernel (fused_qkv_mha_bwd.cu) regenerates the same mask.  With
// no seeds the deterministic instantiation runs, without the mask code.
//
// What bounds it on an H100.  The projections dominate: at the text call
// of the R2R rollout (B = 8, L = 60, D = 768, H = 12) they are 3 * 2 * 8 *
// 60 * 768 * 768 = 1.7 GFLOP against 7 MB of weights and 3 MB of
// activations, so the work is bound by operations.  This first version
// runs them on the float32 CUDA cores (no tensor cores, no TMA/wgmma), and
// blocks with more than one query tile recompute their head's K and V.
// Both are left for a later change.

#include <cuda_runtime.h>
#include <math.h>

#include "dropout_hash.cuh"

namespace {

constexpr int DH = 64;          // head width the kernel is written for
constexpr int TILE = 64;        // query rows per block; rows per projection tile
constexpr int TD = 32;          // depth of one projection chunk (D % TD == 0)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LK = 256;
constexpr int KSTR = DH + 1;    // padded row strides in shared memory
constexpr int ASTR = TILE + 1;
constexpr int BSTR = TILE + 1;

__host__ __device__ inline int lk_padded(int Lk) {
  return ((Lk + TILE - 1) / TILE) * TILE;
}

__host__ inline size_t smem_floats(int Lk) {
  const int lp = lk_padded(Lk);
  return (size_t)TILE * DH + (size_t)lp * (KSTR + DH) + (size_t)WARPS * lp +
         (size_t)TD * (ASTR + BSTR);
}

// dst[r * dstr + c] = src[row0 + r, :] . W[:, col0 + c] + bias[col0 + c]
// for r, c < 64; rows at or past nrows read as zero.  W[d, o] lies at
// w[d * sd + o * so].  Ends with a block-wide barrier.
__device__ void project_tile(const float* __restrict__ src, int nrows,
                             int row0, int D, const float* __restrict__ w,
                             long long sd, long long so,
                             const float* __restrict__ bias, int col0,
                             float* As, float* Bs, float* dst, int dstr) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += TD) {
    // source chunk, stored depth-major: As[k][r]
    for (int i = tid; i < TILE * TD; i += THREADS) {
      const int r = i / TD, k = i % TD;
      const int row = row0 + r;
      As[k * ASTR + r] =
          row < nrows ? src[(long long)row * D + d0 + k] : 0.f;
    }
    // weight chunk Bs[k][c]; consecutive threads walk the unit stride
    if (sd == 1) {
      for (int i = tid; i < TILE * TD; i += THREADS) {
        const int c = i / TD, k = i % TD;
        Bs[k * BSTR + c] = w[(long long)(d0 + k) + (long long)(col0 + c) * so];
      }
    } else {
      for (int i = tid; i < TILE * TD; i += THREADS) {
        const int k = i / TILE, c = i % TILE;
        Bs[k * BSTR + c] =
            w[(long long)(d0 + k) * sd + (long long)(col0 + c) * so];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TD; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k * ASTR + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k * BSTR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[(ty + 16 * i) * dstr + tx + 16 * j] =
          acc[i][j] + bias[col0 + tx + 16 * j];
}

// DROP: the dropout variant; the deterministic one (DROP = false) is
// compiled without the mask code, so it stays the kernel it was before.
template <bool DROP>
__global__ void __launch_bounds__(THREADS)
fused_qkv_mha_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         const float* __restrict__ wq, long long wq_sd,
                         long long wq_so, const float* __restrict__ bq,
                         const float* __restrict__ wk, long long wk_sd,
                         long long wk_so, const float* __restrict__ bk,
                         const float* __restrict__ wv, long long wv_sd,
                         long long wv_so, const float* __restrict__ bv,
                         const float* __restrict__ bias, long long sb,
                         long long sh, long long sq, long long sk,
                         float* __restrict__ out, int Lq, int Lk, int D,
                         int H, float scale, const int* __restrict__ seeds,
                         unsigned int thresh, float inv_keep) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * TILE;
  const int lp = lk_padded(Lk);
  float* Qs = smem;                    // [TILE][DH]
  float* Ks = Qs + TILE * DH;          // [lp][KSTR]
  float* Vs = Ks + lp * KSTR;          // [lp][DH]
  float* Ps = Vs + lp * DH;            // [WARPS][lp]
  float* As = Ps + WARPS * lp;         // [TD][ASTR]
  float* Bs = As + TD * ASTR;          // [TD][BSTR]

  const float* xb = x + (long long)b * Lq * D;
  const float* yb = y + (long long)b * Lk * D;
  const int col0 = h * DH;

  project_tile(xb, Lq, q0, D, wq, wq_sd, wq_so, bq, col0, As, Bs, Qs, DH);
  for (int r0 = 0; r0 < Lk; r0 += TILE) {
    project_tile(yb, Lk, r0, D, wk, wk_sd, wk_so, bk, col0, As, Bs,
                 Ks + r0 * KSTR, KSTR);
    project_tile(yb, Lk, r0, D, wv, wv_sd, wv_so, bv, col0, As, Bs,
                 Vs + r0 * DH, DH);
  }
  // project_tile ends with a barrier after its last shared-memory read,
  // but the epilogue writes of the last tile must be visible to all warps
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* P = Ps + warp * lp;
  const float* bias_bh =
      bias != nullptr ? bias + (long long)b * sb + (long long)h * sh : nullptr;
  const long long HD = (long long)H * DH;

  for (int r = warp; r < TILE; r += WARPS) {
    const int qi = q0 + r;
    if (qi >= Lq) break;                 // uniform across the warp
    float s[MAX_LK / 32];
    float m = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < MAX_LK / 32; ++jj) {
      const int j = lane + 32 * jj;
      float v = -INFINITY;
      if (j < Lk) {
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d)
          acc = fmaf(Qs[r * DH + d], Ks[j * KSTR + d], acc);
        v = acc * scale;
        if (bias_bh != nullptr)
          v += bias_bh[(long long)qi * sq + (long long)j * sk];
      }
      s[jj] = v;
      m = fmaxf(m, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < MAX_LK / 32; ++jj) {
      const int j = lane + 32 * jj;
      const float e = j < Lk ? expf(s[jj] - m) : 0.f;
      s[jj] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (!DROP) {
#pragma unroll
      for (int jj = 0; jj < MAX_LK / 32; ++jj) {
        const int j = lane + 32 * jj;
        if (j < Lk) P[j] = s[jj] / sum;
      }
    } else {
      const uint32_t seed = (uint32_t)seeds[b];
#pragma unroll
      for (int jj = 0; jj < MAX_LK / 32; ++jj) {
        const int j = lane + 32 * jj;
        if (j < Lk) {
          const bool keep = dropout_bits(seed, b, h, qi, j) >= thresh;
          P[j] = keep ? (s[jj] / sum) * inv_keep : 0.f;
        }
      }
    }
    __syncwarp();
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < Lk; ++j) {
      const float p = P[j];
      o0 = fmaf(p, Vs[j * DH + lane], o0);
      o1 = fmaf(p, Vs[j * DH + lane + 32], o1);
    }
    float* orow = out + ((long long)b * Lq + qi) * HD + col0;
    orow[lane] = o0;
    orow[lane + 32] = o1;
    __syncwarp();                        // P is rewritten by the next row
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  Shapes it does not take return
// cudaErrorInvalidValue without launching.  `seeds` (int32 [B]) turns on
// dropout: keep iff bits >= thresh, kept probabilities times inv_keep;
// null runs the deterministic kernel.
int fused_qkv_mha_fwd(const void* x, const void* y,
                      const void* wq, long long wq_sd, long long wq_so,
                      const void* bq,
                      const void* wk, long long wk_sd, long long wk_so,
                      const void* bk,
                      const void* wv, long long wv_sd, long long wv_so,
                      const void* bv,
                      const void* bias, long long sb, long long sh,
                      long long sq, long long sk,
                      void* out, int B, int Lq, int Lk, int D, int H,
                      float scale, const void* seeds, unsigned int thresh,
                      float inv_keep, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Lk > MAX_LK || H < 1 || D < TD ||
      D % TD != 0)
    return (int)cudaErrorInvalidValue;
  // The attribute is per device, so it is set on every call (on the
  // current device), at the size the largest Lk needs: no state is kept
  // between calls or shared between threads.
  auto kernel = seeds != nullptr ? fused_qkv_mha_fwd_kernel<true>
                                 : fused_qkv_mha_fwd_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(MAX_LK) * sizeof(float)));
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = smem_floats(Lk) * sizeof(float);
  const dim3 grid(B, H, (Lq + TILE - 1) / TILE);
  kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y,
      (const float*)wq, wq_sd, wq_so, (const float*)bq,
      (const float*)wk, wk_sd, wk_so, (const float*)bk,
      (const float*)wv, wv_sd, wv_so, (const float*)bv,
      (const float*)bias, sb, sh, sq, sk,
      (float*)out, Lq, Lk, D, H, scale, (const int*)seeds, thresh,
      inv_keep);
  return (int)cudaGetLastError();
}

// Head width the kernel is compiled for, so the wrapper can check it.
int fused_qkv_mha_head_dim(void) { return DH; }

// Largest key length the kernel takes.
int fused_qkv_mha_max_lk(void) { return MAX_LK; }

}  // extern "C"
