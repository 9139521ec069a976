// Multi-head attention over projected q / k / v, forward only, float32.
//
// Replaces the TPU kernel `_mha_kernel` (vln_goat_tpu/ops/attention.py:49),
// launched by `_pallas_mha_impl` (:66, `pallas_call` :92) behind
// `pallas_mha` (:104).  For every batch row b and head h:
//
//   s = q[b, :, h] k[b, :, h]^T / sqrt(dh) + bias[b, h or 0]
//   p = softmax(s) along the keys (row max subtracted, float32)
//   out[b, :, h*dh:(h+1)*dh] = p v[b, :, h]
//
// Layouts: q [B, Lq, H, dh], k and v [B, Lk, H, dh], each read through
// its four element strides, so a view (a slice of a packed projection, a
// transpose) needs no copy; the TPU wrapper transposes to [B*H, L, dh]
// outside its kernel, this one reads the heads where they lie.  The
// additive bias is read through four element strides (0 on a broadcast
// dimension); out [B, Lq, H*dh] contiguous.
//
// Design.  One block per (batch row, head, tile of 64 query rows).  The
// block copies its head's K (padded rows, so the per-lane key loop reads
// without bank conflicts) and V for all Lk <= 256 keys and its 64 query
// rows into shared memory, then each warp takes query rows one at a time:
// scores in registers (one key per lane and 32-key group), warp-shuffle
// max and sum, probabilities through a per-warp row of shared memory, and
// each lane writes two of the 64 output columns.  Shared memory at
// Lk = 256: 64 x 64 (q) + 256 x 65 (K) + 256 x 64 (V) + 8 x 256 (p) floats,
// 153 KB.
//
// What bounds it on an H100.  At the shapes it is held at (Lq, Lk <= 60,
// dh = 64) the two products are 4 * Lq * Lk * dh operations per (b, h)
// against reading q, k, v and writing out once, 4 * (2 Lq + 2 Lk) * dh
// bytes: at Lq 50, Lk 60, 4 * 50 * 60 * 64 / (4 * 220 * 64) = 14
// operations per byte, under the card's float32 balance of 67 / 3.35 = 20,
// so the bytes bound it.  This first version
// computes on the float32 CUDA cores and re-reads K and V for each query
// tile of a head (one tile at Lq <= 64).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 64;          // head width the kernel is written for
constexpr int TILE = 64;        // query rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LK = 256;
constexpr int KSTR = DH + 1;    // padded row stride of K in shared memory

__host__ __device__ inline int lk_padded(int Lk) {
  return ((Lk + 31) / 32) * 32;
}

__host__ inline size_t smem_floats(int Lk) {
  const int lp = lk_padded(Lk);
  return (size_t)TILE * DH + (size_t)lp * (KSTR + DH) + (size_t)WARPS * lp;
}

struct Strides {
  long long b, l, h, d;
};

__global__ void __launch_bounds__(THREADS)
mha_fwd_kernel(const float* __restrict__ q, Strides qs,
               const float* __restrict__ k, Strides ks,
               const float* __restrict__ v, Strides vs,
               const float* __restrict__ bias, long long sb, long long sh,
               long long sq, long long sk, float* __restrict__ out, int Lq,
               int Lk, int H, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * TILE;
  const int lp = lk_padded(Lk);
  float* Qs = smem;                    // [TILE][DH]
  float* Ks = Qs + TILE * DH;          // [lp][KSTR]
  float* Vs = Ks + lp * KSTR;          // [lp][DH]
  float* Ps = Vs + lp * DH;            // [WARPS][lp]

  const int tid = threadIdx.x;
  const float* qb = q + (long long)b * qs.b + (long long)h * qs.h;
  const float* kb = k + (long long)b * ks.b + (long long)h * ks.h;
  const float* vb = v + (long long)b * vs.b + (long long)h * vs.h;
  // consecutive threads take consecutive columns of a row
  for (int i = tid; i < TILE * DH; i += THREADS) {
    const int r = i / DH, c = i % DH;
    const int qi = q0 + r;
    Qs[i] = qi < Lq ? qb[(long long)qi * qs.l + (long long)c * qs.d] : 0.f;
  }
  for (int i = tid; i < Lk * DH; i += THREADS) {
    const int j = i / DH, c = i % DH;
    Ks[j * KSTR + c] = kb[(long long)j * ks.l + (long long)c * ks.d];
    Vs[j * DH + c] = vb[(long long)j * vs.l + (long long)c * vs.d];
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
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
      float val = -INFINITY;
      if (j < Lk) {
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d)
          acc = fmaf(Qs[r * DH + d], Ks[j * KSTR + d], acc);
        val = acc * scale;
        if (bias_bh != nullptr)
          val += bias_bh[(long long)qi * sq + (long long)j * sk];
      }
      s[jj] = val;
      m = fmaxf(m, val);
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
#pragma unroll
    for (int jj = 0; jj < MAX_LK / 32; ++jj) {
      const int j = lane + 32 * jj;
      if (j < Lk) P[j] = s[jj] / sum;
    }
    __syncwarp();
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < Lk; ++j) {
      const float p = P[j];
      o0 = fmaf(p, Vs[j * DH + lane], o0);
      o1 = fmaf(p, Vs[j * DH + lane + 32], o1);
    }
    float* orow = out + ((long long)b * Lq + qi) * HD + (long long)h * DH;
    orow[lane] = o0;
    orow[lane + 32] = o1;
    __syncwarp();                        // P is rewritten by the next row
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  Shapes it does not take return
// cudaErrorInvalidValue without launching.  q, k, v: pointer and four
// element strides (batch, position, head, column); bias: pointer (null:
// none) and four strides.
int mha_fwd(const void* q, long long q_sb, long long q_sl, long long q_sh,
            long long q_sd,
            const void* k, long long k_sb, long long k_sl, long long k_sh,
            long long k_sd,
            const void* v, long long v_sb, long long v_sl, long long v_sh,
            long long v_sd,
            const void* bias, long long sb, long long sh, long long sq,
            long long sk, void* out, int B, int Lq, int Lk, int H,
            float scale, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Lk > MAX_LK || H < 1)
    return (int)cudaErrorInvalidValue;
  // per device, so set on every call (on the current device), at the
  // largest Lk's size: no state is kept between calls
  const cudaError_t e = cudaFuncSetAttribute(
      mha_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(MAX_LK) * sizeof(float)));
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = smem_floats(Lk) * sizeof(float);
  const dim3 grid(B, H, (Lq + TILE - 1) / TILE);
  mha_fwd_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)q, Strides{q_sb, q_sl, q_sh, q_sd},
      (const float*)k, Strides{k_sb, k_sl, k_sh, k_sd},
      (const float*)v, Strides{v_sb, v_sl, v_sh, v_sd},
      (const float*)bias, sb, sh, sq, sk, (float*)out, Lq, Lk, H, scale);
  return (int)cudaGetLastError();
}

// Head width the kernel is compiled for, so the wrapper can check it.
int mha_head_dim(void) { return DH; }

// Largest key length the kernel takes.
int mha_max_lk(void) { return MAX_LK; }

}  // extern "C"
