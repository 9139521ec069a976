// One launch of GEMM jobs on a tensor-core GEMM core, and the q / k / v
// projection built from it.
//
// A table of up to MAX_JOBS GEMM jobs runs in one launch, and after them
// an elementwise job: the sum over the heads of ds, the bias gradient of
// a [B, 1, Lq, Lk] bias.  `Core` is the float32-accurate 3xTF32 core
// (gemm_tf32x3.cuh, `Tf32x3`), whose `gemm_jobs_kernel<Core>` gives each
// block one tile (or one split-K slice of a tile) of one job, or the bf16
// core (gemm_bf16.cuh, `Bf16`), whose persistent kernel walks the same
// table with one block per SM (`launch_jobs` for `Jobs<Bf16>`, the
// core's launch parameters).  `qkv_jobs` fills the table with the three
// projections q = x Wq + bq, k = y Wk + bk, v = y Wv + bv over all B*L
// rows at once, each [rows, H*dh] written contiguously into one scratch of
// B (Lq + 2 Lk) H*dh elements of the core's type (bf16 for the bf16 core:
// the JAX package's cast of q, k and v before its products): the forward
// (fused_qkv_mha.cu) projects through it, and the backward
// (fused_qkv_mha_bwd.cu) recomputes through the same jobs, so both see the
// same q, k and v bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "gemm_bf16.cuh"
#include "gemm_tf32x3.cuh"

namespace qkv_proj {
// internal linkage: each library that includes this has its own kernel
namespace {

constexpr int MAX_JOBS = 5;
constexpr int THREADS = tf32x3::THREADS;
static_assert(MAX_JOBS == gemm_bf16::MAX_JOBS, "one job table for both cores");

// the float32-accurate core: float operands and results
struct Tf32x3 {
  using T = float;
  using Job = tf32x3::GemmJob;
  static constexpr size_t SMEM_BYTES = tf32x3::SMEM_BYTES;
  static constexpr int BK = tf32x3::BK;   // split-K slices: whole chunks
  __device__ static void block(const Job& j, int s, int tile, void* smem) {
    tf32x3::gemm_block(j, s, tile, static_cast<float*>(smem));
  }
  // C float32 always (the last argument, bf16 C, is the bf16 core's)
  static void job(Job& j, int m, int n, int k, int splits, int kc, void* c,
                  long long c_sm, long long c_sn, long long c_split,
                  int = 0) {
    tf32x3::set_job(j, m, n, k, splits, kc, (float*)c, c_sm, c_sn, c_split);
  }
  static tf32x3::Operand operand(const void* p, long long sr, long long sk) {
    return tf32x3::make_operand(p, sr, sk);
  }
};

// the bf16 core: bf16 operands, C rounded to bf16 unless `job` is told
// otherwise (the split-K weight-gradient slices and the tests' C are float)
struct Bf16 {
  using T = gemm_bf16::bf16;
  using Job = gemm_bf16::GemmJob;
  static constexpr int BK = gemm_bf16::BK;
  static void job(Job& j, int m, int n, int k, int splits, int kc, void* c,
                  long long c_sm, long long c_sn, long long c_split,
                  int c_bf16 = 1) {
    gemm_bf16::set_job(j, m, n, k, splits, kc, c, c_bf16, c_sm, c_sn,
                       c_split);
  }
  static gemm_bf16::Operand operand(const void* p, long long sr,
                                    long long sk) {
    return gemm_bf16::make_operand(p, sr, sk);
  }
};

template <class Core>
struct Jobs {
  typename Core::Job job[MAX_JOBS];
  int njobs;
  int gemm_blocks;
  // dbias[b, 0, q, k] = sum over h of ds[b, h, q, k] (fixed order)
  const float* ds;
  float* dbias;
  int H;
  long long hsum_qk;  // Lq * Lk
  long long hsum_n;   // B * Lq * Lk (0: none)
};

template <class Core>
__global__ void __launch_bounds__(THREADS, 2) gemm_jobs_kernel(
    const Jobs<Core> J) {
  extern __shared__ __align__(16) unsigned char jobs_smem[];
  __shared__ typename Core::Job job;
  const int blk = blockIdx.x;
  if (blk < J.gemm_blocks) {
    int jj = 0;
#pragma unroll
    for (int i = 1; i < MAX_JOBS; ++i)
      if (i < J.njobs && blk >= J.job[i].block0) jj = i;
    if (threadIdx.x == 0) job = J.job[jj];
    __syncthreads();
    const int local = blk - job.block0;
    const int tiles = job.tiles_m * job.tiles_n;
    Core::block(job, local / tiles, local % tiles, jobs_smem);
    return;
  }
  const long long e =
      (long long)(blk - J.gemm_blocks) * THREADS + threadIdx.x;
  if (e >= J.hsum_n) return;
  // e = b * QK + qk; ds[b, h, q, k] lies at (b * H + h) * QK + qk
  const long long QK = J.hsum_qk;
  const float* src = J.ds + (e / QK) * J.H * QK + e % QK;
  float acc = 0.f;
  for (int h = 0; h < J.H; ++h) acc += src[h * QK];
  J.dbias[e] = acc;
}

// the bf16 core's table is its launch parameters
template <>
struct Jobs<Bf16> : gemm_bf16::Params {};

// Numbers the jobs' blocks, launches the table on `stream` and returns
// cudaGetLastError() (0: nothing to launch).
template <class Core>
inline int launch_jobs(Jobs<Core>& J, cudaStream_t stream) {
  int blocks = 0;
  for (int i = 0; i < J.njobs; ++i) {
    J.job[i].block0 = blocks;
    blocks += J.job[i].blocks;
  }
  J.gemm_blocks = blocks;
  blocks += (int)((J.hsum_n + THREADS - 1) / THREADS);
  if (blocks == 0) return 0;
  const cudaError_t e =
      tf32x3::smem_limit<gemm_jobs_kernel<Core>>((int)Core::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  gemm_jobs_kernel<Core><<<blocks, THREADS, Core::SMEM_BYTES, stream>>>(J);
  return (int)cudaGetLastError();
}

inline int launch_jobs(Jobs<Bf16>& J, cudaStream_t stream) {
  return gemm_bf16::launch(J, stream);
}

// The three projection jobs: x [B*Lq, D] and y [B*Lk, D] contiguous, each
// weight [D, HD] read through its strides (W[d, o] at w[d * sd + o * so]),
// biases [HD]; q, k and v [rows, HD] one after the other in qkv, all of
// the core's element type.
template <class Core>
inline void qkv_jobs(Jobs<Core>& J, const void* x, const void* y,
                     const void* const w[3], const long long sd[3],
                     const long long so[3], const void* const bias[3],
                     void* qkv, int B, int Lq, int Lk, int D, int HD) {
  J = Jobs<Core>{};
  J.njobs = 3;
  const void* src[3] = {x, y, y};
  const int rows[3] = {B * Lq, B * Lk, B * Lk};
  typename Core::T* out = static_cast<typename Core::T*>(qkv);
  for (int i = 0; i < 3; ++i) {
    typename Core::Job& j = J.job[i];
    Core::job(j, rows[i], HD, D, 1, 0, out, HD, 1, 0);
    add_seg(j, Core::operand(src[i], D, 1), Core::operand(w[i], so[i], sd[i]),
            D);
    j.bias = static_cast<const typename Core::T*>(bias[i]);
    out += (long long)rows[i] * HD;
  }
}

}  // namespace
}  // namespace qkv_proj
