// One launch of GEMM jobs on the 3xTF32 core (gemm_tf32x3.cuh), and the
// q / k / v projection built from it.
//
// `gemm_jobs_kernel` runs a table of up to MAX_JOBS GEMM jobs in one
// launch, each block one tile (or one split-K slice of a tile) of one job,
// and after them an elementwise job: the sum over the heads of ds, the
// bias gradient of a [B, 1, Lq, Lk] bias.  `qkv_jobs` fills the table with
// the three projections q = x Wq + bq, k = y Wk + bk, v = y Wv + bv over
// all B*L rows at once, each [rows, H*dh] written contiguously into one
// scratch of B (Lq + 2 Lk) H*dh floats: the forward (fused_qkv_mha.cu)
// projects through it, and the backward (fused_qkv_mha_bwd.cu) recomputes
// through the same jobs, so both see the same q, k and v bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "gemm_tf32x3.cuh"

namespace qkv_proj {
// internal linkage: each library that includes this has its own kernel
namespace {

constexpr int MAX_JOBS = 5;
constexpr int THREADS = tf32x3::THREADS;

struct Jobs {
  tf32x3::GemmJob job[MAX_JOBS];
  int njobs;
  int gemm_blocks;
  // dbias[b, 0, q, k] = sum over h of ds[b, h, q, k] (fixed order)
  const float* ds;
  float* dbias;
  int H;
  long long hsum_qk;  // Lq * Lk
  long long hsum_n;   // B * Lq * Lk (0: none)
};

__global__ void __launch_bounds__(THREADS, 2) gemm_jobs_kernel(const Jobs J) {
  extern __shared__ float smem[];
  __shared__ tf32x3::GemmJob job;
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
    tf32x3::gemm_block(job, local / tiles, local % tiles, smem);
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

// Numbers the jobs' blocks, launches the table on `stream` and returns
// cudaGetLastError() (0: nothing to launch).
inline int launch_jobs(Jobs& J, cudaStream_t stream) {
  int blocks = 0;
  for (int i = 0; i < J.njobs; ++i) {
    J.job[i].block0 = blocks;
    blocks += J.job[i].blocks;
  }
  J.gemm_blocks = blocks;
  blocks += (int)((J.hsum_n + THREADS - 1) / THREADS);
  if (blocks == 0) return 0;
  const cudaError_t e =
      tf32x3::smem_limit<gemm_jobs_kernel>((int)tf32x3::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  gemm_jobs_kernel<<<blocks, THREADS, tf32x3::SMEM_BYTES, stream>>>(J);
  return (int)cudaGetLastError();
}

// The three projection jobs: x [B*Lq, D] and y [B*Lk, D] contiguous, each
// weight [D, HD] read through its strides (W[d, o] at w[d * sd + o * so]),
// biases [HD]; q, k and v [rows, HD] one after the other in qkv.
inline void qkv_jobs(Jobs& J, const void* x, const void* y,
                     const void* const w[3], const long long sd[3],
                     const long long so[3], const void* const bias[3],
                     float* qkv, int B, int Lq, int Lk, int D, int HD) {
  J = Jobs{};
  J.njobs = 3;
  const void* src[3] = {x, y, y};
  const int rows[3] = {B * Lq, B * Lk, B * Lk};
  float* out = qkv;
  for (int i = 0; i < 3; ++i) {
    tf32x3::GemmJob& j = J.job[i];
    tf32x3::set_job(j, rows[i], HD, D, 1, 0, out, HD, 1, 0);
    tf32x3::add_seg(j, tf32x3::make_operand(src[i], D, 1),
                    tf32x3::make_operand(w[i], so[i], sd[i]), D);
    j.bias = (const float*)bias[i];
    out += (long long)rows[i] * HD;
  }
}

}  // namespace
}  // namespace qkv_proj
