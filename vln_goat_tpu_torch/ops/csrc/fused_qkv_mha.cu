// Fused q/k/v projections + multi-head attention, forward, in float32 and
// in bf16.
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
// What bounds it on an H100.  Operations: the projections are
// 2 B (Lq + 2 Lk) D H*dh, 12 GFLOP a launch on average over the batch-64
// train mix (13.6 at text60), against 7 MB of weights and 10-35 MB of
// activations; the two attention products add a twentieth.  In the
// float32-accurate 3xTF32 split the tensor cores give a third of their 495
// TFLOP/s of TF32, so the bound is about 0.072 ms a launch on that mix
// (0.18 ms on the 67 TFLOP/s of the float32 CUDA cores).
//
// Design: two launches, both on the tensor cores in the 3xTF32 split.
//   1. The projections as three jobs of one GEMM launch over all B*L rows
//      (qkv_proj.cuh on gemm_tf32x3.cuh: wgmma m64n128k8, 128 x 128 tiles,
//      a cp.async ring), into scratch of B (Lq + 2 Lk) H*dh floats that the
//      wrapper frees on return.  They are the jobs through which the
//      backward (fused_qkv_mha_bwd.cu) recomputes q, k and v; one GEMM over
//      all rows reads each weight once per 128-row tile instead of once per
//      (batch row, head, query tile), and keeps the tensor cores on large
//      tiles.  The forward saves nothing for the backward, which
//      recomputes, as the JAX kernel does (`_fa_bwd_kernel` :200).
//   2. The attention over that scratch, attn_fwd.cuh: one block per (batch
//      row, head), K and V staged once per head up to 256 keys (in blocks
//      of 256 with an online softmax past that, so any Lk), both products
//      on 3xTF32 mma.sync fragments.
// Head widths: the attention kernels of either build are templates of the
// head width, one instance for each of head_dims.cuh's 32, 64, 128, 192
// and 256, chosen at launch from the `dh` argument; a head wider than 256
// that is a multiple of 64 runs on attn_wide.cuh (128-column pieces,
// float32 sums on the CUDA cores); the projections only see H dh.  Any other width returns
// cudaErrorInvalidValue before a launch.
//
// bf16 (the JAX package's bf16 model, whose kernel takes bf16 operands and
// sums in float32: `_bdot(..., dt=x.dtype)` :120-137): the `_bf16` entries
// take x, y, the weights, the biases and the additive bias in bf16 and
// return the output in bf16.  The projections run on the bf16 core
// (gemm_bf16.cuh: one persistent block per SM, a producer warp feeding a
// TMA ring, wgmma m64n256k16 on both operands in shared memory, whatever
// the weights' layout) with float32 sums plus the bias,
// rounded to bf16 into a scratch of half the float32 size (the JAX kernel
// casts q, k and v to bf16 before its products); the attention runs on the
// Hopper core of attn_fwd_sm90.cuh (persistent blocks over 64-row query
// tiles, k and v by 64-key tiles through a TMA ring, q k^T and p v on
// wgmma with the scores in registers and an online softmax, so any Lk):
// float32 scores, softmax and dropout, e = exp(s - max) rounded to bf16
// before p v.  Bound: the same operations at the 989 TFLOP/s of bf16,
// about 0.012 ms a launch on the train mix; the attention part alone is
// bound by its bytes (attn_fwd_sm90.cuh).
//
// Dropout (`_fa_probs` :149-166): with per-row seeds the normalised
// probabilities pass through the counter-based keep mask of
// dropout_hash.cuh, keyed by seed[b] with the counter (b, h, q, k), so the
// backward kernel regenerates the same mask.  Without seeds, no mask.

#include <cuda_runtime.h>

#include "attn_fwd.cuh"
#include "attn_fwd_sm90.cuh"
#include "attn_wide.cuh"
#include "head_dims.cuh"
#include "qkv_proj.cuh"

namespace {

template <class Core>
int proj(const void* x, const void* y, const void* wq, long long wq_sd,
         long long wq_so, const void* bq, const void* wk, long long wk_sd,
         long long wk_so, const void* bk, const void* wv, long long wv_sd,
         long long wv_so, const void* bv, void* qkv, int B, int Lq, int Lk,
         int D, int H, int dh, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || D < 1 || dh < 1)
    return (int)cudaErrorInvalidValue;
  const void* w[3] = {wq, wk, wv};
  const long long sd[3] = {wq_sd, wk_sd, wv_sd};
  const long long so[3] = {wq_so, wk_so, wv_so};
  const void* b[3] = {bq, bk, bv};
  qkv_proj::Jobs<Core> J;
  qkv_proj::qkv_jobs(J, x, y, w, sd, so, b, qkv, B, Lq, Lk, D, H * dh);
  return qkv_proj::launch_jobs(J, (cudaStream_t)stream);
}

// The attention over a projection scratch laid out as fwd's (q, then k
// and v) into out.
template <class T>
int attend(const void* qkv, const void* bias, long long sb, long long sh,
           long long sq, long long sk, void* out, int B, int Lq, int Lk,
           int H, int dh, float scale, const void* seeds,
           unsigned int thresh, float inv_keep, cudaStream_t stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || dh < 1)
    return (int)cudaErrorInvalidValue;
  const int HD = H * dh;
  const T* qs = (const T*)qkv;
  const T* ks = qs + (long long)B * Lq * HD;
  const T* vs = ks + (long long)B * Lk * HD;
  if (head_dims::wide(dh)) {
    attn_wide::Params<T, T> W{};
    W.q = {qs, (long long)Lq * HD, HD, dh, 1};
    W.k = {ks, (long long)Lk * HD, HD, dh, 1};
    W.v = {vs, (long long)Lk * HD, HD, dh, 1};
    W.bias = (const T*)bias;
    W.sb = sb;
    W.sh = sh;
    W.sq = sq;
    W.sk = sk;
    W.seeds = (const int*)seeds;
    W.thresh = thresh;
    W.inv_keep = inv_keep;
    W.out = (T*)out;
    W.B = B;
    W.Lq = Lq;
    W.Lk = Lk;
    W.H = H;
    W.dh = dh;
    W.scale = scale;
    return attn_wide::forward<T, T, sizeof(T) == 2>(W, stream);
  }
  if constexpr (sizeof(T) == 2) {
    // the Hopper core, over the scratch as [B, L, H, dh] heads
    attn_fwd_sm90::Params<T> P;
    P.q = {qs, (long long)Lq * HD, HD, dh, 1, Lq};
    P.k = {ks, (long long)Lk * HD, HD, dh, 1, Lk};
    P.v = {vs, (long long)Lk * HD, HD, dh, 1, Lk};
    P.bias = (const T*)bias;
    P.sb = sb;
    P.sh = sh;
    P.sq = sq;
    P.sk = sk;
    P.seeds = (const int*)seeds;
    P.thresh = thresh;
    P.inv_keep = inv_keep;
    P.out = (T*)out;
    P.H = H;
    P.scale = scale;
    return attn_fwd_sm90::launch<T, false>(P, B, dh, stream);
  } else {
    attn_fwd::Args A;
    A.q = qs;
    A.qs = {(long long)Lq * HD, HD, dh, 1};
    A.k = ks;
    A.ks = {(long long)Lk * HD, HD, dh, 1};
    A.v = vs;
    A.vs = A.ks;
    A.bias = (const float*)bias;
    A.sb = sb;
    A.sh = sh;
    A.sq = sq;
    A.sk = sk;
    A.seeds = (const int*)seeds;
    A.thresh = thresh;
    A.inv_keep = inv_keep;
    A.out = (T*)out;
    A.Lq = Lq;
    A.Lk = Lk;
    A.H = H;
    A.scale = scale;
    return attn_fwd::launch(A, B, dh, stream);
  }
}

template <class Core>
int fwd(const void* x, const void* y, const void* wq, long long wq_sd,
        long long wq_so, const void* bq, const void* wk, long long wk_sd,
        long long wk_so, const void* bk, const void* wv, long long wv_sd,
        long long wv_so, const void* bv, const void* bias, long long sb,
        long long sh, long long sq, long long sk, void* out, void* qkv,
        int B, int Lq, int Lk, int D, int H, int dh, float scale,
        const void* seeds, unsigned int thresh, float inv_keep,
        void* stream) {
  const int rc = proj<Core>(x, y, wq, wq_sd, wq_so, bq, wk, wk_sd, wk_so, bk,
                            wv, wv_sd, wv_so, bv, qkv, B, Lq, Lk, D, H, dh,
                            stream);
  if (rc != 0) return rc;
  return attend<typename Core::T>(qkv, bias, sb, sh, sq, sk, out, B, Lq, Lk,
                                  H, dh, scale, seeds, thresh, inv_keep,
                                  (cudaStream_t)stream);
}

}  // namespace

extern "C" {

#define PROJ_ARGS                                                            \
  const void *x, const void *y, const void *wq, long long wq_sd,            \
      long long wq_so, const void *bq, const void *wk, long long wk_sd,      \
      long long wk_so, const void *bk, const void *wv, long long wv_sd,      \
      long long wv_so, const void *bv
#define PROJ_NAMES \
  x, y, wq, wq_sd, wq_so, bq, wk, wk_sd, wk_so, bk, wv, wv_sd, wv_so, bv
#define FWD_ARGS                                                             \
  PROJ_ARGS, const void *bias, long long sb, long long sh, long long sq,     \
      long long sk, void *out, void *qkv, int B, int Lq, int Lk, int D,      \
      int H, int dh, float scale, const void *seeds, unsigned int thresh,    \
      float inv_keep, void *stream
#define FWD_NAMES                                                            \
  PROJ_NAMES, bias, sb, sh, sq, sk, out, qkv, B, Lq, Lk, D, H, dh, scale,    \
      seeds, thresh, inv_keep, stream

// The forward's first launch alone: q, k and v into `qkv` (laid out as
// fused_qkv_mha_fwd's).  Returns cudaGetLastError().  Exported for timing the
// projection apart from the attention; the wrapper calls the whole
// forward.  Weights [D, H*dh] through strides (W[d, o] at w[d sd + o so]).
int fused_qkv_mha_proj(PROJ_ARGS, void* qkv, int B, int Lq, int Lk, int D,
                       int H, int dh, void* stream) {
  return proj<qkv_proj::Tf32x3>(PROJ_NAMES, qkv, B, Lq, Lk, D, H, dh,
                                stream);
}

int fused_qkv_mha_proj_bf16(PROJ_ARGS, void* qkv, int B, int Lq, int Lk,
                            int D, int H, int dh, void* stream) {
  return proj<qkv_proj::Bf16>(PROJ_NAMES, qkv, B, Lq, Lk, D, H, dh, stream);
}

// Launches the forward on `stream` and returns the first CUDA error (0
// when every launch was accepted).  Shapes it does not take return
// cudaErrorInvalidValue without launching.  `seeds` (int32 [B]) turns on
// dropout: keep iff bits >= thresh, kept probabilities times inv_keep;
// null: no dropout.  `qkv` is scratch of B (Lq + 2 Lk) H*dh elements:
// q [B*Lq, H*dh], then k and v [B*Lk, H*dh].  float32 throughout; the
// `_bf16` entry takes every tensor (scratch and output too) in bf16.
int fused_qkv_mha_fwd(FWD_ARGS) {
  return fwd<qkv_proj::Tf32x3>(FWD_NAMES);
}

int fused_qkv_mha_fwd_bf16(FWD_ARGS) { return fwd<qkv_proj::Bf16>(FWD_NAMES); }

// The bf16 forward's second launch alone (the attention core of
// attn_fwd_sm90.cuh over a scratch that fused_qkv_mha_proj_bf16 filled):
// exported for timing the core apart from the projection; the wrapper
// calls the whole forward.  Arguments as fused_qkv_mha_fwd_bf16's.
int fused_qkv_mha_attn_bf16(const void* qkv, const void* bias, long long sb,
                            long long sh, long long sq, long long sk,
                            void* out, int B, int Lq, int Lk, int H, int dh,
                            float scale, const void* seeds,
                            unsigned int thresh, float inv_keep,
                            void* stream) {
  return attend<attn_sm90::bf16>(qkv, bias, sb, sh, sq, sk, out, B, Lq, Lk,
                                 H, dh, scale, seeds, thresh, inv_keep,
                                 (cudaStream_t)stream);
}

// The head widths the attention kernels are compiled for, then the step of
// the widths past them that attn_wide.cuh takes (the first n into out), so
// the wrapper can check a call's; returns how many there are.
int fused_qkv_mha_head_dims(int* out, int n) {
  return head_dims::query(out, n);
}

// The route of this library's last bf16 projection launch: 1 every operand
// by TMA, 0 at least one loaded directly, -1 no launch yet.
int fused_qkv_mha_bf16_route(void) { return gemm_bf16::last_route(); }

// The route of this library's last bf16 attention launch
// (attn_fwd_sm90.cuh): 1 q, k and v by TMA, 0 loaded directly, -1 none yet.
int fused_qkv_mha_attn_route(void) { return attn_sm90::last_route(); }

}  // extern "C"
