// Multi-head attention over projected q / k / v, forward only, in float32
// and in bf16.
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
// What bounds it on an H100.  Bytes: the two products are 4 Lq Lk dh
// operations per (b, h) against reading q, k, v and writing out once,
// 4 (2 Lq + 2 Lk) dh bytes; at the hoisted-text shapes it is compared at
// (Lq 50-54, Lk 60) that is 14 operations per byte, and the 3xTF32 split
// on the tensor cores runs 165 TFLOP/s of float32-accurate products
// against 3.35 TB/s, 49 operations per byte, so the memory bounds it
// (a key mask adds its bytes, a [B, H, Lq, Lk] bias more).
//
// Design: the attention-forward core of attn_fwd.cuh, shared with the
// fused forward, without dropout: one block per (batch row, head) stages
// K and V once and walks the query tiles, both products on 3xTF32
// mma.sync fragments, so each byte of q, k, v is read from memory once
// (past 256 keys K and V go in blocks of 256 for each query tile, with an
// online softmax: any Lk).
//
// bf16 (`mha_fwd_bf16`; the TPU kernel takes bf16 q, k, v, upcasts them and
// computes in float32, :49-62): the Hopper core of attn_fwd_sm90.cuh,
// shared with the fused forward's bf16 build (key-tiled, any Lk, TMA and
// wgmma), with p v in two bf16 terms of p so that p keeps float32's
// precision; the bias is read in float32, the output rounded to bf16.
//
// Both builds take the head widths of head_dims.cuh (32, 64, 128, 192,
// 256), one kernel instance each, chosen at launch from `dh`, and any
// wider multiple of 64 on attn_wide.cuh (128-column pieces, float32 sums, p kept in
// float32 in bf16 too); any other width returns cudaErrorInvalidValue
// without a launch.

#include <cuda_runtime.h>

#include "attn_fwd.cuh"
#include "attn_fwd_sm90.cuh"
#include "attn_wide.cuh"
#include "head_dims.cuh"

// The bf16 kernel on the Hopper core (attn_fwd_sm90.cuh): q, k, v and out
// bf16, the bias float32, scores, softmax and p in float32; SPLIT_P: p v
// as two bf16 products of p's high and low parts.  Any Lk.
#define MHA_BF16_ARGS                                                        \
  const void *q, long long q_sb, long long q_sl, long long q_sh,             \
      long long q_sd, const void *k, long long k_sb, long long k_sl,         \
      long long k_sh, long long k_sd, const void *v, long long v_sb,         \
      long long v_sl, long long v_sh, long long v_sd, const void *bias,      \
      long long sb, long long sh, long long sq, long long sk, void *out,     \
      int B, int Lq, int Lk, int H, int dh, float scale, void *stream
#define MHA_BF16_NAMES                                                       \
  q, q_sb, q_sl, q_sh, q_sd, k, k_sb, k_sl, k_sh, k_sd, v, v_sb, v_sl, v_sh, \
      v_sd, bias, sb, sh, sq, sk, out, B, Lq, Lk, H, dh, scale, stream

namespace {

// q, k, v, out of T, the bias float32, on attn_wide.cuh (dh past 256)
template <class T, bool ROUND_P>
int mha_wide(MHA_BF16_ARGS) {
  attn_wide::Params<T, float> W{};
  W.q = {(const T*)q, q_sb, q_sl, q_sh, q_sd};
  W.k = {(const T*)k, k_sb, k_sl, k_sh, k_sd};
  W.v = {(const T*)v, v_sb, v_sl, v_sh, v_sd};
  W.bias = (const float*)bias;
  W.sb = sb;
  W.sh = sh;
  W.sq = sq;
  W.sk = sk;
  W.seeds = nullptr;
  W.thresh = 0;
  W.inv_keep = 1.f;
  W.out = (T*)out;
  W.B = B;
  W.Lq = Lq;
  W.Lk = Lk;
  W.H = H;
  W.dh = dh;
  W.scale = scale;
  return attn_wide::forward<T, float, ROUND_P>(W, (cudaStream_t)stream);
}

template <bool SPLIT_P>
int mha_bf16(MHA_BF16_ARGS) {
  using attn_sm90::bf16;
  if (head_dims::wide(dh)) return mha_wide<bf16, !SPLIT_P>(MHA_BF16_NAMES);
  attn_fwd_sm90::Params<float> P;
  P.q = {(const bf16*)q, q_sb, q_sl, q_sh, q_sd, Lq};
  P.k = {(const bf16*)k, k_sb, k_sl, k_sh, k_sd, Lk};
  P.v = {(const bf16*)v, v_sb, v_sl, v_sh, v_sd, Lk};
  P.bias = (const float*)bias;
  P.sb = sb;
  P.sh = sh;
  P.sq = sq;
  P.sk = sk;
  P.seeds = nullptr;
  P.thresh = 0;
  P.inv_keep = 1.f;
  P.out = (bf16*)out;
  P.H = H;
  P.scale = scale;
  return attn_fwd_sm90::launch<float, SPLIT_P>(P, B, dh,
                                               (cudaStream_t)stream);
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
            long long sk, void* out, int B, int Lq, int Lk, int H, int dh,
            float scale, void* stream) {
  if (head_dims::wide(dh))
    return mha_wide<float, false>(q, q_sb, q_sl, q_sh, q_sd, k, k_sb, k_sl,
                                  k_sh, k_sd, v, v_sb, v_sl, v_sh, v_sd,
                                  bias, sb, sh, sq, sk, out, B, Lq, Lk, H,
                                  dh, scale, stream);
  attn_fwd::Args A;
  A.q = (const float*)q;
  A.qs = {q_sb, q_sl, q_sh, q_sd};
  A.k = (const float*)k;
  A.ks = {k_sb, k_sl, k_sh, k_sd};
  A.v = (const float*)v;
  A.vs = {v_sb, v_sl, v_sh, v_sd};
  A.bias = (const float*)bias;
  A.sb = sb;
  A.sh = sh;
  A.sq = sq;
  A.sk = sk;
  A.seeds = nullptr;
  A.thresh = 0;
  A.inv_keep = 1.f;
  A.out = (float*)out;
  A.Lq = Lq;
  A.Lk = Lk;
  A.H = H;
  A.scale = scale;
  return attn_fwd::launch(A, B, dh, (cudaStream_t)stream);
}

// The same in bf16: q, k, v and out bf16, the bias float32, scores,
// softmax and p in float32 (p v as two bf16 products of p's high and low
// parts); any Lk.
int mha_fwd_bf16(MHA_BF16_ARGS) { return mha_bf16<true>(MHA_BF16_NAMES); }

// The bf16 kernel with p v as one product of p rounded to bf16, the
// precision the TPU kernel does not have: exported only as the control of
// the bf16 kernel's one-rounding check (chip_smoke.py), which must fail
// it.
int mha_fwd_bf16_one_term(MHA_BF16_ARGS) {
  return mha_bf16<false>(MHA_BF16_NAMES);
}

// The head widths the kernels are compiled for, then the step of the widths
// past them that attn_wide.cuh takes (the first n into out), so the
// wrapper can check a call's; returns how many there are.
int mha_head_dims(int* out, int n) { return head_dims::query(out, n); }

// The route of this library's last bf16 launch: 1 q, k and v by TMA, 0
// loaded directly, -1 none yet.
int mha_attn_route(void) { return attn_sm90::last_route(); }

}  // extern "C"
