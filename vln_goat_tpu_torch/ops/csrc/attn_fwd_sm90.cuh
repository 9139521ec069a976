// Attention forward in bf16 for Hopper: K1 bf16's attention part
// (fused_qkv_mha.cu, over its projection scratch) and the bf16 K3
// (mha.cu, over the caller's views).  The float32 builds keep
// attn_fwd.cuh.
//
// For batch row b and head h, over bf16 q, k, v (and a bias of BiasT):
//
//   s = q k^T * scale + bias[b, h]                   (float32)
//   out[b, :, h*dh:(h+1)*dh] = softmax(s) v          (dropout: keep mask)
//
// A template of the head width DH (head_dims.cuh: 32, 64, 128, 192,
// 256), whose operands are NT = ceil(DH / 64) tiles of 64 head columns
// each (attn_sm90.cuh): s sums the NT tiles' products, and o = e v is NT
// 64 x 64 accumulators, one per tile of v.  Past 128 columns (NT = 3, 4)
// the accumulators take 96 or 128 registers a thread beside the score
// tile and its A operand, so those instances ask for one block an SM
// (MIN_BLOCKS) and its whole register file; their q buffers and k / v
// ring (6 NT 8 KB: 144 or 192 KB) fit the 227 KB a block may have.
//
// What bounds it on an H100: bytes.  At the train shapes (Lq, Lk <= 64,
// dh 64) a (b, h) reads q, k and v once (24 KB) and writes 8 KB for
// 2 Lq Lk dh * 2 operations, about 16 operations a byte against the
// card's 295 in bf16; over the batch-64 mix about 20 MB a launch, 6 us at
// 3.35 TB/s.  So the design keeps the bytes moving and every
// intermediate on the chip:
//
// - one persistent block per resident slot walks work units (b, h, a
//   64-row query tile); its producer warp loads the unit's q tile into
//   one of two buffers and its k and v 64-key tiles into a ring of
//   KV_STAGES, by TMA where the strides allow (attn_sm90.cuh), running
//   ahead into the next unit while the consumers compute this one;
// - the consumer warpgroup computes each key tile's s = q k^T with
//   wgmma (both operands K-major in shared memory) into registers, adds
//   the scale, the bias (read through four strides, 0 on a broadcast
//   dimension) and -inf past Lk, keeps each row's running max m and sum
//   l over the key tiles (the online softmax, in log2 units with the
//   SFU's 2^x, attn_sm90.cuh; a row's 64 keys sit on the four lanes of a
//   quad), rescales the output accumulator past the first key tile, and
//   turns e = exp(s - m) into bf16 in registers as the A operand of
//   o += e v (v MN-major): no score tile passes through shared memory,
//   so any Lk fits;
// - the keep mask of dropout_hash.cuh at each (b, h, q, k) zeroes e in
//   the product only (l sums every e, as the JAX kernel normalises before
//   it drops); the output is o * inv_keep / l, rounded to bf16.
//
// The rounding point: the JAX bf16 kernel rounds the normalised, dropped
// probabilities p before p v (`_bdot(pd, v, dt=bf16)`); this kernel rounds
// e = exp(s - m), m the running max, and divides by l after the product.
// Both are one bf16 rounding of a value of at most 1 (times inv_keep)
// before p v.  With SPLIT_P (the bf16 K3, whose TPU kernel keeps p in
// float32: `_mha_kernel` upcasts q, k, v and takes p v in float32) e goes
// in as two bf16 terms, e_hi + e_lo, two products into one float32 sum,
// which carries 16 bits of e.
#pragma once

#include "attn_sm90.cuh"

namespace attn_fwd_sm90 {
namespace {

using namespace attn_sm90;

constexpr int KV_STAGES = 2;     // k and v tiles in flight
constexpr int Q_BUFS = 2;        // q tiles: this unit's and the next one's

// blocks an SM is to hold at head width DH: two up to 128 columns, one
// past (the output accumulators' registers)
template <int DH>
__host__ __device__ constexpr int min_blocks() {
  return DH > 128 ? 1 : 2;
}

// q, k and v of one unit or key tile at head width DH, and the kernel's
// shared memory
template <int DH>
__host__ __device__ constexpr int opnd_bytes() {
  return tiles_of(DH) * TILE_BYTES;
}
template <int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  return ALIGN + (size_t)(Q_BUFS + 2 * KV_STAGES) * opnd_bytes<DH>() +
         2 * (Q_BUFS + KV_STAGES) * sizeof(uint64_t);
}

template <class BiasT>
struct Params {
  CUtensorMap map[3];   // q, k, v (the TMA route)
  Heads q, k, v;        // L: Lq, Lk, Lk
  const BiasT* bias;    // bias[b sb + h sh + q sq + k sk], or null
  long long sb, sh, sq, sk;
  const int* seeds;     // [B], or null: no dropout
  unsigned int thresh;
  float inv_keep;
  bf16* out;            // [B, Lq, H*dh]
  int H, qtiles, units;
  float scale;
  int tma;
};

// A thread's two rows: their bias rows and dropout hash prefixes.
template <class BiasT>
struct Rows {
  const BiasT* bias[2];
  uint32_t hash[2];
};

// One key tile k0 of a thread's two rows: s (its 32 raw scores, columns
// 8 i + 2 t + e) scaled to log2 units, biased and -inf past Lk; the running
// max m and sum l, alpha the factor that rescales what was summed before;
// s <- e = 2^(s - m), zeroed where dropped.  No branch inside: the bias
// and dropout cases are template arguments, every load is clamped into
// its row and every key past Lk masked by a select.
template <bool BIAS, bool DROP, class BiasT>
__device__ __forceinline__ void softmax_tile(float s[32], float m[2],
                                             float l[2], float alpha[2],
                                             const Rows<BiasT>& R, int k0,
                                             const Params<BiasT>& P) {
  const int t = threadIdx.x % 4, Lk = P.k.L;
  const float c = P.scale * LOG2E;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * i + 2 * t + e, idx = 4 * i + 2 * r + e;
        float v = s[idx] * c;
        if constexpr (BIAS) v += bias_at(R.bias[r], kj, Lk, P.sk) * LOG2E;
        s[idx] = kj < Lk ? v : -INFINITY;
        mx = fmaxf(mx, s[idx]);
      }
    const float m_new = fmaxf(m[r], quad_max(mx));
    // a row that is -inf so far keeps a 0 sum and no NaN
    const float mref = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = m[r] == -INFINITY ? 0.f : exp2_approx(m[r] - mref);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * i + 2 * r + e;
        float ev = exp2_approx(s[idx] - mref);
        sum += ev;
        if constexpr (DROP)
          ev = dropout_bits_at(R.hash[r], k0 + 8 * i + 2 * t + e) >= P.thresh
              ? ev : 0.f;
        s[idx] = ev;
      }
    l[r] = l[r] * alpha[r] + sum;
  }
}

template <class BiasT, bool SPLIT_P, int DH>
__global__ void __launch_bounds__(THREADS, min_blocks<DH>())
    attn_fwd_sm90_kernel(const __grid_constant__ Params<BiasT> P) {
  constexpr int NT = tiles_of(DH), OB = opnd_bytes<DH>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_raw + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  unsigned char* Qs = base;                              // [Q_BUFS] q
  unsigned char* Ks = Qs + Q_BUFS * OB;                  // [KV_STAGES] k
  unsigned char* Vs = Ks + KV_STAGES * OB;               // [KV_STAGES] v
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + KV_STAGES * OB);
  uint64_t* q_empty = q_full + Q_BUFS;
  uint64_t* kv_full = q_empty + Q_BUFS;
  uint64_t* kv_empty = kv_full + KV_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < Q_BUFS; ++i) {
      bar_init(&q_full[i], 1);
      bar_init(&q_empty[i], 1);
    }
    for (int i = 0; i < KV_STAGES; ++i) {
      bar_init(&kv_full[i], 1);
      bar_init(&kv_empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int Lq = P.q.L, Lk = P.k.L, H = P.H;

  if (threadIdx.x >= CONSUMERS) {
    // producer warp: the q tile of each unit, then its key tiles
    int it = 0, n = 0;
    for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++n) {
      const int bh = u / P.qtiles, q0 = (u % P.qtiles) * TILE;
      const int b = bh / H, h = bh % H;
      const int qb = n % Q_BUFS;
      bar_wait(&q_empty[qb], ((n / Q_BUFS) & 1) ^ 1);
      {
        unsigned char* dst[1] = {Qs + qb * OB};
        const Heads* o[1] = {&P.q};
        const CUtensorMap* m[1] = {&P.map[0]};
        const int l0[1] = {q0};
        load_tiles<1, DH>(dst, o, m, l0, b, h, P.tma, &q_full[qb]);
      }
      for (int k0 = 0; k0 < Lk; k0 += TILE, ++it) {
        const int st = it % KV_STAGES;
        bar_wait(&kv_empty[st], ((it / KV_STAGES) & 1) ^ 1);
        unsigned char* dst[2] = {Ks + st * OB, Vs + st * OB};
        const Heads* o[2] = {&P.k, &P.v};
        const CUtensorMap* m[2] = {&P.map[1], &P.map[2]};
        const int l0[2] = {k0, k0};
        load_tiles<2, DH>(dst, o, m, l0, b, h, P.tma, &kv_full[st]);
      }
    }
    return;
  }

  // consumers: warp w holds rows 16 w + g and 16 w + g + 8 of the tile
  // (g = lane / 4), columns 8 i + 2 t, +1 (t = lane % 4, i < 8)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const long long HD = (long long)H * DH;
  int it = 0, n = 0;
  for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++n) {
    const int bh = u / P.qtiles, q0 = (u % P.qtiles) * TILE;
    const int b = bh / H, h = bh % H;
    const int qb = n % Q_BUFS;
    const uint32_t qs = smem_addr(Qs + qb * OB);
    // per row: its bias (a row past Lq reads the last one's), its dropout
    // hash prefix
    int rows[2];
    Rows<BiasT> R;
    const uint32_t seed = P.seeds != nullptr ? (uint32_t)P.seeds[b] : 0u;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows[r] = q0 + 16 * warp + g + 8 * r;
      R.bias[r] = P.bias != nullptr
          ? P.bias + (long long)b * P.sb + (long long)h * P.sh +
                (long long)min(rows[r], Lq - 1) * P.sq
          : nullptr;
      R.hash[r] = dropout_row(seed, b, h, rows[r]);
    }
    float o[NT][32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) zero(o[j]);
    bar_wait(&q_full[qb], (n / Q_BUFS) & 1);
    for (int k0 = 0; k0 < Lk; k0 += TILE, ++it) {
      const int st = it % KV_STAGES;
      const uint32_t ks = smem_addr(Ks + st * OB);
      const uint32_t vs = smem_addr(Vs + st * OB);
      bar_wait(&kv_full[st], (it / KV_STAGES) & 1);
      float s[32];
      zero(s);
      fence_acc(s);
      mma_fence();
#pragma unroll
      for (int j = 0; j < NT; ++j)
        tile_ss<0, 0>(s, qs + j * TILE_BYTES, ks + j * TILE_BYTES);
      mma_commit();
      mma_wait();
      fence_acc(s);
      // the unit's last key tile: its q tile is free for the next unit
      if (k0 + TILE >= Lk && tid == 0) bar_arrive(&q_empty[qb]);

      // the scores in log2 units, the running max and sum, e = 2^(s - m),
      // by a branch-free loop for each case of bias and dropout
      float alpha[2];
      const bool drop = P.seeds != nullptr;
      if (P.bias != nullptr) {
        if (drop) softmax_tile<true, true>(s, m, l, alpha, R, k0, P);
        else softmax_tile<true, false>(s, m, l, alpha, R, k0, P);
      } else {
        if (drop) softmax_tile<false, true>(s, m, l, alpha, R, k0, P);
        else softmax_tile<false, false>(s, m, l, alpha, R, k0, P);
      }
      // past the first key tile, the output so far rescaled to the new max
      if (k0 > 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int idx = 0; idx < 32; ++idx)
            o[j][idx] *= alpha[(idx >> 1) & 1];
      }
      uint32_t pa[4][4];
      to_a(s, pa);
      uint32_t lo[4][4];
      if constexpr (SPLIT_P) to_a_lo(s, lo);
#pragma unroll
      for (int j = 0; j < NT; ++j) fence_acc(o[j]);
      mma_fence();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tile_rs<1>(o[j], pa, vs + j * TILE_BYTES);
        if constexpr (SPLIT_P) tile_rs<1>(o[j], lo, vs + j * TILE_BYTES);
      }
      mma_commit();
      mma_wait();
#pragma unroll
      for (int j = 0; j < NT; ++j) fence_acc(o[j]);
      if (tid == 0) bar_arrive(&kv_empty[st]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float f =
          (P.seeds != nullptr ? P.inv_keep : 1.f) / quad_sum(l[r]);
      if (rows[r] >= Lq) continue;
      bf16* dst = P.out + ((long long)b * Lq + rows[r]) * HD +
                  (long long)h * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          // at DH = 32 the columns past 32 are the tile's zero padding
          if (TW * j + 8 * i < DH)
            *reinterpret_cast<__nv_bfloat162*>(dst + TW * j + 8 * i) =
                __floats2bfloat162_rn(o[j][4 * i + 2 * r] * f,
                                      o[j][4 * i + 2 * r + 1] * f);
    }
  }
}

// Encodes the tensor maps, chooses the route and launches one persistent
// block per resident slot (at most one per unit) of the kernel of head
// width dh on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue without launching for shapes it does not take (a
// head width outside head_dims.cuh's set among them).
template <class BiasT, bool SPLIT_P>
__host__ inline int launch(Params<BiasT>& P, int B, int dh,
                           cudaStream_t stream) {
  const int Lq = P.q.L, Lk = P.k.L;
  if (B < 1 || Lq < 1 || Lk < 1 || P.v.L != Lk || P.H < 1 ||
      (long long)B * P.H * ((Lq + TILE - 1) / TILE) > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  return head_dims::dispatch(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    constexpr int smem = (int)smem_bytes<DH>();
    static_assert(smem <= tf32x3::SMEM_OPT_IN,
                  "a block's shared memory on an H100");
    P.qtiles = (Lq + TILE - 1) / TILE;
    P.units = B * P.H * P.qtiles;
    P.tma = encode(&P.map[0], P.q, B, P.H, DH) &&
            encode(&P.map[1], P.k, B, P.H, DH) &&
            encode(&P.map[2], P.v, B, P.H, DH);
    const cudaError_t e =
        tf32x3::smem_limit<attn_fwd_sm90_kernel<BiasT, SPLIT_P, DH>>(smem);
    if (e != cudaSuccess) return (int)e;
    const int slots =
        blocks_per_sm<attn_fwd_sm90_kernel<BiasT, SPLIT_P, DH>>(smem) *
        gemm_bf16::sm_count();
    const int grid = P.units < slots ? P.units : slots;
    attn_fwd_sm90_kernel<BiasT, SPLIT_P, DH>
        <<<grid, THREADS, smem, stream>>>(P);
    last_route() = P.tma;
    return (int)cudaGetLastError();
  });
}

}  // namespace
}  // namespace attn_fwd_sm90
