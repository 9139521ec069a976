// Attention backward in bf16 for Hopper: K2 (a) bf16's attention part
// (fused_qkv_mha_bwd.cu, over the recomputed projection scratch).  The
// float32 build keeps `attn_bwd_kernel`.
//
// For batch row b and head h, from bf16 q, k, v, dO (and the bias, seeds
// and keep mask of the forward):
//
//   s = q k^T * scale + bias     p = softmax(s)     pd = keep ? p inv_keep : 0
//   dp = keep ? (dO v^T) inv_keep : 0     ds = p (dp - rowsum(dp p))
//   dv = pd^T dO     dk = scale ds^T q     dq = scale ds k
//
// with p, pd and ds rounded to bf16 where they enter a product (the JAX
// bf16 kernel's `_bdot(dt=bf16)` casts, :200-225), every sum float32, and
// ds written in float32 when the bias needs a gradient.
//
// A template of the head width DH (head_dims.cuh: 32, 64, 128, 192,
// 256), whose operands are NT = ceil(DH / 64) tiles of 64 head columns
// each (attn_sm90.cuh): s and dp sum the NT tiles' products; dq, dk and
// dv are NT 64 x 64 accumulators each, one per tile of k, q and dO, dk and
// dv held through the query tiles and dq taken one tile after the other.
// At DH = 128 (NT = 2) that is 128 accumulator registers a thread for dk
// and dv, and one block an SM.  Past 128 columns the block has two
// consumer warpgroups (GROUPS), each owning half of the column tiles
// (its dk, dv and dq: two tiles each at DH = 256, two and one at 192), so
// a thread still holds 128 accumulator registers.  Both compute the
// whole s and dp of a tile pair (the products over the head dimension
// take every column tile), the first writes pd and ds to shared memory,
// and both read them there for their tiles' dv and dk; ds k for dq takes
// each group's own ds in registers.  At DH = 256 the pairs (64 KB) leave
// room for one outer pair (OUTER): it is the key tile, held through all
// the query tiles, so at Lk <= 64 the block loads it once either way.
//
// What bounds it on an H100: bytes.  At the train shapes a (b, h) reads
// q, k, v and dO once (32 KB) and writes dq, dk, dv (24 KB), plus the
// float32 ds (16 KB) for a graph bias, for 5 products of 2 Lq Lk dh
// operations: about 13 operations a byte.  The design keeps every
// intermediate on the chip:
//
// - one block per (b, h) owns all its keys and queries, so dk and dv sum
//   over the query tiles in registers and dq over the key tiles in one
//   block: no atomics, and two launches give the same bits;
// - a producer warp loads 64-row tiles in pairs, (k, v) of a key tile and
//   (q, dO) of a query tile, by TMA (attn_sm90.cuh), into an "outer" pair
//   (two buffers) held through an inner loop and a ring of two "inner"
//   pairs streamed through it, running ahead of the consumers;
// - per (key tile j, query tile i) the consumer warpgroup computes
//   s = q k^T and dp = dO v^T with wgmma into registers (operands
//   K-major), turns them into pd and ds in registers (the row statistics
//   over the quad's lanes, the softmax in log2 units with the SFU's 2^x,
//   attn_sm90.cuh), takes dq = ds k with ds as the register A
//   operand (k MN-major), and writes pd and ds once to shared memory as
//   bf16 for dv += pd^T dO and dk += ds^T q (both operands MN-major:
//   the q, dO tiles of s and dp read down their columns).
// - Row statistics: with one key tile (Lk <= 64: every train shape) a
//   query tile holds whole rows, so the max, the sum and rowsum(dp p)
//   come from the tile itself; with more, a first sweep over the key
//   tiles keeps them online per query tile and leaves them in a small
//   float32 scratch [B, H, Lq, 3] (the forward saves nothing), and dq is
//   summed over the key tiles in a float32 scratch by the one block that
//   owns it and rounded to bf16 once, after the last (as the JAX kernel's
//   one float32 product over all keys, :216).
#pragma once

#include "attn_sm90.cuh"

namespace attn_bwd_sm90 {
namespace {

using namespace attn_sm90;

constexpr int INNER = 2;          // inner pairs in flight

// outer pairs at head width DH: this one and the next, one at 256 columns
// (shared memory)
template <int DH>
__host__ __device__ constexpr int outer() {
  return tiles_of(DH) > 3 ? 1 : 2;
}
// consumer warpgroups at head width DH, each owning `group_tiles` of the
// column tiles, and the block's threads: one warpgroup and the producer
// warp, or two and a producer warpgroup whose first warp loads (so that
// `setmaxnreg` can move its registers to the consumers: REGS each of
// theirs, 40 of its, at most the SM's 65536 at one block an SM)
template <int DH>
__host__ __device__ constexpr int groups() {
  return tiles_of(DH) > 2 ? 2 : 1;
}
template <int DH>
__host__ __device__ constexpr int group_tiles() {
  return (tiles_of(DH) + groups<DH>() - 1) / groups<DH>();
}
template <int DH>
__host__ __device__ constexpr int threads() {
  return groups<DH>() > 1 ? (groups<DH>() + 1) * CONSUMERS : THREADS;
}
constexpr int REGS = 232, PRODUCER_REGS = 40;
static_assert(2 * CONSUMERS * REGS + CONSUMERS * PRODUCER_REGS <= 65536,
              "two consumer warpgroups' and the producer's registers");

// one operand's tiles at head width DH, a pair of operands, and the
// kernel's shared memory
template <int DH>
__host__ __device__ constexpr int opnd_bytes() {
  return tiles_of(DH) * TILE_BYTES;
}
template <int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  return ALIGN + (size_t)(outer<DH>() + INNER) * 2 * opnd_bytes<DH>() +
         2 * TILE_BYTES + 2 * (outer<DH>() + INNER) * sizeof(uint64_t);
}

struct Params {
  CUtensorMap map[4];   // q, k, v, dO (the TMA route)
  Heads q, k, v, o;     // o: dO; L: Lq, Lk, Lk, Lq
  const bf16* bias;     // bias[b sb + h sh + q sq + k sk], or null
  long long sb, sh, sq, sk;
  const int* seeds;     // [B], or null: no dropout
  unsigned int thresh;
  float inv_keep;
  bf16* dq;             // [B, Lq, H*dh]
  bf16* dk;             // [B, Lk, H*dh]
  bf16* dv;
  float* ds;            // [B, H, Lq, Lk], or null
  float* stats;         // [B, H, Lq, 3] when Lk > TILE
  float* dq_acc;        // [B, Lq, H*dh] when Lk > TILE
  int H;
  float scale;
  int tma;
};

// The pairs in the order the producer loads them and the consumers take
// them: with several key tiles, for each query tile (q, dO) as an outer
// pair and every (k, v) as inner ones (the statistics sweep); then for
// each key tile (k, v) as an outer pair and every (q, dO) as inner ones.
struct Ring {
  unsigned char* outer;     // [outer<DH>()] pairs
  unsigned char* inner;     // [INNER] pairs
  uint64_t *outer_full, *outer_empty, *inner_full, *inner_empty;
  int on = 0, in = 0;       // outer and inner pairs taken so far
};

// The scores and dp of a thread's elements of query tile q0 x key tile
// k0, as the kernel's `scores` describes them: the bias and dropout cases
// are template arguments, a bias load is clamped into its row (a query
// past Lq reads the last query's row, a key past Lk the row's last key)
// and every key past Lk masked by a select, so the loop has no branch.
template <bool BIAS, bool DROP>
__device__ __forceinline__ uint32_t scores_tile(float s[32], float dp[32],
                                                int q0, int k0, int b, int h,
                                                uint32_t seed,
                                                const Params& P) {
  // the warp within its warpgroup
  const int lane = threadIdx.x % 32, warp = threadIdx.x % CONSUMERS / 32;
  const int g = lane >> 2, t = lane & 3;
  const int Lq = P.q.L, Lk = P.k.L;
  const float scale2 = P.scale * LOG2E;
  uint32_t keep = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * warp + g + 8 * r;
    const bf16* brow = nullptr;
    if constexpr (BIAS)
      brow = P.bias + (long long)b * P.sb + (long long)h * P.sh +
             (long long)min(qi, Lq - 1) * P.sq;
    uint32_t hrow = 0;
    if constexpr (DROP) hrow = dropout_row(seed, b, h, qi);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * c + 2 * r + e, kj = k0 + 8 * c + 2 * t + e;
        float v = s[idx] * scale2;
        if constexpr (BIAS) v += bias_at(brow, kj, Lk, P.sk) * LOG2E;
        bool kp = kj < Lk;
        if constexpr (DROP)
          kp = kp & (dropout_bits_at(hrow, kj) >= P.thresh);
        s[idx] = kj < Lk ? v : -INFINITY;
        dp[idx] = kp ? dp[idx] * P.inv_keep : 0.f;
        keep |= (uint32_t)kp << idx;
      }
  }
  return keep;
}

// the consumers of `groups` warpgroups meet (named barrier 1; the producer
// warp is not in it)
template <int GROUPS>
__device__ __forceinline__ void groups_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(GROUPS * CONSUMERS) : "memory");
}

template <int DH>
__global__ void __launch_bounds__(threads<DH>(), DH > 64 ? 1 : 2)
    attn_bwd_sm90_kernel(const __grid_constant__ Params P) {
  constexpr int NT = tiles_of(DH), OB = opnd_bytes<DH>(), PAIR = 2 * OB;
  constexpr int OUTER = outer<DH>(), GROUPS = groups<DH>();
  constexpr int GT = group_tiles<DH>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_raw + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  Ring R;
  R.outer = base;
  R.inner = R.outer + OUTER * PAIR;
  unsigned char* Ps = R.inner + INNER * PAIR;         // pd [q][key], bf16
  unsigned char* Ss = Ps + TILE_BYTES;                // ds [q][key], bf16
  R.outer_full = reinterpret_cast<uint64_t*>(Ss + TILE_BYTES);
  R.outer_empty = R.outer_full + OUTER;
  R.inner_full = R.outer_empty + OUTER;
  R.inner_empty = R.inner_full + INNER;
  if (threadIdx.x == 0) {
    // a pair is free once every consumer warpgroup has released it
    for (int i = 0; i < OUTER; ++i) {
      bar_init(&R.outer_full[i], 1);
      bar_init(&R.outer_empty[i], GROUPS);
    }
    for (int i = 0; i < INNER; ++i) {
      bar_init(&R.inner_full[i], 1);
      bar_init(&R.inner_empty[i], GROUPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int H = P.H, b = blockIdx.x / H, h = blockIdx.x % H;
  const int Lq = P.q.L, Lk = P.k.L;
  const int nq = (Lq + TILE - 1) / TILE, nk = (Lk + TILE - 1) / TILE;

  if (threadIdx.x >= GROUPS * CONSUMERS) {
    // producer warp
    if constexpr (GROUPS > 1) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          PRODUCER_REGS) : "memory");
      if (threadIdx.x % CONSUMERS >= 32) return;
    }
    auto push = [&](bool outer, bool qside, int l0) {
      const int i = outer ? R.on++ : R.in++;
      const int n = outer ? OUTER : INNER;
      unsigned char* pair = (outer ? R.outer : R.inner) + (i % n) * PAIR;
      bar_wait(&(outer ? R.outer_empty : R.inner_empty)[i % n],
               ((i / n) & 1) ^ 1);
      unsigned char* dst[2] = {pair, pair + OB};
      const Heads* o[2] = {qside ? &P.q : &P.k, qside ? &P.o : &P.v};
      const CUtensorMap* m[2] = {&P.map[qside ? 0 : 1],
                                 &P.map[qside ? 3 : 2]};
      const int l[2] = {l0, l0};
      load_tiles<2, DH>(dst, o, m, l, b, h, P.tma,
                        &(outer ? R.outer_full : R.inner_full)[i % n]);
    };
    if (nk > 1)
      for (int i = 0; i < nq; ++i) {
        push(true, true, i * TILE);
        for (int j = 0; j < nk; ++j) push(false, false, j * TILE);
      }
    for (int j = 0; j < nk; ++j) {
      push(true, false, j * TILE);
      for (int i = 0; i < nq; ++i) push(false, true, i * TILE);
    }
    return;
  }

  // consumers: warp w of a warpgroup holds rows 16 w + g and 16 w + g + 8
  // of each 64 x 64 accumulator (g = lane / 4), columns 8 c + 2 t, +1
  // (t = lane % 4); warpgroup wg owns column tiles [wg GT, wg GT + GT)
  if constexpr (GROUPS > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS)
                 : "memory");
  const int tid = threadIdx.x, wg = tid / CONSUMERS;
  const int warp = tid % CONSUMERS / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool first = wg == 0;   // writes what both groups compute
  const long long HD = (long long)H * DH;
  const uint32_t seed = P.seeds != nullptr ? (uint32_t)P.seeds[b] : 0u;
  const bool drop = P.seeds != nullptr;
  float* stats = P.stats != nullptr
      ? P.stats + ((long long)b * H + h) * Lq * 3 : nullptr;
  // waits for the next outer (inner) pair; returns its shared address
  auto take = [&](bool outer, int& slot) {
    const int i = outer ? R.on++ : R.in++;
    const int n = outer ? OUTER : INNER;
    slot = i % n;
    bar_wait(&(outer ? R.outer_full : R.inner_full)[slot], (i / n) & 1);
    return smem_addr((outer ? R.outer : R.inner) + slot * PAIR);
  };
  auto release = [&](bool outer, int slot) {
    if (tid % CONSUMERS == 0)
      bar_arrive(&(outer ? R.outer_empty : R.inner_empty)[slot]);
  };
  // s (scaled, biased, in log2 units, -inf past Lk) and dp (dropped) of
  // this thread's elements of query tile q0 x key tile k0, from the raw
  // products; bit idx of the result: element idx is a key below Lk that
  // is kept.  One branch-free loop for each case of bias and dropout.
  auto scores = [&](float s[32], float dp[32], int q0, int k0) {
    if (P.bias != nullptr) {
      return drop ? scores_tile<true, true>(s, dp, q0, k0, b, h, seed, P)
                  : scores_tile<true, false>(s, dp, q0, k0, b, h, seed, P);
    }
    return drop ? scores_tile<false, true>(s, dp, q0, k0, b, h, seed, P)
                : scores_tile<false, false>(s, dp, q0, k0, b, h, seed, P);
  };
  // raw s = q k^T and dp = dO v^T of an inner / outer pair combination
  auto products = [&](float s[32], float dp[32], uint32_t qpair,
                      uint32_t kpair) {
    zero(s);
    zero(dp);
    fence_acc(s);
    fence_acc(dp);
    mma_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tile_ss<0, 0>(s, qpair + j * TILE_BYTES, kpair + j * TILE_BYTES);
      tile_ss<0, 0>(dp, qpair + OB + j * TILE_BYTES,
                    kpair + OB + j * TILE_BYTES);
    }
    mma_commit();
    mma_wait();
    fence_acc(s);
    fence_acc(dp);
  };

  if (nk > 1) {
    // the statistics sweep: per query row the running max m, the sum l of
    // exp(s - m) and the sum of exp(s - m) dp, left as (m, l, rowsum(p dp))
    for (int i = 0; i < nq; ++i) {
      int os;
      const uint32_t qp = take(true, os);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
            d[2] = {0.f, 0.f};
      for (int j = 0; j < nk; ++j) {
        int is;
        const uint32_t kp = take(false, is);
        float s[32], dp[32];
        products(s, dp, qp, kp);
        release(false, is);
        scores(s, dp, i * TILE, j * TILE);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            mx = fmaxf(mx, fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]));
          const float m_new = fmaxf(m[r], quad_max(mx));
          const float mref = m_new == -INFINITY ? 0.f : m_new;
          const float alpha =
              m[r] == -INFINITY ? 0.f : exp2_approx(m[r] - mref);
          float sl = 0.f, sd = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ev = exp2_approx(s[4 * c + 2 * r + e] - mref);
              sl += ev;
              sd += ev * dp[4 * c + 2 * r + e];
            }
          m[r] = m_new;
          l[r] = l[r] * alpha + sl;
          d[r] = d[r] * alpha + sd;
        }
      }
      release(true, os);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lr = quad_sum(l[r]), dr = quad_sum(d[r]);
        const int qi = i * TILE + 16 * warp + g + 8 * r;
        if (first && t == 0 && qi < Lq) {
          stats[qi * 3] = m[r];
          stats[qi * 3 + 1] = lr;
          stats[qi * 3 + 2] = dr / lr;
        }
      }
    }
    __threadfence_block();
    groups_sync<GROUPS>();
  }

  uint32_t ps = smem_addr(Ps), ss = smem_addr(Ss);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * TILE;
    int os;
    const uint32_t kp = take(true, os);
    // dk and dv of this warpgroup's column tiles
    float dk[GT][32], dv[GT][32];
#pragma unroll
    for (int jj = 0; jj < GT; ++jj) {
      zero(dk[jj]);
      zero(dv[jj]);
    }
    for (int i = 0; i < nq; ++i) {
      const int q0 = i * TILE;
      int is;
      const uint32_t qp = take(false, is);
      float s[32], dp[32];
      products(s, dp, qp, kp);
      const uint32_t keep = scores(s, dp, q0, k0);
      // the rows' statistics and s <- exp(s - m), then s <- pd and
      // dp <- ds
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + 16 * warp + g + 8 * r;
        float m, l, dsum;
        if (nk == 1) {
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            mx = fmaxf(mx, fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]));
          m = quad_max(mx);
          if (m == -INFINITY) m = 0.f;
          float sl = 0.f, sd = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * c + 2 * r + e;
              s[idx] = exp2_approx(s[idx] - m);
              sl += s[idx];
              sd += s[idx] * dp[idx];
            }
          l = quad_sum(sl);
          dsum = quad_sum(sd) / l;
        } else {
          m = 0.f;
          l = 1.f;
          dsum = 0.f;
          if (qi < Lq) {
            m = stats[qi * 3];
            if (m == -INFINITY) m = 0.f;
            l = stats[qi * 3 + 1];
            dsum = stats[qi * 3 + 2];
          }
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * c + 2 * r + e;
              s[idx] = exp2_approx(s[idx] - m);
            }
        }
        const float inv_l = 1.f / l;
        float* ds_row = P.ds != nullptr && qi < Lq && first
            ? P.ds + (((long long)b * H + h) * Lq + qi) * Lk : nullptr;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * c + 2 * r + e, kj = k0 + 8 * c + 2 * t + e;
            // zero in the rows past Lq and the keys past Lk, by selects
            const bool in = (qi < Lq) & (kj < Lk);
            const float p = in ? s[idx] * inv_l : 0.f;
            const float dsv = in ? p * (dp[idx] - dsum) : 0.f;
            if (ds_row != nullptr && kj < Lk) ds_row[kj] = dsv;
            s[idx] = (keep >> idx) & 1 ? p * P.inv_keep : 0.f;
            dp[idx] = dsv;
          }
      }
      // dq (tile rows) = ds k; pd and ds to shared memory, [q][key] in the
      // swizzled layout, for dv += pd^T dO and dk += ds^T q
      uint32_t da[4][4];
      to_a(dp, da);
      // every group's last products are done with Ps, Ss
      groups_sync<GROUPS>();
      if (first) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int off =
                row * ROW_BYTES + ((c ^ (row & 7)) << 4) + 4 * t;
            *reinterpret_cast<uint32_t*>(Ps + off) =
                gemm_bf16::pack2(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]);
            *reinterpret_cast<uint32_t*>(Ss + off) =
                gemm_bf16::pack2(dp[4 * c + 2 * r], dp[4 * c + 2 * r + 1]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      groups_sync<GROUPS>();
      // per tile jt of the group's head columns: dq's, and dk's and dv's
      // sums (the condition holds for a whole warpgroup)
#pragma unroll
      for (int jj = 0; jj < GT; ++jj) {
        const int jt = wg * GT + jj;
        if (jt >= NT) continue;
        float dq[32];
        zero(dq);
        fence_acc(dq);
        fence_acc(dk[jj]);
        fence_acc(dv[jj]);
        mma_fence();
        tile_rs<1>(dq, da, kp + jt * TILE_BYTES);
        tile_ss<1, 1>(dv[jj], ps, qp + OB + jt * TILE_BYTES);
        tile_ss<1, 1>(dk[jj], ss, qp + jt * TILE_BYTES);
        mma_commit();
        mma_wait();
        fence_acc(dq);
        fence_acc(dk[jj]);
        fence_acc(dv[jj]);
        // dq: written, or summed over the key tiles in float32 and
        // rounded once with the last
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = q0 + 16 * warp + g + 8 * r;
          if (qi >= Lq) continue;
          const long long row =
              ((long long)b * Lq + qi) * HD + h * DH + TW * jt;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            // at DH = 32 the columns past 32 are the tiles' zero padding
            if (TW * jt + 8 * c >= DH) continue;
            const long long o = row + 8 * c + 2 * t;
            float v0 = dq[4 * c + 2 * r] * P.scale;
            float v1 = dq[4 * c + 2 * r + 1] * P.scale;
            if (nk > 1) {
              if (j > 0) {
                const float2 a =
                    *reinterpret_cast<const float2*>(P.dq_acc + o);
                v0 += a.x;
                v1 += a.y;
              }
              if (j < nk - 1) {
                *reinterpret_cast<float2*>(P.dq_acc + o) =
                    make_float2(v0, v1);
                continue;
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(P.dq + o) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      release(false, is);
    }
    release(true, os);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = k0 + 16 * warp + g + 8 * r;
      if (kj >= Lk) continue;
      const long long row = ((long long)b * Lk + kj) * HD + h * DH;
#pragma unroll
      for (int jj = 0; jj < GT; ++jj) {
        const int jt = wg * GT + jj;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (jt >= NT || TW * jt + 8 * c >= DH) continue;
          const long long o = row + TW * jt + 8 * c + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(P.dk + o) =
              __floats2bfloat162_rn(dk[jj][4 * c + 2 * r] * P.scale,
                                    dk[jj][4 * c + 2 * r + 1] * P.scale);
          *reinterpret_cast<__nv_bfloat162*>(P.dv + o) =
              __floats2bfloat162_rn(dv[jj][4 * c + 2 * r],
                                    dv[jj][4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

// Encodes the tensor maps, chooses the route and launches one block per
// (b, h) of the kernel of head width dh on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue without launching for
// shapes or scratch it does not take (a head width outside head_dims.cuh's
// set among them).
__host__ inline int launch(Params& P, int B, int dh, cudaStream_t stream) {
  const int Lq = P.q.L, Lk = P.k.L;
  if (B < 1 || Lq < 1 || Lk < 1 || P.v.L != Lk || P.o.L != Lq || P.H < 1 ||
      (long long)B * P.H >= (1ll << 31) ||
      (Lk > TILE && (P.stats == nullptr || P.dq_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (Lk <= TILE) {
    P.stats = nullptr;
    P.dq_acc = nullptr;
  }
  return head_dims::dispatch(dh, [&](auto w) {
    constexpr int DH = decltype(w)::value;
    constexpr int smem = (int)smem_bytes<DH>();
    static_assert(smem <= tf32x3::SMEM_OPT_IN,
                  "a block's shared memory on an H100");
    P.tma = encode(&P.map[0], P.q, B, P.H, DH) &&
            encode(&P.map[1], P.k, B, P.H, DH) &&
            encode(&P.map[2], P.v, B, P.H, DH) &&
            encode(&P.map[3], P.o, B, P.H, DH);
    const cudaError_t e =
        tf32x3::smem_limit<attn_bwd_sm90_kernel<DH>>(smem);
    if (e != cudaSuccess) return (int)e;
    attn_bwd_sm90_kernel<DH><<<B * P.H, threads<DH>(), smem, stream>>>(P);
    last_route() = P.tma;
    return (int)cudaGetLastError();
  });
}

}  // namespace
}  // namespace attn_bwd_sm90
