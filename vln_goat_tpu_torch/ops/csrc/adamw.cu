// AdamW over a table of leaves, with the global-norm clip: the update of
// both of the port's optimizers in two launches, in float32 and float64.
//
// Replaces no TPU kernel.  The JAX package leaves optax's
// clip_by_global_norm and adamw to XLA, which fuses their elementwise
// work; the port's loops over the leaves (the fine-tune `AdamW` of
// train/trainer.py and the pretraining chain of pretrain/optimizers.py)
// launched some 25 small kernels a leaf and read the norm back to the host
// in the middle of the update.  These two launches take their place
// (ops/optim.py `clip_adamw_`).
//
// The table: int64 [L, 8] on the device, one row a leaf:
//   p, g (0: the leaf has no gradient, which counts as zero), mu, nu,
//   n (elements), first item, flags (bit 0: the leaf decays; bit 1:
//   float64), first gradient item
// A leaf's elements are cut into items of `chunk` elements (a multiple of
// 4); item i lies in the last leaf whose first item is at or below i.
// Gradient items count only the leaves with a gradient, so that the norm
// of the same gradients sums in the same order whatever leaves lie
// between them.
//
// adamw_norm: NORM_BLOCKS blocks; block b takes gradient items b, b +
// NORM_BLOCKS, ... in order, and thread t the groups of four elements t,
// t + 256, ... of each item.  The float32 square of each element
// (g.float() * g.float(), as torch computes it) is added to the thread's
// float64 sum in that order, and the block's sums in a fixed tree into
// partials[b].  No atomics: a rerun gives the same bits.
//
// adamw_update: every block first sums the partials in one fixed order,
// norm = float32(sqrt(sum)), and block 0 writes it out.  Then each element,
// in the leaf's type T, takes the loops' operations in their order, each
// rounded as torch rounds it on the card (IEEE round-to-nearest
// intrinsics, so that nvcc contracts nothing into an FMA):
//   clip:  g = (g / norm) * max_norm     where `clip_mode` says so
//   mu = (1 - b1) g + b1 mu              nu = (1 - b2) (g g) + b2 nu
//   u = (mu / bc1) / (sqrt(nu / bc2) + eps)      bc on the device, or
//   u = (mu * inv1) / (sqrt(nu * inv2) + eps)    bc a Python float: torch's
//       CUDA div by a CPU scalar multiplies by its reciprocal in T
//   u = u + wd p where the leaf decays   p = p + (-lr) u
// p, mu and nu are written in place.
//
// What bounds it on an H100: bytes.  The norm reads g (4 bytes an element
// in float32), the update reads p, g, mu, nu and writes p, mu, nu (28):
// 32 bytes an element, about 5.9 GB at the fine-tune model's 184 M
// parameters, 1.8 ms at 3.35 TB/s; some 20 operations an element are far
// below the ridge point.  So each element is read once by each launch,
// four at a time (16-byte loads where the four pointers allow them), over
// enough blocks to keep the memory busy; the update's blocks each re-sum
// the partials (528 floats from L2) instead of a third launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NORM_BLOCKS = 528;     // 4 an SM of an H100
constexpr int UPDATE_BLOCKS = 1056;  // the update's grid walks the items
constexpr int COLS = 8;
enum { P_, G_, MU_, NU_, N_, FIRST_, FLAGS_, GFIRST_ };
constexpr long long DECAY = 1, F64 = 2;

#define ROUNDED(T, name, op)                                               \
  __device__ __forceinline__ T name(T a, T b) { return op(a, b); }
ROUNDED(float, add_, __fadd_rn)
ROUNDED(double, add_, __dadd_rn)
ROUNDED(float, mul_, __fmul_rn)
ROUNDED(double, mul_, __dmul_rn)
ROUNDED(float, div_, __fdiv_rn)
ROUNDED(double, div_, __ddiv_rn)
#undef ROUNDED
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_(double a) { return __dsqrt_rn(a); }

// the row of the leaf that holds item `it` (counted in column `col`: FIRST_
// or GFIRST_), among rows [l0, l1)
__device__ __forceinline__ const long long* leaf_of(const long long* tab,
                                                    int l0, int l1,
                                                    long long it, int col) {
  int lo = l0, hi = l1 - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (tab[(long long)mid * COLS + col] <= it) lo = mid;
    else hi = mid - 1;
  }
  return tab + (long long)lo * COLS;
}

// the block's sum of each thread's v, in a fixed tree
__device__ double block_sum(double v, double* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = __dadd_rn(sh[t], sh[t + s]);
    __syncthreads();
  }
  const double out = sh[0];
  __syncthreads();
  return out;
}

// the elements j < left of x[4] from src (all four at once where `vec`);
// unrolled, so that x stays in registers
__device__ __forceinline__ void load4(const float* src, long long left,
                                      bool vec, float (&x)[4]) {
  if (vec && left >= 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < left) x[j] = src[j];
}

__device__ __forceinline__ void load4(const double* src, long long left,
                                      bool, double (&x)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < left) x[j] = src[j];
}

__device__ __forceinline__ void store4(float* dst, long long left, bool vec,
                                       const float (&x)[4]) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < left) dst[j] = x[j];
}

__device__ __forceinline__ void store4(double* dst, long long left, bool,
                                       const double (&x)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < left) dst[j] = x[j];
}

// acc plus the float32 squares of g[0, len), in this thread's order
template <class T>
__device__ double sq_sum(const T* g, long long len, double acc) {
  const bool vec = ((uintptr_t)g & 15) == 0;
  for (long long e = 4LL * threadIdx.x; e < len; e += 4LL * THREADS) {
    T x[4];
    load4(g + e, len - e, vec, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < len - e) {
        const float f = (float)x[j];
        acc = __dadd_rn(acc, (double)__fmul_rn(f, f));
      }
    }
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
norm_kernel(const long long* tab, int L, long long W, long long chunk,
            double* partials) {
  __shared__ double sh[THREADS];
  double acc = 0.0;
  for (long long it = blockIdx.x; it < W; it += gridDim.x) {
    const long long* row = leaf_of(tab, 0, L, it, GFIRST_);
    const long long start = (it - row[GFIRST_]) * chunk;
    const long long len = min(chunk, row[N_] - start);
    if (row[FLAGS_] & F64)
      acc = sq_sum((const double*)row[G_] + start, len, acc);
    else
      acc = sq_sum((const float*)row[G_] + start, len, acc);
  }
  const double s = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// the update's scalars in T; bc1 / bc2 on the device, or null and inv1 /
// inv2 the reciprocals of the host's
template <class T>
struct Step {
  T c1, b1, c2, b2, eps, wd, neg_lr, inv1, inv2, max_norm;
  const T* bc1;
  const T* bc2;
};

template <class T>
__device__ __forceinline__ void adam(T& p, T g, T& m, T& v, bool clip,
                                     T norm, bool decay, T bc1, T bc2,
                                     bool dev_bc, const Step<T>& s) {
  if (clip) g = mul_(div_(g, norm), s.max_norm);
  const T mn = add_(mul_(s.c1, g), mul_(s.b1, m));
  const T vn = add_(mul_(s.c2, mul_(g, g)), mul_(s.b2, v));
  const T mh = dev_bc ? div_(mn, bc1) : mul_(mn, s.inv1);
  const T vh = dev_bc ? div_(vn, bc2) : mul_(vn, s.inv2);
  T u = div_(mh, add_(sqrt_(vh), s.eps));
  if (decay) u = add_(u, mul_(s.wd, p));
  p = add_(p, mul_(s.neg_lr, u));
  m = mn;
  v = vn;
}

// clip_mode: 0 none, 1 where norm > max_cmp (fine-tuning), 2 unless
// norm < max_cmp (pretraining; so also at max_cmp, and for a NaN norm)
template <class T>
__global__ void __launch_bounds__(THREADS)
update_kernel(const long long* tab, int l0, int l1, long long w0,
              long long w1, long long chunk, const double* partials,
              int nparts, float* norm_out, Step<T> s, int clip_mode,
              double max_cmp) {
  __shared__ double sh[THREADS];
  bool clip = false;
  T norm = T(0);
  if (partials) {
    double acc = 0.0;
    for (int i = threadIdx.x; i < nparts; i += THREADS)
      acc = __dadd_rn(acc, partials[i]);
    const float nf = __double2float_rn(__dsqrt_rn(block_sum(acc, sh)));
    if (norm_out && blockIdx.x == 0 && threadIdx.x == 0) *norm_out = nf;
    const double nd = nf;
    clip = clip_mode == 1 ? nd > max_cmp
                          : clip_mode == 2 ? !(nd < max_cmp) : false;
    norm = (T)nf;
  }
  const bool dev_bc = s.bc1 != nullptr;
  const T bc1 = dev_bc ? *s.bc1 : T(0), bc2 = dev_bc ? *s.bc2 : T(0);
  for (long long it = w0 + blockIdx.x; it < w1; it += gridDim.x) {
    const long long* row = leaf_of(tab, l0, l1, it, FIRST_);
    const long long start = (it - row[FIRST_]) * chunk;
    const long long len = min(chunk, row[N_] - start);
    const bool decay = row[FLAGS_] & DECAY;
    T* p = (T*)row[P_] + start;
    const T* g = row[G_] ? (const T*)row[G_] + start : nullptr;
    T* mu = (T*)row[MU_] + start;
    T* nu = (T*)row[NU_] + start;
    const bool vec = (((uintptr_t)p | (uintptr_t)g | (uintptr_t)mu |
                       (uintptr_t)nu) & 15) == 0;
    for (long long e = 4LL * threadIdx.x; e < len; e += 4LL * THREADS) {
      const long long left = len - e;
      T pv[4], gv[4] = {T(0), T(0), T(0), T(0)}, mv[4], vv[4];
      load4(p + e, left, vec, pv);
      if (g) load4(g + e, left, vec, gv);
      load4(mu + e, left, vec, mv);
      load4(nu + e, left, vec, vv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < left)
          adam(pv[j], gv[j], mv[j], vv[j], clip, norm, decay, bc1, bc2,
               dev_bc, s);
      store4(p + e, left, vec, pv);
      store4(mu + e, left, vec, mv);
      store4(nu + e, left, vec, vv);
    }
  }
}

template <class T>
int launch_update(const long long* tab, int l0, int l1, long long w0,
                  long long w1, long long chunk, const double* partials,
                  float* norm_out, const double* h, const void* bc1,
                  const void* bc2, int clip_mode, void* stream) {
  Step<T> s{(T)h[0], (T)h[1], (T)h[2], (T)h[3], (T)h[4], (T)h[5], (T)h[6],
            (T)h[7], (T)h[8], (T)h[9], (const T*)bc1, (const T*)bc2};
  long long blocks = w1 - w0;
  blocks = blocks < 1 ? 1 : blocks > UPDATE_BLOCKS ? UPDATE_BLOCKS : blocks;
  update_kernel<T><<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      tab, l0, l1, w0, w1, chunk, partials, NORM_BLOCKS, norm_out, s,
      clip_mode, h[10]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launches go to `stream` and return cudaGetLastError() (0 when the
// launch was accepted).

int adamw_norm_blocks() { return NORM_BLOCKS; }

// partials[NORM_BLOCKS] of the squares of the gradients of table rows
// [0, L), whose gradient items are [0, W)
int adamw_norm(const long long* tab, int L, long long W, long long chunk,
               double* partials, void* stream) {
  norm_kernel<<<NORM_BLOCKS, THREADS, 0, (cudaStream_t)stream>>>(
      tab, L, W, chunk, partials);
  return (int)cudaGetLastError();
}

// One update of table rows [l0, l1) (items [w0, w1)), all float32 (f32)
// or all float64 (f64).  partials: adamw_norm's (null: no norm; clip_mode
// must then be 0); norm_out: float32, or null.  h, on the host: 1 - b1,
// b1, 1 - b2, b2, eps, weight decay, -lr, inv1, inv2, max_norm (the
// clip's factor), max_cmp (its threshold, compared in float64).  bc1 /
// bc2: the bias corrections on the device in T, or null (then inv1 /
// inv2).
int adamw_update_f32(const long long* tab, int l0, int l1, long long w0,
                     long long w1, long long chunk, const double* partials,
                     float* norm_out, const double* h, const void* bc1,
                     const void* bc2, int clip_mode, void* stream) {
  return launch_update<float>(tab, l0, l1, w0, w1, chunk, partials,
                              norm_out, h, bc1, bc2, clip_mode, stream);
}

int adamw_update_f64(const long long* tab, int l0, int l1, long long w0,
                     long long w1, long long chunk, const double* partials,
                     float* norm_out, const double* h, const void* bc1,
                     const void* bc2, int clip_mode, void* stream) {
  return launch_update<double>(tab, l0, l1, w0, w1, chunk, partials,
                               norm_out, h, bc1, bc2, clip_mode, stream);
}

}  // extern "C"
