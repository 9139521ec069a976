// The head widths the attention kernels are built for, and the launch-time
// choice of the kernel instance for a call's head width.
//
// Every instanced attention kernel of the port (attn_fwd.cuh,
// fused_qkv_mha_bwd.cu's attn_bwd_kernel, attn_fwd_sm90.cuh,
// attn_bwd_sm90.cuh) is a template of its head width DH and is compiled for
// each width of DIMS, on the tensor cores.  A head wider than the widest
// of DIMS (256) whose width is a multiple of WIDE_STEP runs on
// attn_wide.cuh, which takes the width at run time as 128-column pieces
// on the CUDA cores (`wide`).  A call with any other width
// launches nothing and returns cudaErrorInvalidValue.  The libraries'
// `*_head_dims` entries report the set and the step, so the wrappers
// (ops/attention.py) can name them when they refuse a width.
#pragma once

#include <cuda_runtime.h>

namespace head_dims {
namespace {

constexpr int COUNT = 5;
constexpr int DIMS[COUNT] = {32, 64, 128, 192, 256};
// past DIMS[COUNT - 1], any multiple of this runs on attn_wide.cuh (64:
// the bf16 projection backward's dy job sums H dh in 64-deep chunks)
constexpr int WIDE_STEP = 64;

// whether head width dh runs on attn_wide.cuh
inline bool wide(int dh) {
  return dh > DIMS[COUNT - 1] && dh % WIDE_STEP == 0;
}

template <int W>
struct Dh {
  static constexpr int value = W;
};

// f(Dh<dh>{}) for a width of DIMS, cudaErrorInvalidValue for any other
template <class F>
inline int dispatch(int dh, F&& f) {
  switch (dh) {
    case 32:
      return f(Dh<32>{});
    case 64:
      return f(Dh<64>{});
    case 128:
      return f(Dh<128>{});
    case 192:
      return f(Dh<192>{});
    case 256:
      return f(Dh<256>{});
  }
  return (int)cudaErrorInvalidValue;
}

// writes the first n of DIMS followed by WIDE_STEP to out; returns
// COUNT + 1
inline int query(int* out, int n) {
  for (int i = 0; i < COUNT && i < n; ++i) out[i] = DIMS[i];
  if (COUNT < n) out[COUNT] = WIDE_STEP;
  return COUNT + 1;
}

}  // namespace
}  // namespace head_dims
