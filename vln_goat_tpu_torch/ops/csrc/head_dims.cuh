// The head widths the attention kernels are built for, and the launch-time
// choice of the kernel instance for a call's head width.
//
// Every attention kernel of the port (attn_fwd.cuh, fused_qkv_mha_bwd.cu's
// attn_bwd_kernel, attn_fwd_sm90.cuh, attn_bwd_sm90.cuh) is a template of
// its head width DH and is compiled for each width of DIMS; a call with any
// other width launches nothing and returns cudaErrorInvalidValue.  The
// libraries' `*_head_dims` entries report the set, so the wrappers
// (ops/attention.py) can name it when they refuse a width.
#pragma once

#include <cuda_runtime.h>

namespace head_dims {
namespace {

constexpr int COUNT = 3;
constexpr int DIMS[COUNT] = {32, 64, 128};

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
  }
  return (int)cudaErrorInvalidValue;
}

// writes the first n widths of DIMS to out; returns COUNT
inline int query(int* out, int n) {
  for (int i = 0; i < COUNT && i < n; ++i) out[i] = DIMS[i];
  return COUNT;
}

}  // namespace
}  // namespace head_dims
