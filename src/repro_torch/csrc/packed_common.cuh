// Shared by the packed segment kernels (segsum_packed.cu,
// edge_softmax_packed.cu): the element types they take, and the walk over a
// dst-row block's slots that both use.
//
// Packed layout (repro_torch/kernels/segsum/ops.py::pack_edges): block db
// holds EB slots; local_dst[db*EB + s] is the slot's destination row within
// the block's R rows, or R for padding. The valid slots of a block are in edge
// order, not sorted by row.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace packed {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// The calling warp owns rows [r0, r0 + 32) of the block. Walks the block's
// slots in packed order, 32 at a time (one coalesced index load per lane),
// and calls visit(slot, row - r0) for each slot of an owned row, in order.
template <typename Visit>
__device__ __forceinline__ void walk_owned(const int* __restrict__ local_dst,
                                           long long slot0, int EB, int r0,
                                           Visit visit) {
  const int lane = threadIdx.x;
  for (int c = 0; c < EB; c += 32) {
    const int j = c + lane;
    const int d = j < EB ? local_dst[slot0 + j] : -1;
    unsigned mine = __ballot_sync(kFull, d >= r0 && d < r0 + 32);
    while (mine) {
      const int k = __ffs(mine) - 1;
      mine &= mine - 1u;
      visit(slot0 + c + k, __shfl_sync(kFull, d, k) - r0);
    }
  }
}

}  // namespace packed
