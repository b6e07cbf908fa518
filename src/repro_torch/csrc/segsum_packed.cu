// Masked per-destination sum over dst-row-blocked packs, hand-written for
// Hopper (sm_90a). Plain C entry point, loaded with ctypes by
// ``repro_torch/kernels/segsum/ops.py``.
//
// Replaces the Pallas kernel repro/kernels/segsum/kernel.py::segment_sum_packed
// (body ``_segsum_body``), which builds an (EB, R) one-hot of each block's
// local_dst and contracts it with the block's messages on the MXU. That idiom
// is not carried over. Here each block of threads owns one dst-row block and
// 32 feature columns; warp w owns rows [32w, 32w + 32) and walks the block's
// slots in packed order, adding each owned slot's row into a per-(row, column)
// float sum in shared memory that only one thread ever touches. No float
// atomics and a fixed summation order: the result repeats bit for bit.
//
// Layout: contrib (DB*EB, F) f32/bf16/f16; local_dst (DB*EB) i32 in [0, R],
// R marking padding; out (DB*R, F) in contrib's type, accumulated in f32.
// Any F; R a multiple of 32, at most 128 (the wrapper checks).
//
// Bound on this card: bytes. Each valid slot reads one F-wide row for F adds;
// the least traffic is the valid rows, the indices and the output once, far
// below the fp32 rate. Padding slots are never read.
#include "packed_common.cuh"

namespace {

// Grid (DB, ceil(F/32)), block (32, R/32), R*32 floats of shared memory.
template <typename T>
__global__ void __launch_bounds__(128) segsum_packed_kernel(
    const T* __restrict__ contrib, const int* __restrict__ local_dst,
    T* __restrict__ out, int EB, int F, int R) {
  extern __shared__ float acc[];  // (R, 32): row-major, lane-contiguous
  const int lane = threadIdx.x;
  const int r0 = threadIdx.y * 32;
  const int f = blockIdx.y * 32 + lane;
  const bool col = f < F;
  for (int i = 0; i < 32; ++i) acc[(r0 + i) * 32 + lane] = 0.f;
  const long long slot0 = (long long)blockIdx.x * EB;
  packed::walk_owned(local_dst, slot0, EB, r0, [&](long long s, int r) {
    if (col) acc[(r0 + r) * 32 + lane] += packed::to_f(contrib[s * F + f]);
  });
  if (!col) return;
  const long long row0 = (long long)blockIdx.x * R + r0;
  for (int i = 0; i < 32; ++i) {
    out[(row0 + i) * F + f] = packed::from_f<T>(acc[(r0 + i) * 32 + lane]);
  }
}

template <typename T>
int launch(const void* contrib, const int* local_dst, void* out, int DB,
           int EB, int F, int R, cudaStream_t stream) {
  const dim3 block(32, R / 32);
  const dim3 grid(DB, (F + 31) / 32);
  const size_t smem = (size_t)R * 32 * sizeof(float);
  segsum_packed_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(contrib), local_dst, static_cast<T*>(out), EB, F,
      R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 f16
int segsum_packed(const void* contrib, const int* local_dst, void* out, int DB,
                  int EB, int F, int R, int dtype, cudaStream_t stream) {
  if (DB <= 0 || F <= 0) return 0;
  switch (dtype) {
    case 0: return launch<float>(contrib, local_dst, out, DB, EB, F, R, stream);
    case 1:
      return launch<__nv_bfloat16>(contrib, local_dst, out, DB, EB, F, R,
                                   stream);
    case 2: return launch<__half>(contrib, local_dst, out, DB, EB, F, R, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
