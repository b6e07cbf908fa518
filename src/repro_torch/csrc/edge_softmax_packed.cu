// Per-destination softmax of edge logits over dst-row-blocked packs,
// hand-written for Hopper (sm_90a). Plain C entry point, loaded with ctypes by
// ``repro_torch/kernels/edge_softmax/ops.py``.
//
// Replaces the Pallas kernel
// repro/kernels/edge_softmax/kernel.py::edge_softmax_packed (body
// ``_edge_softmax_body``), which takes the segment max with an (EB, R, H)
// broadcast compare and gathers and sums with one-hot MXU matmuls. Here each
// block of threads owns one dst-row block and 32 heads; warp w owns rows
// [32w, 32w + 32), a lane one head. Two walks over the block's slots in
// packed order keep each (row, head)'s max and then its sum of exponentials
// in shared memory, each cell touched by one thread only (no atomics, a fixed
// order: the result repeats bit for bit). A third pass writes every slot.
// The Pallas kernel's clamps are kept: the max is floored at -1e30 (finite,
// so an empty row stays finite), the f32 denominator at 1e-30; padding slots
// get exactly 0.
//
// Layout: logits (DB*EB, H) f32/bf16/f16; local_dst (DB*EB) i32 in [0, R], R
// marking padding; out (DB*EB, H) in the logits' type, computed in f32. Any
// H; R a multiple of 32, at most 128 (the wrapper checks).
//
// Bound on this card: bytes. A valid (slot, head) does about five flops and
// an exponential; the least traffic is the valid logits and the indices once
// and the output once.
#include "packed_common.cuh"

namespace {

constexpr float kMaxFloor = -1e30f;
constexpr float kDenomFloor = 1e-30f;

// Grid (DB, ceil(H/32)), block (32, R/32), 2*R*32 floats of shared memory.
template <typename T>
__global__ void __launch_bounds__(128) edge_softmax_packed_kernel(
    const T* __restrict__ logits, const int* __restrict__ local_dst,
    T* __restrict__ out, int EB, int H, int R) {
  extern __shared__ float sm[];
  float* smax = sm;           // (R, 32)
  float* sden = sm + R * 32;  // (R, 32)
  const int lane = threadIdx.x;
  const int r0 = threadIdx.y * 32;
  const int h0 = blockIdx.y * 32;
  const int h = h0 + lane;
  const bool col = h < H;
  for (int i = 0; i < 32; ++i) {
    smax[(r0 + i) * 32 + lane] = kMaxFloor;
    sden[(r0 + i) * 32 + lane] = 0.f;
  }
  const long long slot0 = (long long)blockIdx.x * EB;
  packed::walk_owned(local_dst, slot0, EB, r0, [&](long long s, int r) {
    if (col) {
      float* m = &smax[(r0 + r) * 32 + lane];
      *m = fmaxf(*m, packed::to_f(logits[s * H + h]));
    }
  });
  packed::walk_owned(local_dst, slot0, EB, r0, [&](long long s, int r) {
    if (col) {
      const int cell = (r0 + r) * 32 + lane;
      sden[cell] += expf(packed::to_f(logits[s * H + h]) - smax[cell]);
    }
  });
  __syncthreads();
  const int nh = min(32, H - h0);
  const long long n = (long long)EB * nh;
  const int nthreads = blockDim.x * blockDim.y;
  for (long long i = threadIdx.y * 32 + lane; i < n; i += nthreads) {
    const long long s = slot0 + i / nh;
    const int hh = (int)(i % nh);
    const int d = local_dst[s];
    float a = 0.f;
    if (d >= 0 && d < R) {
      const int cell = d * 32 + hh;
      a = expf(packed::to_f(logits[s * H + h0 + hh]) - smax[cell]) /
          fmaxf(sden[cell], kDenomFloor);
    }
    out[s * H + h0 + hh] = packed::from_f<T>(a);
  }
}

template <typename T>
int launch(const void* logits, const int* local_dst, void* out, int DB, int EB,
           int H, int R, cudaStream_t stream) {
  const dim3 block(32, R / 32);
  const dim3 grid(DB, (H + 31) / 32);
  const size_t smem = 2 * (size_t)R * 32 * sizeof(float);
  edge_softmax_packed_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(logits), local_dst, static_cast<T*>(out), EB, H,
      R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 f16
int edge_softmax_packed(const void* logits, const int* local_dst, void* out,
                        int DB, int EB, int H, int R, int dtype,
                        cudaStream_t stream) {
  if (DB <= 0 || H <= 0) return 0;
  switch (dtype) {
    case 0: return launch<float>(logits, local_dst, out, DB, EB, H, R, stream);
    case 1:
      return launch<__nv_bfloat16>(logits, local_dst, out, DB, EB, H, R,
                                   stream);
    case 2: return launch<__half>(logits, local_dst, out, DB, EB, H, R, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
