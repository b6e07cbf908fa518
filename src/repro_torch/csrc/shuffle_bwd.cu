// Adjoint of sim_shuffle's send gather, hand-written for Hopper (sm_90a).
// Plain C entry point, loaded with ctypes by
// ``repro_torch/kernels/shuffle/kernel.py``.
//
// The forward is ``send[q, p, s] = h[q, send_idx[q, p, s]]`` (owner q, needer
// p of Q, slot s). In the JAX package its adjoint is XLA's scatter-add, the
// adjoint of ``jnp.take_along_axis`` in repro/core/shuffle.py::sim_shuffle;
// no Pallas kernel has it. The GNN layers' self-row gather
// (``mixed[split, self_pos]``) has the same form with Q = 1, and takes this
// kernel too. It computes, for each owner q and local row n,
//
//   dh[q, n] = sum over p ascending of g[q, p, s], over the valid slots
//              s < send_count[q, p] with send_idx[q, p, s] == n,
//
// summed in fp32 from +0.0, the order of the plain version
// (repro_torch/kernels/shuffle/ref.py::shuffle_bwd), which it equals bit for
// bit. Padding slots (s >= send_count) are never read: their cotangents are
// zero (the row adjoint never addresses a padding receive row), so skipping
// them is exact. torch's own adjoint (index_put_ with accumulate) walks every
// padding slot, all of which hold row 0, as one serial run of a thousand or
// more duplicates.
//
// Layout: g (P, Q, S, F) f32, send_idx (P, Q, S) i32, send_count (P, Q)
// i32, dh (P, N, F) f32, all contiguous; Q <= 32. Precondition: within each
// (q, p) pair the valid slots hold distinct rows in ascending order, as
// build_split_plan writes them (slots follow the sorted frontier, and an
// owner's local rows keep its order; so do the self rows of a split's
// destinations).
//
// Bound on this card: bytes. dh is written once (P*N*F*4, mostly zero rows),
// the valid cotangent rows are read once, and the index runs a block needs.
// Design: a gather, with no atomics and no workspace. A block owns 32
// consecutive rows [n0, n0 + 32) of one owner. Its first Q threads find,
// by two binary searches in each pair's ascending valid slots, the slots
// whose rows fall in that range; the block writes each such slot into a
// shared table slot_of[p][n - n0]. Then each warp takes four rows, reads the
// table (a broadcast from shared memory), adds the found cotangent rows in
// ascending p with 16-byte loads, and stores the row once with 16-byte
// stores (zero where nothing was sent).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 32;  // rows of one owner a block writes
constexpr int kMaxGroups = 32;  // kernel.MAX_GROUPS

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo,
                                           int hi, int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}

// Grid (ceil(N / kRows), P), block 32 * kWarps. kVec: F % 4 == 0 and g
// 16-byte aligned, so every row is and moves as float4.
template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps) shuffle_bwd_kernel(
    const float* __restrict__ g, const int* __restrict__ send_idx,
    const int* __restrict__ send_count, float* __restrict__ dh, int Q, int N,
    int S, int F) {
  __shared__ int slot_of[kMaxGroups * kRows];
  __shared__ int range[2 * kMaxGroups];
  const int q = blockIdx.y;
  const int n0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  for (int i = tid; i < Q * kRows; i += blockDim.x) slot_of[i] = -1;
  if (tid < Q) {
    const int pair = q * Q + tid;
    const int* a = send_idx + (long long)pair * S;
    const int cnt = min(max(send_count[pair], 0), S);
    const int lo = lower_bound(a, 0, cnt, n0);
    range[2 * tid] = lo;
    range[2 * tid + 1] = lower_bound(a, lo, cnt, n0 + kRows);
  }
  __syncthreads();
  for (int p = 0; p < Q; ++p) {
    const int* a = send_idx + ((long long)q * Q + p) * S;
    const int hi = range[2 * p + 1];
    for (int s = range[2 * p] + tid; s < hi; s += blockDim.x) {
      slot_of[p * kRows + (a[s] - n0)] = s;
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long gq = (long long)q * Q;  // first pair of owner q
  for (int r = warp; r < kRows; r += kWarps) {
    const int n = n0 + r;
    if (n >= N) break;
    float* out = dh + ((long long)q * N + n) * F;
    if (kVec) {
      const int F4 = F >> 2;
      for (int c = lane; c < F4; c += 32) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int p = 0; p < Q; ++p) {
          const int s = slot_of[p * kRows + r];
          if (s >= 0) {
            const float4* row = reinterpret_cast<const float4*>(
                g + ((gq + p) * S + s) * F);
            add4(acc, __ldg(row + c));
          }
        }
        reinterpret_cast<float4*>(out)[c] = acc;
      }
    } else {
      for (int c = lane; c < F; c += 32) {
        float acc = 0.f;
        for (int p = 0; p < Q; ++p) {
          const int s = slot_of[p * kRows + r];
          if (s >= 0) acc = __fadd_rn(acc, __ldg(g + ((gq + p) * S + s) * F + c));
        }
        out[c] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

int shuffle_bwd(const float* g, const int* send_idx, const int* send_count,
                float* dh, int P, int Q, int N, int S, int F,
                cudaStream_t stream) {
  if (P <= 0 || N <= 0 || F <= 0) return 0;
  if (Q > kMaxGroups) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + kRows - 1) / kRows), (unsigned)P);
  const dim3 block(32 * kWarps);
  if (F % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dh) % 16 == 0) {
    shuffle_bwd_kernel<true><<<grid, block, 0, stream>>>(g, send_idx, send_count,
                                                         dh, Q, N, S, F);
  } else {
    shuffle_bwd_kernel<false><<<grid, block, 0, stream>>>(g, send_idx, send_count,
                                                          dh, Q, N, S, F);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
