// Per-destination softmax of edge logits over dst-row-blocked packs,
// hand-written for Hopper (sm_90a). Plain C entry point, loaded with ctypes by
// ``repro_torch/kernels/edge_softmax/ops.py``.
//
// Replaces the Pallas kernel
// repro/kernels/edge_softmax/kernel.py::edge_softmax_packed (body
// ``_edge_softmax_body``), which takes the segment max with an (EB, R, H)
// broadcast compare and gathers and sums with one-hot MXU matmuls. That idiom
// is not carried over.
//
// Bound on this card: bytes. A valid (slot, head) does about five flops and
// an exponential; the least traffic is the valid logits and the indices once
// and the output once. What costs time above that is the walk to each row's
// slots: the pack is not sorted by row inside a block.
//
// Design: a block owns 32 rows of one pack block and up to 32 heads (grid
// (DB, R/32, ceil(H/32)), 8 warps).
//   1. Per tile of up to 2048 slots it stages the block's local_dst entries
//      with cp.async and sorts its rows' slots by row, stably
//      (``packed::stage_and_sort``, shared with the packed segment sum).
//   2. Warp w owns rows w, w + 8, ... . A row's run of (slot, head) pairs is
//      spread over the lanes: with hw = min(H - h0, 32) heads, lane L takes
//      head L % hw of slot L / hw of each step of 32 / hw slots (8 slots a
//      step at GAT's H = 4). The lane keeps its first 8 logits of the run in
//      registers, so a run of up to 8 steps is read once.
//   3. The max is an in-lane max, then a shuffle tree over the lanes of one
//      head (a max is exact in any order); the sum of expf(l - max) is added
//      in-lane in slot order, then by a fixed shuffle tree: the result
//      repeats bit for bit. Each pair is written as ex / max(sum, 1e-30).
//   4. A pack block longer than one tile (EB > 2048) keeps each (row, head)'s
//      max and sum in shared memory across tiles, combined in tile order as
//      an online softmax (the sum rescaled by expf(old max - new max)); a
//      second sweep over the tiles writes the output.
// Padding slots (local_dst outside [0, R)) are written as exact zeros in a
// coalesced pass over each tile's (slot, head) pairs, shared by the pack
// block's row-group blocks. The Pallas
// kernel's clamps are kept: the max is floored at -1e30 (finite, so an empty
// row stays finite), the f32 denominator at 1e-30. No atomics.
//
// Layout: logits (DB*EB, H) f32/bf16/f16; local_dst (DB*EB) i32 in [0, R], R
// marking padding; out (DB*EB, H) in the logits' type, computed in f32. Any
// H and EB; R a multiple of 32, at most 128 (the wrapper checks).
#include "packed_common.cuh"

namespace {

using packed::kRows;
using packed::kThreads;
using packed::kTile;
using packed::kWarps;

constexpr float kMaxFloor = -1e30f;
constexpr float kDenomFloor = 1e-30f;
constexpr int kCache = 8;  // steps of a run whose logits a lane keeps

// The run's (slot, head) pairs as the calling warp's lanes take them.
template <typename T>
struct Run {
  const T* logits;  // the tile's first slot's row
  const int* list;  // the run's slots, tile-relative, in packed order
  int n;            // slots in the run
  int H;
  int h;    // the lane's head
  int j;    // the lane's slot within a step
  int sps;  // slots a step
  bool on;  // the lane takes a pair (lanes past sps * hw idle)
  __device__ __forceinline__ bool has(int i) const { return on && i < n; }
  __device__ __forceinline__ float at(int i) const {
    return packed::to_f(__ldg(logits + (long long)list[i] * H + h));
  }
  __device__ __forceinline__ T* out(T* tile_out, int i) const {
    return tile_out + (long long)list[i] * H + h;
  }
};

// The lanes of one head: lane j*hw + hh of step slot j. Combines their
// values into slot lane 0 (a fixed tree: the same order on every run) and
// hands the result to every lane of the head.
template <typename Op>
__device__ __forceinline__ float head_reduce(float v, int j, int sps, int hw,
                                             int lane, Op op) {
  for (int s = 1; s < sps; s <<= 1) {
    const float o = __shfl_down_sync(packed::kFull, v, s * hw);
    if (j + s < sps) v = op(v, o);
  }
  return __shfl_sync(packed::kFull, v, lane % hw);
}

// The run's max and sum of expf(l - max) within this tile; c[] ends holding
// the exponentials of the lane's first kCache steps.
template <typename T>
__device__ __forceinline__ void run_stats(const Run<T>& run, int hw, int lane,
                                          float (&c)[kCache], float* max_out,
                                          float* sum_out) {
  float mx = kMaxFloor;
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const int i = run.j + k * run.sps;
    if (run.has(i)) c[k] = run.at(i);
  }
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    if (run.has(run.j + k * run.sps)) mx = fmaxf(mx, c[k]);
  }
  for (int i = run.j + kCache * run.sps; run.has(i); i += run.sps) {
    mx = fmaxf(mx, run.at(i));
  }
  mx = head_reduce(mx, run.j, run.sps, hw, lane,
                   [](float a, float b) { return fmaxf(a, b); });
  float sum = 0.f;  // in-lane in slot order
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    if (run.has(run.j + k * run.sps)) {
      c[k] = expf(c[k] - mx);
      sum += c[k];
    }
  }
  for (int i = run.j + kCache * run.sps; run.has(i); i += run.sps) {
    sum += expf(run.at(i) - mx);
  }
  *max_out = mx;
  *sum_out = head_reduce(sum, run.j, run.sps, hw, lane,
                         [](float a, float b) { return a + b; });
}

// Writes the run's weights expf(l - mx) / max(sum, 1e-30), the first
// kCache steps' exponentials from c[] when ``cached``.
template <typename T>
__device__ __forceinline__ void run_write(const Run<T>& run, T* tile_out,
                                          const float (&c)[kCache],
                                          bool cached, float mx, float sum) {
  const float d = fmaxf(sum, kDenomFloor);
  int i = run.j;
  if (cached) {
#pragma unroll
    for (int k = 0; k < kCache; ++k, i += run.sps) {
      if (run.has(i)) *run.out(tile_out, i) = packed::from_f<T>(c[k] / d);
    }
  }
  for (; run.has(i); i += run.sps) {
    *run.out(tile_out, i) = packed::from_f<T>(expf(run.at(i) - mx) / d);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) edge_softmax_packed_kernel(
    const T* __restrict__ logits, const int* __restrict__ local_dst,
    T* __restrict__ out, int EB, int H, int R, bool idx_vec) {
  __shared__ __align__(16) packed::Sort sm;
  // a run over several tiles: each (row, head)'s max and sum so far
  __shared__ float s_max[kRows][32];
  __shared__ float s_sum[kRows][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int r_lo = blockIdx.y * kRows;
  const int h0 = blockIdx.z * 32;
  const int hw = min(32, H - h0);
  const long long block0 = (long long)blockIdx.x * EB;
  const bool one_tile = EB <= kTile;
  for (int i = threadIdx.x; i < kRows * 32; i += kThreads) {
    s_max[i / 32][i % 32] = kMaxFloor;
    s_sum[i / 32][i % 32] = 0.f;
  }
  Run<T> run;
  run.H = H;
  run.h = h0 + lane % hw;
  run.j = lane / hw;
  run.sps = 32 / hw;
  run.on = run.j < run.sps;

  for (int t0 = 0; t0 < EB; t0 += kTile) {
    const int tn = min(kTile, EB - t0);
    packed::stage_and_sort(sm, local_dst + block0 + t0, tn, r_lo, idx_vec);
    const long long tile0 = block0 + t0;
    T* tile_out = out + tile0 * H;
    run.logits = logits + tile0 * H;
    {  // padding: exact zeros; the row-group blocks share the tile's pairs
      const int pairs = tn * hw;
      const int part = (pairs + gridDim.y - 1) / gridDim.y;
      const int e1 = min(pairs, part * (int)(blockIdx.y + 1));
      for (int e = part * blockIdx.y + threadIdx.x; e < e1; e += kThreads) {
        const int i = e / hw;
        const int d = sm.idx[i];
        if (d < 0 || d >= R) {
          tile_out[(long long)i * H + h0 + e % hw] = packed::from_f<T>(0.f);
        }
      }
    }
    for (int r = warp; r < kRows; r += kWarps) {
      run.n = sm.row_cnt[r];
      if (run.n == 0) continue;  // warp-uniform
      run.list = sm.sorted + sm.row_off[r];
      float c[kCache];
      float mx, sum;
      run_stats(run, hw, lane, c, &mx, &sum);
      if (one_tile) {
        run_write(run, tile_out, c, true, mx, sum);
      } else if (lane < hw) {  // online: combine in tile order
        const float m_old = s_max[r][lane];
        const float m_new = fmaxf(m_old, mx);
        s_sum[r][lane] = s_sum[r][lane] * expf(m_old - m_new) +
                         sum * expf(mx - m_new);
        s_max[r][lane] = m_new;
      }
    }
    __syncthreads();  // the staged tile and the sort are reused
  }
  if (one_tile) return;
  for (int t0 = 0; t0 < EB; t0 += kTile) {  // second sweep: write
    const int tn = min(kTile, EB - t0);
    packed::stage_and_sort(sm, local_dst + block0 + t0, tn, r_lo, idx_vec);
    const long long tile0 = block0 + t0;
    run.logits = logits + tile0 * H;
    for (int r = warp; r < kRows; r += kWarps) {
      run.n = sm.row_cnt[r];
      if (run.n == 0) continue;
      run.list = sm.sorted + sm.row_off[r];
      const float c[kCache] = {};
      run_write(run, out + tile0 * H, c, false, s_max[r][lane % hw],
                s_sum[r][lane % hw]);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* logits, const int* local_dst, void* out, int DB, int EB,
           int H, int R, cudaStream_t stream) {
  const bool idx_vec =
      EB % 4 == 0 && reinterpret_cast<uintptr_t>(local_dst) % 16 == 0;
  const dim3 grid(DB, R / kRows, (H + 31) / 32);
  edge_softmax_packed_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), local_dst, static_cast<T*>(out), EB, H,
      R, idx_vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 f16
int edge_softmax_packed(const void* logits, const int* local_dst, void* out,
                        int DB, int EB, int H, int R, int dtype,
                        cudaStream_t stream) {
  if (DB <= 0 || H <= 0 || EB <= 0) return 0;
  if (R % kRows != 0) return (int)cudaErrorInvalidValue;
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
