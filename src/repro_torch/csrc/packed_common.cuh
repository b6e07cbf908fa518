// Shared by the packed segment kernels (segsum_packed.cu,
// edge_softmax_packed.cu): the element types they take, and the staged,
// row-sorted tile of a pack block's slots that both walk.
//
// Packed layout (repro_torch/kernels/segsum/ops.py::pack_edges): block db
// holds EB slots; local_dst[db*EB + s] is the slot's destination row within
// the block's R rows, or R for padding. The valid slots of a block are in edge
// order, not sorted by row.
#pragma once
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace packed {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps of a block that sorts a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;    // dst rows a block owns (one per lane in the scan)
constexpr int kTile = 2048;  // local_dst entries staged at a time

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

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  }
}

// The slot key of entry i of the staged tile: its row within the block's
// kRows rows, or -1 (padding, another row group, or past the tile).
__device__ __forceinline__ int slot_key(const int* idx, int i, int tn,
                                        int r_lo) {
  const int d = i < tn ? idx[i] - r_lo : -1;
  return d >= 0 && d < kRows ? d : -1;
}

// The staged entries, the tile's slots of the block's rows sorted by row,
// the per-(warp, row) counts (then offsets), and each row's run in
// ``sorted``: [row_off[r], row_off[r] + row_cnt[r]).
struct Sort {
  int idx[kTile];
  int sorted[kTile];
  int cnt[kWarps][kRows];
  int row_off[kRows];
  int row_cnt[kRows];
};

// Every thread of a block of kThreads calls this. It copies the tile's
// ``tn`` entries (``tile`` points at its first) into sm.idx with cp.async
// (``idx_vec``: 16-byte copies, for a 16-byte aligned tile and tn % 4 ==
// 0), then sorts the tile's slots of rows [r_lo, r_lo +
// kRows) by row, stably: warp w takes a contiguous run of 32-slot groups
// (skipping groups with no slot of the block's rows) and counts each row's
// slots by __match_any_sync; one warp scans the (row, warp) counts into
// offsets; each warp then places its slots at offset + rank among equal
// rows. Integer arithmetic only, no atomics: each row's list keeps packed
// order. Ends with a barrier; the caller syncs before it stages the next
// tile.
__device__ __forceinline__ void stage_and_sort(Sort& sm,
                                               const int* __restrict__ tile,
                                               int tn, int r_lo,
                                               bool idx_vec) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (idx_vec) {
    for (int i = threadIdx.x * 4; i < tn; i += kThreads * 4) {
      cp_async(&sm.idx[i], tile + i, 16);
    }
  } else {
    for (int i = threadIdx.x; i < tn; i += kThreads) {
      cp_async(&sm.idx[i], tile + i, 4);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  sm.cnt[warp][lane] = 0;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int groups = (tn + 31) / 32;
  const int per_warp = (groups + kWarps - 1) / kWarps;
  const int g0 = warp * per_warp;
  const int g1 = min(groups, g0 + per_warp);
  for (int g = g0; g < g1; ++g) {
    const int key = slot_key(sm.idx, g * 32 + lane, tn, r_lo);
    if (!__ballot_sync(kFull, key >= 0)) continue;
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      sm.cnt[warp][key] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  if (warp == 0) {  // lane = row: per-warp exclusive offsets, then rows
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = sm.cnt[w][lane];
      sm.cnt[w][lane] = total;
      total += c;
    }
    int incl = total;
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += up;
    }
    const int base = incl - total;
    sm.row_off[lane] = base;
    sm.row_cnt[lane] = total;
    for (int w = 0; w < kWarps; ++w) sm.cnt[w][lane] += base;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int g = g0; g < g1; ++g) {
    const int key = slot_key(sm.idx, g * 32 + lane, tn, r_lo);
    if (!__ballot_sync(kFull, key >= 0)) continue;
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0) {
      sm.sorted[sm.cnt[warp][key] + __popc(peers & below)] = g * 32 + lane;
    }
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) {
      sm.cnt[warp][key] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
}

}  // namespace packed
