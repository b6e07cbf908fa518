// Wavefront expansion of the device sampler, hand-written for Hopper (sm_90a).
// Plain C entry point, loaded with ctypes by
// ``repro_torch/sampler/kernel.py``.
//
// Replaces the Pallas kernel repro/sampler/kernel.py::wavefront_expand_kernel
// (body ``_expand_body``, which calls repro/sampler/ref.py::expand_codes).
// For every (vertex, slot) it hashes the 64-bit layer key, the global vertex id
// and the slot with three lowbias32 rounds, reduces the word onto the degree,
// and emits a slot code: a within-row neighbour offset (>= 0), a self-loop
// (-1) or invalid (-2). A sampled slot dies when an earlier slot of its row
// drew the same offset. The result is bitwise equal to the plain version
// (repro_torch/sampler/ref.py::expand_codes): the words are native uint32
// here and int64-emulated there.
//
// Layout: vid, deg (B,) i32 (deg < 0 marks an invalid row); key (2,) i64
// holding the two uint32 lanes (read on the device, so a new layer key needs
// no host sync); out (B, fanout) i32. No row-block padding: any B.
//
// Bound on this card: bytes, with the integer work close behind. A row reads
// 8 bytes and writes 4*fanout; the slots of a valid row do about 28 integer
// ops each plus the dedup compare. At the sampler's shapes (tens of
// thousands of rows) the bound is below a microsecond, under the launch
// floor, so the design spends its effort on keeping every lane busy and
// the blocks few:
//  * a lane takes one (row, slot) pair, and at fanout <= 16 floor(32/fanout)
//    rows share a warp (fanout 15: 30 of 32 lanes busy);
//  * the dedup runs only where a row of the warp samples (deg > fanout:
//    take-all offsets are distinct), as fanout - 1 shuffles: slot j reads
//    slot j - k of its own row for k = 1..fanout-1 and is a duplicate when
//    one of them (k <= j) drew the same offset. A __match_any_sync on
//    (row, offset) did the same in one instruction, but its cost grows with
//    the distinct values in the warp (nearly 32 here), and with it the
//    kernel measured little faster than the one-row-a-warp kernel it
//    replaced (PERF.md);
//  * a block expands 16 * rows-per-warp rows (two row groups a warp, the
//    rows' vid/deg loaded before any hashing; four groups left half the
//    warps a wave could hold idle and measured slower), stages their codes
//    in shared memory and writes them as one contiguous span with 16-byte
//    stores (the span starts at a row that is a multiple of 16, so it is
//    16-byte aligned);
//  * rows with deg < 0 write the -2 fill without hashing;
//  * the grid is persistent: at most 8 blocks an SM, a grid-stride loop over
//    the row blocks.
// Fanouts above 32 take a second kernel, one warp per row: a first pass
// stores each slot's raw offset in the output row, and a second pass, from
// the last 32-slot chunk to the first, compares each chunk against the raw
// offsets of the chunks before it (not yet overwritten, since the pass runs
// backwards) and then writes its final codes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kInvalid = -2;
constexpr int kSelfLoop = -1;
constexpr int kWarps = 8;
constexpr int kGroups = 2;  // row groups a warp expands per block step
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The raw offset of slot j of a row (before dedup) and whether the slot is
// valid apart from dedup; the semantics of ref.expand_codes.
__device__ __forceinline__ int raw_offset(uint32_t h2, int d, int fanout,
                                          int j, bool* valid) {
  const bool take_all = d <= fanout;
  *valid = d < 0 ? false : (d == 0 ? j == 0 : (take_all ? j < d : true));
  if (d == 0 && j == 0) return kSelfLoop;
  if (take_all) return j;
  const uint32_t u = mix32(h2 + (uint32_t)j * 0x9E3779B9u);
  return (int)(u % (uint32_t)d);
}

// fanout <= 32: rpw = 32 / fanout rows a warp; lane = row * fanout + slot.
// Block 32 * kWarps threads, a block step covers kWarps * kGroups * rpw rows.
__global__ void __launch_bounds__(32 * kWarps) wavefront_expand_narrow(
    const int* __restrict__ vid, const int* __restrict__ deg,
    const long long* __restrict__ key, int* __restrict__ out, int B,
    int fanout, int rpw) {
  __shared__ __align__(16) int stage[kWarps * kGroups * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = lane / fanout;
  const int j = lane - r * fanout;
  const bool active = r < rpw;
  const uint32_t klo = (uint32_t)key[0];
  const uint32_t khi = (uint32_t)key[1];
  const int rows_per_step = kWarps * kGroups * rpw;
  for (long long b0 = (long long)blockIdx.x * rows_per_step; b0 < B;
       b0 += (long long)gridDim.x * rows_per_step) {
    int d[kGroups], v[kGroups];
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const long long b = b0 + (long long)(warp * kGroups + gi) * rpw + r;
      const bool live = active && b < B;
      d[gi] = live ? deg[b] : -1;
      v[gi] = live ? vid[b] : 0;
    }
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      int code = kInvalid;
      int off = 0;
      bool sampled = false;
      if (d[gi] >= 0) {
        const uint32_t h2 = mix32(mix32((uint32_t)v[gi] ^ klo) ^ khi);
        bool valid;
        off = raw_offset(h2, d[gi], fanout, j, &valid);
        code = valid ? off : kInvalid;
        sampled = d[gi] > fanout;
      }
      // dedup where a row of the warp samples (take-all offsets are
      // distinct): slot j is a duplicate when slot j - k of its row, k in
      // 1..j, drew the same offset
      if (__any_sync(kFull, sampled)) {
        bool dup = false;
        for (int k = 1; k < fanout; ++k) {
          const int earlier = __shfl_sync(kFull, off, lane >= k ? lane - k : lane);
          dup |= j >= k && earlier == off;
        }
        if (sampled && dup) code = kInvalid;
      }
      if (active) stage[((warp * kGroups + gi) * rpw + r) * fanout + j] = code;
    }
    __syncthreads();
    const long long rows = B - b0 < rows_per_step ? B - b0 : rows_per_step;
    const int n = (int)rows * fanout;
    int* dst = out + b0 * fanout;
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(stage)[i];
    }
    for (int i = (n4 << 2) + threadIdx.x; i < n; i += blockDim.x) dst[i] = stage[i];
    __syncthreads();  // the stage is free for the next step
  }
}

// fanout > 32: one warp per row, rows in a grid-stride loop.
__global__ void __launch_bounds__(32 * kWarps) wavefront_expand_wide(
    const int* __restrict__ vid, const int* __restrict__ deg,
    const long long* __restrict__ key, int* __restrict__ out, int B,
    int fanout) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t klo = (uint32_t)key[0];
  const uint32_t khi = (uint32_t)key[1];
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); b < B;
       b += stride) {
    const int d = deg[b];
    int* row = out + b * fanout;
    if (d < 0) {
      for (int j = lane; j < fanout; j += 32) row[j] = kInvalid;
      continue;
    }
    const uint32_t h2 = mix32(mix32((uint32_t)vid[b] ^ klo) ^ khi);
    // raw offsets first, then backwards chunk by chunk
    for (int j = lane; j < fanout; j += 32) {
      bool unused;
      row[j] = raw_offset(h2, d, fanout, j, &unused);
    }
    __syncwarp();
    const int last = ((fanout - 1) / 32) * 32;
    for (int base = last; base >= 0; base -= 32) {
      const int j = base + lane;
      const bool active = j < fanout;
      bool valid = false;
      const int off = active ? raw_offset(h2, d, fanout, j, &valid) : 0;
      // inactive lanes hold values no offset takes (offsets are >= -1)
      const unsigned same = __match_any_sync(kFull, active ? off : -3 - lane);
      bool dup = (same & below) != 0u;
      if (active) {
        for (int k = 0; k < base && !dup; ++k) dup = row[k] == off;
      }
      __syncwarp();  // every lane has read the earlier chunks' raw offsets
      if (active) row[j] = (valid && !dup) ? off : kInvalid;
      __syncwarp();
    }
  }
}

__global__ void wavefront_expand_empty() {}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

// The grid both entry points launch for (B, fanout).
unsigned grid_for(int B, int fanout) {
  const long long rows_per_block =
      fanout <= 32 ? (long long)kWarps * kGroups * (32 / fanout) : kWarps;
  const long long want = ((long long)B + rows_per_block - 1) / rows_per_block;
  const long long most = (long long)sm_count() * kBlocksPerSm;
  return (unsigned)(want < most ? want : most);
}

}  // namespace

extern "C" {

int wavefront_expand(const int* vid, const int* deg, const long long* key,
                     int* out, int B, int fanout, cudaStream_t stream) {
  if (B <= 0) return 0;
  const unsigned grid = grid_for(B, fanout);
  if (fanout <= 32) {
    wavefront_expand_narrow<<<grid, 32 * kWarps, 0, stream>>>(
        vid, deg, key, out, B, fanout, 32 / fanout);
  } else {
    wavefront_expand_wide<<<grid, 32 * kWarps, 0, stream>>>(vid, deg, key, out,
                                                            B, fanout);
  }
  return (int)cudaGetLastError();
}

// An empty kernel on the grid wavefront_expand launches for (B, fanout):
// the launch floor its times are read against. Launches nothing else.
int wavefront_expand_floor(int B, int fanout, cudaStream_t stream) {
  if (B <= 0) return 0;
  wavefront_expand_empty<<<grid_for(B, fanout), 32 * kWarps, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
