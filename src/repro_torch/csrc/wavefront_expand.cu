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
// ops each plus the dedup compares. It is right, not fast: at papers-s it
// runs in tens of microseconds. One warp expands one row with a lane per
// slot (each lane recomputes the row's two key rounds), and the dedup is one
// __match_any_sync per 32-slot chunk: lane j's offset is a duplicate when a
// lane below it holds the same value. Fanouts above 32 loop over chunks: a
// first pass stores each slot's raw offset in the output row, and a second
// pass, from the last chunk to the first, compares each chunk against the raw
// offsets of the chunks before it (not yet overwritten, since the pass runs
// backwards) and then writes its final codes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kInvalid = -2;
constexpr int kSelfLoop = -1;
constexpr int kWarps = 4;

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
  const uint32_t u = mix32(h2 + (uint32_t)j * 0x9E3779B9u);
  const bool take_all = d <= fanout;
  const uint32_t degc = (uint32_t)(d > 1 ? d : 1);
  int off = take_all ? j : (int)(u % degc);
  *valid = d < 0 ? false : (d == 0 ? j == 0 : (take_all ? j < d : true));
  if (d == 0 && j == 0) off = kSelfLoop;
  return off;
}

// One warp per row, rows in a grid-stride loop. Grid (ceil(B/4)), block (32, 4).
__global__ void __launch_bounds__(32 * kWarps) wavefront_expand_kernel(
    const int* __restrict__ vid, const int* __restrict__ deg,
    const long long* __restrict__ key, int* __restrict__ out, int B,
    int fanout) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t klo = (uint32_t)key[0];
  const uint32_t khi = (uint32_t)key[1];
  const long long stride = (long long)gridDim.x * blockDim.y;
  for (long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y; b < B;
       b += stride) {
    const int d = deg[b];
    const uint32_t h2 = mix32(mix32((uint32_t)vid[b] ^ klo) ^ khi);
    int* row = out + b * fanout;
    if (fanout <= 32) {
      const bool active = lane < fanout;
      bool valid = false;
      const int off = active ? raw_offset(h2, d, fanout, lane, &valid) : 0;
      // inactive lanes hold values no offset takes (offsets are >= -1)
      const unsigned same = __match_any_sync(kFull, active ? off : -3 - lane);
      const bool dup = (same & below) != 0u;
      if (active) row[lane] = (valid && !dup) ? off : kInvalid;
      continue;
    }
    // fanout > 32: raw offsets first, then backwards chunk by chunk
    for (int base = 0; base < fanout; base += 32) {
      const int j = base + lane;
      bool unused;
      if (j < fanout) row[j] = raw_offset(h2, d, fanout, j, &unused);
    }
    __syncwarp();
    const int last = ((fanout - 1) / 32) * 32;
    for (int base = last; base >= 0; base -= 32) {
      const int j = base + lane;
      const bool active = j < fanout;
      bool valid = false;
      const int off = active ? raw_offset(h2, d, fanout, j, &valid) : 0;
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

}  // namespace

extern "C" {

int wavefront_expand(const int* vid, const int* deg, const long long* key,
                     int* out, int B, int fanout, cudaStream_t stream) {
  if (B <= 0) return 0;
  const dim3 block(32, kWarps);
  const long long want = ((long long)B + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(want < 65535LL * 32 ? want : 65535LL * 32);
  wavefront_expand_kernel<<<grid, block, 0, stream>>>(vid, deg, key, out, B,
                                                       fanout);
  return (int)cudaGetLastError();
}

}  // extern "C"
