// Masked per-destination sum over dst-row-blocked packs, hand-written for
// Hopper (sm_90a). Plain C entry point, loaded with ctypes by
// ``repro_torch/kernels/segsum/ops.py``.
//
// Replaces the Pallas kernel repro/kernels/segsum/kernel.py::segment_sum_packed
// (body ``_segsum_body``), which builds an (EB, R) one-hot of each block's
// local_dst and contracts it with the block's messages on the MXU. That idiom
// is not carried over.
//
// Bound on this card: bytes. Each valid slot reads one F-wide row for F adds;
// the least traffic is the valid rows, the indices and the output once, far
// below the fp32 rate. Padding slots are never read. To reach the bytes
// bound a kernel must keep about 3 MB of row loads in flight across the card
// (3.35 TB/s at about 1 us of latency).
//
// Design: a block takes one dst-row block, one group of 32 of its rows and
// one 16-byte-per-lane column piece (grid (DB, R/32, ceil(F/(32*VEC)))), so
// the R rows of a pack block are spread over R/32 blocks of 8 warps.
//   1. The block copies up to 2048 of the pack block's local_dst entries into
//      shared memory with cp.async (each of its row groups reads them; the
//      later reads hit L2).
//   2. It sorts the valid slots of its 32 rows by row, stably, in shared
//      memory (``packed::stage_and_sort``, shared with the packed edge
//      softmax; integer arithmetic only, no atomics): the list keeps packed
//      order within each row.
//   3. Warp w owns rows w, w + 8, ... . For each row it issues the loads of
//      up to 8 of the row's slots (one 16-byte piece a lane: at F = 128 f32
//      one warp instruction reads a whole 512-byte row) before adding them,
//      in list order, into f32 registers. The loads overlap; the adds stay
//      in packed order.
//   4. A row's f32 sum carries over to the next 2048 slots in shared memory
//      (only the owning warp touches it), and each output row is written
//      once, coalesced, in the input's type.
// Each output element is summed from 0 in packed slot order, as the plain
// version's index_add_ on a CPU tensor sums it: the f32 result equals it bit
// for bit and repeats bit for bit. No float atomics.
//
// Layout: contrib (DB*EB, F) f32/bf16/f16; local_dst (DB*EB) i32 in [0, R],
// R marking padding; out (DB*R, F) in contrib's type, accumulated in f32.
// Any F (a ragged F, or rows not 16-byte aligned, take masked element
// loads); any EB; R a multiple of 32, at most 128 (the wrapper checks).
#include <cstdint>

#include "packed_common.cuh"

namespace {

using packed::kRows;
using packed::kThreads;
using packed::kTile;
using packed::kWarps;
constexpr int kInFlight = 8;  // row loads a warp issues before adding them

// elements of T in one lane's 16-byte piece
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
struct __align__(16) Piece {
  T v[kVec<T>];
};

// One lane's piece of a row: columns [col, col + VEC), masked past F.
template <typename T, bool kAligned>
__device__ __forceinline__ Piece<T> load_piece(const T* __restrict__ row,
                                               int col, int F) {
  Piece<T> p;
  if (kAligned) {
    *reinterpret_cast<uint4*>(&p) =
        __ldg(reinterpret_cast<const uint4*>(row + col));
  } else {
#pragma unroll
    for (int e = 0; e < kVec<T>; ++e) {
      p.v[e] = col + e < F ? row[col + e] : packed::from_f<T>(0.f);
    }
  }
  return p;
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads) segsum_packed_kernel(
    const T* __restrict__ contrib, const int* __restrict__ local_dst,
    T* __restrict__ out, int EB, int F, int R, bool idx_vec) {
  constexpr int VEC = kVec<T>;
  constexpr int CW = 32 * VEC;  // columns a block covers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  packed::Sort& sm = *reinterpret_cast<packed::Sort*>(smem_raw);
  float* carry = reinterpret_cast<float*>(smem_raw + sizeof(packed::Sort));
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int db = blockIdx.x;
  const int r_lo = blockIdx.y * kRows;
  const int col = blockIdx.z * CW + lane * VEC;
  const bool active = col < F;
  float* my_carry = carry + lane * VEC;  // + row * CW
  for (int r = warp; r < kRows; r += kWarps) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) my_carry[r * CW + e] = 0.f;
  }
  const long long block0 = (long long)db * EB;

  for (int t0 = 0; t0 < EB; t0 += kTile) {
    const int tn = min(kTile, EB - t0);
    // 1-2. stage the tile's entries and sort the block's rows' slots
    packed::stage_and_sort(sm, local_dst + block0 + t0, tn, r_lo, idx_vec);

    // 3. each warp sums its rows, kInFlight loads in flight
    if (active) {
      const T* tile_rows = contrib + (block0 + t0) * F;
      for (int r = warp; r < kRows; r += kWarps) {
        const int n = sm.row_cnt[r];
        if (n == 0) continue;
        const int* list = sm.sorted + sm.row_off[r];
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = my_carry[r * CW + e];
        for (int j0 = 0; j0 < n; j0 += kInFlight) {
          Piece<T> buf[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            if (j0 + u < n) {
              buf[u] = load_piece<T, kAligned>(
                  tile_rows + (long long)list[j0 + u] * F, col, F);
            }
          }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            if (j0 + u < n) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[e] += packed::to_f(buf[u].v[e]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) my_carry[r * CW + e] = acc[e];
      }
    }
    __syncthreads();  // the staged tile and the sort are reused
  }

  // 4. write the block's rows once, in T
  if (!active) return;
  for (int r = warp; r < kRows; r += kWarps) {
    T* dst = out + ((long long)db * R + r_lo + r) * F + col;
    Piece<T> p;
#pragma unroll
    for (int e = 0; e < VEC; ++e) p.v[e] = packed::from_f<T>(my_carry[r * CW + e]);
    if (kAligned) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&p);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (col + e < F) dst[e] = p.v[e];
      }
    }
  }
}

template <typename T>
size_t smem_bytes() {
  return sizeof(packed::Sort) + sizeof(float) * kRows * 32 * kVec<T>;
}

template <typename T, bool kAligned>
int launch_as(const void* contrib, const int* local_dst, void* out, int DB,
              int EB, int F, int R, cudaStream_t stream) {
  static bool attr_set = false;  // above 48 KB of shared memory: opt in once
  const size_t smem = smem_bytes<T>();
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        segsum_packed_kernel<T, kAligned>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const bool idx_vec =
      EB % 4 == 0 && reinterpret_cast<uintptr_t>(local_dst) % 16 == 0;
  const dim3 grid(DB, R / kRows, (F + 32 * kVec<T> - 1) / (32 * kVec<T>));
  segsum_packed_kernel<T, kAligned><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(contrib), local_dst, static_cast<T*>(out), EB, F,
      R, idx_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* contrib, const int* local_dst, void* out, int DB,
           int EB, int F, int R, cudaStream_t stream) {
  // 16-byte pieces need every row, and both bases, on 16-byte boundaries
  const bool aligned = F % kVec<T> == 0 &&
                       reinterpret_cast<uintptr_t>(contrib) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return aligned ? launch_as<T, true>(contrib, local_dst, out, DB, EB, F, R,
                                      stream)
                 : launch_as<T, false>(contrib, local_dst, out, DB, EB, F, R,
                                       stream);
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 f16
int segsum_packed(const void* contrib, const int* local_dst, void* out, int DB,
                  int EB, int F, int R, int dtype, cudaStream_t stream) {
  if (DB <= 0 || F <= 0 || EB <= 0) return 0;
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
