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
//      memory: warp w takes a contiguous run of 32-slot groups (skipping
//      groups with no slot of the block's rows), counts each row's slots by
//      __match_any_sync; one warp scans the (row, warp) counts into offsets;
//      each warp then places its slots at offset + rank among equal rows.
//      Integer arithmetic only, no atomics: the list keeps packed order
//      within each row.
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

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;     // dst rows a block sums (one per lane in the scan)
constexpr int kTile = 2048;   // local_dst entries staged at a time
constexpr int kInFlight = 8;  // row loads a warp issues before adding them

// elements of T in one lane's 16-byte piece
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
struct __align__(16) Piece {
  T v[kVec<T>];
};

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

// The slot key of lane's entry i of the staged tile: its row within the
// block's 32 rows, or -1 (padding, another row group, or past the tile).
__device__ __forceinline__ int slot_key(const int* idx, int i, int tn,
                                        int r_lo) {
  const int d = i < tn ? idx[i] - r_lo : -1;
  return d >= 0 && d < kRows ? d : -1;
}

// dynamic shared memory: staged entries | row-sorted slots | per-(warp, row)
// counts, then offsets | row offsets | row counts | f32 row sums (kRows, CW)
struct Sort {
  int idx[kTile];
  int sorted[kTile];
  int cnt[kWarps][kRows];
  int row_off[kRows];
  int row_cnt[kRows];
};

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads) segsum_packed_kernel(
    const T* __restrict__ contrib, const int* __restrict__ local_dst,
    T* __restrict__ out, int EB, int F, int R, bool idx_vec) {
  constexpr int VEC = kVec<T>;
  constexpr int CW = 32 * VEC;  // columns a block covers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sort& sm = *reinterpret_cast<Sort*>(smem_raw);
  float* carry = reinterpret_cast<float*>(smem_raw + sizeof(Sort));
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
    // 1. stage the tile's entries
    if (idx_vec) {  // 16-byte copies: EB % 4 == 0 and local_dst aligned
      for (int i = threadIdx.x * 4; i < tn; i += kThreads * 4) {
        cp_async(&sm.idx[i], local_dst + block0 + t0 + i, 16);
      }
    } else {
      for (int i = threadIdx.x; i < tn; i += kThreads) {
        cp_async(&sm.idx[i], local_dst + block0 + t0 + i, 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    sm.cnt[warp][lane] = 0;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // 2. stable counting sort of the block's rows' slots
    const int groups = (tn + 31) / 32;
    const int per_warp = (groups + kWarps - 1) / kWarps;
    const int g0 = warp * per_warp;
    const int g1 = min(groups, g0 + per_warp);
    for (int g = g0; g < g1; ++g) {
      const int key = slot_key(sm.idx, g * 32 + lane, tn, r_lo);
      if (!__ballot_sync(packed::kFull, key >= 0)) continue;
      const unsigned peers = __match_any_sync(packed::kFull, key);
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
        const int up = __shfl_up_sync(packed::kFull, incl, off);
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
      if (!__ballot_sync(packed::kFull, key >= 0)) continue;
      const unsigned peers = __match_any_sync(packed::kFull, key);
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
  return sizeof(Sort) + sizeof(float) * kRows * 32 * kVec<T>;
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
