// Fused gather -> segment-aggregate over the plan's dst-sorted packed layout,
// hand-written for Hopper (sm_90a). Plain C entry points, loaded with ctypes
// by ``repro_torch/kernels/gather_segsum/kernel.py``.
//
// Replaces the three Pallas kernels of repro/kernels/gather_segsum/kernel.py:
//   gss_fwd                  <- gather_segsum_fwd        (_fwd_body)
//   gss_src_walk + gss_bwd_mixed
//                            <- gather_segsum_bwd_mixed  (_bwd_mixed_body)
//   gss_bwd_w                <- gather_segsum_bwd_w      (_bwd_w_body)
// The TPU kernels gather and scatter with one-hot MXU matmuls over VMEM tiles;
// that idiom is not carried over. Here a warp owns a whole output row (16
// bytes a lane, up to two pieces a lane: 256 columns) and walks its slots in
// a fixed order with up to 8 row loads in flight before adding them.
//
// Layout (all P splits in one launch; per split p):
//   mixed     (P, M, F)        f32  mixed-frontier rows
//   pack_src  (P, DB*EB)       i32  source row per packed slot
//   pack_dst  (P, DB*EB)       i32  dst - db*R per slot; >= R marks padding
//   w         (P, DB*EB, H)    f32  optional per-slot per-head weights
//   out       (P, num_out, F)  f32
// A padding slot's pack_src is never read. Inside a pack block the valid
// slots are dst-sorted and the padding comes last (layout.py contract), so
// each output row is one contiguous run of slots.
//
// Bound on this card: bytes. Each valid slot reads one F-wide row (4F bytes)
// for F adds; the least traffic is the indices, each needed row once and the
// output once, far below the 67 TFLOP/s fp32 line. To near it a kernel must
// keep megabytes of row loads in flight; one row load at a time per warp
// pays a full L2 or DRAM latency per slot. Every sum starts at 0 and adds in
// increasing slot order, products rounded by __fmul_rn and sums by
// __fadd_rn (no contraction into an FMA), as the plain versions'
// ``index_add_`` adds on a CPU tensor; the weight adjoint sums each head in
// the tree order its plain version states. The results equal the plain
// versions' bit for bit and repeat bit for bit. No float atomics.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Rows a warp loads before adding them: 8 (one or two 16-byte loads a lane
// each), or 4 for weighted rows wider than 128 columns, whose weights take
// registers too.
template <int NP, bool kWeighted>
__host__ __device__ constexpr int in_flight() { return kWeighted && NP > 1 ? 4 : 8; }
constexpr int kPieceCols = 128;  // columns of one warp-wide 16-byte piece

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

struct __align__(16) Piece {
  float v[4];
};

// One lane's piece of a row: columns [col, col + 4), zero past F. kAligned:
// F % 4 == 0 and the base on 16 bytes, so col < F means the whole piece.
// ``kNc``: rows written earlier by this kernel are read without the
// non-coherent path.
template <bool kAligned, bool kNc = true>
__device__ __forceinline__ Piece load_piece(const float* row, int col, int F) {
  Piece p;
  if (kAligned) {
    if (col < F) {
      *reinterpret_cast<float4*>(&p) =
          kNc ? __ldg(reinterpret_cast<const float4*>(row + col))
              : *reinterpret_cast<const float4*>(row + col);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) p.v[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p.v[e] = col + e < F ? (kNc ? __ldg(row + col + e) : row[col + e]) : 0.f;
    }
  }
  return p;
}

template <bool kAligned>
__device__ __forceinline__ void store_piece(float* row, int col, int F,
                                            const float (&acc)[4]) {
  if (kAligned) {
    if (col < F) {
      *reinterpret_cast<float4*>(row + col) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col + e < F) row[col + e] = acc[e];
    }
  }
}

// The columns and heads of a lane's NP pieces in column chunk c0.
template <int NP>
struct Cols {
  int col[NP];
  int head[NP][4];
  __device__ __forceinline__ Cols(int c0, int lane, int F, int dh) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      col[q] = c0 + q * kPieceCols + lane * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        head[q][e] = col[q] + e < F ? (col[q] + e) / dh : 0;
      }
    }
  }
};

// Writes a lane's pieces of a row.
template <bool kAligned, int NP>
__device__ __forceinline__ void store_row(float* row, const Cols<NP>& c, int F,
                                          float (&acc)[NP][4]) {
#pragma unroll
  for (int q = 0; q < NP; ++q) store_piece<kAligned>(row, c.col[q], F, acc[q]);
}

// Adds the next min(n, in_flight()) entries of the calling warp's run, in
// order, into acc: their rows' pieces (and weights) are loaded first, then
// added. ``row_of(u)`` and ``slot_of(u)`` give the u-th entry's row pointer
// and flat slot; every lane calls them with the same u (they may shuffle).
template <int NP, bool kWeighted, bool kAligned, typename RowOf, typename SlotOf>
__device__ __forceinline__ void add_rows(float (&acc)[NP][4], int n,
                                         const Cols<NP>& c, int F,
                                         const float* __restrict__ w, int H,
                                         bool head_vec, RowOf row_of,
                                         SlotOf slot_of) {
  constexpr int kIn = in_flight<NP, kWeighted>();
  Piece buf[kIn][NP];
  float wv[kIn][NP];
  int slot[kIn];
#pragma unroll
  for (int u = 0; u < kIn; ++u) {
    if (u < n) {
      const float* row = row_of(u);
#pragma unroll
      for (int q = 0; q < NP; ++q) buf[u][q] = load_piece<kAligned>(row, c.col[q], F);
      if (kWeighted) {
        slot[u] = slot_of(u);
        const float* wr = w + (long long)slot[u] * H;
#pragma unroll
        for (int q = 0; q < NP; ++q) wv[u][q] = __ldg(wr + c.head[q][0]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kIn; ++u) {
    if (u < n) {
#pragma unroll
      for (int q = 0; q < NP; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = buf[u][q].v[e];
          if (kWeighted) {
            const float x = head_vec
                ? wv[u][q]
                : __ldg(w + (long long)slot[u] * H + c.head[q][e]);
            v = __fmul_rn(v, x);
          }
          acc[q][e] = __fadd_rn(acc[q][e], v);
        }
      }
    }
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  }
}

// ---- forward ----------------------------------------------------------------
// out[p, db*R + r, :] = sum over the slots s of pack block (p, db) with
// pack_dst[s] == r of (w[s, head] *) mixed[p, pack_src[s], :].
// A block owns kRows destination rows of one pack block and one column chunk
// (grid (P*DB, R/kRows, ceil(F / (NP*128)))). Per tile of kTile slots it
// stages the block's pack_dst and pack_src with cp.async, finds where each
// of its rows' runs starts and ends in shared memory (a run starts where
// pack_dst changes: no binary search, no launch before this one), then warp
// w sums rows w, w + 8, ... . A run that spans tiles carries its partial sum
// in the output row itself (only the owning lane touches it). Streaming a
// warp's consecutive rows as one run, with loads in flight across their
// boundaries, measured slower on the card.
constexpr int kRows = 32;
constexpr int kTile = 2048;

template <int NP, bool kWeighted, bool kAligned>
__global__ void __launch_bounds__(kThreads) gss_fwd_kernel(
    const float* __restrict__ mixed, const int* __restrict__ pack_src,
    const int* __restrict__ pack_dst, const float* __restrict__ w,
    float* __restrict__ out, int M, int F, int DB, int EB, int num_out, int H,
    int dh, int R, bool idx_vec, bool head_vec) {
  __shared__ __align__(16) int s_dst[kTile];
  __shared__ __align__(16) int s_src[kTile];
  __shared__ int s_start[kRows];
  __shared__ int s_end[kRows];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int blk = blockIdx.x;
  const int p = blk / DB;
  const int r_lo = blockIdx.y * kRows;
  const int row0 = (blk % DB) * R + r_lo;
  if (row0 >= num_out) return;  // block-uniform
  const Cols<NP> c(blockIdx.z * NP * kPieceCols, lane, F, dh);
  const long long slot0 = (long long)blk * EB;
  const float* mp = mixed + (long long)p * M * F;
  float* op = out + (long long)p * num_out * F;
  for (int t0 = 0; t0 < EB; t0 += kTile) {
    const int tn = min(kTile, EB - t0);
    if (idx_vec) {
      for (int i = threadIdx.x * 4; i < tn; i += kThreads * 4) {
        cp_async(&s_dst[i], pack_dst + slot0 + t0 + i, 16);
        cp_async(&s_src[i], pack_src + slot0 + t0 + i, 16);
      }
    } else {
      for (int i = threadIdx.x; i < tn; i += kThreads) {
        cp_async(&s_dst[i], pack_dst + slot0 + t0 + i, 4);
        cp_async(&s_src[i], pack_src + slot0 + t0 + i, 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (threadIdx.x < kRows) {
      s_start[threadIdx.x] = 0;
      s_end[threadIdx.x] = 0;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // each run of the block's rows inside the tile: [s_start, s_end)
    for (int i = threadIdx.x; i < tn; i += kThreads) {
      const int d = s_dst[i];
      const int r = d - r_lo;  // padding (>= R) lands past kRows
      if (r >= 0 && r < kRows) {
        if (i == 0 || s_dst[i - 1] != d) s_start[r] = i;
        if (i == tn - 1 || s_dst[i + 1] != d) s_end[r] = i + 1;
      }
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      const int row = row0 + r;
      const int a = s_start[r];
      const int b = s_end[r];
      if (row >= num_out || (t0 > 0 && a == b)) continue;  // warp-uniform
      float acc[NP][4];
      float* orow = op + (long long)row * F;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (t0 > 0) {  // the partial sum of the earlier tiles
          const Piece prev = load_piece<kAligned, false>(orow, c.col[q], F);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] = prev.v[e];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
        }
      }
      for (int j0 = a; j0 < b; j0 += in_flight<NP, kWeighted>()) {
        add_rows<NP, kWeighted, kAligned>(
            acc, b - j0, c, F, w, H, head_vec,
            [&](int u) { return mp + (long long)s_src[j0 + u] * F; },
            [&](int u) { return (int)(slot0 + t0 + j0 + u); });
      }
      store_row<kAligned>(orow, c, F, acc);
    }
    __syncthreads();  // the staged tile is reused
  }
}

// ---- the src-ordered walk ---------------------------------------------------
// (offsets, sorted_grow, sorted_slot) as a stable sort of the valid slots by
// flat source row key = p*M + pack_src gives them: offsets (P*M + 1) are the
// runs of the keys, each run lists its slots in increasing slot index, and
// sorted_grow is the flat row of the cotangent each slot reads; past
// offsets[P*M] the padding slots follow in increasing slot index. Three
// launches:
//   1. count: one integer atomicAdd per valid slot into its key's counter and
//      one per warp into its pack block's valid count; the block that
//      finishes last scans the counters into offsets and the blocks' valid
//      counts into their inclusive prefix.
//   2. place: each valid slot takes a place in its key's run by an atomic
//      cursor (its counter, counted back down to 0), with its cotangent row
//      beside it; each padding slot goes straight to its place in the tail.
//   3. order: the order inside a run is then arbitrary; a warp owns kGroup
//      keys and ranks their runs' slot ids by shuffles (a block deals its
//      runs longer than 32 to its warps in turn), and the block sorts a run
//      longer than kWarpSortMax by setting its slots in a bitmap of the
//      split's slot range (64 Ki slots a window) and reading them back in
//      order.
// Integer counts are exact in any order, so the arrays are the same on every
// run. The counters live in a workspace that is zero between builds: the
// last block of (1) clears what it read, (2) counts the key counters down.
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kBitmapWords = 2048;
constexpr int kGroup = 8;  // keys (source rows) a warp orders
constexpr int kWarpSortMax = 1024;  // longest run a warp orders alone

// Exclusive prefix of v over the block (any multiple of 32 threads, up to
// 1024); *total gets the block's sum. Every thread calls it.
__device__ __forceinline__ int block_prefix(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, t, off);
      if (lane >= off) t += y;
    }
    s_warp[lane] = t;
  }
  __syncthreads();
  const int before = warp > 0 ? s_warp[warp - 1] : 0;
  *total = s_warp[nw - 1];
  __syncthreads();  // s_warp is reused by the next call
  return before + x - v;
}

// Exclusive prefixes of the four components of v over the block (any
// multiple of 32 threads, up to 1024); *total gets the block's sums.
__device__ __forceinline__ int4 block_prefix4(int4 v, int4* s_warp, int4* total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  int4 x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int4 y = make_int4(__shfl_up_sync(kFull, x.x, off), __shfl_up_sync(kFull, x.y, off),
                             __shfl_up_sync(kFull, x.z, off), __shfl_up_sync(kFull, x.w, off));
    if (lane >= off) x = make_int4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int4 t = lane < nw ? s_warp[lane] : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int4 y = make_int4(__shfl_up_sync(kFull, t.x, off), __shfl_up_sync(kFull, t.y, off),
                               __shfl_up_sync(kFull, t.z, off), __shfl_up_sync(kFull, t.w, off));
      if (lane >= off) t = make_int4(t.x + y.x, t.y + y.y, t.z + y.z, t.w + y.w);
    }
    s_warp[lane] = t;
  }
  __syncthreads();
  const int4 before = warp > 0 ? s_warp[warp - 1] : make_int4(0, 0, 0, 0);
  *total = s_warp[nw - 1];
  __syncthreads();  // s_warp is reused by the next call
  return make_int4(before.x + x.x - v.x, before.y + x.y - v.y,
                   before.z + x.z - v.z, before.w + x.w - v.w);
}

// out[i] = in[0] + ... + in[i - 1] for i <= n, by one block of kScanThreads.
// ``in`` was summed by other blocks' atomics: read through L2. A pass takes
// kScanTile entries as kScanItems / 4 groups of 16-byte pieces, a piece a
// thread and a group a warp-wide 512-byte load or store: one SM moves the
// whole array, so every load and store is coalesced, and one barrier scan
// of the groups' four sums serves the whole pass. The next pass's loads are
// in flight while this one is scanned.
__device__ __forceinline__ int4 load4(const int* in, int i, int n, bool vec) {
  if (vec && i + 4 <= n) return __ldcg(reinterpret_cast<const int4*>(in + i));
  return make_int4(i < n ? __ldcg(in + i) : 0, i + 1 < n ? __ldcg(in + i + 1) : 0,
                   i + 2 < n ? __ldcg(in + i + 2) : 0, i + 3 < n ? __ldcg(in + i + 3) : 0);
}

__device__ void block_scan(const int* in, int n, int* out, int4* s_warp) {
  constexpr int kGroups = kScanItems / 4;
  static_assert(kGroups == 4, "one block_prefix4 a pass scans four groups");
  const bool vec = aligned16(in) && aligned16(out);
  int4 next[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) next[k] = load4(in, 4 * (k * kScanThreads + threadIdx.x), n, vec);
  int carry = 0;
  for (int base = 0; base < n; base += kScanTile) {
    int4 v[kGroups];
    int sums[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      v[k] = next[k];
      sums[k] = v[k].x + v[k].y + v[k].z + v[k].w;
      next[k] = load4(in, base + kScanTile + 4 * (k * kScanThreads + threadIdx.x), n, vec);
    }
    int4 total;
    const int4 excl = block_prefix4(make_int4(sums[0], sums[1], sums[2], sums[3]),
                                    s_warp, &total);
    const int group_base[4] = {carry, carry + total.x, carry + total.x + total.y,
                               carry + total.x + total.y + total.z};
    const int group_excl[4] = {excl.x, excl.y, excl.z, excl.w};
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int i = base + 4 * (k * kScanThreads + threadIdx.x);
      int run = group_base[k] + group_excl[k];
      int4 o;
      o.x = run; run += v[k].x;
      o.y = run; run += v[k].y;
      o.z = run; run += v[k].z;
      o.w = run;
      if (vec && i + 4 <= n) {
        *reinterpret_cast<int4*>(out + i) = o;
      } else {
        if (i < n) out[i] = o.x;
        if (i + 1 < n) out[i + 1] = o.y;
        if (i + 2 < n) out[i + 2] = o.z;
        if (i + 3 < n) out[i + 3] = o.w;
      }
    }
    carry += total.x + total.y + total.z + total.w;
  }
  if (threadIdx.x == 0) out[n] = carry;
}

// in[0] + ... + in[i] into out[i] for i < n, by one warp, 32 at a time;
// ``in`` (summed by atomics: read through L2) is zeroed as it is read.
__device__ void warp_scan_inclusive(int* in, int n, int* out) {
  const int lane = threadIdx.x % 32;
  int carry = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    int x = i < n ? __ldcg(in + i) : 0;
    if (i < n) in[i] = 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (i < n) out[i] = carry + x;
    carry += __shfl_sync(kFull, x, 31);
  }
}

// Workspace: the n_keys key counters, then the count kernel's
// finished-block counter, then the n_blk pack blocks' valid counts.
__global__ void __launch_bounds__(kScanThreads) walk_count_kernel(
    const int* __restrict__ pack_src, const int* __restrict__ pack_dst,
    int* ws, int* __restrict__ offsets, int* __restrict__ valid_incl,
    long long S, int per_split, int EB, int M, int R, int n_keys, int n_blk) {
  __shared__ int4 s_warp[32];
  __shared__ bool s_last;
  int* key_count = ws;
  int* done = ws + n_keys;
  int* blk_count = ws + n_keys + 1;
  const int lane = threadIdx.x % 32;
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool valid = false;
  int b = -1;
  if (s < S) {
    valid = pack_dst[s] < R;
    b = (int)(s / EB);
    if (valid) atomicAdd(&key_count[(int)(s / per_split) * M + pack_src[s]], 1);
  }
  const unsigned mine = __match_any_sync(kFull, b) & __ballot_sync(kFull, valid);
  if (valid && lane == __ffs(mine) - 1) atomicAdd(&blk_count[b], __popc(mine));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: every count is in. Warp 0 first scans the pack blocks'
  // counts while the other warps' loads of the key counters are in flight.
  if (threadIdx.x < 32) warp_scan_inclusive(blk_count, n_blk, valid_incl);
  block_scan(key_count, n_keys, offsets, s_warp);
  if (threadIdx.x == 0) *done = 0;
}

__device__ __forceinline__ int grow_of(int s, const int* __restrict__ pack_dst,
                                       int per_split, int EB, int DB, int R,
                                       int num_out) {
  return (s / per_split) * num_out + ((s / EB) % DB) * R + pack_dst[s];
}

__global__ void __launch_bounds__(kThreads) walk_place_kernel(
    const int* __restrict__ pack_src, const int* __restrict__ pack_dst,
    int* ws, const int* __restrict__ offsets,
    const int* __restrict__ valid_incl, int* __restrict__ placed,
    int* __restrict__ placed_grow, int* __restrict__ sorted_grow,
    int* __restrict__ sorted_slot, long long S,
    int per_split, int EB, int DB, int M, int R, int num_out, int n_keys) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  int* key_count = ws;
  const int d = pack_dst[s];
  if (d < R) {
    const int key = (int)(s / per_split) * M + pack_src[s];
    const int at = offsets[key] + atomicSub(&key_count[key], 1) - 1;
    placed[at] = (int)s;
    placed_grow[at] = grow_of((int)s, pack_dst, per_split, EB, DB, R, num_out);
  } else {
    // padding comes last in its pack block: the slots before it that are
    // padding are s less the valid slots of this and the earlier blocks
    const int pos = offsets[n_keys] + (int)s - valid_incl[s / EB];
    sorted_slot[pos] = (int)s;
    sorted_grow[pos] = grow_of((int)s, pack_dst, per_split, EB, DB, R, num_out);
  }
}

// A warp owns kGroup consecutive keys. Its runs of up to 32 slots are
// ranked in windows of 32 consecutive walk entries that hold whole runs:
// lane j takes entry base + j, finds its run among the window's, and counts
// the run's entries with a smaller slot id. A longer run of up to
// kWarpSortMax slots is ranked by the warp the same way, 32 entries against
// the run's every 32 at a time. A longer one still (a large hub) is sorted
// afterwards by the whole block: its slots are set in a bitmap of its
// split's slot range, kBitmapWords words a window, and read back in order.
__global__ void __launch_bounds__(kThreads) walk_order_kernel(
    const int* __restrict__ pack_dst, const int* __restrict__ offsets,
    const int* __restrict__ placed, const int* __restrict__ placed_grow,
    int* __restrict__ sorted_grow, int* __restrict__ sorted_slot, int n_keys,
    int M, int per_split, int EB, int DB, int R, int num_out) {
  __shared__ unsigned bitmap[kBitmapWords];
  __shared__ unsigned s_hubs[kWarps];
  __shared__ unsigned s_long[kWarps];
  __shared__ int s_warp[32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int r0 = (blockIdx.x * kWarps + warp) * kGroup;
  const int cnt = r0 < n_keys ? min(kGroup, n_keys - r0) : 0;
  const int lo = lane < cnt ? offsets[r0 + lane] : 0;
  const int hi = lane < cnt ? offsets[r0 + lane + 1] : 0;
  const int len = hi - lo;
  const unsigned hubs = __ballot_sync(kFull, len > kWarpSortMax);
  if (lane == 0) s_hubs[warp] = hubs;
  for (unsigned todo = __ballot_sync(kFull, len > 0 && len <= 32); todo;) {
    // the window [base, base + 32) and the runs wholly inside it; a longer
    // run after the first ends past it, and so does every run after that
    const int base = __shfl_sync(kFull, lo, __ffs(todo) - 1);
    const unsigned take = todo & __ballot_sync(kFull, hi <= base + 32);
    todo &= ~take;
    const int end = __shfl_sync(kFull, hi, 31 - __clz(take));
    const int k = base + lane;
    const bool mine = k < end;
    const int s = mine ? placed[k] : INT_MAX;
    const int gr = mine ? placed_grow[k] : 0;
    int owner = -1;  // lane index of k's run
    for (unsigned t = take; t; t &= t - 1u) {
      const int i = __ffs(t) - 1;
      const int lo_i = __shfl_sync(kFull, lo, i);  // every lane shuffles
      const int hi_i = __shfl_sync(kFull, hi, i);
      if (k >= lo_i && k < hi_i) owner = i;
    }
    int rank = 0;
    for (int q = 0; q < end - base; ++q) {
      const int sq = __shfl_sync(kFull, s, q);
      const int oq = __shfl_sync(kFull, owner, q);
      rank += oq == owner && sq < s;
    }
    const int first = __shfl_sync(kFull, lo, owner < 0 ? 0 : owner);
    if (mine) {
      sorted_slot[first + rank] = s;
      sorted_grow[first + rank] = gr;
    }
  }
  // the block's runs of 33 to kWarpSortMax slots, dealt round-robin to its
  // warps (they cluster: one warp's keys may hold several)
  const unsigned long_runs = __ballot_sync(kFull, len > 32 && len <= kWarpSortMax);
  if (lane == 0) s_long[warp] = long_runs;
  __syncthreads();
  int n_long = 0;
  for (int k = 0; k < kWarps; ++k) n_long += __popc(s_long[k]);
  for (int h = warp; h < n_long; h += kWarps) {
    int k = 0, skip = h;  // the h-th long run: warp k's bit
    while (skip >= __popc(s_long[k])) skip -= __popc(s_long[k++]);
    unsigned m = s_long[k];
    for (; skip > 0; --skip) m &= m - 1u;
    const int hr = (blockIdx.x * kWarps + k) * kGroup + __ffs(m) - 1;
    const int a = offsets[hr];
    const int b = offsets[hr + 1];
    for (int c0 = a; c0 < b; c0 += 32) {
      const int kk = c0 + lane;
      const bool mine = kk < b;
      const int s = mine ? placed[kk] : INT_MAX;
      const int gr = mine ? placed_grow[kk] : 0;
      int rank = 0;
      for (int d0 = a; d0 < b; d0 += 32) {
        const int t = d0 + lane < b ? placed[d0 + lane] : INT_MAX;
#pragma unroll 8
        for (int q = 0; q < 32; ++q) rank += __shfl_sync(kFull, t, q) < s;
      }
      if (mine) {
        sorted_slot[a + rank] = s;
        sorted_grow[a + rank] = gr;
      }
    }
  }
  constexpr int kWordsPerThread = kBitmapWords / kThreads;
  for (int k = 0; k < kWarps; ++k) {
    for (unsigned hb = s_hubs[k]; hb; hb &= hb - 1u) {  // block-uniform
      const int hr = (blockIdx.x * kWarps + k) * kGroup + __ffs(hb) - 1;
      const int ha = offsets[hr];
      const int hend = offsets[hr + 1];
      const long long lo_slot = (long long)(hr / M) * per_split;
      const long long hi_slot = lo_slot + per_split;
      int pos = ha;
      for (long long w0 = lo_slot; w0 < hi_slot; w0 += 32LL * kBitmapWords) {
        const int words =
            (int)min((long long)kBitmapWords, (hi_slot - w0 + 31) / 32);
        for (int i = threadIdx.x; i < kBitmapWords; i += kThreads) bitmap[i] = 0u;
        __syncthreads();
        for (int j = ha + threadIdx.x; j < hend; j += kThreads) {
          const long long off = placed[j] - w0;
          if (off >= 0 && off < 32LL * words) {
            atomicOr(&bitmap[off / 32], 1u << (off % 32));
          }
        }
        __syncthreads();
        // thread t reads words [t * kWordsPerThread, ...) in order
        unsigned bits[kWordsPerThread];
        int n_set = 0;
#pragma unroll
        for (int i = 0; i < kWordsPerThread; ++i) {
          bits[i] = bitmap[threadIdx.x * kWordsPerThread + i];
          n_set += __popc(bits[i]);
        }
        int total;
        int at = pos + block_prefix(n_set, s_warp, &total);
#pragma unroll
        for (int i = 0; i < kWordsPerThread; ++i) {
          for (unsigned m = bits[i]; m; m &= m - 1u) {
            const int sl = (int)(w0 + 32LL * (threadIdx.x * kWordsPerThread + i) +
                                 __ffs(m) - 1);
            sorted_slot[at] = sl;
            sorted_grow[at] = grow_of(sl, pack_dst, per_split, EB, DB, R, num_out);
            ++at;
          }
        }
        pos += total;
        __syncthreads();  // the bitmap is reused
      }
    }
  }
}

// ---- adjoint w.r.t. mixed -----------------------------------------------------
// dmixed[r, :] = sum_{k in [offsets[r], offsets[r+1])} (w[slot[k], head] *)
//                g[grow[k], :]
// with r = p*M + source row, in the walk's order (increasing slot index). A
// warp owns kAdjRowsPerWarp consecutive rows and one column chunk (grid
// (ceil(rows / (8 * kAdjRowsPerWarp)), ceil(F / (NP*128)))): one load gives
// it their run bounds; for each row it reads up to 32 of the run's indices
// at once and issues in_flight() cotangent-row loads before adding them. A
// row with no slot (most rows of a layer) is written as zeros, with the same
// wide stores. Owning more rows a warp and streaming their slots across row
// boundaries, or splitting a block's slots evenly over its warps, measured
// no faster on the card: the output's write and the gathered rows' L2 reads
// hold it back, not the warps' latency chains.
constexpr int kAdjRowsPerWarp = 2;

template <int NP, bool kWeighted, bool kAligned>
__global__ void __launch_bounds__(kThreads) gss_bwd_mixed_kernel(
    const float* __restrict__ g, const int* __restrict__ offsets,
    const int* __restrict__ sorted_grow, const int* __restrict__ sorted_slot,
    const float* __restrict__ w, float* __restrict__ dmixed, int num_rows,
    int F, int H, int dh, bool head_vec) {
  constexpr int rpw = kAdjRowsPerWarp;
  const int lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x * kWarps + threadIdx.x / 32) * rpw;
  if (r0 >= num_rows) return;  // warp-uniform
  const int cnt = min(rpw, num_rows - r0);
  const Cols<NP> c(blockIdx.y * NP * kPieceCols, lane, F, dh);
  const int lo = lane < cnt ? offsets[r0 + lane] : 0;
  const int hi = lane < cnt ? offsets[r0 + lane + 1] : 0;
  for (int i = 0; i < cnt; ++i) {
    const int a = __shfl_sync(kFull, lo, i);
    const int b = __shfl_sync(kFull, hi, i);
    float acc[NP][4];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    }
    for (int c0 = a; c0 < b; c0 += 32) {
      const int j = c0 + lane;
      int my_g = 0, my_slot = 0;
      if (j < b) {
        my_g = sorted_grow[j];
        if (kWeighted) my_slot = sorted_slot[j];
      }
      const int n = min(32, b - c0);
      for (int j0 = 0; j0 < n; j0 += in_flight<NP, kWeighted>()) {
        add_rows<NP, kWeighted, kAligned>(
            acc, n - j0, c, F, w, H, head_vec,
            [&](int u) {
              return g + (long long)__shfl_sync(kFull, my_g, (j0 + u) % 32) * F;
            },
            [&](int u) { return __shfl_sync(kFull, my_slot, (j0 + u) % 32); });
      }
    }
    store_row<kAligned>(dmixed + (long long)(r0 + i) * F, c, F, acc);
  }
}

// ---- adjoint w.r.t. the per-slot weights -------------------------------------
// dw[slot, h] = sum over head h's dh columns f of
//               mixed[p, pack_src[slot], f] * g[p, db*R + pack_dst[slot], f]
// in the order ref.gather_segsum_bwd_w_packed states: each product rounded
// once; a head's columns cut into units of 4 (of 1 when dh % 4 != 0), each
// unit's products added left to right; the head's n = dh/u unit partials,
// padded with +0.0 to n2, the next power of two, added by a halving tree
// (x[i] + x[i + n2/2], repeated). So dw equals the plain version's on a CPU
// tensor bit for bit, and repeats bit for bit.
// A block owns kRows destination rows of one pack block (grid (P*DB,
// R/kRows)), stages the tile's indices and finds each row's run as gss_fwd
// does, and warp w takes rows w, w + 8, ... . Lane l's unit in a lane group:
//   n2 <= 32 ("narrow"): a head takes a group of n2 lanes, unit i = l % n2;
//     32/n2 heads a slice, NQ slices a pass (NQ units a lane). The warp loads
//     the row's cotangent units of a pass once, then for each kWIn slots of
//     the run issues their source units' loads before using them. The tree
//     is a reduce-scatter over the group (offsets n2/2, ..., 1; a lane sends
//     half of its kWIn*NQ values at each level): at GAT's 64-column heads a
//     group of 8 slots costs 15 shuffles, and each lane ends with one
//     (slot, head) result, so the group's 8 slots x 4 heads are one store.
//   n2 > 32 ("wide"): a head takes the whole warp, lane l its units l + 32k,
//     k < n2/32. The in-lane halving tree over k is added as a pairwise sum
//     over k in bit-reversed order (the same tree, streamed over the column
//     chunks), then the butterfly 16, ..., 1. One slot at a time.
// In the wide path lane 0 writes each head. Slots of rows at or
// past num_out get exact zeros, and so does each tile's padding tail
// (padding comes last in a pack block), in one coalesced fill shared by the
// pack block's row-group blocks.
constexpr int kWIn = 8;         // slots a narrow warp loads before using them
constexpr int kTreeLevels = 20; // in-lane levels of a wide head: n2 <= 2^24

// A lane's unit: 4 columns from ``col`` (kU4) or 1; zeros when ``on`` fails.
template <bool kU4, bool kAligned>
__device__ __forceinline__ Piece load_unit(const float* row, int col, bool on) {
  Piece p;
#pragma unroll
  for (int e = 0; e < 4; ++e) p.v[e] = 0.f;
  if (!on) return p;
  if (kU4 && kAligned) {
    *reinterpret_cast<float4*>(&p) = __ldg(reinterpret_cast<const float4*>(row + col));
  } else {
#pragma unroll
    for (int e = 0; e < (kU4 ? 4 : 1); ++e) p.v[e] = __ldg(row + col + e);
  }
  return p;
}

// The unit's products added left to right (a zero unit gives +0.0).
template <bool kU4>
__device__ __forceinline__ float unit_dot(const Piece& m, const Piece& g) {
  float s = __fmul_rn(m.v[0], g.v[0]);
#pragma unroll
  for (int e = 1; e < (kU4 ? 4 : 1); ++e) s = __fadd_rn(s, __fmul_rn(m.v[e], g.v[e]));
  return s;
}

// Level L of the reduce-scatter over a lane group of n2 lanes (offset
// n2 >> (L + 1)) while L < lg_n2: the lane keeps half of its V >> L values
// and adds its partner's copy of that half. Every index is a constant.
template <int V, int L>
__device__ __forceinline__ void scatter_levels(float (&x)[V], int lane, int n2,
                                               int lg_n2) {
  if constexpr ((V >> L) > 1) {
    if (L < lg_n2) {  // warp-uniform
      constexpr int half = V >> (L + 1);
      const int off = n2 >> (L + 1);
      const bool up = lane & off;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float got = __shfl_xor_sync(kFull, up ? x[i] : x[i + half], off);
        x[i] = __fadd_rn(up ? x[i + half] : x[i], got);
      }
      scatter_levels<V, L + 1>(x, lane, n2, lg_n2);
    }
  }
}

template <int NQ, bool kU4, bool kAligned, bool kWide>
__global__ void __launch_bounds__(kThreads) gss_bwd_w_kernel(
    const float* __restrict__ mixed, const float* __restrict__ g,
    const int* __restrict__ pack_src, const int* __restrict__ pack_dst,
    float* __restrict__ dw, int M, int F, int DB, int EB, int num_out, int H,
    int dh, int R, int lg_n2, bool idx_vec) {
  __shared__ __align__(16) int s_dst[kTile];
  __shared__ __align__(16) int s_src[kTile];
  __shared__ int s_start[kRows];
  __shared__ int s_end[kRows];
  __shared__ int s_pad;  // the tile's first padding slot
  constexpr int u = kU4 ? 4 : 1;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int blk = blockIdx.x;
  const int p = blk / DB;
  const int r_lo = blockIdx.y * kRows;
  const int row0 = (blk % DB) * R + r_lo;
  const long long slot0 = (long long)blk * EB;
  const float* mp = mixed + (long long)p * M * F;
  const int n = dh / u;        // units a head
  const int n2 = 1 << lg_n2;   // padded to a power of two
  for (int t0 = 0; t0 < EB; t0 += kTile) {
    const int tn = min(kTile, EB - t0);
    if (idx_vec) {
      for (int i = threadIdx.x * 4; i < tn; i += kThreads * 4) {
        cp_async(&s_dst[i], pack_dst + slot0 + t0 + i, 16);
        cp_async(&s_src[i], pack_src + slot0 + t0 + i, 16);
      }
    } else {
      for (int i = threadIdx.x; i < tn; i += kThreads) {
        cp_async(&s_dst[i], pack_dst + slot0 + t0 + i, 4);
        cp_async(&s_src[i], pack_src + slot0 + t0 + i, 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (threadIdx.x < kRows) {
      s_start[threadIdx.x] = 0;
      s_end[threadIdx.x] = 0;
    }
    if (threadIdx.x == 0) s_pad = tn;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int i = threadIdx.x; i < tn; i += kThreads) {
      const int d = s_dst[i];
      const int r = d - r_lo;  // padding (>= R) lands past kRows
      if (r >= 0 && r < kRows) {
        if (i == 0 || s_dst[i - 1] != d) s_start[r] = i;
        if (i == tn - 1 || s_dst[i + 1] != d) s_end[r] = i + 1;
      }
      if (d >= R && (i == 0 || s_dst[i - 1] < R)) s_pad = i;  // padding is last
    }
    __syncthreads();
    float* tile_dw = dw + (slot0 + t0) * H;
    {  // the padding tail's exact zeros, one coalesced share a row group
      const long long lo = (long long)s_pad * H;
      const long long part = ((long long)tn * H - lo + gridDim.y - 1) / gridDim.y;
      const long long e1 = min((long long)tn * H, lo + part * (blockIdx.y + 1));
      for (long long e = lo + part * blockIdx.y + threadIdx.x; e < e1; e += kThreads) {
        tile_dw[e] = 0.f;
      }
    }
    for (int r = warp; r < kRows; r += kWarps) {
      const int a = s_start[r];
      const int b = s_end[r];
      if (a == b) continue;  // warp-uniform
      const int row = row0 + r;
      if (row >= num_out) {  // no cotangent row: exact zeros
        for (long long e = (long long)a * H + lane; e < (long long)b * H; e += 32) tile_dw[e] = 0.f;
        continue;
      }
      const float* grow = g + ((long long)p * num_out + row) * F;
      if (kWide) {
        const int lg_k = lg_n2 - 5;  // units a lane holds of a head: 2^lg_k
        for (int j = a; j < b; ++j) {
          const float* mrow = mp + (long long)s_src[j] * F;
          for (int hq = 0; hq < H; ++hq) {
            float st[kTreeLevels];
            float v = 0.f;
            for (int t = 0; t < (1 << lg_k); ++t) {
              const int i = lane + 32 * (int)(__brev((unsigned)t) >> (32 - lg_k));
              const int col = hq * dh + i * u;
              v = unit_dot<kU4>(load_unit<kU4, kAligned>(mrow, col, i < n),
                                load_unit<kU4, kAligned>(grow, col, i < n));
#pragma unroll
              for (int lv = 0; lv < kTreeLevels; ++lv) {  // pairwise, in t order
                if (!((t >> lv) & 1)) {
                  st[lv] = v;
                  break;
                }
                v = __fadd_rn(st[lv], v);
              }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
            }
            if (lane == 0) tile_dw[(long long)j * H + hq] = v;
          }
        }
        continue;
      }
      const int hp = 32 / n2;       // heads a slice
      const int gi = lane % n2;     // the lane's unit in its head
      const int gh = lane / n2;     // the lane's head in a slice
      for (int h0 = 0; h0 < H; h0 += NQ * hp) {
        int col[NQ];
        bool on[NQ];
        Piece gu[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int hq = h0 + q * hp + gh;
          on[q] = hq < H && gi < n;
          col[q] = hq * dh + gi * u;
          gu[q] = load_unit<kU4, kAligned>(grow, col[q], on[q]);
        }
        for (int j0 = a; j0 < b; j0 += kWIn) {
          const int cnt = min(kWIn, b - j0);
          // x[s * NQ + q]: slot s's unit partial in slice q (+0.0 past cnt)
          constexpr int V = kWIn * NQ;
          constexpr int lg_v = V == 16 ? 4 : V == 8 ? 3 : 0;
          static_assert(V == 1 << lg_v, "8 or 16 values a lane");
          float x[V];
          {
            Piece mu[kWIn][NQ];
#pragma unroll
            for (int s = 0; s < kWIn; ++s) {
              const float* mrow = mp + (long long)s_src[j0 + min(s, cnt - 1)] * F;
#pragma unroll
              for (int q = 0; q < NQ; ++q) {
                mu[s][q] = load_unit<kU4, kAligned>(mrow, col[q], on[q] && s < cnt);
              }
            }
#pragma unroll
            for (int s = 0; s < kWIn; ++s) {
#pragma unroll
              for (int q = 0; q < NQ; ++q) x[s * NQ + q] = unit_dot<kU4>(mu[s][q], gu[q]);
            }
          }
          // each head's tree: the reduce-scatter, then plain levels once a
          // lane holds one value (n2 > V)
          scatter_levels<V, 0>(x, lane, n2, lg_n2);
          const int lh = min(lg_n2, lg_v);  // the levels done by halving
          for (int off = n2 >> (lh + 1); off > 0; off >>= 1) {  // one value left
            x[0] = __fadd_rn(x[0], __shfl_xor_sync(kFull, x[0], off));
          }
          // the lane holds values base .. base + left - 1, each held by dup lanes
          const int left = V >> lh;
          const int dup = lg_n2 > lg_v ? n2 >> lg_v : 1;
          if (gi % dup == 0) {
            const int base = gi / dup * left;
#pragma unroll
            for (int i = 0; i < V; ++i) {
              const int e = base + i;
              const int hq = h0 + (e % NQ) * hp + gh;
              if (i < left && e / NQ < cnt && hq < H) {
                tile_dw[(long long)(j0 + e / NQ) * H + hq] = x[i];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the staged tile is reused
  }
}

// Instantiates kernel<NP, kWeighted, kAligned> for the runtime flags and
// launches it with ``args``.
#define GSS_DISPATCH(kernel, grid, np, weighted, aligned, stream, ...)        \
  do {                                                                        \
    if (np == 1) {                                                            \
      if (weighted) {                                                         \
        if (aligned) kernel<1, true, true><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);   \
        else kernel<1, true, false><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);          \
      } else {                                                                \
        if (aligned) kernel<1, false, true><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);  \
        else kernel<1, false, false><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);         \
      }                                                                       \
    } else {                                                                  \
      if (weighted) {                                                         \
        if (aligned) kernel<2, true, true><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);   \
        else kernel<2, true, false><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);          \
      } else {                                                                \
        if (aligned) kernel<2, false, true><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);  \
        else kernel<2, false, false><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);         \
      }                                                                       \
    }                                                                         \
  } while (0)

// pieces a lane owns per column chunk: one up to 128 columns, else two
int pieces(int F) { return F <= kPieceCols ? 1 : 2; }

}  // namespace

extern "C" {

int gss_fwd(const float* mixed, const int* pack_src, const int* pack_dst,
            const float* w, float* out, int P, int M, int F, int DB, int EB,
            int num_out, int H, int dh, int R, cudaStream_t stream) {
  if (P <= 0 || DB <= 0 || EB <= 0 || F <= 0 || num_out <= 0) return 0;
  if (R % kRows != 0) return (int)cudaErrorInvalidValue;
  const int np = pieces(F);
  const dim3 grid(P * DB, R / kRows, (F + np * kPieceCols - 1) / (np * kPieceCols));
  const bool aligned = F % 4 == 0 && aligned16(mixed) && aligned16(out);
  const bool idx_vec = EB % 4 == 0 && aligned16(pack_src) && aligned16(pack_dst);
  const bool head_vec = H == 1 || dh % 4 == 0;
  GSS_DISPATCH(gss_fwd_kernel, grid, np, w != nullptr, aligned, stream, mixed,
               pack_src, pack_dst, w, out, M, F, DB, EB, num_out, H, dh, R,
               idx_vec, head_vec);
  return (int)cudaGetLastError();
}

int gss_src_walk(const int* pack_src, const int* pack_dst, int* ws,
                 int* offsets, int* valid_incl, int* placed, int* placed_grow,
                 int* sorted_grow, int* sorted_slot, int P, int M, int DB,
                 int EB, int num_out, int R, cudaStream_t stream) {
  const long long S = (long long)P * DB * EB;
  const int per_split = DB * EB;
  const int n_keys = P * M;
  const int n_blk = P * DB;
  // at least one block: its last block writes offsets even for no slots
  const unsigned count_blocks =
      S > 0 ? (unsigned)((S + kScanThreads - 1) / kScanThreads) : 1u;
  walk_count_kernel<<<count_blocks, kScanThreads, 0, stream>>>(
      pack_src, pack_dst, ws, offsets, valid_incl, S, per_split, EB, M, R,
      n_keys, n_blk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (S > 0) {
    walk_place_kernel<<<(unsigned)((S + kThreads - 1) / kThreads), kThreads, 0,
                        stream>>>(pack_src, pack_dst, ws, offsets, valid_incl,
                                  placed, placed_grow, sorted_grow,
                                  sorted_slot, S, per_split, EB, DB, M, R,
                                  num_out, n_keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_keys > 0) {
    const int keys_per_block = kWarps * kGroup;
    walk_order_kernel<<<(n_keys + keys_per_block - 1) / keys_per_block,
                        kThreads, 0, stream>>>(
        pack_dst, offsets, placed, placed_grow, sorted_grow, sorted_slot,
        n_keys, M, per_split, EB, DB, R, num_out);
    err = cudaGetLastError();
  }
  return (int)err;
}

int gss_bwd_mixed(const float* g, const int* offsets, const int* sorted_grow,
                  const int* sorted_slot, const float* w, float* dmixed,
                  int num_rows, int F, int H, int dh, cudaStream_t stream) {
  if (num_rows <= 0 || F <= 0) return 0;
  const int np = pieces(F);
  const int rows_per_block = kWarps * kAdjRowsPerWarp;
  const dim3 grid((num_rows + rows_per_block - 1) / rows_per_block,
                  (F + np * kPieceCols - 1) / (np * kPieceCols));
  const bool aligned = F % 4 == 0 && aligned16(g) && aligned16(dmixed);
  const bool head_vec = H == 1 || dh % 4 == 0;
  GSS_DISPATCH(gss_bwd_mixed_kernel, grid, np, w != nullptr, aligned, stream,
               g, offsets, sorted_grow, sorted_slot, w, dmixed, num_rows, F, H,
               dh, head_vec);
  return (int)cudaGetLastError();
}

int gss_bwd_w(const float* mixed, const float* g, const int* pack_src,
              const int* pack_dst, float* dw, int P, int M, int F, int DB,
              int EB, int num_out, int H, int dh, int rows,
              cudaStream_t stream) {
  if (P <= 0 || DB <= 0 || EB <= 0 || H <= 0) return 0;
  if (rows % kRows != 0 || dh <= 0) return (int)cudaErrorInvalidValue;
  const bool u4 = dh % 4 == 0;
  const int n = u4 ? dh / 4 : dh;
  int lg_n2 = 0;
  while ((1 << lg_n2) < n) ++lg_n2;
  if (lg_n2 - 5 >= kTreeLevels) return (int)cudaErrorInvalidValue;
  const bool wide = lg_n2 > 5;
  const int hp = wide ? 1 : 32 >> lg_n2;
  const bool two = !wide && H > hp;  // two slices a pass
  const bool aligned = u4 && aligned16(mixed) && aligned16(g);
  const bool idx_vec = EB % 4 == 0 && aligned16(pack_src) && aligned16(pack_dst);
  const dim3 grid(P * DB, rows / kRows);
#define GSS_BWD_W(nq, u4_, al, wd)                                           \
  gss_bwd_w_kernel<nq, u4_, al, wd><<<grid, kThreads, 0, stream>>>(          \
      mixed, g, pack_src, pack_dst, dw, M, F, DB, EB, num_out, H, dh, rows,  \
      lg_n2, idx_vec)
  if (wide) {
    if (!u4) GSS_BWD_W(1, false, false, true);
    else if (aligned) GSS_BWD_W(1, true, true, true);
    else GSS_BWD_W(1, true, false, true);
  } else if (two) {
    if (!u4) GSS_BWD_W(2, false, false, false);
    else if (aligned) GSS_BWD_W(2, true, true, false);
    else GSS_BWD_W(2, true, false, false);
  } else {
    if (!u4) GSS_BWD_W(1, false, false, false);
    else if (aligned) GSS_BWD_W(1, true, true, false);
    else GSS_BWD_W(1, true, false, false);
  }
#undef GSS_BWD_W
  return (int)cudaGetLastError();
}

}  // extern "C"
