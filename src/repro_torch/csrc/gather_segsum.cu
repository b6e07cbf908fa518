// Fused gather -> segment-aggregate over the plan's dst-sorted packed layout,
// hand-written for Hopper (sm_90a). Plain C entry points, loaded with ctypes
// by ``repro_torch/kernels/gather_segsum/kernel.py``.
//
// Replaces the three Pallas kernels of repro/kernels/gather_segsum/kernel.py:
//   gss_fwd        <- gather_segsum_fwd        (_fwd_body)
//   gss_bwd_mixed  <- gather_segsum_bwd_mixed  (_bwd_mixed_body)
//   gss_bwd_w      <- gather_segsum_bwd_w      (_bwd_w_body)
// The TPU kernels gather and scatter with one-hot MXU matmuls over VMEM tiles;
// that idiom is not carried over. Here every thread owns one feature column
// and walks index lists directly.
//
// Layout (all P splits in one launch; per split p):
//   mixed     (P, M, F)        f32  mixed-frontier rows
//   pack_src  (P, DB*EB)       i32  source row per packed slot
//   pack_dst  (P, DB*EB)       i32  dst - db*R per slot; R marks padding
//   row_off   (P*DB, R+1)      i32  slot run of each row of a block (forward)
//   w         (P, DB*EB, H)    f32  optional per-slot per-head weights
//   out       (P, num_out, F)  f32
// Only ``pack_dst >= R`` marks a padding slot; its pack_src is never read.
// Inside a block the valid slots are dst-sorted and the padding comes last
// (layout.py contract), so each output row is one contiguous run of slots and
// is written exactly once.
//
// Bound on this card: bytes. Each valid slot reads one F-wide row (4F bytes)
// for 2F flops; the least traffic is the indices, each needed row once and the
// output once, far below the 67 TFLOP/s fp32 line. The design keeps every sum
// in a register (no per-edge buffer in device memory, no float atomics, a
// fixed summation order, so results repeat bit for bit) and makes each warp's
// row reads 128-byte coalesced. The forward never visits a padding slot (about
// two thirds of the pack on papers-s); the weight adjoint writes it a zero.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Forward: out[p, db*R + r, f] = sum over slots s of block (p, db) with
// pack_dst[s] == r of w[s, f/dh] * mixed[p, pack_src[s], f].
// The slots of a block are dst-sorted with the padding last, so row r's slots
// are the run [row_off[blk, r], row_off[blk, r+1]) (blk = p*DB + db; the host
// finds the runs with one batched binary search over pack_dst). Each warp owns
// 32 columns of a few output rows and walks their runs in packed order.
// Grid (ceil(P*DB*R / (4 * kRowsPerWarp)), ceil(F/32)); block (32, 4).
constexpr int kRowsPerWarp = 4;

template <bool kWeighted>
__global__ void __launch_bounds__(128) gss_fwd_kernel(
    const float* __restrict__ mixed, const int* __restrict__ pack_src,
    const int* __restrict__ row_off, const float* __restrict__ w,
    float* __restrict__ out, int M, int F, int DB, int EB, int num_out,
    int H, int dh, int rows, long long block_rows) {
  const int lane = threadIdx.x;
  const int f = blockIdx.y * 32 + lane;
  const bool col = f < F;
  const int head = (kWeighted && col) ? f / dh : 0;
  const long long g0 =
      ((long long)blockIdx.x * blockDim.y + threadIdx.y) * kRowsPerWarp;
  const long long g1 = min(g0 + kRowsPerWarp, block_rows);
  for (long long gr = g0; gr < g1; ++gr) {
    const long long blk = gr / rows;  // p * DB + db
    const int r = (int)(gr % rows);
    const int p = (int)(blk / DB);
    const int row = (int)(blk % DB) * rows + r;
    if (row >= num_out) continue;  // past the last destination (warp-uniform)
    const int a = row_off[blk * (rows + 1) + r];
    const int b = row_off[blk * (rows + 1) + r + 1];
    const long long slot0 = blk * EB;
    const float* mp = mixed + (long long)p * M * F;
    float acc = 0.f;
    for (int c = a; c < b; c += 32) {
      // each lane fetches one slot's source row; the warp walks them in order
      const int j = c + lane;
      const int my_src = j < b ? pack_src[slot0 + j] : 0;
      const int n = min(32, b - c);
      for (int k = 0; k < n; ++k) {
        const int s = __shfl_sync(kFull, my_src, k);
        if (col) {
          float v = mp[(long long)s * F + f];
          if (kWeighted) v *= w[(slot0 + c + k) * H + head];
          acc += v;
        }
      }
    }
    if (col) out[((long long)p * num_out + row) * F + f] = acc;
  }
}

// Adjoint w.r.t. mixed, as a src-sorted segmented sum:
// dmixed[r, f] = sum_{k in [offsets[r], offsets[r+1])} w[slot[k], f/dh] *
//                g[grow[k], f]
// with r = p*M + source row, ``grow`` the flat row of g each slot read from and
// ``slot`` its flat slot index. The host builds (offsets, grow, slot) with a
// stable sort, so the order of every sum is fixed.
// Grid (ceil(num_rows / (4 * kRowsPerWarp)), ceil(F/32)); block (32, 4).

template <bool kWeighted>
__global__ void __launch_bounds__(128) gss_bwd_mixed_kernel(
    const float* __restrict__ g, const int* __restrict__ offsets,
    const int* __restrict__ sorted_grow, const int* __restrict__ sorted_slot,
    const float* __restrict__ w, float* __restrict__ dmixed, int num_rows,
    int F, int H, int dh) {
  const int lane = threadIdx.x;
  const int f = blockIdx.y * 32 + lane;
  const bool col = f < F;
  const int head = (kWeighted && col) ? f / dh : 0;
  const int r0 = (blockIdx.x * blockDim.y + threadIdx.y) * kRowsPerWarp;
  const int r1 = min(r0 + kRowsPerWarp, num_rows);
  for (int r = r0; r < r1; ++r) {
    const int a = offsets[r];
    const int b = offsets[r + 1];
    float acc = 0.f;
    for (int c = a; c < b; c += 32) {
      const int j = c + lane;
      int my_g = 0, my_slot = 0;
      if (j < b) {
        my_g = sorted_grow[j];
        if (kWeighted) my_slot = sorted_slot[j];
      }
      const int n = min(32, b - c);
      for (int k = 0; k < n; ++k) {
        const int gr = __shfl_sync(kFull, my_g, k);
        const int sl = kWeighted ? __shfl_sync(kFull, my_slot, k) : 0;
        if (col) {
          float v = g[(long long)gr * F + f];
          if (kWeighted) v *= w[(long long)sl * H + head];
          acc += v;
        }
      }
    }
    if (col) dmixed[(long long)r * F + f] = acc;
  }
}

// Adjoint w.r.t. the per-slot weights:
// dw[slot, h] = sum_{f in head h} mixed[p, pack_src, f] * g[p, db*R + pack_dst, f]
// One warp per slot, lanes strided over the head's columns, then a fixed
// shuffle tree. Padding slots get exact zeros.
// Grid ceil(P*DB*EB / 8); block (32, 8).
__global__ void __launch_bounds__(256) gss_bwd_w_kernel(
    const float* __restrict__ mixed, const float* __restrict__ g,
    const int* __restrict__ pack_src, const int* __restrict__ pack_dst,
    float* __restrict__ dw, int P, int M, int F, int DB, int EB, int num_out,
    int H, int dh, int rows) {
  const int lane = threadIdx.x;
  const long long slot = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const long long per_split = (long long)DB * EB;
  if (slot >= P * per_split) return;  // warp-uniform
  const int p = (int)(slot / per_split);
  const int db = (int)((slot % per_split) / EB);
  const int row0 = db * rows;
  const int row_end = min(rows, num_out - row0);
  const int d = pack_dst[slot];
  float* out = dw + slot * H;
  if (d < 0 || d >= row_end) {
    for (int h = lane; h < H; h += 32) out[h] = 0.f;
    return;
  }
  const float* mrow = mixed + ((long long)p * M + pack_src[slot]) * F;
  const float* grow = g + ((long long)p * num_out + row0 + d) * F;
  for (int h = 0; h < H; ++h) {
    float acc = 0.f;
    for (int f = h * dh + lane; f < (h + 1) * dh; f += 32)
      acc += mrow[f] * grow[f];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(kFull, acc, off);
    if (lane == 0) out[h] = acc;
  }
}

}  // namespace

extern "C" {

int gss_fwd(const float* mixed, const int* pack_src, const int* row_off,
            const float* w, float* out, int P, int M, int F, int DB, int EB,
            int num_out, int H, int dh, int rows, cudaStream_t stream) {
  const dim3 block(32, 4);
  const long long block_rows = (long long)P * DB * rows;
  const long long rows_per_block = 4 * kRowsPerWarp;
  const dim3 grid((unsigned)((block_rows + rows_per_block - 1) / rows_per_block),
                  (F + 31) / 32);
  if (w != nullptr) {
    gss_fwd_kernel<true><<<grid, block, 0, stream>>>(
        mixed, pack_src, row_off, w, out, M, F, DB, EB, num_out, H, dh, rows,
        block_rows);
  } else {
    gss_fwd_kernel<false><<<grid, block, 0, stream>>>(
        mixed, pack_src, row_off, w, out, M, F, DB, EB, num_out, H, dh, rows,
        block_rows);
  }
  return (int)cudaGetLastError();
}

int gss_bwd_mixed(const float* g, const int* offsets, const int* sorted_grow,
                  const int* sorted_slot, const float* w, float* dmixed,
                  int num_rows, int F, int H, int dh, cudaStream_t stream) {
  const dim3 block(32, 4);
  const int rows_per_block = 4 * kRowsPerWarp;
  const dim3 grid((num_rows + rows_per_block - 1) / rows_per_block, (F + 31) / 32);
  if (w != nullptr) {
    gss_bwd_mixed_kernel<true><<<grid, block, 0, stream>>>(
        g, offsets, sorted_grow, sorted_slot, w, dmixed, num_rows, F, H, dh);
  } else {
    gss_bwd_mixed_kernel<false><<<grid, block, 0, stream>>>(
        g, offsets, sorted_grow, sorted_slot, w, dmixed, num_rows, F, H, dh);
  }
  return (int)cudaGetLastError();
}

int gss_bwd_w(const float* mixed, const float* g, const int* pack_src,
              const int* pack_dst, float* dw, int P, int M, int F, int DB,
              int EB, int num_out, int H, int dh, int rows,
              cudaStream_t stream) {
  const dim3 block(32, 8);
  const long long slots = (long long)P * DB * EB;
  const unsigned grid = (unsigned)((slots + 7) / 8);
  gss_bwd_w_kernel<<<grid, block, 0, stream>>>(
      mixed, g, pack_src, pack_dst, dw, P, M, F, DB, EB, num_out, H, dh, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
