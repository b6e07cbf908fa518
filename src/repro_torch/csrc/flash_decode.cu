// Single-token GQA decode attention over a masked KV cache, hand-written for
// Hopper (sm_90a). Plain C entry point, loaded with ctypes by
// ``repro_torch/kernels/flash_decode/kernel.py``.
//
// Replaces the Pallas kernel
// repro/kernels/flash_decode/kernel.py::decode_attention_pallas_bkv (body
// ``_decode_body``). That kernel walks the cache's sequence axis as a
// sequential grid dimension, carrying the online-softmax state in revisited
// output blocks, needs S % 512 == 0, and its wrapper transposes the whole
// cache into (B*KV, S, D) on every call. None of that is carried over.
//
// Bound on this card: bytes. The K/V rows up to cache_len are read once
// (4*D bytes per row and KV head in bf16) for 4*G*D flops: G flops a byte,
// 48 at Granite's MQA group, far below the 295 flops a byte where the bf16
// tensor cores meet 3.35 TB/s. To reach the bound a kernel must keep enough
// loads in flight on every SM and keep the arithmetic off the critical path
// (on CUDA cores a large group is a dependent FMA chain per score). Where
// the whole cache is a few MB (the serve shape; Granite's single KV head),
// the bytes take microseconds and the fixed costs remain: one DRAM round
// trip per ring stage, two launches, and the merge of the chunks.
//
// Design (split-K flash-decoding):
//   * A block takes one (b, kv) pair, one chunk of cache rows and, on the
//     tensor-core path, one 16-head tile of the G = H/KV query heads of the
//     group (the CUDA-core path serves the whole group), so each K/V row is
//     read from device memory once for the group; the tiles of one chunk run
//     side by side and share its rows in L2. The wrapper picks the chunk
//     from (B, KV, S, G) so that the grid makes at least two waves on 132
//     SMs (``kernel.py::decode_chunk``).
//   * bf16 (the serve dtype), head dims up to 256: K and V tiles of 64 rows
//     stay bf16 in a three-stage ring in shared memory, filled by 16-byte
//     cp.async copies, so the loads of the next two tiles overlap the work
//     on the current one. Rows at or past cache_len (a device int32) and the
//     head dim's padding are zero-filled, never read. Scores (q.k^T) and p.V
//     run on the tensor cores, mma.sync.m16n8k16 bf16 with f32 sums: the
//     head tile is the M side, the cache rows N. Warp w takes the 16-row
//     step w of every tile with an online softmax (running max and sum) and
//     an output of its own in registers, so no warp waits on another between
//     tiles and no work is done twice; the four warps' states are merged in
//     warp order at the end of the chunk. p enters the p.V product as the
//     mma's bf16 operand: the Pallas kernel's ``p.astype(v.dtype)``.
//   * f32, and bf16 head dims above 256: a CUDA-core path with the same
//     online softmax over 32-row tiles staged as f32.
//   * Each block writes its chunk's partial (max, sum, unnormalised output)
//     to a workspace; a second kernel folds the chunks of each (b, head) in
//     chunk order, with a running max, and divides. No atomics: every sum
//     has a fixed order, so results repeat bit for bit.
//   * ``flash_decode_partial`` is the same two kernels with the merge's
//     output kept in f32 and its running max and denominator written beside
//     it: the Pallas kernel's three outputs (o, m, d). A sequence-sharded
//     decode runs it on each rank's rows and merges the ranks' partials
//     (``flash_decode/ref.py::merge_partials``). On a shard with no valid
//     row every chunk is empty, so m = -1e30, d = 0 and o = 0 (the Pallas
//     kernel's d counts the masked rows there, exp(0) each); either weighs
//     nothing in the merge against a shard that has a row.
//   * The Pallas kernel's clamps are kept: masked scores -1e30, the
//     denominator floored at 1e-30; the sums stay f32, and the output is cast
//     to q's dtype. A chunk wholly past cache_len writes an empty partial
//     (max -1e30, sum 0), so cache_len below 1 gives zeros.
//
// Layout: q (B, H, D) contiguous with head h = kv*G + g; k (B, S, KV, D) and
// v (B, S, KV, Dv) with unit stride in the last dim and KV*D (KV*Dv) between
// a row's heads' ends, batch and row strides as given (multiples of 8
// elements, bases 16-byte aligned); out (B, H, Dv) in q's dtype. D and Dv
// multiples of 8; f32 or bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskValue = -1e30f;
constexpr float kDenomFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: the Pallas kernel's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The chunk's partial of an empty chunk (every row at or past cache_len).
__device__ void write_empty(float* o_ws, float* ml_ws, int G, int Dv) {
  for (int i = threadIdx.x; i < G * Dv; i += blockDim.x) o_ws[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    ml_ws[2 * g] = kMaskValue;
    ml_ws[2 * g + 1] = 0.f;
  }
}

// =================== tensor-core path (bf16) ===============================
// DP: the head dim padded to 64, 128 or 256. blockIdx.x = chunk * head tiles
// + tile, so the tiles that read the same rows run side by side.
constexpr int kRowsPerTile = 64;
constexpr int kStages = 3;

template <int DP>
struct MmaShape {
  static constexpr int kLd = DP + 8;  // smem row: ldmatrix reads no bank twice
  static constexpr int kNtv = DP / 8;  // n8 tiles of p.V a warp
  static constexpr int kTileElems = kRowsPerTile * kLd;
};

template <int DP>
constexpr size_t mma_smem_bytes() {
  using Sh = MmaShape<DP>;
  return sizeof(__nv_bfloat16) *
         ((size_t)16 * Sh::kLd + (size_t)kStages * 2 * Sh::kTileElems);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + valid) of one (b, kv) head's K and V into a ring stage
// (zeros past ``valid`` rows and past D / Dv columns).
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                          const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb,
                                          long long k_ss, long long v_ss,
                                          int row0, int valid, int D, int Dv) {
  constexpr int kPieces = DP / 8;
  constexpr int kLd = DP + 8;
  for (int i = threadIdx.x; i < kRowsPerTile * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int c = (i - r * kPieces) * 8;
    const bool row_ok = r < valid;
    const bool k_ok = row_ok && c < D;
    const bool v_ok = row_ok && c < Dv;
    cp_async_16(ks + r * kLd + c,
                k_ok ? kb + (long long)(row0 + r) * k_ss + c : kb, k_ok);
    cp_async_16(vs + r * kLd + c,
                v_ok ? vb + (long long)(row0 + r) * v_ss + c : vb, v_ok);
  }
}

// One warp's online-softmax state: per thread, heads grp (h = 0) and
// grp + 8 (h = 1) of its 16-head tile; output columns nt*8 + 2*tig (+1).
template <int NTV>
struct State {
  float m[2];
  float l[2];  // this thread's part of the sum (its columns' rows)
  float o[NTV][4];
};

// One 16-row step for the calling warp: rows ``row`` .. + 15 of the staged
// tile (``r_chunk`` .. + 15 of the chunk, masked from ``n``) against the 16
// queries at ``qt``: scores on the tensor cores, scaled and masked, the
// online-softmax update, and p.V over the whole (padded) head dim.
template <int DP>
__device__ __forceinline__ void mma_step(const __nv_bfloat16* qt,
                                         const __nv_bfloat16* ks,
                                         const __nv_bfloat16* vs, int row,
                                         int r_chunk, int n, float scale,
                                         State<DP / 8>& st) {
  constexpr int kLd = DP + 8;
  constexpr int NTV = DP / 8;
  const int lane = threadIdx.x % 32;
  const int tig = lane % 4;
  // s[j]: the 8 rows row + 8j .. + 7
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t kf[4];  // b of rows 0-7 (kf[0], kf[1]) and 8-15 (kf[2], kf[3])
    ldmatrix_x4(kf, ks + (row + (lane % 8) + (lane / 16) * 8) * kLd + kk * 16 +
                        ((lane / 8) % 2) * 8);
    uint32_t qf[4];
    ldmatrix_x4(qf, qt + ((lane % 8) + ((lane / 8) % 2) * 8) * kLd + kk * 16 +
                        (lane / 16) * 8);
    mma_bf16(s[0], qf, kf[0], kf[1]);
    mma_bf16(s[1], qf, kf[2], kf[3]);
  }
  // scale, mask, online softmax; p as the bf16 A operand of p.V
  const int r_base = r_chunk + 2 * tig;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kMaskValue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[j][2 * h + e] * scale;
        s[j][2 * h + e] = r_base + 8 * j + e < n ? x : kMaskValue;
        mx = fmaxf(mx, s[j][2 * h + e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(st.m[h], mx);
    const float corr = expf(st.m[h] - m_new);
    st.m[h] = m_new;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(s[j][2 * h + e] - m_new);
        s[j][2 * h + e] = p;
        psum += p;
      }
    }
    st.l[h] = st.l[h] * corr + psum;
#pragma unroll
    for (int nt = 0; nt < NTV; ++nt) {
      st.o[nt][2 * h] *= corr;
      st.o[nt][2 * h + 1] *= corr;
    }
  }
  const uint32_t pf[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                          pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
  for (int np = 0; np < NTV / 2; ++np) {
    uint32_t vf[4];  // b of columns +0..7 (vf[0], vf[1]), +8..15 (vf[2], vf[3])
    ldmatrix_x4_trans(vf, vs + (row + (lane % 8) + ((lane / 8) % 2) * 8) * kLd +
                              np * 16 + (lane / 16) * 8);
    mma_bf16(st.o[2 * np], pf, vf[0], vf[1]);
    mma_bf16(st.o[2 * np + 1], pf, vf[2], vf[3]);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_decode_partial_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ cache_len,
    float* __restrict__ ws_o, float* __restrict__ ws_ml, int S, int KV, int G,
    int D, int Dv, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, float scale, int chunk) {
  using Sh = MmaShape<DP>;
  constexpr int kLd = Sh::kLd;
  constexpr int T = kRowsPerTile;
  constexpr int NS = kStages;
  constexpr int NTV = Sh::kNtv;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + 16 * kLd;  // stage s: K at 2s, V at 2s + 1

  const int tiles = (G + 15) / 16;
  const int c = blockIdx.x / tiles;
  const int g0 = (blockIdx.x - c * tiles) * 16;  // the block's first head
  const int gn = min(16, G - g0);                // and its heads
  const int bkv = blockIdx.y;
  const int nC = gridDim.x / tiles;
  const int b = bkv / KV;
  const int kv = bkv - b * KV;
  const int len = min(max(*cache_len, 0), S);
  const int c0 = c * chunk;
  const int n = max(0, min(chunk, len - c0));  // valid rows of this chunk
  float* o_ws = ws_o + (((long long)bkv * nC + c) * G + g0) * Dv;
  float* ml_ws = ws_ml + (((long long)bkv * nC + c) * G + g0) * 2;
  if (n == 0) {  // block-uniform: the chunk lies past cache_len
    write_empty(o_ws, ml_ws, gn, Dv);
    return;
  }
  const __nv_bfloat16* kb = k + b * k_sb + (long long)kv * D + c0 * k_ss;
  const __nv_bfloat16* vb = v + b * v_sb + (long long)kv * Dv + c0 * v_ss;
  const int ntiles = (n + T - 1) / T;

  // the block's queries (zero-padded) with the ring's first tile, then the
  // ring's second
  const __nv_bfloat16* qg = q + ((long long)bkv * G + g0) * D;
  if (reinterpret_cast<uintptr_t>(qg) % 16 == 0) {
    for (int i = threadIdx.x; i < 16 * (DP / 8); i += kThreads) {
      const int r = i / (DP / 8);
      const int col = (i - r * (DP / 8)) * 8;
      const bool ok = r < gn && col < D;
      cp_async_16(qs + r * kLd + col, ok ? qg + r * D + col : qg, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 16 * DP; i += kThreads) {
      const int r = i / DP;
      const int col = i - r * DP;
      qs[r * kLd + col] =
          r < gn && col < D ? qg[r * D + col] : __float2bfloat16(0.f);
    }
  }
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < ntiles) {
      load_tile<DP>(ring + 2 * s * Sh::kTileElems,
                    ring + (2 * s + 1) * Sh::kTileElems, kb, vb, k_ss, v_ss,
                    s * T, min(T, n - s * T), D, Dv);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int grp = lane / 4;  // the fragment's row (head) and column
  const int tig = lane % 4;  // (cache row) selectors of the PTX layout
  State<NTV> st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.m[h] = kMaskValue;
    st.l[h] = 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < NTV; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[nt][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    {
      const int tl = t + NS - 1;
      if (tl < ntiles) {
        const int s = tl % NS;
        load_tile<DP>(ring + 2 * s * Sh::kTileElems,
                      ring + (2 * s + 1) * Sh::kTileElems, kb, vb, k_ss, v_ss,
                      tl * T, min(T, n - tl * T), D, Dv);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 1) : "memory");
    __syncthreads();
    const __nv_bfloat16* ks = ring + 2 * (t % NS) * Sh::kTileElems;
    const __nv_bfloat16* vs = ks + Sh::kTileElems;
    if (warp * 16 < min(T, n - t * T)) {  // step ``warp`` of the tile
      mma_step<DP>(qs, ks, vs, warp * 16, t * T + warp * 16, n, scale, st);
    }
    __syncthreads();  // the stage is refilled in a later iteration
  }

  // the four warps' states through shared memory (the ring is free), merged
  // in warp order into the chunk's max, sum and output
  constexpr int kLo = DP + 1;
  float* mw = reinterpret_cast<float*>(ring);  // (kWarps, 16)
  float* lw = mw + kWarps * 16;                // (kWarps, 16)
  float* ow = lw + kWarps * 16;                // (kWarps, 16, kLo)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = st.l[h];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const int g = grp + 8 * h;
    if (tig == 0) {
      mw[warp * 16 + g] = st.m[h];
      lw[warp * 16 + g] = l;
    }
#pragma unroll
    for (int nt = 0; nt < NTV; ++nt) {
      const int dv = nt * 8 + 2 * tig;
      ow[(warp * 16 + g) * kLo + dv] = st.o[nt][2 * h];
      ow[(warp * 16 + g) * kLo + dv + 1] = st.o[nt][2 * h + 1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * Dv; i += kThreads) {
    const int g = i / Dv;
    const int dv = i - g * Dv;
    float M = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mw[w * 16 + g]);
    float L = 0.f;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(mw[w * 16 + g] - M);
      L = fmaf(lw[w * 16 + g], wt, L);
      acc = fmaf(ow[(w * 16 + g) * kLo + dv], wt, acc);
    }
    o_ws[i] = acc;
    if (dv == 0) {
      ml_ws[2 * g] = M;
      ml_ws[2 * g + 1] = L;
    }
  }
}

// =================== CUDA-core path (f32; bf16 beyond the mma limits) ======
constexpr int kTile = 32;  // cache rows staged in shared memory at a time

// elements of T in one 16-byte load
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// Stage rows [r0, r0 + n) of one (b, kv) head's K or V into ``tile`` as f32,
// row stride ``ld``; 16-byte loads, neighbouring threads on neighbouring
// 16-byte pieces of a row.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ base,
                                           long long row_stride, int r0,
                                           int n, int width, float* tile,
                                           int ld) {
  const int per_row = width / kVec<T>;
  const int total = n * per_row;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kVec<T>;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        base + (long long)(r0 + r) * row_stride + c);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec<T>; ++e) tile[r * ld + c + e] = to_f(vals[e]);
  }
}

// Partials of one (chunk, b*KV + kv) block. Shared memory (f32):
// q (G*D) | this tile's scores, then p (G*kTile) | p.V sums (G*Dv) |
// running max (G) | running sum (G) | this tile's correction (G) |
// staged tile (kTile * ld).
// ``ds`` lanes share one score's dot product (ds = 4, 2, 1 for G = 1, 2, >2),
// so small groups still keep all four warps busy.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_partial_fma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ cache_len, float* __restrict__ ws_o,
    float* __restrict__ ws_ml, int S, int KV, int G, int D, int Dv,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    float scale, int chunk, int ds, int ld) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int bkv = blockIdx.y;
  const int nC = gridDim.x;
  const int b = bkv / KV;
  const int kv = bkv - b * KV;
  const int len = min(max(*cache_len, 0), S);
  const int c0 = c * chunk;
  const int n = max(0, min(chunk, len - c0));  // valid rows of this chunk
  float* o_ws = ws_o + ((long long)bkv * nC + c) * G * Dv;
  float* ml_ws = ws_ml + ((long long)bkv * nC + c) * G * 2;
  if (n == 0) {  // block-uniform: the chunk lies past cache_len
    write_empty(o_ws, ml_ws, G, Dv);
    return;
  }
  float* qs = smem;
  float* ps = qs + G * D;
  float* os = ps + G * kTile;
  float* ms = os + G * Dv;
  float* ls = ms + G;
  float* cs = ls + G;
  float* tile = cs + G;
  const T* qg = q + (long long)bkv * G * D;  // the group's G heads
  for (int i = threadIdx.x; i < G * D; i += kThreads) qs[i] = to_f(qg[i]);
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) os[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    ms[g] = kMaskValue;
    ls[g] = 0.f;
  }
  const T* kb = k + b * k_sb + (long long)kv * D;
  const T* vb = v + b * v_sb + (long long)kv * Dv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int items = G * kTile * ds;  // a multiple of 32: warps stay whole
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int tn = min(kTile, n - t0);
    __syncthreads();  // the previous tile is consumed (and the state set)
    stage_rows(kb, k_ss, c0 + t0, tn, D, tile, ld);
    __syncthreads();
    for (int idx = threadIdx.x; idx < items; idx += kThreads) {
      const int part = idx % ds;
      const int j = (idx / ds) % kTile;
      const int g = idx / (ds * kTile);
      float s = 0.f;
      if (j < tn) {
        const float* qr = qs + g * D;
        const float* kr = tile + j * ld;
        for (int d = part; d < D; d += ds) s = fmaf(qr[d], kr[d], s);
      }
      for (int off = ds >> 1; off > 0; off >>= 1) {
        s += __shfl_xor_sync(kFull, s, off);
      }
      if (part == 0 && j < tn) ps[g * kTile + j] = s * scale;
    }
    __syncthreads();
    // online softmax, a warp per head and a lane per row; V staged meanwhile
    for (int g = warp; g < G; g += kWarps) {
      const float s = lane < tn ? ps[g * kTile + lane] : kMaskValue;
      float mx = s;
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      }
      const float m_new = fmaxf(ms[g], mx);
      const float corr = expf(ms[g] - m_new);
      const float p = expf(s - m_new);
      float l = p;
      for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
      ps[g * kTile + lane] = round_to<T>(p);
      __syncwarp();
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = ls[g] * corr + l;
        cs[g] = corr;
      }
    }
    stage_rows(vb, v_ss, c0 + t0, tn, Dv, tile, ld);
    __syncthreads();
    // p.V, each thread owning fixed (head, column) sums
    for (int i = threadIdx.x; i < G * Dv; i += kThreads) {
      const int g = i / Dv;
      const int dv = i - g * Dv;
      const float* pr = ps + g * kTile;
      float a = 0.f;
      for (int j = 0; j < tn; ++j) a = fmaf(pr[j], tile[j * ld + dv], a);
      os[i] = os[i] * cs[g] + a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) o_ws[i] = os[i];
  for (int g = threadIdx.x; g < G; g += kThreads) {
    ml_ws[2 * g] = ms[g];
    ml_ws[2 * g + 1] = ls[g];
  }
}

// lanes that share one score's dot product: 4, 2, 1 for G = 1, 2, > 2
int dot_lanes(int G) {
  int ds = 1;
  while (ds < 4 && G * kTile * ds * 2 <= kThreads) ds *= 2;
  return ds;
}

size_t fma_smem_bytes(int G, int D, int Dv) {
  const int ld = (D > Dv ? D : Dv) + dot_lanes(G);
  return sizeof(float) *
         ((size_t)G * (D + kTile + Dv + 3) + (size_t)kTile * ld);
}

// =================== merge ================================================
constexpr int kMergeThreads = 128;
constexpr int kMergeBatch = 16;  // chunks whose partials are loaded at once

// One block per (b, head), a thread per output column: the chunks' partials
// are folded in chunk order with a running max, kMergeBatch chunks at a time
// (their loads all in flight together): rescale what is summed so far to the
// batch's max, add each chunk's sum and output weighted by exp(m_c - max),
// then divide by the clamped denominator and cast.
// With ``m_out`` (the partial call) the (b, head)'s running max and
// denominator go to m_out / d_out too.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) flash_decode_merge(
    const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
    T* __restrict__ out, float* __restrict__ m_out, float* __restrict__ d_out,
    int nC, int G, int Dv) {
  const int bh = blockIdx.x;  // (b*KV + kv)*G + g == b*H + h
  const int bkv = bh / G;
  const int g = bh - bkv * G;
  const float* ml = ws_ml + ((long long)bkv * nC * G + g) * 2;  // + c*G*2
  const float* o = ws_o + ((long long)bkv * nC * G + g) * Dv;   // + c*G*Dv
  for (int dv = threadIdx.x; dv < Dv; dv += kMergeThreads) {
    float M = kMaskValue;
    float L = 0.f;
    float acc = 0.f;
    for (int c0 = 0; c0 < nC; c0 += kMergeBatch) {
      float mc[kMergeBatch], lc[kMergeBatch], oc[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const long long c = c0 + j;
        const bool ok = c < nC;
        mc[j] = ok ? ml[c * G * 2] : kMaskValue;
        lc[j] = ok ? ml[c * G * 2 + 1] : 0.f;
        oc[j] = ok ? o[c * G * Dv + dv] : 0.f;
      }
      float mx = M;
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) mx = fmaxf(mx, mc[j]);
      const float scale = expf(M - mx);
      L *= scale;
      acc *= scale;
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const float w = expf(mc[j] - mx);
        L = fmaf(lc[j], w, L);
        acc = fmaf(oc[j], w, acc);
      }
      M = mx;
    }
    out[(long long)bh * Dv + dv] = from_f<T>(acc / fmaxf(L, kDenomFloor));
    if (m_out != nullptr && dv == 0) {
      m_out[bh] = M;
      d_out[bh] = L;
    }
  }
}

// =================== dispatch =============================================
// The tensor-core path's padded head dim for a shape (bf16, D and Dv <= 256),
// or 0 for the CUDA-core path.
int mma_dim(int dtype, int D, int Dv) {
  const int w = D > Dv ? D : Dv;
  const int dp = w <= 64 ? 64 : w <= 128 ? 128 : w <= 256 ? 256 : 0;
  return dtype == 1 ? dp : 0;
}

size_t smem_bytes(int dtype, int G, int D, int Dv) {
  switch (mma_dim(dtype, D, Dv)) {
    case 64: return mma_smem_bytes<64>();
    case 128: return mma_smem_bytes<128>();
    case 256: return mma_smem_bytes<256>();
    default: return fma_smem_bytes(G, D, Dv);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* cache_len;
  float* ws_o;
  float* ws_ml;
  int S, KV, G, D, Dv;
  long long k_sb, k_ss, v_sb, v_ss;
  float scale;
  int chunk;
};

// opt a kernel into ``smem`` bytes of dynamic shared memory, once
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool& done) {
  if (done || smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done = err == cudaSuccess;
  return err;
}

template <int DP>
cudaError_t launch_mma(const Args& a, dim3 grid, cudaStream_t stream) {
  static bool attr = false;
  constexpr size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_decode_partial_mma<DP>, smem, attr);
  if (err != cudaSuccess) return err;
  grid.x *= (a.G + 15) / 16;  // the group's 16-head tiles
  flash_decode_partial_mma<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.cache_len, a.ws_o, a.ws_ml,
      a.S, a.KV, a.G, a.D, a.Dv, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.scale,
      a.chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const Args& a, dim3 grid, cudaStream_t stream) {
  static bool attr = false;
  const int ds = dot_lanes(a.G);
  // rows ld floats apart: a tile row starts ds banks after the one above
  const int ld = (a.D > a.Dv ? a.D : a.Dv) + ds;
  const size_t smem = fma_smem_bytes(a.G, a.D, a.Dv);
  cudaError_t err = allow_smem(flash_decode_partial_fma<T>, smem, attr);
  if (err != cudaSuccess) return err;
  flash_decode_partial_fma<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.cache_len, a.ws_o, a.ws_ml, a.S, a.KV,
      a.G, a.D, a.Dv, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.scale, a.chunk, ds,
      ld);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_merge(const Args& a, void* out, float* m_out, float* d_out,
                         int B, int nC, cudaStream_t stream) {
  flash_decode_merge<T><<<B * a.KV * a.G, kMergeThreads, 0, stream>>>(
      a.ws_o, a.ws_ml, static_cast<T*>(out), m_out, d_out, nC, a.G, a.Dv);
  return cudaGetLastError();
}

// The partial kernel of the shape's path over every (chunk, b*KV) block.
cudaError_t launch_partials(const Args& a, int B, int nC, int dtype,
                            cudaStream_t stream) {
  const dim3 grid(nC, B * a.KV);
  switch (mma_dim(dtype, a.D, a.Dv)) {
    case 64: return launch_mma<64>(a, grid, stream);
    case 128: return launch_mma<128>(a, grid, stream);
    case 256: return launch_mma<256>(a, grid, stream);
    default:
      if (dtype == 0) return launch_fma<float>(a, grid, stream);
      if (dtype == 1) return launch_fma<__nv_bfloat16>(a, grid, stream);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one partial block needs, in bytes (the wrapper checks it
// against the card's 227 KB before launching).
int flash_decode_smem_bytes(int dtype, int G, int D, int Dv) {
  return (int)smem_bytes(dtype, G, D, Dv);
}

// 1 if the shape takes the tensor-core path, else 0
int flash_decode_uses_mma(int dtype, int D, int Dv) {
  return mma_dim(dtype, D, Dv) != 0;
}

// What one call's shapes and strides fix (the wrapper caches it per shape).
// dtype: 0 f32, 1 bf16.
struct DecodeShape {
  int B, S, KV, G, D, Dv;
  long long k_sb, k_ss, v_sb, v_ss;
  float scale;
  int chunk, dtype;
};

// Workspace ``ws``: the partial outputs (B*KV, nC, G, Dv), then the partial
// (max, sum) pairs (B*KV, nC, G, 2), f32, with nC = ceil(S / chunk).
static int run(const void* q, const void* k, const void* v,
               const int* cache_len, float* ws, void* out, float* m_out,
               float* d_out, const DecodeShape& p, cudaStream_t stream) {
  const int B = p.B, S = p.S, KV = p.KV, G = p.G, D = p.D, Dv = p.Dv;
  const int chunk = p.chunk, dtype = p.dtype;
  if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || chunk <= 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int nC = (S + chunk - 1) / chunk;
  const Args a{q,      k,      v,      cache_len, ws,
               ws + (long long)B * KV * nC * G * Dv,
               S,      KV,     G,      D,         Dv,
               p.k_sb, p.k_ss, p.v_sb, p.v_ss,    p.scale,
               chunk};
  cudaError_t err = launch_partials(a, B, nC, dtype, stream);
  if (err != cudaSuccess) return (int)err;
  if (m_out != nullptr || dtype == 0) {  // an f32 output
    err = launch_merge<float>(a, out, m_out, d_out, B, nC, stream);
  } else {
    err = launch_merge<__nv_bfloat16>(a, out, nullptr, nullptr, B, nC, stream);
  }
  return (int)err;
}

// The attention output (B, H, Dv) in q's dtype.
int flash_decode(const void* q, const void* k, const void* v,
                 const int* cache_len, float* ws, void* out,
                 const DecodeShape* shape, cudaStream_t stream) {
  return run(q, k, v, cache_len, ws, out, nullptr, nullptr, *shape, stream);
}

// The partial output: o (B, H, Dv) f32, normalised by its own denominator,
// and each (b, head)'s running max m (B, H) and denominator d (B, H), f32.
int flash_decode_partial(const void* q, const void* k, const void* v,
                         const int* cache_len, float* ws, float* out,
                         float* m_out, float* d_out, const DecodeShape* shape,
                         cudaStream_t stream) {
  return run(q, k, v, cache_len, ws, out, m_out, d_out, *shape, stream);
}

}  // extern "C"
