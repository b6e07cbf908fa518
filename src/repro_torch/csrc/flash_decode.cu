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
// Design (split-K flash-decoding):
//   * Grid (ceil(S / chunk), B*KV). A block takes one (b, kv) pair and one
//     chunk of cache rows and serves all G = H/KV query heads of the group,
//     so each K/V row is read from device memory once for G heads. Without
//     the split, the serve shape (B*KV = 24) would fill 24 of 132 SMs.
//   * The cache is read where it lies, (B, S, KV, D) with the batch and row
//     strides the wrapper passes, in 16-byte loads; no transpose copy. Rows
//     at or past cache_len (read from a device int32) are never loaded: a
//     chunk wholly past it writes an empty partial (max -1e30, sum 0).
//   * Pass 1 stages K in tiles of 32 rows (f32 in shared memory) and writes
//     the chunk's scores q.k * scale; pass 2 takes the chunk's max and
//     exp-sum per head, and pass 3 stages V and accumulates p.V. The partial
//     (max, sum, unnormalised output) goes to a workspace; a second kernel
//     merges the chunks of each (b, kv) in a fixed order and divides. No
//     atomics: every sum has a fixed order, so results repeat bit for bit.
//   * The Pallas kernel's clamps are kept: masked scores -1e30, the
//     denominator floored at 1e-30; p is rounded to the value dtype before
//     the p.V product (as the Pallas kernel's ``p.astype(v.dtype)``), the
//     sums stay f32, and the output is cast to q's dtype.
//
// Bound on this card: bytes for small groups. The K/V rows up to cache_len
// are read once (4*D bytes per row and KV head in bf16, 8*D in f32) for
// 4*G*D flops: G flops a byte in bf16. At the serve shape (SmolLM, G=3, D=64)
// that is 3, far below the 20 flops a byte where 67 TFLOP/s of CUDA-core
// fp32 meet 3.35 TB/s. A large group (Granite's MQA, G=48) does 48 flops a
// byte: on CUDA-core FMAs, as here, it is bound by operations (on the
// tensor cores, 295 flops a byte, it would still be bound by bytes; wgmma
// is for a later kernel).
//
// Layout: q (B, H, D) with head h = kv*G + g; k (B, S, KV, D) and v
// (B, S, KV, Dv) with unit stride in the last dim and KV*D (KV*Dv) between
// a row's heads' ends, batch and row strides as given; out (B, H, Dv) in q's
// dtype. D and Dv multiples of 8; f32 or bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // cache rows staged in shared memory at a time
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
// q (G*D) | scores, then probabilities (G*chunk) | p.V accumulators (G*Dv) |
// max (G) | sum (G) | staged tile (kTile * ld).
// ``ds`` lanes share one score's dot product (ds = 4, 2, 1 for G = 1, 2, >2),
// so small groups still keep all four warps busy in pass 1.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_partial(
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
    for (int i = threadIdx.x; i < G * Dv; i += kThreads) o_ws[i] = 0.f;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      ml_ws[2 * g] = kMaskValue;
      ml_ws[2 * g + 1] = 0.f;
    }
    return;
  }
  float* qs = smem;
  float* ps = qs + G * D;
  float* os = ps + G * chunk;
  float* ms = os + G * Dv;
  float* ls = ms + G;
  float* tile = ls + G;
  const T* qg = q + ((long long)b * KV + kv) * G * D;  // the group's G heads
  for (int i = threadIdx.x; i < G * D; i += kThreads) qs[i] = to_f(qg[i]);
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) os[i] = 0.f;
  const T* kb = k + b * k_sb + (long long)kv * D;
  const T* vb = v + b * v_sb + (long long)kv * Dv;

  // pass 1: scores of the chunk's valid rows
  const int items = G * kTile * ds;  // a multiple of 32: warps stay whole
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int tn = min(kTile, n - t0);
    __syncthreads();  // the previous tile is consumed (and qs is written)
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
      if (part == 0 && j < tn) ps[g * chunk + t0 + j] = s * scale;
    }
  }
  __syncthreads();

  // pass 2: per head, the chunk's max and exp-sum; p kept for pass 3
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += kThreads / 32) {
    float* pr = ps + g * chunk;
    float m = kMaskValue;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, pr[j]);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    }
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(pr[j] - m);
      l += p;
      pr[j] = round_to<T>(p);
    }
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
    if (lane == 0) {
      ms[g] = m;
      ls[g] = l;
    }
  }

  // pass 3: p.V, each thread owning fixed (head, column) accumulators
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int tn = min(kTile, n - t0);
    __syncthreads();  // pass 2 (or the previous tile) is done
    stage_rows(vb, v_ss, c0 + t0, tn, Dv, tile, ld);
    __syncthreads();
    for (int i = threadIdx.x; i < G * Dv; i += kThreads) {
      const int g = i / Dv;
      const int dv = i - g * Dv;
      const float* pr = ps + g * chunk + t0;
      float a = 0.f;
      for (int j = 0; j < tn; ++j) a = fmaf(pr[j], tile[j * ld + dv], a);
      os[i] += a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) o_ws[i] = os[i];
  for (int g = threadIdx.x; g < G; g += kThreads) {
    ml_ws[2 * g] = ms[g];
    ml_ws[2 * g + 1] = ls[g];
  }
}

// Merge of one (b, kv) group's chunks, in chunk order: rescale each partial
// to the global max, sum, divide by the clamped denominator, cast.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_merge(
    const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
    T* __restrict__ out, int nC, int G, int Dv) {
  const int bkv = blockIdx.x;
  const float* ml = ws_ml + (long long)bkv * nC * G * 2;
  const float* o = ws_o + (long long)bkv * nC * G * Dv;
  T* ob = out + (long long)bkv * G * Dv;  // heads kv*G .. kv*G + G - 1 of b
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) {
    const int g = i / Dv;
    float M = kMaskValue;
    for (int c = 0; c < nC; ++c) M = fmaxf(M, ml[(c * G + g) * 2]);
    float L = 0.f;
    float acc = 0.f;
    for (int c = 0; c < nC; ++c) {
      const float w = expf(ml[(c * G + g) * 2] - M);
      L = fmaf(ml[(c * G + g) * 2 + 1], w, L);
      acc = fmaf(o[(long long)c * G * Dv + i], w, acc);
    }
    ob[i] = from_f<T>(acc / fmaxf(L, kDenomFloor));
  }
}

// lanes that share one score's dot product: 4, 2, 1 for G = 1, 2, > 2
int dot_lanes(int G) {
  int ds = 1;
  while (ds < 4 && G * kTile * ds * 2 <= kThreads) ds *= 2;
  return ds;
}

size_t smem_bytes(int G, int D, int Dv, int chunk) {
  const int ld = (D > Dv ? D : Dv) + dot_lanes(G);
  return sizeof(float) * ((size_t)G * (D + chunk + Dv + 2) + (size_t)kTile * ld);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* cache_len,
           float* ws_o, float* ws_ml, void* out, int B, int S, int KV, int G,
           int D, int Dv, long long k_sb, long long k_ss, long long v_sb,
           long long v_ss, float scale, int chunk, cudaStream_t stream) {
  const int ds = dot_lanes(G);
  // rows ld floats apart: a tile row starts ds banks after the one above
  const int ld = (D > Dv ? D : Dv) + ds;
  const size_t smem = smem_bytes(G, D, Dv, chunk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nC = (S + chunk - 1) / chunk;
  flash_decode_partial<T><<<dim3(nC, B * KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache_len, ws_o, ws_ml, S, KV, G, D, Dv, k_sb,
      k_ss, v_sb, v_ss, scale, chunk, ds, ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_merge<T><<<B * KV, kThreads, 0, stream>>>(
      ws_o, ws_ml, static_cast<T*>(out), nC, G, Dv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one partial block needs, in bytes (the wrapper checks it
// against the card's 227 KB before launching).
int flash_decode_smem_bytes(int G, int D, int Dv, int chunk) {
  return (int)smem_bytes(G, D, Dv, chunk);
}

// dtype: 0 f32, 1 bf16. Workspaces: ws_o (B*KV, nC, G, Dv), ws_ml
// (B*KV, nC, G, 2) f32 with nC = ceil(S / chunk).
int flash_decode(const void* q, const void* k, const void* v,
                 const int* cache_len, float* ws_o, float* ws_ml, void* out,
                 int B, int S, int KV, int G, int D, int Dv, long long k_sb,
                 long long k_ss, long long v_sb, long long v_ss, float scale,
                 int chunk, int dtype, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || G <= 0) return 0;
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, cache_len, ws_o, ws_ml, out, B, S, KV, G,
                           D, Dv, k_sb, k_ss, v_sb, v_ss, scale, chunk, stream);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, cache_len, ws_o, ws_ml, out, B, S,
                                   KV, G, D, Dv, k_sb, k_ss, v_sb, v_ss, scale,
                                   chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
