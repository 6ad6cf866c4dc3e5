// One-token decode attention against a KV cache: split-K flash-decoding
// with a combine pass. Per-row lengths, optional sliding window and tanh
// logit softcap, grouped-query heads.
//
// Replaces the TPU kernel `flash_decode` / `_decode_kernel` in
// src/repro/kernels/flash_decode.py (pallas_call at :110).
// q: (B, Hq, D); k_cache, v_cache: (B, L, Hkv, D); lengths: (B,) int32,
// the valid positions of each row including the newest token. bf16 or
// f32, contiguous; output (B, Hq, D) in q's type. Position t of row b is
// seen when t < lengths[b] and, with window > 0, t >= lengths[b] - window.
// A row that sees no position (length 0) writes zeros, as the TPU kernel
// does.
//
// What bounds it on an H100: the bytes of the valid cache. Each key and
// value row is read once for the G = Hq / Hkv query heads of its group,
// ~4 G FLOP per cache byte in bf16; at the decode shape (B = 128, Hkv = 3,
// D = 64, mean length ~1024) one launch reads ~100 MB, ~30 us at
// 3.35 TB/s. The design therefore reads the valid cache once, with all the
// card's SMs in flight, and nothing else of size.
//
// Design: pass 1 gives each (batch row, KV head) NS = 4 * gridDim.x spans
// of its valid range (a multiple of 32 positions each), one span per warp.
// The number of blocks per row grows as B * Hkv shrinks, so B = 1 with a
// long cache still fills the card. A block holds the G query heads of its
// group in shared memory (no KV duplication for GQA), and reads `lengths`
// itself (the TPU kernel's scalar prefetch). Positions past the length
// and before the window are never loaded. A warp walks its span in tiles
// of 32 positions: it copies the K and V rows to shared memory with 16-byte
// loads (K rows padded 16 bytes so lane j reading row j hits distinct
// banks), lane j scores position j for every head, and the (max,
// denominator, accumulator) of each head is carried in f32 registers,
// lane c holding output columns c, c + 32, ... . Pass 2 merges the NS
// partial states of each row and head and divides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;          // positions per warp tile (one per lane)
constexpr int kMaxG = 8;           // query heads per KV head

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared bytes of one K or V tile row: D elements plus 16 bytes of padding.
template <typename T, int D>
__host__ __device__ constexpr int row_bytes() {
  return D * static_cast<int>(sizeof(T)) + 16;
}

template <typename T, int D>
size_t split_smem_bytes(int G) {
  return sizeof(float) * G * D +
         static_cast<size_t>(kWarps) * 2 * kTile * row_bytes<T, D>();
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ lengths,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc, int L, int Hkv,
                          int G, float scale, int window, float softcap) {
  constexpr int C = (D + 31) / 32;           // output columns per lane
  constexpr int E = 16 / sizeof(T);          // elements per 16 bytes
  constexpr int CPR = D / E;                 // 16-byte chunks per row
  constexpr int RB = row_bytes<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);             // [G][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ks = smem + sizeof(float) * G * D +
                      static_cast<size_t>(warp) * 2 * kTile * RB;
  unsigned char* vs = ks + kTile * RB;

  const int hk = blockIdx.y;
  const long long b = blockIdx.z;
  const int Hq = Hkv * G;
  const T* qb = q + (b * Hq + static_cast<long long>(hk) * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    qs[i] = to_float(qb[i]);
  __syncthreads();

  // This warp's span of the row's valid range [lo, hi).
  const int len = lengths[b];
  const int hi = min(max(len, 0), L);
  const int lo = window > 0 ? min(max(len - window, 0), hi) : 0;
  const int n_spans = gridDim.x * kWarps;
  const int span_id = blockIdx.x * kWarps + warp;
  const int per = (hi - lo + n_spans - 1) / n_spans;
  const int span = (per + kTile - 1) / kTile * kTile;
  const int beg = min(lo + span_id * span, hi);
  const int end = min(beg + span, hi);

  float m[kMaxG], l[kMaxG], acc[kMaxG][C];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[g][c] = 0.f;
  }

  const long long row_stride = static_cast<long long>(Hkv) * D;
  const T* kb = k + b * L * row_stride + static_cast<long long>(hk) * D;
  const T* vb = v + b * L * row_stride + static_cast<long long>(hk) * D;
  for (int k0 = beg; k0 < end; k0 += kTile) {
    const int n = min(kTile, end - k0);
    for (int c = lane; c < kTile * CPR; c += 32) {
      const int j = c / CPR, part = c % CPR;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < n) {
        const long long off = (k0 + j) * row_stride;
        kk = reinterpret_cast<const uint4*>(kb + off)[part];
        vv = reinterpret_cast<const uint4*>(vb + off)[part];
      }
      *reinterpret_cast<uint4*>(ks + j * RB + part * 16) = kk;
      *reinterpret_cast<uint4*>(vs + j * RB + part * 16) = vv;
    }
    __syncwarp();

    // Lane j scores position k0 + j against every head of the group.
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    const unsigned char* krow = ks + lane * RB;
#pragma unroll 2
    for (int part = 0; part < CPR; ++part) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + part * 16);
      const T* kv = reinterpret_cast<const T*>(&raw);
      float kf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kf[e] = to_float(kv[e]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float* qg = qs + g * D + part * E;
#pragma unroll
        for (int e = 0; e < E; ++e) s[g] = fmaf(qg[e], kf[e], s[g]);
      }
    }
    const bool ok = lane < n;
    float p[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float x = s[g] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const float m_new = fmaxf(m[g], warp_max(ok ? x : -INFINITY));
      p[g] = ok ? expf(x - m_new) : 0.f;     // n >= 1: m_new is finite
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] *= corr;
    }

    // Lane c accumulates output columns c + 32 i over the tile.
    for (int j = 0; j < n; ++j) {
      const T* vrow = reinterpret_cast<const T*>(vs + j * RB);
      float vf[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        vf[c] = (D % 32 == 0 || lane + 32 * c < D)
                    ? to_float(vrow[lane + 32 * c]) : 0.f;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[g][c] = fmaf(pj, vf[c], acc[g][c]);
      }
    }
    __syncwarp();                   // the tile is consumed
  }

  const long long part_idx = (b * Hkv + hk) * n_spans + span_id;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      part_m[part_idx * G + g] = m[g];
      part_l[part_idx * G + g] = l[g];
    }
    float* pa = part_acc + (part_idx * G + g) * D;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (D % 32 == 0 || lane + 32 * c < D) pa[lane + 32 * c] = acc[g][c];
  }
}

// Pass 2: one block per (KV head, batch row) merges the row's spans.
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ part_m,
                                            const float* __restrict__ part_l,
                                            const float* __restrict__ part_acc,
                                            T* __restrict__ o, int Hkv, int G,
                                            int D, int n_spans) {
  const int hk = blockIdx.x;
  const long long b = blockIdx.y;
  const long long row = (b * Hkv + hk) * n_spans;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
    for (int s = 0; s < n_spans; ++s)
      mx = fmaxf(mx, part_m[(row + s) * G + g]);
    float den = 0.f, num = 0.f;
    if (mx > -INFINITY) {
      for (int s = 0; s < n_spans; ++s) {
        const float w = expf(part_m[(row + s) * G + g] - mx);
        den = fmaf(part_l[(row + s) * G + g], w, den);
        num = fmaf(part_acc[((row + s) * G + g) * D + d], w, num);
      }
    }
    o[((b * Hkv + hk) * G + g) * D + d] =
        from_float<T>(den > 0.f ? num / den : 0.f);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess || count <= 0)
      count = 132;
  }
  return count;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* part_m, float* part_l, float* part_acc, void* o, int B,
           int L, int Hkv, int G, int n_spans, float scale, int window,
           float softcap, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<T, D>(G);
  auto split = flash_decode_split_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  const dim3 grid(n_spans / kWarps, Hkv, B);
  split<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_m, part_l, part_acc, L, Hkv, G,
      scale, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<T><<<dim3(Hkv, B), 128, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), Hkv, G, D, n_spans);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Spans per (batch row, KV head), a multiple of the warps of a block:
// about four blocks per SM in all, each warp at least one tile of the
// longest row.
extern "C" int flash_decode_n_spans(int B, int Hkv, int L) {
  const long long rows = static_cast<long long>(B) * Hkv;
  long long blocks = rows > 0 ? (4LL * sm_count() + rows - 1) / rows : 1;
  const long long cap = (static_cast<long long>(L) + kWarps * kTile - 1) /
                        (kWarps * kTile);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;
  return static_cast<int>(blocks) * kWarps;
}

// dtype: 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128}; G <= 8;
// n_spans from flash_decode_n_spans; part_m, part_l: (B, Hkv, n_spans, G)
// and part_acc: (B, Hkv, n_spans, G, D) float32 scratch. Launches both
// passes on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   float* part_m, float* part_l,
                                   float* part_acc, void* o, int B, int L,
                                   int Hkv, int G, int D, int n_spans,
                                   int dtype, float scale, int window,
                                   float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kMaxG || n_spans < kWarps || n_spans % kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
#define FD_CASE(TYPE, DIM)                                                 \
  return launch<TYPE, DIM>(q, k, v, lengths, part_m, part_l, part_acc, o, \
                           B, L, Hkv, G, n_spans, scale, window, softcap,  \
                           st)
  if (dtype == 0) {
    if (D == 16) FD_CASE(float, 16);
    if (D == 32) FD_CASE(float, 32);
    if (D == 64) FD_CASE(float, 64);
    if (D == 128) FD_CASE(float, 128);
  } else if (dtype == 1) {
    if (D == 16) FD_CASE(__nv_bfloat16, 16);
    if (D == 32) FD_CASE(__nv_bfloat16, 32);
    if (D == 64) FD_CASE(__nv_bfloat16, 64);
    if (D == 128) FD_CASE(__nv_bfloat16, 128);
  }
#undef FD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
