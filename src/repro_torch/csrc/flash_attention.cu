// Attention forward with online softmax: causal, sliding window, tanh
// logit softcap, grouped-query heads.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at :126).
// q: (B, S, Hq, D), k and v: (B, S, Hkv, D), bf16 or f32, contiguous;
// output (B, S, Hq, D) in q's type.
//
// What bounds it on an H100: at the trust evaluator's shapes (S = 31
// tokens, D = 64, 9 query heads over 3 KV heads) each (batch, head) pair
// does ~0.25 MFLOP on 16 KB of q, k, v and o, ~16 FLOP per byte, far below
// the ~295 FLOP/byte at which the tensor cores would become the limit: the
// bytes bound it. This first version computes in FP32 FMAs from shared
// memory (no tensor cores), so its arithmetic, not memory, sets its time;
// `wgmma` and TMA are for a later version.
//
// Design: one block of 4 warps per (batch, query head, 32-row query tile).
// GQA reads KV head h / (Hq / Hkv) directly, never a repeated copy. The
// block walks the 32-key tiles its rows can see (tiles wholly above the
// causal diagonal or behind the window are never loaded), keeping the
// running max, denominator and f32 accumulator of its 8 rows per warp in
// registers. Lane j of a warp scores key j of the tile against the warp's
// rows (K rows padded in shared memory so the lanes hit distinct banks),
// then accumulates output columns lane and lane + 32 (and + 64, + 96 for
// D = 128) over the tile's keys; for D = 16 the lanes past D idle. Any S
// is accepted: rows and keys past S are masked, and a row that sees no
// key writes zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;            // query rows per block
constexpr int kBK = 32;            // keys per tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;  // query rows per warp

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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Hq, int Hkv, float scale, int causal, int window,
                       float softcap) {
  constexpr int DP = D + 4;        // padded K row: conflict-free float4 reads
  constexpr int C = (D + 31) / 32; // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [kBQ][D]
  float* Ks = Qs + kBQ * D;        // [kBK][DP]
  float* Vs = Ks + kBK * DP;       // [kBK][D]

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % Hq;
  const long long b = blockIdx.x / (static_cast<long long>(n_qt) * Hq);
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const long long q_row = static_cast<long long>(Hq) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const T* qb = q + b * S * q_row + static_cast<long long>(h) * D;
  const T* kb = k + b * S * kv_row + static_cast<long long>(hk) * D;
  const T* vb = v + b * S * kv_row + static_cast<long long>(hk) * D;
  T* ob = o + b * S * q_row + static_cast<long long>(h) * D;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    Qs[idx] = s < S ? to_float(qb[s * q_row + d]) : 0.f;
  }

  // Key tiles the block's rows can see.
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m[kRows], l[kRows], acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();               // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
      const int r = idx / D, d = idx % D, s = k0 + r;
      Ks[r * DP + d] = s < S ? to_float(kb[s * kv_row + d]) : 0.f;
      Vs[idx] = s < S ? to_float(vb[s * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // Scores: lane = key of the tile, rows of this warp.
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) p[r] = 0.f;
    const float* krow = Ks + lane * DP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(Qs + (warp * kRows + r) * D + d);
        p[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      float s = p[r] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      bool ok = kpos < S;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float m_new = fmaxf(m[r], warp_max(ok ? s : -INFINITY));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      p[r] = ok ? expf(s - m_use) : 0.f;
      const float corr = expf(m[r] - m_use);
      l[r] = l[r] * corr + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= corr;
    }

    // Output: lane owns columns lane + 32 c.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        vv[c] = (D % 32 == 0 || lane + 32 * c < D)
                    ? Vs[j * D + lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] += pj * vv[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= S) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (D % 32 == 0 || lane + 32 * c < D)
        ob[qpos * q_row + lane + 32 * c] = from_float<T>(acc[r][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Hq, int Hkv, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 4) + kBK * D);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * Hq * ((S + kBQ - 1) / kBQ);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, scale,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D must be 16, 64 or 128 (the wrapper
// checks; 16 is the smoke-width evaluator's head). Launches on `stream`;
// returns cudaGetLastError() (0 = ok).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Hq, int Hkv, int D, int dtype,
                                      float scale, int causal, int window,
                                      float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 16)
    return launch<float, 16>(q, k, v, o, B, S, Hq, Hkv, scale, causal,
                             window, softcap, st);
  if (dtype == 1 && D == 16)
    return launch<__nv_bfloat16, 16>(q, k, v, o, B, S, Hq, Hkv, scale,
                                     causal, window, softcap, st);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, S, Hq, Hkv, scale, causal,
                             window, softcap, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, S, Hq, Hkv, scale, causal,
                              window, softcap, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, Hq, Hkv, scale,
                                     causal, window, softcap, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, Hq, Hkv, scale,
                                      causal, window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
