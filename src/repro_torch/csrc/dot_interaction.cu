// DLRM dot interaction: for (B, F, D) features, the strict upper
// triangle of each sample's F x F Gram matrix, (B, F(F-1)/2), in the
// order of np.triu_indices(F, 1). The full Gram is never stored.
//
// Replaces the TPU kernel `dot_interaction` / `_dot_int_kernel` in
// src/repro/kernels/dot_interaction.py (pallas_call at :61). The TPU
// kernel gathers the triangle with a 0/1 selection-matrix GEMM, the MXU's
// idiom for a gather; here each thread writes its entries straight to
// their triangle index instead.
// x: (B, F, D) f32 or bf16, contiguous; output (B, F(F-1)/2) in x's type,
// sums in f32.
//
// What bounds it on an H100: the bytes. At DLRM's shapes (F = 27,
// D = 128, f32) a sample is 13.8 KB read and 1.4 KB written for 45k
// FMAs, ~3 FMA per byte, far below the card's FP32 rate per byte of HBM;
// at B = 4096 the bound is 62.4 MB / 3.35 TB/s = 18.6 us. Shared memory is
// the next limit: one FMA per two shared-memory loads would take ~50 us.
//
// Design: a block stages the (F, D) rows of S samples in shared memory as
// f32, rows padded to F_pad = 4T (T = ceil(F/4)) with zero rows and to a
// stride of round_up(D, 8) + 4 floats. Each thread owns a 4 x 4 tile of
// one sample's Gram, (row group ti, column group tj) with ti <= tj, where
// group t holds rows {t, t + T, t + 2T, t + 3T}: the T(T+1)/2 tiles cover
// every unordered pair once (the Gram is symmetric; a diagonal tile keeps
// r < c only). Per four columns a thread loads eight float4s and does 64
// FMAs, a quarter of the loads of one pair per thread. Rows of a group are
// T apart, so the stride's odd multiple of 16 bytes puts the rows a
// quarter warp reads in distinct bank groups. The block writes its
// entries into a shared output tile, then stores it contiguously.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Index of pair (r, c), r < c, in np.triu_indices(F, 1) order.
__device__ __forceinline__ int pair_index(int r, int c, int F) {
  return r * F - r * (r + 1) / 2 + (c - r - 1);
}

struct Layout {
  int T;       // row groups
  int n_tiles; // T (T + 1) / 2
  int f_pad;   // 4 T rows in shared memory
  int stride;  // floats per shared row: round_up(D, 8) + 4
  int d4;      // float4 steps over D: ceil(D / 4)
  int spb;     // samples per block
  int n_pairs; // F (F - 1) / 2
};

__host__ __device__ inline Layout make_layout(int F, int D) {
  Layout L;
  L.T = (F + 3) / 4;
  L.n_tiles = L.T * (L.T + 1) / 2;
  L.f_pad = 4 * L.T;
  L.stride = (D + 7) / 8 * 8 + 4;
  L.d4 = (D + 3) / 4;
  L.n_pairs = F * (F - 1) / 2;
  // About 128 threads a block, and at most 64 KB of staged rows.
  const int by_threads = 128 / L.n_tiles;
  const int by_smem = (64 * 1024) / (L.f_pad * L.stride * 4);
  int spb = by_threads < by_smem ? by_threads : by_smem;
  L.spb = spb < 1 ? 1 : spb;
  return L;
}

__host__ __device__ inline size_t smem_bytes(const Layout& L) {
  return sizeof(float) *
         (static_cast<size_t>(L.spb) * L.f_pad * L.stride +
          static_cast<size_t>(L.spb) * L.n_pairs);
}

template <typename T>
__global__ void dot_interaction_kernel(const T* __restrict__ x,
                                       T* __restrict__ out, int B, int F,
                                       int D, Layout L) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                    // [spb][f_pad][stride]
  float* os = smem + static_cast<size_t>(L.spb) * L.f_pad * L.stride;
  const long long b0 = static_cast<long long>(blockIdx.x) * L.spb;
  const long long left = B - b0;
  const int n_here = left < L.spb ? static_cast<int>(left) : L.spb;

  // Stage the block's samples, one shared row per warp at a time: 16-byte
  // loads along the row when D allows them, else one element a lane.
  // Padding rows and columns are zero.
  constexpr int E = 16 / sizeof(T);             // elements per 16 bytes
  const int per_sample = L.f_pad * L.stride;
  const T* xb = x + b0 * F * D;
  const bool vec =
      D % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
#pragma unroll 4
  for (int row = warp; row < L.spb * L.f_pad; row += n_warps) {
    const int s = row / L.f_pad, r = row % L.f_pad;
    float* dst = xs + static_cast<size_t>(row) * L.stride;
    const bool real = s < n_here && r < F;
    const T* src = xb + (static_cast<long long>(s) * F + r) * D;
    if (real && vec) {
      for (int c = lane; c < D / E; c += 32) {
        const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < E; ++e) dst[c * E + e] = to_float(v[e]);
      }
    } else if (real) {
      for (int d = lane; d < D; d += 32) dst[d] = to_float(src[d]);
    }
    for (int d = (real ? D : 0) + lane; d < L.stride; d += 32) dst[d] = 0.f;
  }
  __syncthreads();

  const int s = threadIdx.x / L.n_tiles;
  if (s < n_here) {
    int t = threadIdx.x % L.n_tiles, ti = 0;
    while (t >= L.T - ti) {                 // tile t -> (ti, tj), ti <= tj
      t -= L.T - ti;
      ++ti;
    }
    const int tj = ti + t;
    const float* base = xs + static_cast<size_t>(s) * per_sample;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    for (int k = 0; k < L.d4; ++k) {
      float4 ra[4], cb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ra[a] = *reinterpret_cast<const float4*>(
            base + (ti + a * L.T) * L.stride + 4 * k);
        cb[a] = *reinterpret_cast<const float4*>(
            base + (tj + a * L.T) * L.stride + 4 * k);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[a][c] = fmaf(ra[a].x, cb[c].x, acc[a][c]);
          acc[a][c] = fmaf(ra[a].y, cb[c].y, acc[a][c]);
          acc[a][c] = fmaf(ra[a].z, cb[c].z, acc[a][c]);
          acc[a][c] = fmaf(ra[a].w, cb[c].w, acc[a][c]);
        }
    }
    float* o = os + static_cast<size_t>(s) * L.n_pairs;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = ti + a * L.T, col = tj + c * L.T;
        if (r >= F || col >= F || r == col) continue;
        if (r < col)
          o[pair_index(r, col, F)] = acc[a][c];
        else if (ti != tj)                  // the transposed entry, once
          o[pair_index(col, r, F)] = acc[a][c];
      }
  }
  __syncthreads();

  T* ob = out + b0 * L.n_pairs;
  for (int idx = threadIdx.x; idx < n_here * L.n_pairs; idx += blockDim.x)
    ob[idx] = from_float<T>(os[idx]);
}

template <typename T>
int launch(const void* x, void* out, int B, int F, int D,
           cudaStream_t stream) {
  const Layout L = make_layout(F, D);
  const size_t smem = smem_bytes(L);
  auto kernel = dot_interaction_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || L.n_pairs == 0) return 0;
  const int blocks = (B + L.spb - 1) / L.spb;
  const int threads = (L.spb * L.n_tiles + 31) / 32 * 32;
  kernel<<<blocks, threads, smem, stream>>>(static_cast<const T*>(x),
                                            static_cast<T*>(out), B, F, D,
                                            L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a launch needs, so the wrapper can refuse shapes the card
// cannot hold (227 KB a block) before launching.
extern "C" long long dot_interaction_smem_bytes(int F, int D) {
  return static_cast<long long>(smem_bytes(make_layout(F, D)));
}

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream`; returns
// cudaGetLastError() (0 = ok).
extern "C" int dot_interaction_launch(const void* x, void* out, int B, int F,
                                      int D, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, B, F, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, B, F, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
