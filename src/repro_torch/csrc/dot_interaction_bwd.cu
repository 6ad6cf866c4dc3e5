// DLRM dot interaction, backward: for out[b, p] = x[b, i] . x[b, j], (i, j)
// the p-th pair of np.triu_indices(F, 1), the gradient of the features
//   dx[b, i] = sum over j != i of g[b, pair(i, j)] x[b, j],
// in float32 sums, returned in x's type.
//
// The TPU kernel `dot_interaction` / `_dot_int_kernel` in
// src/repro/kernels/dot_interaction.py:48 (pallas_call at :61) has no
// backward: the JAX package differentiates its einsum and triangle gather
// with jax.grad. The port's forward on the card is the kernel
// (dot_interaction.cu), so its gradient is a kernel too.
// x: (B, F, D) f32 or bf16, contiguous; g: (B, F(F-1)/2) in x's type;
// dx: (B, F, D) in x's type.
//
// What bounds it on an H100: the bytes. At DLRM's training batch (B 65536,
// F 27, D 128, f32) it reads x (906 MB) and g (92 MB) and writes dx
// (906 MB): 0.57 ms at 3.35 TB/s, against 12.2 GFLOP of products.
//
// Design (simple first, deterministic: no atomics): one block per sample.
// The sample's F x D rows and its gradient, scattered into a symmetric
// F x F matrix with a zero diagonal, are staged in shared memory as
// float32; each thread computes whole entries of dx, each a sum over j in
// a fixed order, and writes them contiguously. Where D is a multiple of 4
// a thread takes 4 neighbouring columns of one row, reading x as float4:
// one shared-memory load of a row's 4 values and one of its Gram entry
// per 4 FMAs, instead of two loads per FMA, which paced the scalar form
// (1.75 ms at B 65536 against 0.57 of bytes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

// Floats of the Gram matrix, rounded up so that the rows after it start
// on a 16-byte boundary.
__host__ __device__ inline int gram_floats(int F) { return (F * F + 3) & ~3; }

size_t smem_bytes(int F, int D) {
  return sizeof(float) * (static_cast<size_t>(gram_floats(F)) +
                          static_cast<size_t>(F) * D);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_interaction_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           T* __restrict__ dx, int F, int D) {
  extern __shared__ __align__(16) float sm[];
  float* Gm = sm;                  // [F][F], symmetric, zero diagonal
  float* Xs = sm + gram_floats(F); // [F][D]
  const long long b = blockIdx.x;
  const int n = F * D, P = F * (F - 1) / 2;
  const T* xb = x + b * n;
  const T* gb = g + b * P;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
    Xs[idx] = to_float(xb[idx]);
  for (int idx = threadIdx.x; idx < F * F; idx += blockDim.x) {
    const int i = idx / F, j = idx % F;
    const int lo = min(i, j), hi = max(i, j);
    Gm[idx] = i == j ? 0.f
                     : to_float(gb[lo * F - lo * (lo + 1) / 2 + hi - lo - 1]);
  }
  __syncthreads();
  T* out = dx + b * n;
  if (D % 4 == 0) {
    for (int idx = threadIdx.x; idx < n / 4; idx += blockDim.x) {
      const int i = (4 * idx) / D, d = (4 * idx) % D;
      const float* grow = Gm + i * F;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < F; ++j) {
        const float g = grow[j];
        const float4 xv = *reinterpret_cast<const float4*>(Xs + j * D + d);
        acc.x = fmaf(g, xv.x, acc.x);
        acc.y = fmaf(g, xv.y, acc.y);
        acc.z = fmaf(g, xv.z, acc.z);
        acc.w = fmaf(g, xv.w, acc.w);
      }
      out[4 * idx] = from_float<T>(acc.x);
      out[4 * idx + 1] = from_float<T>(acc.y);
      out[4 * idx + 2] = from_float<T>(acc.z);
      out[4 * idx + 3] = from_float<T>(acc.w);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    const float* grow = Gm + i * F;
    float acc = 0.f;
    for (int j = 0; j < F; ++j) acc = fmaf(grow[j], Xs[j * D + d], acc);
    out[idx] = from_float<T>(acc);
  }
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int B, int F, int D,
           cudaStream_t stream) {
  if (B == 0 || F == 0 || D == 0) return 0;
  const size_t smem = smem_bytes(F, D);
  auto kernel = dot_interaction_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                        static_cast<const T*>(g),
                                        static_cast<T*>(dx), F, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a block takes for (F, D): the wrapper refuses more than a
// block has.
extern "C" long long dot_interaction_bwd_smem_bytes(int F, int D, int dtype) {
  (void)dtype;                     // staged as float32 in either type
  return static_cast<long long>(smem_bytes(F, D));
}

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream`; returns
// cudaGetLastError() (0 = ok).
extern "C" int dot_interaction_bwd_launch(const void* x, const void* g,
                                          void* dx, int B, int F, int D,
                                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, g, dx, B, F, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, g, dx, B, F, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
