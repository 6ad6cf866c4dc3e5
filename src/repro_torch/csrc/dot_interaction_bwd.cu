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
// What held the first design back (one block a sample, one float4 of dx a
// thread): each thread read one 16-byte row chunk of x and one Gram entry
// from shared memory per 4 FMAs, each x row for one output row only, so
// shared memory paced it (1.2107 ms at B 65536 against 0.5683 of bytes);
// x was staged with 4-byte loads and dx written with 4-byte stores.
//
// Design: a persistent grid (as many blocks as fit) whose blocks walk
// samples, sums in float32 in a fixed order, no atomics. A block stages
// the next sample while it computes this one: float32 rows and the
// triangle's gradient arrive by `cp.async` (16-byte copies for the rows)
// into the other of two buffers; bf16, or rows whose bytes are not a
// multiple of 16, are staged with plain loads, converted to float32. The
// triangle's gradient is then scattered into a symmetric matrix with a
// zero diagonal, stored by columns in slices of kRows rows (each slice
// padded to 8 floats): Gs[j][slice][r] = G[slice kRows + r][j], which
// equals G[j][slice kRows + r]. A thread owns VW = 16 / sizeof(T)
// neighbouring columns (4 in f32, 8 in bf16) of the kRows output rows of
// one slice: kRows x VW accumulators. For each j it reads the VW values
// of row j of x once (16-byte loads, consecutive threads on consecutive
// chunks) and the slice's kRows Gram entries as two 16-byte loads (the
// same address for the threads of a warp, a broadcast), then does
// kRows x VW FMAs: each x row read serves the whole slice. Each output
// row's VW values leave as one 16-byte store. Where D is not a multiple
// of VW, or a pointer is not 16-byte aligned, a thread owns one column
// (the scalar path). One block a sample with synchronous staging took
// 0.8795 ms at B 65536 (chip_smoke.py, one H100 80GB HBM3, 700 W), and
// capping its registers at 64 for more resident blocks made it faster:
// the loads in flight, not the products, set the pace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 7;             // output rows a thread's slice
constexpr int kSlicePad = 8;         // floats a slice takes in Gs
constexpr int kMaxThreads = 256;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
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

__host__ __device__ inline int n_slices(int F) {
  return (F + kRows - 1) / kRows;
}

// Floats a Gram column takes in Gs.
__host__ __device__ inline int gram_stride(int F) {
  return n_slices(F) * kSlicePad;
}

// Floats of one staged triangle gradient, rounded up to 16 bytes.
__host__ __device__ inline int tri_floats(int F) {
  return (F * (F - 1) / 2 + 3) & ~3;
}

size_t smem_bytes(int F, int D) {
  return sizeof(float) * (static_cast<size_t>(F) * gram_stride(F) +
                          2 * (static_cast<size_t>(F) * D + tri_floats(F)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the last
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 16 bytes of T (VW values) as floats, and back.
__device__ __forceinline__ void widen(uint4 w, float (&v)[4]) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void widen(uint4 w, float (&v)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 narrow(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}
__device__ __forceinline__ uint4 narrow(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// Sample b's rows (as float32) and triangle gradient into one buffer.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const T* __restrict__ g, long long b,
                                      int n, int P, float* xs, float* gr) {
  constexpr int VW = 16 / sizeof(T);
  const T* xb = x + b * n;
  const T* gb = g + b * P;
  if constexpr (VEC && sizeof(T) == 4) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      cp_async16(xs + 4 * i, xb + 4 * i);
    for (int i = threadIdx.x; i < P; i += blockDim.x)
      cp_async4(gr + i, gb + i);
    return;
  }
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < n / VW; i += blockDim.x) {
      float v[VW];
      widen(reinterpret_cast<const uint4*>(xb)[i], v);
#pragma unroll
      for (int c = 0; c < VW; c += 4)
        *reinterpret_cast<float4*>(xs + VW * i + c) =
            make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = to_float(xb[i]);
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) gr[i] = to_float(gb[i]);
}

// 64 registers a thread in the float32 row path, so that more blocks
// (more samples' loads in flight) fit on an SM.
template <typename T, bool VEC>
constexpr int kMinBlocks = VEC && sizeof(T) == 4 ? 4 : 1;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, (kMinBlocks<T, VEC>))
dot_interaction_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           T* __restrict__ dx, int B, int F, int D) {
  constexpr int VW = 16 / sizeof(T);
  extern __shared__ __align__(16) float sm[];
  const int GS = gram_stride(F), ns = n_slices(F);
  const int n = F * D, P = F * (F - 1) / 2, TP = tri_floats(F);
  float* Gs = sm;                      // [F][GS]
  float* Xs = sm + F * GS;             // [2][n]
  float* Gr = Xs + 2 * n;              // [2][TP]
  const int cols = VEC ? D / VW : D;   // column groups (VW wide) or columns
  long long b = blockIdx.x;
  int buf = 0;
  if (b < B) stage<T, VEC>(x, g, b, n, P, Xs, Gr);
  cp_async_commit();
  for (; b < B; b += gridDim.x, buf ^= 1) {
    const long long next = b + gridDim.x;
    if (next < B)
      stage<T, VEC>(x, g, next, n, P, Xs + (buf ^ 1) * n,
                    Gr + (buf ^ 1) * TP);
    cp_async_commit();
    cp_async_wait_one();               // this sample's copies landed
    __syncthreads();
    const float* gr = Gr + buf * TP;
    for (int idx = threadIdx.x; idx < F * GS; idx += blockDim.x) {
      const int j = idx / GS, sl = (idx % GS) / kSlicePad;
      const int r = idx % kSlicePad, i = sl * kRows + r;
      float val = 0.f;
      if (r < kRows && i < F && i != j) {
        const int lo = min(i, j), hi = max(i, j);
        val = gr[lo * F - lo * (lo + 1) / 2 + hi - lo - 1];
      }
      Gs[idx] = val;
    }
    __syncthreads();
    const float* xs = Xs + buf * n;
    T* out = dx + b * n;
    for (int item = threadIdx.x; item < ns * cols; item += blockDim.x) {
      const int sl = item / cols, c = item % cols;
      constexpr int W = VEC ? VW : 1;
      float acc[kRows][W];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[r][w] = 0.f;
      const float* gcol = Gs + sl * kSlicePad;
      const float* xcol = xs + c * W;
      for (int j = 0; j < F; ++j) {
        const float4 g0 = *reinterpret_cast<const float4*>(gcol + j * GS);
        const float4 g1 =
            *reinterpret_cast<const float4*>(gcol + j * GS + 4);
        const float gv[kRows] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z};
        float xv[W];
        if constexpr (VEC) {
#pragma unroll
          for (int w = 0; w < W; w += 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(xcol + j * D + w);
            xv[w] = t.x;
            xv[w + 1] = t.y;
            xv[w + 2] = t.z;
            xv[w + 3] = t.w;
          }
        } else {
          xv[0] = xcol[j * D];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int w = 0; w < W; ++w)
            acc[r][w] = fmaf(gv[r], xv[w], acc[r][w]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = sl * kRows + r;
        if (i >= F) break;
        if constexpr (VEC) {
          *reinterpret_cast<uint4*>(out + i * D + c * W) = narrow(acc[r]);
        } else {
          out[i * D + c] = from_float<T>(acc[r][0]);
        }
      }
    }
    __syncthreads();                   // before the buffers are restaged
  }
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int B, int F, int D,
           cudaStream_t stream) {
  if (B == 0 || F == 0 || D == 0) return 0;
  constexpr int VW = 16 / sizeof(T);
  const bool vec = D % VW == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(dx)) % 16 == 0;
  const int items = n_slices(F) * (vec ? D / VW : D);
  const int threads = items >= kMaxThreads ? kMaxThreads
                                           : (items + 31) / 32 * 32;
  const size_t smem = smem_bytes(F, D);
  auto kernel = vec ? dot_interaction_bwd_kernel<T, true>
                    : dot_interaction_bwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(B < fit ? B : fit);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(x),
                                          static_cast<const T*>(g),
                                          static_cast<T*>(dx), B, F, D);
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
