// DLRM dot interaction: for (B, F, D) features, the strict upper
// triangle of each sample's F x F Gram matrix, (B, F(F-1)/2), in the
// order of np.triu_indices(F, 1). The full Gram is never stored.
//
// Replaces the TPU kernel `dot_interaction` / `_dot_int_kernel` in
// src/repro/kernels/dot_interaction.py:48 (pallas_call at :61). The TPU
// kernel gathers the triangle with a 0/1 selection-matrix GEMM, the MXU's
// idiom for a gather; here each Gram entry is written straight to its
// triangle index instead.
// x: (B, F, D) f32 or bf16, contiguous; output (B, F(F-1)/2) in x's type,
// sums in f32.
//
// What bounds it on an H100: the bytes. At DLRM's shapes (F = 27,
// D = 128, f32) a sample is 13.8 KB read and 1.4 KB written for 45k
// multiply-adds; at B = 3072 the bound is 46.8 MB / 3.35 TB/s = 14.0 us.
//
// What held the first design (FMA tiles) back: a block staged its samples
// with synchronous loads, waited, computed, waited and stored, so no block
// overlapped its loads with its arithmetic; and its 4 x 4 FMA tiles read 8
// shared-memory vectors per 64 FMAs, so shared memory, not HBM, paced the
// arithmetic.
//
// Design: a persistent grid (as many blocks as fit on the card) walks
// groups of samples (up to 192 threads' worth: one sample at DLRM's
// F 27, so that several blocks share an SM) through a ring of up to three
// shared-memory stages. The rows of the groups ahead are requested with
// bulk asynchronous copies (`cp.async.bulk`, one a row, completing on the
// stage's mbarrier) before the current group's Gram tiles are computed,
// so HBM stays busy while the tensor cores run. Rows keep x's type in
// shared memory; padding columns up to a multiple of 8 are zeroed once,
// and rows past F read a shared zero row. Rows whose bytes are not a
// multiple of 16, or an unaligned x, are staged with plain loads instead.
//
// A sample's Gram is computed as the m16n8 tiles that cover its upper
// triangle, up to 16 warps a sample, each taking every 16th tile. float32
// inputs take the 3xTF32 split: hi is x rounded to tf32 and lo = x - hi
// rounded to tf32, and a tile takes hi*hi, hi*lo and lo*hi as three TF32
// m16n8k8 `mma.sync` products (lo*lo, at most 2^-22 of a term, is left out):
// under 2^-20 relative error a term, of either sign, where one TF32 product
// alone would miss the 1e-4 tolerance. bf16 inputs are exact in tf32 and
// take the one product. The column pair a lane holds is k and k + 1 for both
// operands (the dot product does not care which k pairs with which fragment
// slot), so a lane reads one 8-byte f32 pair or one 4-byte bf16 pair; the
// row stride puts a warp's reads in distinct banks. The entries land in a
// shared output tile, which the block stores as one contiguous run: scalar
// stores up to a 16-byte boundary, then 16-byte stores.
//
// Measured by chip_smoke.py on one NVIDIA H100 80GB HBM3 at 700.00 W, L2
// flushed between launches (f32, F 27, D 128): 0.0416 ms at B 3072 and
// 0.0512 ms at B 4096 (the FMA-tile design: 0.0678 / 0.0954; torch.bmm +
// triangle gather, two calls: 0.0552 / 0.0686; one read-only torch.sum
// over the same input, the floor a pass over these bytes met under that
// flush: 0.0308 / 0.0369); max abs error 5.96e-07 on the DLRM
// evaluator's own features. PERF.md keeps the current numbers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int MAX_SMEM = 232448;     // an H100 block's shared memory
constexpr int MAX_STAGES = 3;
constexpr int SAMPLE_WARPS = 16;     // warps a sample at most
constexpr int GROUP_THREADS = 192;   // samples are added up to this

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T from the floats at v (4 in f32, 8 in bf16).
__device__ __forceinline__ uint4 pack16(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const float* v, __nv_bfloat16) {
  return make_uint4(tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]),
                    tc::pack_bf16(v[4], v[5]), tc::pack_bf16(v[6], v[7]));
}

// x rounded to the nearest tf32 (10 mantissa bits, ties away from zero)
// by integer operations: cvt.rna runs at a quarter of the ALU rate.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The (k, k + 1) pair of a staged row as tf32 operands. f32: hi, x
// rounded to tf32, and lo = x - hi (exact, at most 2^-11 |x|) rounded to
// tf32, so that both carry unbiased errors. bf16: widened exactly, no lo.
__device__ __forceinline__ void split_pair(const float* p, uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  hi[0] = to_tf32(v.x);
  hi[1] = to_tf32(v.y);
  lo[0] = to_tf32(v.x - __uint_as_float(hi[0]));
  lo[1] = to_tf32(v.y - __uint_as_float(hi[1]));
}
__device__ __forceinline__ void split_pair(const __nv_bfloat16* p,
                                           uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  hi[0] = w << 16;
  hi[1] = w & 0xffff0000u;
  lo[0] = lo[1] = 0u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(tc::smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(tc::smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(tc::smem_addr(bar)), "r"(parity)
                 : "memory");
}
// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(tc::smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(tc::smem_addr(bar)) : "memory");
}

// Index of pair (r, c), r < c, in np.triu_indices(F, 1) order.
__device__ __forceinline__ int pair_index(int r, int c, int F) {
  return r * F - r * (r + 1) / 2 + (c - r - 1);
}

// Accumulators a tile keeps: for f32 one for hi*hi and one for the cross
// terms hi*lo + lo*hi, so the small terms sum apart; for bf16 one (its
// one product is exact).
template <typename T>
__host__ __device__ constexpr int kProducts() {
  return sizeof(T) == 4 ? 2 : 1;
}

// One k step of 8 (a lane's column pair at `col`) of tile (mt, nt).
template <typename T>
__device__ __forceinline__ void gram_step(const T* base, const T* zero_row,
                                          int stride, int F, int col, int mt,
                                          int nt, int grp,
                                          float (&acc)[kProducts<T>()][4]) {
  const int r0 = mt * 16 + grp, r1 = r0 + 8;   // A rows
  const int n = nt * 8 + grp;                 // B: row n of x, as k x n
  uint32_t h0[2], l0[2], h1[2], l1[2], hn[2], ln[2];
  split_pair((r0 < F ? base + r0 * stride : zero_row) + col, h0, l0);
  split_pair((r1 < F ? base + r1 * stride : zero_row) + col, h1, l1);
  split_pair((n < F ? base + n * stride : zero_row) + col, hn, ln);
  const uint32_t a[4] = {h0[0], h1[0], h0[1], h1[1]};
  mma_tf32(acc[0], a, hn[0], hn[1]);
  if constexpr (kProducts<T>() == 2) {
    const uint32_t al[4] = {l0[0], l1[0], l0[1], l1[1]};
    mma_tf32(acc[1], a, ln[0], ln[1]);
    mma_tf32(acc[1], al, hn[0], hn[1]);
  }
}

struct Layout {
  int n_nt;      // 8-column tiles: ceil(F / 8); 16-row tiles: ceil(F / 16)
  int n_tiles;   // m16n8 tiles on or above the diagonal
  int warps;     // warps a sample, each taking every warps-th tile
  int k_pad;     // D rounded up to 8 (zero columns past D)
  int stride;    // elements a staged row
  int n_pairs;   // F (F - 1) / 2
  int group;     // samples a group
  int stages;    // groups a block holds: stages - 1 requested ahead
  int threads;   // group * warps * 32
};

inline size_t smem_bytes(const Layout& L, int F, int group, int stages,
                         size_t size) {
  const size_t rows = static_cast<size_t>(stages) * group * F + 1;  // + zeros
  return rows * L.stride * size +
         sizeof(float) * static_cast<size_t>(group) * L.n_pairs;
}

inline Layout make_layout(int F, int D, size_t size) {
  Layout L;
  const int n_mt = (F + 15) / 16;
  L.n_nt = (F + 7) / 8;
  L.n_tiles = 0;
  for (int mt = 0; mt < n_mt; ++mt) L.n_tiles += L.n_nt - 2 * mt;
  L.warps = L.n_tiles < SAMPLE_WARPS ? L.n_tiles : SAMPLE_WARPS;
  L.k_pad = (D + 7) / 8 * 8;
  // Row stride in 4-byte words: 8 mod 32 for f32 (a half warp's 8-byte
  // reads of 4 rows x 4 column pairs), 4 mod 32 for bf16 (a warp's 4-byte
  // reads of 8 rows x 4 pairs): distinct banks.
  const int words = static_cast<int>(L.k_pad * size / 4);
  const int want = size == 4 ? 8 : 4;
  L.stride = static_cast<int>((words + ((want - words) % 32 + 32) % 32) * 4 /
                              size);
  L.n_pairs = F * (F - 1) / 2;
  // Samples up to GROUP_THREADS threads (at least one), so that two or
  // more blocks share an SM: the group's output run is then not always
  // 16-byte aligned, and its store starts with a few scalar stores.
  const int per_sample = 32 * L.warps;
  int g = GROUP_THREADS / per_sample > 1 ? GROUP_THREADS / per_sample : 1;
  while (g > 1 && smem_bytes(L, F, g, 1, size) > MAX_SMEM) --g;
  L.group = g;
  L.stages = MAX_STAGES;
  while (L.stages > 1 && smem_bytes(L, F, g, L.stages, size) > MAX_SMEM)
    --L.stages;
  L.threads = g * per_sample;
  return L;
}

// MAX_THREADS >= blockDim.x; the launch takes the least of 256, 512 and
// 1024 that holds the block, so that a thread may keep its tiles' sums
// and fragments in registers (65536 / MAX_THREADS of them).
template <typename T, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
dot_interaction_kernel(const T* __restrict__ x, T* __restrict__ out, int B,
                       int F, int D, Layout L, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[MAX_STAGES];
  constexpr int E = 16 / sizeof(T);
  T* xs = reinterpret_cast<T*>(smem);     // [stages][group][F][stride]
  const size_t per_sample = static_cast<size_t>(F) * L.stride;
  const size_t per_stage = per_sample * L.group;
  T* zero_row = xs + L.stages * per_stage;
  float* os = reinterpret_cast<float*>(zero_row + L.stride);
  const int n_groups = (B + L.group - 1) / L.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;

  // Zero the padding columns of every staged row and the zero row (the
  // copies never write them), and set up the stage barriers.
  const int pad = L.stride - D;
  for (int i = threadIdx.x; i < (L.stages * L.group * F + 1) * pad;
       i += blockDim.x) {
    const int row = i / pad;
    xs[static_cast<size_t>(row) * L.stride + D + i % pad] = from_float<T>(0.f);
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    zero_row[i] = from_float<T>(0.f);
  if (threadIdx.x == 0) {
    for (int j = 0; j < L.stages; ++j) mbar_init(&bars[j]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Group gi into stage j: one bulk copy a row from warp 0 (the copies
  // complete on bars[j]), or plain loads by every warp.
  auto stage = [&](long long gi, int j) {
    const long long b0 = gi * L.group;
    const int n = B - b0 < L.group ? static_cast<int>(B - b0) : L.group;
    T* dst = xs + j * per_stage;
    const T* src = x + b0 * F * static_cast<long long>(D);
    if (bulk) {
      if (warp != 0) return;
      if (lane == 0)
        mbar_expect(&bars[j], static_cast<unsigned>(n * F * D * sizeof(T)));
      __syncwarp();
      for (int row = lane; row < n * F; row += 32)
        bulk_copy(dst + static_cast<size_t>(row) * L.stride,
                  src + static_cast<long long>(row) * D,
                  static_cast<unsigned>(D * sizeof(T)), &bars[j]);
      return;
    }
    for (int row = warp; row < n * F; row += blockDim.x >> 5)
      for (int col = lane; col < D; col += 32)
        dst[static_cast<size_t>(row) * L.stride + col] =
            src[static_cast<long long>(row) * D + col];
  };

  // Warp w of sample s takes tiles w, w + warps, ... (tile t counts the
  // row tiles mt, then their column tiles nt >= 2 mt).
  const int s = warp / L.warps, w = warp % L.warps;

  // A ring of L.stages buffers: group g + j * gridDim.x lands in stage
  // (iteration + j) % L.stages, requested L.stages - 1 iterations ahead.
  int g = blockIdx.x;
  for (int j = 0; j + 1 < L.stages; ++j) {
    const long long gj = g + static_cast<long long>(j) * gridDim.x;
    if (gj < n_groups) stage(gj, j);
  }
  for (int it = 0; g < n_groups; g += gridDim.x, ++it) {
    const long long b0 = static_cast<long long>(g) * L.group;
    const long long ahead =
        g + static_cast<long long>(L.stages - 1) * gridDim.x;
    if (ahead < n_groups) stage(ahead, (it + L.stages - 1) % L.stages);
    const int buf = it % L.stages;
    if (bulk) mbar_wait(&bars[buf], (it / L.stages) & 1);
    __syncthreads();

    const long long left = B - b0;
    const int n_here = left < L.group ? static_cast<int>(left) : L.group;
    if (s < n_here) {
      const T* base = xs + buf * per_stage + s * per_sample;
      float* o = os + s * L.n_pairs;
      for (int t = w; t < L.n_tiles; t += L.warps) {
        int mt = 0, nt = t;
        while (nt >= L.n_nt - 2 * mt) {
          nt -= L.n_nt - 2 * mt;
          ++mt;
        }
        nt += 2 * mt;
        // Even and odd k steps sum apart, and so do the tile's products:
        // independent mma chains.
        float acc[2][kProducts<T>()][4] = {};
        for (int k0 = 0; k0 < L.k_pad; k0 += 16) {
          gram_step(base, zero_row, L.stride, F, k0 + 2 * tig, mt, nt, grp,
                    acc[0]);
          if (k0 + 8 < L.k_pad)
            gram_step(base, zero_row, L.stride, F, k0 + 8 + 2 * tig, mt, nt,
                      grp, acc[1]);
        }
        const int r = mt * 16 + grp, c = nt * 8 + 2 * tig;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = r + (e >> 1) * 8, cc = c + (e & 1);
          float sum = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int p = 0; p < kProducts<T>(); ++p) sum += acc[h][p][e];
          if (rr < cc && cc < F) o[pair_index(rr, cc, F)] = sum;
        }
      }
    }
    __syncthreads();

    // The group's entries as one contiguous run: scalar stores up to a
    // 16-byte boundary, then 16-byte stores, then the tail.
    T* dst = out + b0 * L.n_pairs;
    const int count = n_here * L.n_pairs;
    const uintptr_t mis = reinterpret_cast<uintptr_t>(dst) & 15;
    int head = static_cast<int>(((16 - mis) & 15) / sizeof(T));
    if (head > count) head = count;
    const int body = (count - head) / E;
    for (int i = threadIdx.x; i < head; i += blockDim.x)
      dst[i] = from_float<T>(os[i]);
    for (int v = threadIdx.x; v < body; v += blockDim.x)
      reinterpret_cast<uint4*>(dst + head)[v] = pack16(os + head + v * E, T());
    for (int i = head + body * E + threadIdx.x; i < count; i += blockDim.x)
      dst[i] = from_float<T>(os[i]);
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int F, int D,
           cudaStream_t stream) {
  const Layout L = make_layout(F, D, sizeof(T));
  const size_t smem = smem_bytes(L, F, L.group, L.stages, sizeof(T));
  auto kernel = L.threads <= 256   ? dot_interaction_kernel<T, 256>
                : L.threads <= 512 ? dot_interaction_kernel<T, 512>
                                   : dot_interaction_kernel<T, 1024>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || L.n_pairs == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, L.threads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int n_groups = (B + L.group - 1) / L.group;
  const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = n_groups < fit ? n_groups : static_cast<int>(fit);
  // Bulk copies need 16-byte rows and a 16-byte aligned x.
  const bool bulk = (static_cast<size_t>(D) * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<blocks, L.threads, smem, stream>>>(static_cast<const T*>(x),
                                              static_cast<T*>(out), B, F, D,
                                              L, bulk ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a launch needs (dtype 0 = float32, 1 = bfloat16), so the
// wrapper can refuse shapes the card cannot hold (227 KB a block) before
// launching.
extern "C" long long dot_interaction_smem_bytes(int F, int D, int dtype) {
  const size_t size = dtype == 1 ? 2 : 4;
  const Layout L = make_layout(F, D, size);
  return static_cast<long long>(smem_bytes(L, F, L.group, L.stages, size));
}

// Samples a group for (F, D, dtype): the tests pick B and F to reach each
// edge of the group walk.
extern "C" int dot_interaction_group(int F, int D, int dtype) {
  return make_layout(F, D, dtype == 1 ? 2 : 4).group;
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
