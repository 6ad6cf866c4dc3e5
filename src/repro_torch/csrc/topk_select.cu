// Top-k of a dense (N,) float32 or float64 score vector, ordered by
// (score desc, index asc), for sm_90a.
//
// Replaces the TPU kernel ``_topk_kernel`` / ``topk_select`` of
// src/repro/kernels/topk_select.py, which runs kb rounds of max + argmin
// over each (8*r, 128) block and merges the blocks with a host lexsort.
// The TPU kernel takes float32; float64 is added so that retrieval can
// rank BM25 scores summed in the Python oracle's own float64 arithmetic.
//
// Bound on this card: bytes. The function reads N scores and writes k
// values and k indices: N*4 + k*8 bytes in float32, 0.08 us at N = 65536
// and 3.35 TB/s, so at retrieval sizes the kernel sits at launch latency.
//
// Design. Each (score, index) becomes one key whose ascending order is
// (score desc, index asc): the bit-flipped order-preserving image of the
// score (-0.0 canonicalised to +0.0, so the two zeros tie and the index
// breaks the tie, as the oracle's sort of -scores does), then the index.
// In float32 the key packs into one u64 (score image in the high word);
// in float64 it is a (u64 score image, u32 index) pair. Padding is the
// all-ones key, which sorts after every genuine key (NEG_INF included).
//   * Reduce path (k <= TILE / 2, or N <= TILE): each CTA sorts a tile of
//     keys in shared memory (bitonic network) and keeps its first k; the
//     candidates shrink by TILE / k per pass until one CTA holds them
//     all, sorts them and decodes the first k keys. N = 65536 in float32
//     takes two launches, N = 1M three.
//   * Full-sort path (k > TILE / 2 and N > TILE): a bitonic sort of all
//     keys padded to a power of two, tile stages in shared memory and
//     the long strides as one global pass each; then the first k decode.
// Values are read back from the input at the decoded index, so they keep
// their exact bits (a -0.0 score comes back as -0.0). NaN scores are not
// ordered.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 1024;
constexpr int STEP_THREADS = 256;

// float32 scores: the key is one u64, 4096 keys (32 KiB) per tile.
struct F32 {
  typedef float Score;
  typedef u64 Key;
  static constexpr int TILE = 4096;
  __device__ static Key pad() { return ~0ull; }
  __device__ static Key make(float s, unsigned idx) {
    unsigned u = __float_as_uint(s);
    if ((u & 0x7fffffffu) == 0u) u = 0u;                // -0.0 -> +0.0
    unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((u64)(~ord) << 32) | (u64)idx;             // score desc
  }
  __device__ static bool greater(const Key& a, const Key& b) { return a > b; }
  __device__ static unsigned index(const Key& k) {
    return (unsigned)(k & 0xffffffffull);
  }
};

// float64 scores: the key is a (score image, index) pair, 2048 keys
// (32 KiB) per tile.
struct F64 {
  typedef double Score;
  struct Key {
    u64 hi;
    unsigned lo;
  };
  static constexpr int TILE = 2048;
  __device__ static Key pad() { return Key{~0ull, ~0u}; }
  __device__ static Key make(double s, unsigned idx) {
    u64 u = (u64)__double_as_longlong(s);
    if ((u & 0x7fffffffffffffffull) == 0ull) u = 0ull;  // -0.0 -> +0.0
    u64 ord = (u >> 63) ? ~u : (u | 0x8000000000000000ull);
    return Key{~ord, idx};                              // score desc
  }
  __device__ static bool greater(const Key& a, const Key& b) {
    return a.hi > b.hi || (a.hi == b.hi && a.lo > b.lo);
  }
  __device__ static unsigned index(const Key& k) { return k.lo; }
};

// Compare-exchange stages j = j_start .. 1 of bitonic merge ``kk`` over
// n keys in shared memory; ``gbase`` is the global position of s[0],
// which sets each pair's direction (ascending where (pos & kk) == 0).
template <class T>
__device__ void bitonic_steps(typename T::Key* s, int n, u64 kk,
                              int j_start, long long gbase) {
  for (int j = j_start; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
      int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
      typename T::Key a = s[i], b = s[i + j];
      bool up = (((u64)(gbase + i)) & kk) == 0;
      if (T::greater(a, b) == up) {
        s[i] = b;
        s[i + j] = a;
      }
    }
    __syncthreads();
  }
}

// Full bitonic sort of n (a power of two) keys in shared memory.
template <class T>
__device__ void bitonic_sort(typename T::Key* s, int n, long long gbase) {
  for (u64 kk = 2; kk <= (u64)n; kk <<= 1)
    bitonic_steps<T>(s, n, kk, (int)(kk >> 1), gbase);
}

// One reduce pass: CTA b sorts keys [b*sort_n, (b+1)*sort_n) ascending
// (built from ``scores`` on the first pass, else read from ``keys_in``)
// and writes its first ``keep`` keys to keys_out[b*keep ...]. With
// keys_out == nullptr (one CTA) it decodes them into out_v / out_i.
template <class T>
__global__ void __launch_bounds__(THREADS)
topk_tile_kernel(const typename T::Score* __restrict__ scores,
                 const typename T::Key* __restrict__ keys_in, long long n,
                 int sort_n, int keep, typename T::Key* __restrict__ keys_out,
                 const typename T::Score* __restrict__ orig,
                 typename T::Score* __restrict__ out_v,
                 int* __restrict__ out_i) {
  __shared__ typename T::Key s[T::TILE];
  long long base = (long long)blockIdx.x * sort_n;
  for (int t = threadIdx.x; t < sort_n; t += blockDim.x) {
    long long g = base + t;
    typename T::Key key = T::pad();
    if (g < n) key = scores ? T::make(scores[g], (unsigned)g) : keys_in[g];
    s[t] = key;
  }
  __syncthreads();
  bitonic_sort<T>(s, sort_n, 0);
  if (keys_out) {
    for (int t = threadIdx.x; t < keep; t += blockDim.x)
      keys_out[(long long)blockIdx.x * keep + t] = s[t];
  } else {
    for (int t = threadIdx.x; t < keep; t += blockDim.x) {
      unsigned idx = T::index(s[t]);
      out_i[t] = (int)idx;
      out_v[t] = orig[idx];
    }
  }
}

// Full-sort path, first stage: sort each TILE in the alternating
// direction of bitonic merge TILE, writing keys[] (padded to p).
template <class T>
__global__ void __launch_bounds__(THREADS)
bitonic_tiles_kernel(const typename T::Score* __restrict__ scores,
                     long long n, typename T::Key* __restrict__ keys) {
  __shared__ typename T::Key s[T::TILE];
  long long base = (long long)blockIdx.x * T::TILE;
  for (int t = threadIdx.x; t < T::TILE; t += blockDim.x) {
    long long g = base + t;
    s[t] = g < n ? T::make(scores[g], (unsigned)g) : T::pad();
  }
  __syncthreads();
  bitonic_sort<T>(s, T::TILE, base);
  for (int t = threadIdx.x; t < T::TILE; t += blockDim.x)
    keys[base + t] = s[t];
}

// Full-sort path: one compare-exchange stage of stride j >= TILE.
template <class T>
__global__ void bitonic_global_step(typename T::Key* __restrict__ keys,
                                    long long half, u64 kk, long long j) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half) return;
  long long i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  typename T::Key a = keys[i], b = keys[i + j];
  bool up = (((u64)i) & kk) == 0;
  if (T::greater(a, b) == up) {
    keys[i] = b;
    keys[i + j] = a;
  }
}

// Full-sort path: the strides below TILE of merge kk, in shared memory.
template <class T>
__global__ void __launch_bounds__(THREADS)
bitonic_merge_tiles(typename T::Key* __restrict__ keys, u64 kk) {
  __shared__ typename T::Key s[T::TILE];
  long long base = (long long)blockIdx.x * T::TILE;
  for (int t = threadIdx.x; t < T::TILE; t += blockDim.x)
    s[t] = keys[base + t];
  __syncthreads();
  bitonic_steps<T>(s, T::TILE, kk, T::TILE / 2, base);
  for (int t = threadIdx.x; t < T::TILE; t += blockDim.x)
    keys[base + t] = s[t];
}

template <class T>
__global__ void decode_kernel(const typename T::Key* __restrict__ keys,
                              const typename T::Score* __restrict__ orig,
                              int k, typename T::Score* __restrict__ out_v,
                              int* __restrict__ out_i) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= k) return;
  unsigned idx = T::index(keys[t]);
  out_i[t] = (int)idx;
  out_v[t] = orig[idx];
}

long long pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <class T>
bool full_sort(long long n, int k) {
  return n > T::TILE && 2LL * k > T::TILE;
}

template <class T>
long long scratch_bytes(long long n, int k) {
  long long keys;
  if (full_sort<T>(n, k)) {
    keys = pow2_at_least(n);
  } else {
    long long c1 = n > T::TILE ? ceil_div(n, T::TILE) * k : 0;
    long long c2 = c1 > T::TILE ? ceil_div(c1, T::TILE) * k : 0;
    keys = c1 + c2 > 0 ? c1 + c2 : 1;
  }
  return keys * (long long)sizeof(typename T::Key);
}

template <class T>
int launch(const typename T::Score* scores, long long n, int k,
           void* scratch, typename T::Score* out_v, int* out_i,
           cudaStream_t st) {
  typedef typename T::Key Key;
  Key* keys = (Key*)scratch;
  cudaError_t err;
  if (full_sort<T>(n, k)) {
    long long p = pow2_at_least(n);
    long long tiles = p / T::TILE;
    bitonic_tiles_kernel<T><<<(unsigned)tiles, THREADS, 0, st>>>(scores, n,
                                                                 keys);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    long long half = p / 2;
    unsigned step_blocks = (unsigned)ceil_div(half, STEP_THREADS);
    for (long long kk = 2LL * T::TILE; kk <= p; kk <<= 1) {
      for (long long j = kk / 2; j >= T::TILE; j >>= 1) {
        bitonic_global_step<T><<<step_blocks, STEP_THREADS, 0, st>>>(
            keys, half, (u64)kk, j);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      }
      bitonic_merge_tiles<T><<<(unsigned)tiles, THREADS, 0, st>>>(keys,
                                                                  (u64)kk);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    decode_kernel<T><<<(unsigned)ceil_div(k, STEP_THREADS), STEP_THREADS, 0,
                       st>>>(keys, scores, k, out_v, out_i);
    return (int)cudaGetLastError();
  }
  // Reduce path: ping-pong between two regions of the scratch keys.
  long long c1 = n > T::TILE ? ceil_div(n, T::TILE) * k : 0;
  Key* region[2] = {keys, keys + c1};
  const typename T::Score* src_scores = scores;
  const Key* src_keys = nullptr;
  long long count = n;
  int which = 0;
  while (count > T::TILE) {
    long long tiles = ceil_div(count, T::TILE);
    Key* dst = region[which];
    topk_tile_kernel<T><<<(unsigned)tiles, THREADS, 0, st>>>(
        src_scores, src_keys, count, T::TILE, k, dst, nullptr, nullptr,
        nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    src_scores = nullptr;
    src_keys = dst;
    count = tiles * k;
    which ^= 1;
  }
  int sort_n = (int)pow2_at_least(count);
  topk_tile_kernel<T><<<1, THREADS, 0, st>>>(src_scores, src_keys, count,
                                             sort_n, k, nullptr, scores,
                                             out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch memory topk_select_launch needs for (n, k); dtype 0 is
// float32, 1 is float64.
extern "C" long long topk_select_scratch_bytes(long long n, int k,
                                               int dtype) {
  return dtype == 1 ? scratch_bytes<F64>(n, k) : scratch_bytes<F32>(n, k);
}

// scores: (n,) float32 (dtype 0) or float64 (dtype 1) on the device;
// 1 <= k <= n < 2^31; scratch holds topk_select_scratch_bytes(n, k,
// dtype) bytes; out_v (k,) in the scores' type, out_i (k,) int32.
// Launches on ``stream``; returns the first CUDA error, or 0.
extern "C" int topk_select_launch(const void* scores, long long n, int k,
                                  int dtype, void* scratch, void* out_v,
                                  int* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<F64>((const double*)scores, n, k, scratch,
                       (double*)out_v, out_i, st);
  return launch<F32>((const float*)scores, n, k, scratch, (float*)out_v,
                     out_i, st);
}
