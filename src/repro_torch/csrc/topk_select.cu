// Top-k of a dense (N,) float32 or float64 score vector, ordered by
// (score desc, index asc), for sm_90a.
//
// Replaces the TPU kernel ``_topk_kernel`` / ``topk_select`` of
// src/repro/kernels/topk_select.py:111 (pallas_call at :147), which runs
// kb rounds of max + argmin over each (8*r, 128) block and merges the
// blocks with a host lexsort. The TPU kernel takes float32; float64 is
// added so that retrieval can rank BM25 scores summed in the Python
// oracle's own float64 arithmetic.
//
// Bound on this card: bytes. The function reads N scores and writes k
// values and k indices: N*8 + k*12 bytes at the main path's float64
// N = 65536, k = 64, 0.16 us at 3.35 TB/s, below the launch floor (an
// empty kernel through the same ctypes route; chip_smoke.py times both).
//
// Keys. Each score becomes the bit-flipped order-preserving image of its
// bits (-0.0 canonicalised to +0.0, so the two zeros tie and the index
// breaks the tie, as the oracle's sort of -scores does): ascending image
// = descending score. The full key is (image, index); padding is the
// all-ones key, after every genuine key (NEG_INF included). Values are
// read back from the input at the decoded index, so they keep their exact
// bits (-0.0 comes back as -0.0). NaN scores are not ordered.
//
// What held the first design (bitonic sorts) back: at the main path's shape
// it made two serial launches of full bitonic sorts (66 barrier-separated
// shared-memory stages per 2048-key tile, 32 CTAs then one), keeping 64 keys
// of every 2048 it sorted.
//
// Design (N > TILE, k <= TILE / 2, which holds the main path): one launch
// of one thread-block cluster (8 CTAs, or 16 where a CTA's chunk would
// not fit in shared memory), each CTA owning a contiguous index range.
//   * Radix select on the image, 8 bits a pass, most significant first.
//     Each CTA builds its digit histogram in shared memory (warp-
//     aggregated atomics, so runs of equal scores cost one atomic per
//     warp) and adds it into the leader CTA's histogram through
//     distributed shared memory; after cluster.sync() every CTA reads the
//     merged histogram and picks the same digit. Each CTA first stages
//     its images in shared memory where they fit (8 x 64 KB at float64
//     N = 65536), every load in flight at once, so the passes read
//     shared memory, not L2; else each pass reads its chunk again.
//   * It stops once the keys whose image prefix is at or below the
//     chosen one number at most EARLY, or once the prefix is the whole
//     image T (then c_gt keys lie strictly above T).
//   * Candidates: every key below the prefix, and of the keys equal to
//     it either all (early stop) or the (k - c_gt) of smallest index. The
//     ties are taken by an ordered compaction: each warp owns a
//     contiguous index range, a warp ballot orders its lanes, a scan over
//     warps orders the CTA, and an exclusive scan over cluster ranks
//     (which follow index order) gives each CTA its offset. Nothing
//     depends on timing, so a call gives the same bits every run.
//   * The leader ranks its <= max(EARLY, k) candidates by the full key
//     (each candidate counts the smaller ones) and writes the first k.
// Other shapes: N <= TILE sorts the whole input in one CTA (bitonic, in
// shared memory); k > TILE / 2 with N > TILE (off every path of the
// system) is a bitonic sort of all keys padded to a power of two, tile
// stages in shared memory and the long strides one global pass each.
//
// Measured by chip_smoke.py on one NVIDIA H100 80GB HBM3 at 700.00 W, L2
// flushed between launches: 0.0191 ms at the main path's f64 N 65536,
// k 64 (the bitonic design: 0.1004; torch.topk 0.1189); 0.0192 ms at f32
// N 65536 (0.0554) and 0.0722 ms at f32 N 1048576 (0.1197), the latter
// with 16 CTAs walking their chunks from global memory (8 CTAs took
// 0.127 ms); the launch floor is 0.0048 ms. PERF.md keeps the current
// numbers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int STEP_THREADS = 256;
constexpr int RADIX_BITS = 8;
constexpr int BINS = 1 << RADIX_BITS;
constexpr int EARLY = 512;              // candidates the leader ranks at most
constexpr int MAX_CLUSTER = 16;
constexpr int STAGE_BYTES = 160 * 1024;  // a CTA's staged images at most
constexpr int BATCH = 4;                 // images a thread loads at once

// float32 scores: the key is one u64 (image in the high word), 4096 keys
// (32 KiB) per tile.
struct F32 {
  typedef float Score;
  typedef unsigned Radix;
  typedef u64 Key;
  static constexpr int TILE = 4096;
  static constexpr int BITS = 32;
  __device__ static Radix radix(float s) {
    unsigned u = __float_as_uint(s);
    if ((u & 0x7fffffffu) == 0u) u = 0u;                // -0.0 -> +0.0
    unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ~ord;                                        // score desc
  }
  __device__ static Key key(Radix r, unsigned idx) {
    return ((u64)r << 32) | (u64)idx;
  }
  __device__ static Key make(float s, unsigned idx) {
    return key(radix(s), idx);
  }
  __device__ static Key pad() { return ~0ull; }
  __device__ static bool greater(const Key& a, const Key& b) { return a > b; }
  __device__ static unsigned index(const Key& k) {
    return (unsigned)(k & 0xffffffffull);
  }
};

// float64 scores: the key is an (image, index) pair, 2048 keys (32 KiB)
// per tile.
struct F64 {
  typedef double Score;
  typedef u64 Radix;
  struct Key {
    u64 hi;
    unsigned lo;
  };
  static constexpr int TILE = 2048;
  static constexpr int BITS = 64;
  __device__ static Radix radix(double s) {
    u64 u = (u64)__double_as_longlong(s);
    if ((u & 0x7fffffffffffffffull) == 0ull) u = 0ull;  // -0.0 -> +0.0
    u64 ord = (u >> 63) ? ~u : (u | 0x8000000000000000ull);
    return ~ord;                                        // score desc
  }
  __device__ static Key key(Radix r, unsigned idx) { return Key{r, idx}; }
  __device__ static Key make(double s, unsigned idx) {
    return key(radix(s), idx);
  }
  __device__ static Key pad() { return Key{~0ull, ~0u}; }
  __device__ static bool greater(const Key& a, const Key& b) {
    return a.hi > b.hi || (a.hi == b.hi && a.lo > b.lo);
  }
  __device__ static unsigned index(const Key& k) { return k.lo; }
};

// Candidates the cluster path's leader holds: all keys at or below an
// early-stop prefix (<= EARLY), or exactly k <= TILE / 2.
template <class T>
__host__ __device__ constexpr int cand_cap() {
  return EARLY > T::TILE / 2 ? EARLY : T::TILE / 2;
}

// --------------------------------------------------------------------------
// Cluster radix select (N > TILE, k <= TILE / 2)
// --------------------------------------------------------------------------

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
topk_cluster_kernel(const typename T::Score* __restrict__ scores, long long n,
                    int k, int chunk, int staged,
                    typename T::Score* __restrict__ out_v,
                    int* __restrict__ out_i) {
  typedef typename T::Key Key;
  typedef typename T::Radix Radix;
  extern __shared__ __align__(16) unsigned char dyn[];
  Key* cand = reinterpret_cast<Key*>(dyn);                  // leader's
  Radix* stage = reinterpret_cast<Radix*>(dyn + cand_cap<T>() * sizeof(Key));
  __shared__ unsigned s_hist[3][BINS];     // leader's merged, 3 in turn
  __shared__ unsigned s_local[BINS];
  __shared__ unsigned s_tot[MAX_CLUSTER][2];
  __shared__ unsigned s_warp[WARPS][2];
  __shared__ unsigned s_sel[3];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)rank * chunk;
  const long long left = n - base;
  const int len = left <= 0 ? 0 : (left < chunk ? (int)left : chunk);

  for (int i = tid; i < 3 * BINS; i += THREADS) (&s_hist[0][0])[i] = 0u;
  for (int i = tid; i < BINS; i += THREADS) s_local[i] = 0u;
  unsigned* lead_hist = cluster.map_shared_rank(&s_hist[0][0], 0);
  unsigned* lead_tot = cluster.map_shared_rank(&s_tot[0][0], 0);
  Key* lead_cand = cluster.map_shared_rank(cand, 0);
  cluster.sync();            // every CTA running, the leader's bins zero

  auto image = [&](int i) -> Radix {
    return staged ? stage[i] : T::radix(scores[base + i]);
  };

  // Radix passes. ``prefix`` holds the chosen digits (the top BITS -
  // shift bits of the k-th image), ``below`` counts the keys whose top
  // bits lie below it, ``bucket`` those equal to it.
  Radix prefix = 0;
  unsigned below = 0, bucket = 0;
  int shift = T::BITS;
  if (staged) {              // every load in flight at once, then reuse
#pragma unroll 4
    for (int i = tid; i < len; i += THREADS)
      stage[i] = T::radix(scores[base + i]);
    __syncthreads();
  }
  for (int pass = 0;; ++pass) {
    shift -= RADIX_BITS;
    for (int i0 = 0; i0 < len; i0 += BATCH * THREADS) {
      Radix r[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = i0 + j * THREADS + tid;
        r[j] = i < len ? image(i) : (Radix)0;
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const bool in =
            i0 + j * THREADS + tid < len &&
            (pass == 0 || (r[j] >> (shift + RADIX_BITS)) == prefix);
        const unsigned digit = (unsigned)(r[j] >> shift) & (BINS - 1);
        const unsigned mask = __ballot_sync(~0u, in);
        if (in) {
          const unsigned peers = __match_any_sync(mask, digit);
          if (lane == __ffs(peers) - 1)
            atomicAdd(&s_local[digit], (unsigned)__popc(peers));
        }
      }
    }
    __syncthreads();
    unsigned* merged = lead_hist + (pass % 3) * BINS;
    if (tid < BINS && s_local[tid]) atomicAdd(merged + tid, s_local[tid]);
    cluster.sync();
    unsigned v = 0;
    if (tid < BINS) {
      v = merged[tid];
      s_local[tid] = 0u;
      // The buffer two passes on was last read in the previous pass, by
      // every CTA before this cluster.sync(): clear it for that pass.
      if (rank == 0) s_hist[(pass + 2) % 3][tid] = 0u;
    }
    // The bin holding the (k - below)-th key of the bucket.
    unsigned incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31 && warp < BINS / 32) s_warp[warp][0] = incl;
    __syncthreads();
    if (tid < BINS) {
      for (int w = 0; w < warp; ++w) incl += s_warp[w][0];
      const unsigned excl = incl - v, rem = (unsigned)k - below;
      if (excl < rem && rem <= incl) {
        s_sel[0] = tid;
        s_sel[1] = excl;
        s_sel[2] = v;
      }
    }
    __syncthreads();
    prefix = (prefix << RADIX_BITS) | (Radix)s_sel[0];
    below += s_sel[1];
    bucket = s_sel[2];
    if (below + bucket <= (unsigned)EARLY || shift == 0) break;
  }
  // Of the keys equal to the prefix: all on an early stop, else the
  // (k - below) of smallest index.
  const unsigned need =
      below + bucket <= (unsigned)EARLY ? bucket : (unsigned)k - below;

  // Ordered compaction. Warp w owns [s0, s1) of the CTA's range; count
  // first, then scan over warps and over cluster ranks.
  const int seg = (len + WARPS - 1) / WARPS;
  const int s0 = min(len, warp * seg), s1 = min(len, s0 + seg);
  unsigned lt = 0, eq = 0;
#pragma unroll 4
  for (int i = s0 + lane; i < s1; i += 32) {
    const Radix top = image(i) >> shift;
    lt += top < prefix;
    eq += top == prefix;
  }
  for (int o = 16; o > 0; o >>= 1) {
    lt += __shfl_xor_sync(~0u, lt, o);
    eq += __shfl_xor_sync(~0u, eq, o);
  }
  __syncthreads();                       // s_warp's last readers are done
  if (lane == 0) {
    s_warp[warp][0] = lt;
    s_warp[warp][1] = eq;
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned a = s_warp[lane][0], b = s_warp[lane][1];
    unsigned ia = a, ib = b;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned ta = __shfl_up_sync(~0u, ia, o);
      const unsigned tb = __shfl_up_sync(~0u, ib, o);
      if (lane >= o) {
        ia += ta;
        ib += tb;
      }
    }
    s_warp[lane][0] = ia - a;
    s_warp[lane][1] = ib - b;
    if (lane == 31) {
      lead_tot[2 * rank] = ia;
      lead_tot[2 * rank + 1] = ib;
    }
  }
  cluster.sync();
  if (tid == 0) {
    unsigned lo = 0, eo = 0;
    for (unsigned r = 0; r < rank; ++r) {
      lo += lead_tot[2 * r];
      eo += lead_tot[2 * r + 1];
    }
    s_sel[0] = lo;
    s_sel[1] = eo;
  }
  __syncthreads();
  unsigned lt_pos = s_sel[0] + s_warp[warp][0];
  unsigned eq_rank = s_sel[1] + s_warp[warp][1];
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int i0 = s0; i0 < s1; i0 += 32) {
    const int i = i0 + lane;
    const bool have = i < s1;
    const Radix r = have ? image(i) : (Radix)0;
    const Radix top = r >> shift;
    const bool is_lt = have && top < prefix, is_eq = have && top == prefix;
    const unsigned ml = __ballot_sync(~0u, is_lt);
    const unsigned me = __ballot_sync(~0u, is_eq);
    const unsigned idx = (unsigned)(base + i);
    if (is_lt) lead_cand[lt_pos + __popc(ml & lanes_below)] = T::key(r, idx);
    if (is_eq) {
      const unsigned rk = eq_rank + __popc(me & lanes_below);
      if (rk < need) lead_cand[below + rk] = T::key(r, idx);
    }
    lt_pos += __popc(ml);
    eq_rank += __popc(me);
  }
  cluster.sync();                        // every candidate has landed
  if (rank != 0) return;

  // The leader ranks its m candidates by the full key: tpc lanes count,
  // for one candidate, the candidates below it.
  const int m = (int)(below + need);
  int tpc = 1;
  while (tpc < 32 && m * tpc * 2 <= THREADS) tpc <<= 1;
  const int per_round = THREADS / tpc, sub = tid % tpc;
  for (int b0 = 0; b0 < m; b0 += per_round) {
    const int i = b0 + tid / tpc;
    unsigned cnt = 0;
    Key mine = T::pad();
    if (i < m) {
      mine = cand[i];
      for (int j = sub; j < m; j += tpc) cnt += T::greater(mine, cand[j]);
    }
    for (int o = tpc / 2; o > 0; o >>= 1) cnt += __shfl_xor_sync(~0u, cnt, o);
    if (i < m && sub == 0 && cnt < (unsigned)k) {
      const unsigned idx = T::index(mine);
      out_i[cnt] = (int)idx;
      out_v[cnt] = scores[idx];
    }
  }
}

// --------------------------------------------------------------------------
// N <= TILE: one CTA sorts everything; k > TILE / 2: a full bitonic sort
// --------------------------------------------------------------------------

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

// One CTA sorts the n <= sort_n <= TILE keys and decodes the first k.
template <class T>
__global__ void __launch_bounds__(THREADS)
topk_tile_kernel(const typename T::Score* __restrict__ scores, long long n,
                 int sort_n, int k, typename T::Score* __restrict__ out_v,
                 int* __restrict__ out_i) {
  __shared__ typename T::Key s[T::TILE];
  for (int t = threadIdx.x; t < sort_n; t += blockDim.x)
    s[t] = t < n ? T::make(scores[t], (unsigned)t) : T::pad();
  __syncthreads();
  bitonic_sort<T>(s, sort_n, 0);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    unsigned idx = T::index(s[t]);
    out_i[t] = (int)idx;
    out_v[t] = scores[idx];
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

__global__ void empty_kernel() {}

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
  if (!full_sort<T>(n, k)) return 0;
  return pow2_at_least(n) * (long long)sizeof(typename T::Key);
}

template <class T>
bool stages(long long n, int cluster) {
  return ceil_div(n, cluster) * (long long)sizeof(typename T::Radix) <=
         STAGE_BYTES;
}

template <class T>
size_t cluster_smem(long long n, int cluster) {
  long long chunk = ceil_div(n, cluster);
  return cand_cap<T>() * sizeof(typename T::Key) +
         (stages<T>(n, cluster) ? chunk * sizeof(typename T::Radix) : 0);
}

// The cluster kernel's attributes, set once a device: room for the most
// dynamic shared memory a launch gives it, and the non-portable cluster
// size of 16 CTAs.
template <class T>
cudaError_t prepare() {
  constexpr int DEVICES = 64;
  static bool ready[DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < DEVICES && ready[dev])) return err;
  auto kernel = topk_cluster_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(cand_cap<T>() * sizeof(typename T::Key) + STAGE_BYTES));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < DEVICES) ready[dev] = true;
  return err;
}

// 8 CTAs where each one's chunk stages in shared memory, else 16 (a
// non-portable size), so that twice the SMs walk the chunks: at f32
// N 1048576 on an H100, 16 CTAs reading from L2 beat 8 (PERF.md).
template <class T>
int cluster_size(long long n) {
  return stages<T>(n, 8) ? 8 : MAX_CLUSTER;
}

template <class T>
int launch(const typename T::Score* scores, long long n, int k, void* scratch,
           typename T::Score* out_v, int* out_i, cudaStream_t st) {
  typedef typename T::Key Key;
  cudaError_t err;
  if (n <= T::TILE) {
    topk_tile_kernel<T><<<1, THREADS, 0, st>>>(
        scores, n, (int)pow2_at_least(n), k, out_v, out_i);
    return (int)cudaGetLastError();
  }
  if (full_sort<T>(n, k)) {
    Key* keys = (Key*)scratch;
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
  if ((err = prepare<T>()) != cudaSuccess) return (int)err;
  const int cluster = cluster_size<T>(n);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = cluster_smem<T>(n, cluster);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, topk_cluster_kernel<T>, scores, n, k,
                           (int)ceil_div(n, cluster),
                           (int)stages<T>(n, cluster), out_v, out_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch memory topk_select_launch needs for (n, k); dtype 0 is
// float32, 1 is float64. Only the full-sort path (k > TILE / 2 < n) uses
// any.
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
    return launch<F64>((const double*)scores, n, k, scratch, (double*)out_v,
                       out_i, st);
  return launch<F32>((const float*)scores, n, k, scratch, (float*)out_v,
                     out_i, st);
}

// An empty kernel launched through the same route: the card's launch
// floor, which the bytes bound of the main path's shape lies below.
extern "C" int topk_select_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
