// Fused Trust-DB probe + load-shedding tier assignment for one micro-batch.
//
// Replaces the TPU kernel `shed_partition` / `_shed_kernel` in
// src/repro/kernels/shed_partition.py (pallas_call at :257). Per item of an
// arrival-ordered batch it computes the tier (EVAL / CACHED / PRIOR /
// INVALID), the cached trust value, and the compacted eval rank (arrival
// position among EVAL items, -1 otherwise).
//
// What bounds it on an H100: not bytes. At the serving batch (N 4096) it
// reads ~20 B of keys, flags and cache entries and writes 12 B per item,
// ~0.12 MB in all: 0.04 us at 3.35 TB/s, far below the ~4.5 us one launch
// costs. What it pays beyond the launch is the Trust DB probe, four
// scattered cache lines a valid item in the production (ways-leading)
// layout plus one for a hit's value, and the chain of dependent round
// trips (keys, way keys, value) and barriers. One SM looks up ~2.4k such
// lines a microsecond, so on one CTA the probe alone took ~0.007 ms at
// N 4096, cold or warm (PERF.md); spread over 8 SMs it takes ~0.0014.
//
// Why one scan is enough. Every Normal-queue item precedes every Drop-queue
// item in arrival order. Let pos be the number of valid items before an
// item and h the number of valid, non-hit items before it. Then, for any
// validity mask:
//   * the compacted eval rank of every EVAL item is h (every earlier
//     non-hit item of the Normal queue is EVAL, and the Drop queue's EVAL
//     items are a prefix of its candidates);
//   * a valid non-hit item is EVAL iff pos < ucap, or h < budget with a
//     total budget (h - NE is its drop-queue rank, NE the Normal queue's
//     eval count, and the drop-queue budget is budget - NE), or
//     h - NE < budget with a drop-queue budget.
// So the TPU kernel's three dependent scans (arrival position; normal
// evals and drop candidates; EVAL rank) fold into ONE scan of the packed
// pair (valid, valid & !hit).
//
// Design: one cluster of 8 CTAs of 128 threads. A round of up to 8192
// items is cut into one contiguous chunk a CTA and kItems consecutive
// items a thread, kItems in {1, 2, 4, 8} the least whose round covers
// min(N, 8192): the main path's batches (N 3072 and 4096, kItems 4) take
// one round with every thread busy, and threads past N skip to the scan.
//   1. keys load as 16-byte vectors and flags as 4-byte words where the
//      pointers and N allow, else item by item;
//   2. the probe issues every way's key load of all of a thread's items
//      before any compare (n_ways == 4, the production Trust DB, is a
//      template), takes the first matching way, then loads the hits'
//      values: two round trips with no chain between the ways; other
//      n_ways take a generic loop that stops at the first match. Offsets
//      into the Trust DB are 32-bit, the set index a mask where the set
//      count is a power of two;
//   3. a thread-serial prefix over its items, one warp-shuffle scan and
//      one pass over the 4 warp totals give each thread its offset in the
//      CTA; thread 0 posts the CTA's packed count in shared memory, and
//      after one cluster barrier every thread reads the 8 counts through
//      distributed shared memory: pos and h. Each half of a packed pair
//      counts at most the 8192 items of one round; the running totals
//      across rounds (N > 8192) are 32-bit;
//   4. with a drop-queue budget the thread holding arrival position
//      ucap - 1 posts NE in its CTA's shared memory, read by all after
//      one more cluster barrier, in that round only;
//   5. outputs store as 16-byte vectors where aligned; a last cluster
//      barrier keeps every CTA's counts alive until all have read them.
// The kernel allocates nothing and needs no scratch. Keys are uint32 (the
// wrapper hands int32 tensors holding the bit pattern); key 0 means an
// empty way and never hits, and invalid items do not probe.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                  // CTAs, on 8 SMs
constexpr int kThreads = 128;                // a CTA's threads
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 8;                 // items a thread owns, at most
constexpr int kMaxRound = kCluster * kThreads * kMaxItems;
constexpr int TIER_EVAL = 0;
constexpr int TIER_CACHED = 1;
constexpr int TIER_PRIOR = 2;
constexpr int TIER_INVALID = 3;

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The Trust DB in either layout: entry (way w, slot s) lies at
// s * slot_stride + w * way_stride (32-bit: the wrapper checks the size).
struct TrustDB {
  const uint32_t* __restrict__ keys;
  const float* __restrict__ values;
  uint32_t n_slots;
  uint32_t slot_stride, way_stride;
  int n_ways;

  __device__ __forceinline__ uint32_t slot_of(uint32_t key) const {
    const uint32_t h = hash32(key);
    return (n_slots & (n_slots - 1)) == 0 ? h & (n_slots - 1) : h % n_slots;
  }
  __device__ __forceinline__ uint32_t at(int w, uint32_t slot) const {
    return slot * slot_stride + static_cast<uint32_t>(w) * way_stride;
  }
};

// Probe of a thread's items with kWays ways: every way's key load of every
// item is issued before any compare, then the first matching way's value.
// (Loading every way's value beside its key saves that second round trip
// but doubles the cache lines one SM looks up, and was slower: PERF.md.)
// Returns the hit mask; `val` receives the hits' values, 0 elsewhere.
template <int kWays, int kItems>
__device__ __forceinline__ uint32_t probe_fixed(const TrustDB& db,
                                                const uint32_t (&key)[kItems],
                                                uint32_t probe,
                                                float (&val)[kItems]) {
  uint32_t slot[kItems];
  uint32_t way_key[kItems][kWays];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    slot[i] = db.slot_of(key[i]);
    const bool p = (probe >> i) & 1u;
#pragma unroll
    for (int w = 0; w < kWays; ++w)
      way_key[i][w] = p ? __ldg(db.keys + db.at(w, slot[i])) : 0u;
  }
  uint32_t hit = 0;
  int way[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    way[i] = kWays;
#pragma unroll
    for (int w = kWays - 1; w >= 0; --w)       // the lowest matching way
      if (way_key[i][w] == key[i]) way[i] = w;
    if (((probe >> i) & 1u) && way[i] < kWays) hit |= 1u << i;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    val[i] = ((hit >> i) & 1u) ? __ldg(db.values + db.at(way[i], slot[i]))
                               : 0.f;
  return hit;
}

// Any number of ways: item by item, stopping at the first matching way.
template <int kItems>
__device__ __forceinline__ uint32_t probe_any(const TrustDB& db,
                                              const uint32_t (&key)[kItems],
                                              uint32_t probe,
                                              float (&val)[kItems]) {
  uint32_t hit = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    val[i] = 0.f;
    if (!((probe >> i) & 1u)) continue;
    const uint32_t slot = db.slot_of(key[i]);
    for (int w = 0; w < db.n_ways; ++w) {
      const uint32_t off = db.at(w, slot);
      if (db.keys[off] == key[i]) {
        hit |= 1u << i;
        val[i] = db.values[off];
        break;
      }
    }
  }
  return hit;
}

// Block-wide exclusive scan of one packed count per thread; `tot` receives
// the block's sum. `warp_tot` (kWarps + 1 entries) must not be reused by
// the next call: the caller alternates two buffers, so one round needs two
// barriers, not three.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t x,
                                                         uint32_t* warp_tot,
                                                         uint32_t& tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t t = lane < kWarps ? warp_tot[lane] : 0u;
    uint32_t ti = t;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, ti, o);
      if (lane >= o) ti += y;
    }
    if (lane < kWarps) warp_tot[lane] = ti - t;   // exclusive warp offsets
    if (lane == kWarps - 1) warp_tot[kWarps] = ti;
  }
  __syncthreads();
  tot = warp_tot[kWarps];
  return warp_tot[warp] + incl - x;
}

// A thread's kItems keys and flags from item `first` on (0 past n): keys
// in 16-byte loads and flags in 4-byte words where kItems is a multiple of
// 4, the pointers allow and no item lies past n, else item by item.
// Returns the mask of valid items.
template <int kItems>
__device__ __forceinline__ uint32_t load_items(const uint32_t* keys,
                                               const uint8_t* valid,
                                               int first, int n, bool vec,
                                               uint32_t (&key)[kItems]) {
  uint32_t vmask = 0;
  if (kItems % 4 == 0 && vec && first + kItems <= n) {
#pragma unroll
    for (int g = 0; g < kItems / 4; ++g) {
      const uint4 k = __ldg(reinterpret_cast<const uint4*>(keys + first) + g);
      const uint32_t f = __ldg(reinterpret_cast<const unsigned int*>(
                                   valid + first) + g);
      key[4 * g] = k.x;
      key[4 * g + 1] = k.y;
      key[4 * g + 2] = k.z;
      key[4 * g + 3] = k.w;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((f >> (8 * b)) & 0xFFu) vmask |= 1u << (4 * g + b);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool in = first + i < n;
      key[i] = in ? __ldg(keys + first + i) : 0u;
      if (in && __ldg(valid + first + i) != 0) vmask |= 1u << i;
    }
  }
  return vmask;
}

// What a CTA shares, within itself and, through distributed shared memory,
// with the other CTAs of its cluster. The per-round entries alternate
// between two buffers, so a round needs one cluster barrier.
struct Shared {
  uint32_t warp_tot[2][kWarps + 1];
  uint32_t cta_tot[2];                       // this CTA's packed count
  int ne;                                    // NE, where the queue closed
};

// One cluster of kCluster CTAs. A round of kCluster * kThreads * kItems
// items is cut into one contiguous chunk a CTA, kItems consecutive items a
// thread. The launch picks the least kItems whose round covers
// min(N, kMaxRound), so every thread of a main-path batch has work.
template <int kWays, int kItems>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
shed_partition_kernel(const uint32_t* __restrict__ keys,
                      const uint8_t* __restrict__ valid, TrustDB db, int n,
                      int ucap, int budget, int budget_is_total,
                      int32_t* __restrict__ tier_out,
                      float* __restrict__ cval_out,
                      int32_t* __restrict__ rank_out) {
  static_assert(kWarps <= 32, "the warp-total pass is one warp");
  static_assert(kMaxRound < (1 << 16), "a round's counts must fit 16 bits");
  static_assert(kItems <= kMaxItems, "at most kMaxItems items a thread");
  constexpr int kRound = kCluster * kThreads * kItems;
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool vec_in = ((reinterpret_cast<uintptr_t>(keys) & 15) |
                       (reinterpret_cast<uintptr_t>(valid) & 3)) == 0;
  const bool vec_out = ((reinterpret_cast<uintptr_t>(tier_out) |
                         reinterpret_cast<uintptr_t>(cval_out) |
                         reinterpret_cast<uintptr_t>(rank_out)) & 15) == 0;
  int base_pos = 0, base_h = 0;              // carried from round to round
  // NE, the Normal queue's eval count, is needed only with a drop-queue
  // budget and is known once arrival position ucap - 1 has been scanned.
  bool ne_known = budget_is_total || ucap <= 0;
  int ne = 0;

  for (int r0 = 0, round = 0; r0 < n; r0 += kRound, ++round) {
    const int b = round & 1;
    const int first = r0 + (rank * kThreads + threadIdx.x) * kItems;
    uint32_t key[kItems];
    float val[kItems];
    uint32_t vmask = 0, hit = 0;
    if (first < n) {                         // threads past n only scan
      vmask = load_items<kItems>(keys, valid, first, n, vec_in, key);
      uint32_t probe = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i)
        if (((vmask >> i) & 1u) && key[i] != 0u) probe |= 1u << i;
      if constexpr (kWays > 0)
        hit = probe_fixed<kWays, kItems>(db, key, probe, val);
      else
        hit = probe_any<kItems>(db, key, probe, val);
    }
    const uint32_t miss = vmask & ~hit;       // valid, not cached

    // pos and h of the thread's first item: one packed scan in the CTA,
    // then the counts of the CTAs before it in the cluster
    const uint32_t own = __popc(vmask) | (__popc(miss) << 16);
    uint32_t tot;
    const uint32_t ex = block_exclusive_scan(own, sh.warp_tot[b], tot);
    if (threadIdx.x == 0) sh.cta_tot[b] = tot;
    cluster.sync();
    uint32_t before = 0, all = 0;
    int ne_rank = -1;                        // the CTA where the queue closes
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      const uint32_t t = *cluster.map_shared_rank(&sh.cta_tot[b], c);
      const int at = base_pos + static_cast<int>(all & 0xFFFFu);
      if (at <= ucap - 1 && ucap - 1 < at + static_cast<int>(t & 0xFFFFu))
        ne_rank = c;
      if (c < rank) before += t;
      all += t;
    }
    const int round_pos = base_pos + ((before + ex) & 0xFFFFu);
    const int round_h = base_h + ((before + ex) >> 16);
    base_pos += all & 0xFFFFu;
    base_h += all >> 16;

    if (!ne_known && ne_rank >= 0) {         // cluster-uniform
      int pos = round_pos, h = round_h;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (!((vmask >> i) & 1u)) continue;
        h += (miss >> i) & 1u;
        if (pos == ucap - 1) sh.ne = h;      // inclusive: closes the queue
        ++pos;
      }
      cluster.sync();
      ne = *cluster.map_shared_rank(&sh.ne, ne_rank);
      ne_known = true;
    }
    if (first >= n) continue;

    int tier[kItems], rank_of[kItems];
    int pos = round_pos, h = round_h;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool v = (vmask >> i) & 1u;
      const bool m = (miss >> i) & 1u;
      const bool eval =
          m && (pos < ucap || (budget_is_total ? h < budget
                                               : h - ne < budget));
      tier[i] = !v ? TIER_INVALID
                   : !m ? TIER_CACHED : eval ? TIER_EVAL : TIER_PRIOR;
      rank_of[i] = eval ? h : -1;
      pos += v;
      h += m;
    }

    if (kItems % 4 == 0 && vec_out && first + kItems <= n) {
#pragma unroll
      for (int g = 0; g < kItems / 4; ++g) {
        const int i = 4 * g;
        reinterpret_cast<int4*>(tier_out + first)[g] =
            make_int4(tier[i], tier[i + 1], tier[i + 2], tier[i + 3]);
        reinterpret_cast<float4*>(cval_out + first)[g] =
            make_float4(val[i], val[i + 1], val[i + 2], val[i + 3]);
        reinterpret_cast<int4*>(rank_out + first)[g] = make_int4(
            rank_of[i], rank_of[i + 1], rank_of[i + 2], rank_of[i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (first + i < n) {
          tier_out[first + i] = tier[i];
          cval_out[first + i] = val[i];
          rank_out[first + i] = rank_of[i];
        }
      }
    }
  }
  cluster.sync();          // no CTA leaves while another reads its counts
}

template <int kWays>
void launch(const uint32_t* keys, const uint8_t* valid, const TrustDB& db,
            int n, int ucap, int budget, int budget_is_total, int32_t* tier,
            float* cval, int32_t* rank, cudaStream_t stream) {
  constexpr int kCta = kCluster * kThreads;  // threads of the cluster
  const int round = n < kMaxRound ? n : kMaxRound;
  auto kernel = round <= kCta       ? shed_partition_kernel<kWays, 1>
                : round <= 2 * kCta ? shed_partition_kernel<kWays, 2>
                : round <= 4 * kCta ? shed_partition_kernel<kWays, 4>
                                    : shed_partition_kernel<kWays, 8>;
  kernel<<<kCluster, kThreads, 0, stream>>>(keys, valid, db, n, ucap, budget,
                                            budget_is_total, tier, cval,
                                            rank);
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int shed_partition_launch(const void* keys, const void* valid,
                                     const void* cache_keys,
                                     const void* cache_values, int n,
                                     int n_slots, int n_ways,
                                     int ways_leading, int ucap, int budget,
                                     int budget_is_total, void* tier,
                                     void* cval, void* rank, void* stream) {
  const TrustDB db{static_cast<const uint32_t*>(cache_keys),
                   static_cast<const float*>(cache_values),
                   static_cast<uint32_t>(n_slots),
                   ways_leading ? 1u : static_cast<uint32_t>(n_ways),
                   ways_leading ? static_cast<uint32_t>(n_slots) : 1u,
                   n_ways};
  const auto k = static_cast<const uint32_t*>(keys);
  const auto v = static_cast<const uint8_t*>(valid);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_ways == 4)
    launch<4>(k, v, db, n, ucap, budget, budget_is_total,
              static_cast<int32_t*>(tier), static_cast<float*>(cval),
              static_cast<int32_t*>(rank), s);
  else
    launch<0>(k, v, db, n, ucap, budget, budget_is_total,
              static_cast<int32_t*>(tier), static_cast<float*>(cval),
              static_cast<int32_t*>(rank), s);
  return static_cast<int>(cudaGetLastError());
}
