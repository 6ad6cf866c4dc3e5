// Fused Trust-DB probe + load-shedding tier assignment for one micro-batch.
//
// Replaces the TPU kernel `shed_partition` / `_shed_kernel` in
// src/repro/kernels/shed_partition.py (pallas_call at :257). Per item of an
// arrival-ordered batch it computes the tier (EVAL / CACHED / PRIOR /
// INVALID), the cached trust value, and the compacted eval rank (arrival
// position among EVAL items, -1 otherwise).
//
// What bounds it on an H100: nothing but latency. At the serving batch
// (N = 4096) it reads ~20 B of keys, flags and cache entries and writes
// 12 B per item, ~0.2 MB in all: under 0.1 us at 3.35 TB/s, far below the
// few microseconds one kernel launch costs.
//
// Design: the TPU kernel carries four running counters in SMEM across a
// sequential grid. CUDA blocks run in no order, so ONE block owns the
// whole micro-batch and walks it in tiles of 1024 items in arrival order,
// carrying the counters (valid so far, normal-queue evals, drop-queue
// candidates, EVAL cursor) from tile to tile in registers. Each tile needs
// three block-wide exclusive scans (warp shuffles, then one pass over the
// 32 warp totals): arrival position; normal-queue evals and drop-queue
// candidates (packed in one int, each tile count is <= 1024); and the EVAL
// rank, which depends on the tier. Every normal-queue item precedes every
// drop-queue item, so the running normal-eval count is final by the time
// the first drop-queue candidate is scanned: one pass is exact.
// The production Trust DB (65536 slots x 4 ways, 2 MiB) does not fit in
// shared memory; it is probed from global memory, where it stays in L2.
// Keys are uint32 (the wrapper hands int32 tensors holding the bit
// pattern); the hash and `% n_slots` are native unsigned arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int TIER_EVAL = 0;
constexpr int TIER_CACHED = 1;
constexpr int TIER_PRIOR = 2;
constexpr int TIER_INVALID = 3;

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Block-wide exclusive scan of one int per thread. Returns the exclusive
// prefix; `total` receives the block's sum. All threads must call it.
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_tot,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_tot[lane];
    int ti = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, ti, o);
      if (lane >= o) ti += y;
    }
    warp_tot[lane] = ti - t;            // exclusive warp offsets
    if (lane == 31) warp_tot[kWarps] = ti;
  }
  __syncthreads();
  const int out = warp_tot[warp] + incl - x;
  total = warp_tot[kWarps];
  __syncthreads();                      // warp_tot is reused by the next scan
  return out;
}

__global__ void __launch_bounds__(kThreads)
shed_partition_kernel(const uint32_t* __restrict__ keys,
                      const uint8_t* __restrict__ valid,
                      const uint32_t* __restrict__ cache_keys,
                      const float* __restrict__ cache_values, int n,
                      int n_slots, int n_ways, int ways_leading, int ucap,
                      int budget, int budget_is_total,
                      int32_t* __restrict__ tier_out,
                      float* __restrict__ cval_out,
                      int32_t* __restrict__ rank_out) {
  static_assert(kWarps == 32, "the warp-total pass assumes 32 warps");
  __shared__ int warp_tot[kWarps + 1];
  int base_valid = 0, base_ne = 0, base_dq = 0, base_e = 0;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    const bool inside = i < n;
    const uint32_t key = inside ? keys[i] : 0u;
    const bool v = inside && valid[i] != 0;

    // Trust DB probe: first way whose key matches; key 0 means empty.
    bool hit = false;
    float val = 0.f;
    if (v && key != 0u) {
      const uint32_t slot = hash32(key) % static_cast<uint32_t>(n_slots);
      for (int w = 0; w < n_ways; ++w) {
        const size_t off = ways_leading
                               ? static_cast<size_t>(w) * n_slots + slot
                               : static_cast<size_t>(slot) * n_ways + w;
        if (cache_keys[off] == key) {
          hit = true;
          val = cache_values[off];
          break;
        }
      }
    }

    int tot_v, tot_packed, tot_e;
    const int pos = base_valid + block_exclusive_scan(v, warp_tot, tot_v);
    const bool in_normal = v && pos < ucap;
    const bool ne = in_normal && !hit;          // normal-queue eval
    const bool dq = v && !in_normal && !hit;    // drop-queue candidate
    const int packed = block_exclusive_scan(
        static_cast<int>(ne) | (static_cast<int>(dq) << 16), warp_tot,
        tot_packed);
    const int ne_incl = base_ne + (packed & 0xFFFF) + ne;
    const int dq_rank = base_dq + (packed >> 16);
    const int dq_budget = budget_is_total ? budget - ne_incl : budget;

    int tier;
    if (!v) tier = TIER_INVALID;
    else if (hit) tier = TIER_CACHED;
    else if (in_normal || (dq && dq_rank < dq_budget)) tier = TIER_EVAL;
    else tier = TIER_PRIOR;
    const bool is_eval = tier == TIER_EVAL;
    const int erank = base_e + block_exclusive_scan(is_eval, warp_tot, tot_e);

    if (inside) {
      tier_out[i] = tier;
      cval_out[i] = hit ? val : 0.f;
      rank_out[i] = is_eval ? erank : -1;
    }
    base_valid += tot_v;
    base_ne += tot_packed & 0xFFFF;
    base_dq += tot_packed >> 16;
    base_e += tot_e;
  }
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
  shed_partition_kernel<<<1, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint8_t*>(valid),
      static_cast<const uint32_t*>(cache_keys),
      static_cast<const float*>(cache_values), n, n_slots, n_ways,
      ways_leading, ucap, budget, budget_is_total,
      static_cast<int32_t*>(tier), static_cast<float*>(cval),
      static_cast<int32_t*>(rank));
  return static_cast<int>(cudaGetLastError());
}
