// Attention backward: dq, dk, dv of causal / sliding-window / softcapped
// grouped-query attention, given the forward's output o and its row
// log-sum-exp lse (flash_attention.cu writes both).
//
// The TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at :126) has no
// backward: the JAX package differentiates its jnp attention with
// jax.grad. The port's forward on the card is the kernel, so its gradient
// is a kernel too.
// q, o, do: (B, S, Hq, D); k, v: (B, S, Hkv, D); bf16 or f32, contiguous;
// lse: (B, Hq, S) float32; a float32 workspace the wrapper allocates
// (flash_attention_bwd_workspace_bytes); dq, dk, dv in the inputs' type,
// sums in float32.
//
// With t the scaled (and softcapped) scores and P = exp(t - lse):
//   Di = rowsum(dO * O),   dV = P^T dO,   dP = dO V^T,
//   dT = P (dP - Di),   dS = dT (1 - (t / softcap)^2) with a softcap,
//   dQ = scale dS K,   dK = scale dS^T Q,
// dK and dV summed over the G query heads of their KV head. A row whose
// lse is -inf saw no key and gives and gets no gradient.
//
// What bounds it on an H100: at the training shape (B 8, S 4096, 9/3
// heads, D 64, bf16, causal) the five S x S x D products over the causal
// half are ~3.9e11 FLOP against ~40 MB of inputs and outputs, far above
// the ~295 FLOP a byte where the tensor cores become the limit: the
// operations bound it (~0.39 ms at 989 TFLOP/s).
//
// bf16 (D 64, 128 and 256: the training paths; D 16): three launches.
// 1. `fa_bwd_prep_kernel`: Di and the lse in log2 units (+inf for a row
//    that saw no key, so that its P is 0 with no test per score), padded
//    to whole query tiles; zeroes the counters. 8 threads a row, 16-byte
//    loads.
// 2. `fa_bwd_main_kernel`: the five products. K/V-stationary: a work
//    tile is (batch row, KV head, a key tile), whose K and V stay in
//    shared memory while the kernel walks every query tile (of one query
//    head) of the G heads that can see those keys, so dK and dV, summed
//    over the GQA group, are written once with no atomics. A persistent
//    grid (one block an SM) takes work tiles from a global counter, key
//    tile ascending, the longest causal walks first. Two consumer
//    warpgroups share a work tile (`kByRoles`):
//    - D 64, by keys (`consume`): 128 keys, 64 a warpgroup, 64-position
//      query tiles. Each forms S^T = K Q^T and dP^T = V dO^T (wgmma, both
//      operands in shared memory), P^T and dS^T in registers (mask,
//      softcap, dead rows as in `score_grad` and `sees`), dV += P^T dO and
//      dK += dS^T Q (wgmma, A from registers), dS^T to shared memory, and
//      the two take turns at dQ_partial = dS K over the 128 keys.
//    - D 128 and 256, by roles (`consume_roles`): 64 keys and 128 output
//      columns (`kColSplit`: D 256's key tile is two work tiles), 64- and
//      32-position query tiles. Warpgroup 0 forms S^T, P^T and dV and
//      hands P^T (times the softcap's derivative) on through shared
//      memory; warpgroup 1 forms dP^T, dS^T, dK and dQ. Each holds 64
//      accumulators of dK or dV beside one score tile: ptxas keeps a
//      consumer's wgmmas pipelined only within ~168 registers (not
//      setmaxnreg's 232), and with both of dK, dV and both score tiles in
//      one warpgroup (the split by keys, D 128's first design) it spilled
//      ~1.2 KB and serialised every wgmma. At D 256 each work tile forms
//      S and dP over the whole head for its 128 columns (14 D operations
//      a pair for 10).
//    dQ partials (64 x 64, or at D 256 128 columns x 32 positions as
//    dQ^T = K^T dS^T) are staged in shared memory.
//    A producer warpgroup holds the other roles, one thread each:
//    the loader streams each tile's K and V and a ring of Q / dO / lse /
//    Di stages with TMA and mbarriers; two dQ writers, one per consumer
//    warpgroup, add its staged partials to the float32 dq_acc with bulk
//    reduce-adds (a query tile's first one a bulk store), two in flight,
//    in a fixed order, so that a run repeats its bits (a training
//    restart from a checkpoint must equal the straight run): a counter per
//    (batch row, query head, query tile) says how many partials have been
//    added; key tile n's partial goes in once the counter shows every key
//    tile from the first that sees the query tile up to n - 1, then the
//    counter is released. Walks run query tiles from the last down, so a
//    key tile's predecessor reaches each query tile no later than it
//    does, and a partial waits only on a predecessor that a running block
//    already holds. dq_acc keeps each partial's tile in the staged order
//    (one contiguous 16 KB transfer).
//    setmaxnreg gives the producer's registers to the consumers (40 /
//    232), the warpgroup index taken from `__shfl_sync` so that the role
//    test is warp-uniform by construction.
//    Why the writers (timed on one H100 80GB HBM3 at 700 W, the training
//    shape): with the adds done by the consumers themselves (a spin and
//    32 float32 atomics a thread each query tile) the atomics and the
//    spin's round trips took most of the kernel's time; with one producer
//    thread doing both the loads and the adds, one reduce at a time, the
//    staging and adding still showed. PERF.md keeps the current numbers.
// 3. `fa_bwd_post_kernel`: dq = bf16(scale dq_acc), back in (B, S, Hq, D).
//
// bf16 at D 16 (the smoke-width heads; see `consume16`): what
// bounds it is not the tensor cores. At smollm's training microbatch (B
// 8, S 4096, 9/3) the five products over the causal half are 9.67e10
// FLOP (0.0977 ms), but each of the 6.04e8 scores costs an exp on the
// SFU (16 a clock an SM: 0.145-0.165 ms) and ~5 float32 operations. The
// instance forms each score's P and dS once (K/V-stationary, as above)
// and runs two independent pipelines a block, one a consumer warpgroup
// with its own loader, ring, dQ writer and 128-key work tiles, so that
// one warpgroup's exps overlap the other's wgmmas with no barrier
// between them.
// The mma.sync kernels it replaced (the first design: `dkdv_bf16_kernel`,
// one block per (batch row, KV head, 64 keys) walking every query row of the
// group, the G heads packed into the rows of the query tiles (packed row
// r = query head hk * G + r % G at position r / G); `dq_bf16_kernel`, one
// block per tile of packed query rows walking the key tiles it can see;
// S and dP formed in both, seven products for five and every exp twice)
// are no longer launched: `launch/ab_attention.py --backward` builds
// them (`launch_bf16`, variants d16_mma_sync and d256_mma_sync, the D 256
// instance the D 256 warpgroup kernel replaced) to time them beside it.
//
// float32 (the smoke-width models): FP32 FMAs, as the forward's float32
// kernel: one block of 4 warps per (batch row, head, 32 rows), lane j
// taking key (or query) j of a 32-wide tile, columns lane + 32 c.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A row's lse in log2 units, +inf for a row that saw no key (lse -inf),
// so that its P = 2^(t log2(e) - l2) is 0 with no test per score.
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// P and dS of one score from its raw dot product s, dP, the row's Di and
// l2 (lse_log2): t = s scale (softcapped: softcap tanh(s scale /
// softcap)), P = exp(t - lse), dS = P (dP - Di) (1 - (t / softcap)^2
// with a softcap). c_exp = scale log2(e) folds the scale into the FMA.
__device__ __forceinline__ void score_grad(float s, float dp, float di,
                                           float l2, float scale,
                                           float c_exp, float softcap,
                                           float& p, float& ds) {
  if (softcap > 0.f) {
    const float t = softcap * tanhf(s * scale / softcap);
    const float c = t / softcap;
    p = tc::exp2_approx(fmaf(t, kLog2e, -l2));
    ds = p * (dp - di) * (1.f - c * c);
  } else {
    p = tc::exp2_approx(fmaf(s, c_exp, -l2));
    ds = p * (dp - di);
  }
}

// P of one score from its raw dot product s and the row's l2, and F = P
// (1 - (t / softcap)^2) with a softcap (F = P without), so that dS = F (dP
// - Di): `score_grad` split where one warpgroup forms P and another dS.
__device__ __forceinline__ void score_p(float s, float l2, float scale,
                                        float c_exp, float softcap, float& p,
                                        float& f) {
  if (softcap > 0.f) {
    // tc::tanh_ex2 for libdevice tanhf, which took a fifth of the D 256
    // kernel
    const float t = softcap * tc::tanh_ex2(s * scale / softcap);
    const float c = t / softcap;
    p = tc::exp2_approx(fmaf(t, kLog2e, -l2));
    f = p * (1.f - c * c);
  } else {
    p = tc::exp2_approx(fmaf(s, c_exp, -l2));
    f = p;
  }
}

__device__ __forceinline__ bool sees(int kpos, int qpos, int causal,
                                     int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// ---------------------------------------------------------------------------
// Di = rowsum(dO * O), (B, Hq, S) float32, one warp a row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void di_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ di, long long n_rows, int S,
                          int Hq, int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += to_float(orow[d]) * to_float(drow[d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    // row = (b * S + s) * Hq + h  ->  (b * Hq + h) * S + s
    const int h = static_cast<int>(row % Hq);
    const long long bs = row / Hq;
    const long long b = bs / S;
    const int s = static_cast<int>(bs % S);
    di[(b * Hq + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;                // warps a block, 16 rows each
constexpr int kRowsPerBlock = 16 * kWarps;

template <int D>
constexpr int kPadded = D + 8;           // bf16 elements of a shared row

// dq kernel: keys a K/V tile (64 keys at D 128 spilled 24 bytes).
// dk/dv kernel: packed query rows a Q/dO tile.
template <int D>
constexpr int kQKeys = D > 64 ? 32 : 64;
template <int D>
constexpr int kKVRows = D > 64 ? 32 : 64;
// dk/dv kernel: blocks that share a key tile, each its slice of columns.
template <int D>
constexpr int kSplit = D > 128 ? 2 : 1;

// acc[n] (+)= X Y^T for one warp: X rows x0[16][*], Y rows y0[N][*] in
// shared memory (row stride DP), over the K columns [0, K). jmax: the
// 16-row slices of Y at or past it are skipped (their scores are masked).
template <int DP, int K, int N>
__device__ __forceinline__ void mma_xyt(float (&acc)[N / 8][4],
                                        const __nv_bfloat16* x0,
                                        const __nv_bfloat16* y0, int lane,
                                        int jmax) {
#pragma unroll
  for (int jp = 0; jp < N / 16; ++jp) {
    if (16 * jp >= jmax) continue;
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t a[4], b[4];
      tc::ldmatrix_x4(a, x0 + (lane & 15) * DP + (lane >> 4) * 8 + kk * 16);
      tc::ldmatrix_x4(b, y0 + (16 * jp + (lane & 7) + (lane >> 4) * 8) * DP +
                             kk * 16 + ((lane >> 3) & 1) * 8);
      tc::mma_bf16(acc[2 * jp], a, b[0], b[1]);
      tc::mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] += A B for one warp: A the (16 x N) float32 fragments f rounded to
// bf16 (the k dimension is their N columns), B rows b0[N][*] in shared
// memory (row stride DP), columns [0, C). 16-column k-steps at or past
// kmax are skipped (their A is zero).
template <int DP, int N, int C>
__device__ __forceinline__ void mma_ab(float (&acc)[C / 8][4],
                                       const float (&f)[N / 8][4],
                                       const __nv_bfloat16* b0, int lane,
                                       int kmax) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    if (16 * kk >= kmax) continue;
    uint32_t a[4];
    a[0] = tc::pack_bf16(f[2 * kk][0], f[2 * kk][1]);
    a[1] = tc::pack_bf16(f[2 * kk][2], f[2 * kk][3]);
    a[2] = tc::pack_bf16(f[2 * kk + 1][0], f[2 * kk + 1][1]);
    a[3] = tc::pack_bf16(f[2 * kk + 1][2], f[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < C / 16; ++np) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, b0 + (16 * kk + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * DP +
                                   16 * np + (lane >> 4) * 8);
      tc::mma_bf16(acc[2 * np], a, b[0], b[1]);
      tc::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Packed query row r of pair (b, hk): its q/o/do row, and its lse/di index.
struct Packed {
  long long q_pos;   // position stride of q, o, do: Hq * D
  int G, S, Hq;
  __device__ long long row(int r, int D) const {
    return (r / G) * q_pos + static_cast<long long>(r % G) * D;
  }
  __device__ long long stat(long long b, int hk, int r) const {
    return (b * Hq + hk * G + r % G) * static_cast<long long>(S) + r / G;
  }
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int B, int S, int Hq,
                 int Hkv, float scale, int causal, int window,
                 float softcap) {
  constexpr int DP = kPadded<D>;
  constexpr int CPR = D / 8;               // 16-byte chunks a row
  constexpr int BR = kKVRows<D>;           // packed query rows a tile
  constexpr int NS = kSplit<D>;
  constexpr int DO = D / NS;               // output columns of this block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kRowsPerBlock * DP;
  __nv_bfloat16* Qs = Vs + kRowsPerBlock * DP;     // [2][BR][DP]
  __nv_bfloat16* Ds = Qs + 2 * BR * DP;            // [2][BR][DP] (dO)
  float* Ls = reinterpret_cast<float*>(Ds + 2 * BR * DP);  // [2][BR] lse
  float* Is = Ls + 2 * BR;                                  // [2][BR] di
  // [2][BR] each packed row's position r / G, so that the mask divides
  // once per row and tile, not once per score
  int* Ps = reinterpret_cast<int*>(Is + 2 * BR);

  const int G = Hq / Hkv;
  const int rows = S * G;
  const int split = blockIdx.x % NS;
  const long long pairs = static_cast<long long>(B) * Hkv;
  const long long pair = (blockIdx.x / NS) % pairs;
  const int kt = static_cast<int>(blockIdx.x / NS / pairs);
  const long long b = pair / Hkv;
  const int hk = static_cast<int>(pair % Hkv);
  const int kb0 = kt * kRowsPerBlock;
  const int kb_last = min(kb0 + kRowsPerBlock, S) - 1;
  const long long kv_pos = static_cast<long long>(Hkv) * D;
  const Packed pk{static_cast<long long>(Hq) * D, G, S, Hq};
  const __nv_bfloat16* qb = q + b * S * pk.q_pos + static_cast<long long>(hk) * G * D;
  const __nv_bfloat16* db = dout + b * S * pk.q_pos + static_cast<long long>(hk) * G * D;
  const long long kv_off = b * S * kv_pos + static_cast<long long>(hk) * D;

  for (int i = threadIdx.x; i < kRowsPerBlock * CPR; i += blockDim.x) {
    const int j = i / CPR, c = i % CPR, pos = kb0 + j;
    const bool ok = pos < S;
    const long long off = kv_off + (ok ? pos * kv_pos + c * 8 : 0);
    tc::cp_async16(Ks + j * DP + c * 8, k + off, ok);
    tc::cp_async16(Vs + j * DP + c * 8, v + off, ok);
  }

  // Packed query rows that can see a key of the block.
  const int r_begin = causal ? kb0 * G : 0;
  const int r_end = window > 0
                        ? min(rows, (kb_last + window) * G)
                        : rows;
  const int t_begin = r_begin / BR;
  const int t_end = (r_end + BR - 1) / BR;

  auto load_q = [&](int t, int stage) {
    __nv_bfloat16* qs = Qs + stage * BR * DP;
    __nv_bfloat16* ds = Ds + stage * BR * DP;
    for (int i = threadIdx.x; i < BR * CPR; i += blockDim.x) {
      const int rr = i / CPR, c = i % CPR, r = t * BR + rr;
      const bool ok = r < rows;
      const long long off = ok ? pk.row(r, D) + c * 8 : 0;
      tc::cp_async16(qs + rr * DP + c * 8, qb + off, ok);
      tc::cp_async16(ds + rr * DP + c * 8, db + off, ok);
    }
    for (int rr = threadIdx.x; rr < BR; rr += blockDim.x) {
      const int r = t * BR + rr;
      const bool ok = r < rows;
      Ls[stage * BR + rr] =
          ok ? lse_log2(lse[pk.stat(b, hk, r)]) : INFINITY;
      Is[stage * BR + rr] = ok ? di[pk.stat(b, hk, r)] : 0.f;
      Ps[stage * BR + rr] = r / G;
    }
  };
  if (t_begin < t_end) load_q(t_begin, 0);
  tc::cp_async_commit();                   // K, V and the first tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wj0 = kb0 + 16 * warp;         // the warp's first key
  const int wj1 = min(wj0 + 15, S - 1);
  const int key[2] = {wj0 + grp, wj0 + grp + 8};
  const int col0 = split * DO;
  const float c_exp = scale * kLog2e;
  float acck[DO / 8][4], accv[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[n][e] = accv[n][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin, st = it & 1;
    if (t + 1 < t_end) load_q(t + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                // this tile (and K, V) landed
    __syncthreads();
    const int q_first = (t * BR) / G;
    const int q_last = (min(t * BR + BR, rows) - 1) / G;
    const bool skip = wj0 >= S || (causal && q_last < wj0) ||
                      (window > 0 && q_first > wj1 + window - 1);
    // every key of the warp visible to every row of the tile: no mask
    const bool open = wj0 + 15 < S && t * BR + BR <= rows &&
                      (!causal || q_first >= wj0 + 15) &&
                      (window <= 0 || q_last < wj0 + window);
    if (!skip) {
      const __nv_bfloat16* qs = Qs + st * BR * DP;
      const __nv_bfloat16* ds = Ds + st * BR * DP;
      const float* ls = Ls + st * BR;
      const float* is = Is + st * BR;
      const int* ps = Ps + st * BR;
      float p[BR / 8][4], dp[BR / 8][4];
#pragma unroll
      for (int n = 0; n < BR / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[n][e] = dp[n][e] = 0.f;
      mma_xyt<DP, D, BR>(p, Ks + 16 * warp * DP, qs, lane, BR);   // S^T
      mma_xyt<DP, D, BR>(dp, Vs + 16 * warp * DP, ds, lane, BR);  // dP^T
#pragma unroll
      for (int n = 0; n < BR / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * tig + (e & 1);   // column: query row
          const int r = t * BR + c, j = key[e >> 1];
          const bool ok = open || (j < S && r < rows &&
                                   sees(j, ps[c], causal, window));
          float pv, dsv;
          score_grad(p[n][e], dp[n][e], is[c], ls[c], scale, c_exp, softcap,
                     pv, dsv);
          p[n][e] = ok ? pv : 0.f;
          dp[n][e] = ok ? dsv : 0.f;
        }
      mma_ab<DP, BR, DO>(accv, p, ds + col0, lane, BR);    // dV += P^T dO
      mma_ab<DP, BR, DO>(acck, dp, qs + col0, lane, BR);   // dK += dS^T Q
    }
    __syncthreads();                       // the stage may be refilled
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = key[h];
    if (j >= S) continue;
    const long long at = kv_off + j * kv_pos + col0 + 2 * tig;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n) = tc::pack_bf16(
          acck[n][2 * h] * scale, acck[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n) =
          tc::pack_bf16(accv[n][2 * h], accv[n][2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ di,
               __nv_bfloat16* __restrict__ dq, int B, int S, int Hq, int Hkv,
               int n_tiles, float scale, int causal, int window,
               float softcap) {
  constexpr int DP = kPadded<D>;
  constexpr int CPR = D / 8;
  constexpr int NK = kQKeys<D>;            // keys a K/V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ds = Qs + kRowsPerBlock * DP;      // dO rows
  __nv_bfloat16* Ks = Ds + kRowsPerBlock * DP;      // [2][NK][DP]
  __nv_bfloat16* Vs = Ks + 2 * NK * DP;             // [2][NK][DP]

  const int G = Hq / Hkv;
  const int rows = S * G;
  const long long pairs = static_cast<long long>(B) * Hkv;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x / pairs);
  const long long pair = blockIdx.x % pairs;
  const long long b = pair / Hkv;
  const int hk = static_cast<int>(pair % Hkv);
  const int r0 = tile * kRowsPerBlock;
  const long long kv_pos = static_cast<long long>(Hkv) * D;
  const Packed pk{static_cast<long long>(Hq) * D, G, S, Hq};
  const long long q_off = b * S * pk.q_pos + static_cast<long long>(hk) * G * D;
  const long long kv_off = b * S * kv_pos + static_cast<long long>(hk) * D;

  for (int i = threadIdx.x; i < kRowsPerBlock * CPR; i += blockDim.x) {
    const int rr = i / CPR, c = i % CPR, r = r0 + rr;
    const bool ok = r < rows;
    const long long off = q_off + (ok ? pk.row(r, D) + c * 8 : 0);
    tc::cp_async16(Qs + rr * DP + c * 8, q + off, ok);
    tc::cp_async16(Ds + rr * DP + c * 8, dout + off, ok);
  }

  const int p_lo = r0 / G, p_hi = (min(r0 + kRowsPerBlock, rows) - 1) / G;
  const int kv_end = causal ? p_hi + 1 : S;
  const int kv_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int t_begin = kv_begin / NK;
  const int t_end = (kv_end + NK - 1) / NK;

  auto load_kv = [&](int t, int stage) {
    __nv_bfloat16* ks = Ks + stage * NK * DP;
    __nv_bfloat16* vs = Vs + stage * NK * DP;
    for (int i = threadIdx.x; i < NK * CPR; i += blockDim.x) {
      const int j = i / CPR, c = i % CPR, pos = t * NK + j;
      const bool ok = pos < S;
      const long long off = kv_off + (ok ? pos * kv_pos + c * 8 : 0);
      tc::cp_async16(ks + j * DP + c * 8, k + off, ok);
      tc::cp_async16(vs + j * DP + c * 8, v + off, ok);
    }
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  tc::cp_async_commit();                   // Q, dO and the first tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wr0 = r0 + 16 * warp;
  const bool live = wr0 < rows;
  const int row[2] = {wr0 + grp, wr0 + grp + 8};
  const int qpos[2] = {row[0] / G, row[1] / G};
  const float c_exp = scale * kLog2e;
  float lrow[2], drow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row[h] < rows;
    lrow[h] = ok ? lse_log2(lse[pk.stat(b, hk, row[h])]) : INFINITY;
    drow[h] = ok ? di[pk.stat(b, hk, row[h])] : 0.f;
  }
  const int w_lo = wr0 / G;
  const int w_hi = live ? (min(wr0 + 16, rows) - 1) / G : -1;
  const int w_kend = causal ? min(w_hi + 1, S) : S;
  const int w_kbegin = window > 0 ? max(0, w_lo - window + 1) : 0;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin, st = it & 1;
    if (t + 1 < t_end) load_kv(t + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int k0 = t * NK;
    // every key of the tile visible to every row of the warp: no mask
    const bool open = k0 + NK <= S && wr0 + 16 <= rows &&
                      (!causal || k0 + NK - 1 <= w_lo) &&
                      (window <= 0 || k0 > w_hi - window);
    if (live && k0 < w_kend && k0 + NK > w_kbegin) {
      const __nv_bfloat16* ks = Ks + st * NK * DP;
      const __nv_bfloat16* vs = Vs + st * NK * DP;
      float s[NK / 8][4], dp[NK / 8][4];
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      const int jmax = w_kend - k0;
      mma_xyt<DP, D, NK>(s, Qs + 16 * warp * DP, ks, lane, jmax);   // S
      mma_xyt<DP, D, NK>(dp, Ds + 16 * warp * DP, vs, lane, jmax);  // dP
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int kpos = k0 + 8 * n + 2 * tig + (e & 1);
          const bool ok = open || (kpos < S && row[h] < rows &&
                                   sees(kpos, qpos[h], causal, window));
          float pv, dsv;
          score_grad(s[n][e], dp[n][e], drow[h], lrow[h], scale, c_exp,
                     softcap, pv, dsv);
          s[n][e] = ok ? dsv : 0.f;
        }
      mma_ab<DP, NK, D>(acc, s, ks, lane, jmax);                    // dS K
    }
    __syncthreads();
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= rows) continue;
    const long long at = q_off + pk.row(row[h], D) + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq + at + 8 * n) = tc::pack_bf16(
          acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* di, void* dq, void* dk,
                void* dv, int B, int S, int Hq, int Hkv, float scale,
                int causal, int window, float softcap, cudaStream_t stream) {
  constexpr int DP = kPadded<D>;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dp = static_cast<const __nv_bfloat16*>(dout);
  const long long rows = static_cast<long long>(S) * (Hq / Hkv);
  const long long pairs = static_cast<long long>(B) * Hkv;

  const size_t kv_smem = sizeof(__nv_bfloat16) * DP *
                             (2 * kRowsPerBlock + 4 * kKVRows<D>) +
                         (2 * sizeof(float) + sizeof(int)) * 2 * kKVRows<D>;
  const long long kv_blocks =
      pairs * ((S + kRowsPerBlock - 1) / kRowsPerBlock) * kSplit<D>;
  const size_t q_smem =
      sizeof(__nv_bfloat16) * DP * (2 * kRowsPerBlock + 4 * kQKeys<D>);
  const long long n_tiles = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long q_blocks = pairs * n_tiles;
  if (kv_blocks == 0 || q_blocks == 0) return 0;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL ||
      rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);

  cudaError_t err = cudaFuncSetAttribute(
      dkdv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_bf16_kernel<D><<<static_cast<unsigned>(kv_blocks), kWarps * 32,
                        kv_smem, stream>>>(
      qp, kp, vp, dp, lse, di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, S, Hq, Hkv, scale, causal, window,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_bf16_kernel<D><<<static_cast<unsigned>(q_blocks), kWarps * 32, q_smem,
                      stream>>>(
      qp, kp, vp, dp, lse, di, static_cast<__nv_bfloat16*>(dq), B, S, Hq,
      Hkv, static_cast<int>(n_tiles), scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: FP32 FMAs
// ---------------------------------------------------------------------------

constexpr int kT = 32;                     // rows (or keys) a tile
constexpr int kRows = kT / kWarps;         // rows (or keys) a warp

// The dot product of the D floats at x and at y (16-byte aligned).
template <int D>
__device__ __forceinline__ float dot_row(const float* x, const float* y) {
  float acc = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + d);
    const float4 c = *reinterpret_cast<const float4*>(y + d);
    acc += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
  }
  return acc;
}

// dQ: one block of 4 warps per (batch row, query head, 32 query rows); a
// warp's 8 rows, lane j scoring key j of a 32-key tile.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              float* __restrict__ dq, int S, int Hq, int Hkv, float scale,
              int causal, int window, float softcap) {
  constexpr int KP = D + 4;
  constexpr int C = (D + 31) / 32;
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;                       // [kT][D]
  float* Ds = Qs + kT * D;                 // [kT][D]
  float* Ks = Ds + kT * D;                 // [kT][KP]
  float* Vs = Ks + kT * KP;                // [kT][KP]

  const int n_qt = (S + kT - 1) / kT;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % Hq;
  const long long b = blockIdx.x / (static_cast<long long>(n_qt) * Hq);
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kT;
  const long long q_row = static_cast<long long>(Hq) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const long long qo = b * S * q_row + static_cast<long long>(h) * D;
  const long long ko = b * S * kv_row + static_cast<long long>(hk) * D;

  for (int idx = threadIdx.x; idx < kT * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    Qs[idx] = s < S ? q[qo + s * q_row + d] : 0.f;
    Ds[idx] = s < S ? dout[qo + s * q_row + d] : 0.f;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float c_exp = scale * kLog2e;
  float lr[kRows], dr[kRows], acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    const long long at = (b * Hq + h) * S + qpos;
    lr[r] = qpos < S ? lse_log2(lse[at]) : INFINITY;
    dr[r] = qpos < S ? di[at] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  const int q_last = min(q0 + kT, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (kv_begin / kT) * kT; k0 < kv_end; k0 += kT) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kT * D; idx += blockDim.x) {
      const int r = idx / D, d = idx % D, s = k0 + r;
      Ks[r * KP + d] = s < S ? k[ko + s * kv_row + d] : 0.f;
      Vs[r * KP + d] = s < S ? v[ko + s * kv_row + d] : 0.f;
    }
    __syncthreads();
    const int kpos = k0 + lane;
    float ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      const float* qrow = Qs + (warp * kRows + r) * D;
      const float* drow = Ds + (warp * kRows + r) * D;
      const float s = dot_row<D>(Ks + lane * KP, qrow);
      const float dpv = dot_row<D>(Vs + lane * KP, drow);
      const bool ok = kpos < S && qpos < S && sees(kpos, qpos, causal,
                                                   window);
      float p;
      score_grad(s, dpv, dr[r], lr[r], scale, c_exp, softcap, p, ds[r]);
      ds[r] = ok ? ds[r] : 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float kk[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        kk[c] = (D % 32 == 0 || lane + 32 * c < D) ? Ks[j * KP + lane + 32 * c]
                                                   : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] += dj * kk[c];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (D % 32 == 0 || lane + 32 * c < D)
        dq[qo + qpos * q_row + lane + 32 * c] = acc[r][c] * scale;
  }
}

// dK, dV: one block of 4 warps per (batch row, KV head, 32 keys); a warp's
// 8 keys, lane i scoring query i of a 32-query tile of each of the G heads.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                float* __restrict__ dk, float* __restrict__ dv, int S,
                int Hq, int Hkv, float scale, int causal, int window,
                float softcap) {
  constexpr int QP = D + 4;
  constexpr int C = (D + 31) / 32;
  extern __shared__ __align__(16) float fsmem[];
  float* Ks = fsmem;                       // [kT][D]
  float* Vs = Ks + kT * D;                 // [kT][D]
  float* Qs = Vs + kT * D;                 // [kT][QP]
  float* Ds = Qs + kT * QP;                // [kT][QP]
  float* Ls = Ds + kT * QP;                // [kT]
  float* Is = Ls + kT;                     // [kT]

  const int n_kt = (S + kT - 1) / kT;
  const int kt = blockIdx.x % n_kt;
  const int hk = (blockIdx.x / n_kt) % Hkv;
  const long long b = blockIdx.x / (static_cast<long long>(n_kt) * Hkv);
  const int G = Hq / Hkv;
  const int k0 = kt * kT;
  const long long q_row = static_cast<long long>(Hq) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const long long ko = b * S * kv_row + static_cast<long long>(hk) * D;

  for (int idx = threadIdx.x; idx < kT * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D, s = k0 + r;
    Ks[idx] = s < S ? k[ko + s * kv_row + d] : 0.f;
    Vs[idx] = s < S ? v[ko + s * kv_row + d] : 0.f;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float c_exp = scale * kLog2e;
  float ak[kRows][C], av[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) ak[r][c] = av[r][c] = 0.f;
  const int k_last = min(k0 + kT, S) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long qo = b * S * q_row + static_cast<long long>(h) * D;
    for (int q0 = (q_begin / kT) * kT; q0 < q_end; q0 += kT) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < kT * D; idx += blockDim.x) {
        const int r = idx / D, d = idx % D, s = q0 + r;
        Qs[r * QP + d] = s < S ? q[qo + s * q_row + d] : 0.f;
        Ds[r * QP + d] = s < S ? dout[qo + s * q_row + d] : 0.f;
      }
      for (int r = threadIdx.x; r < kT; r += blockDim.x) {
        const int s = q0 + r;
        const long long at = (b * Hq + h) * S + s;
        Ls[r] = s < S ? lse_log2(lse[at]) : INFINITY;
        Is[r] = s < S ? di[at] : 0.f;
      }
      __syncthreads();
      const int qpos = q0 + lane;
      const float lq = Ls[lane], dq_i = Is[lane];
      float p[kRows], ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int kpos = k0 + warp * kRows + r;
        const float s = dot_row<D>(Qs + lane * QP, Ks + (warp * kRows + r) * D);
        const float dpv = dot_row<D>(Ds + lane * QP, Vs + (warp * kRows + r) * D);
        const bool ok = kpos < S && qpos < S && sees(kpos, qpos, causal,
                                                     window);
        score_grad(s, dpv, dq_i, lq, scale, c_exp, softcap, p[r], ds[r]);
        p[r] = ok ? p[r] : 0.f;
        ds[r] = ok ? ds[r] : 0.f;
      }
#pragma unroll 4
      for (int i = 0; i < kT; ++i) {
        float qq[C], dd[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const bool in = D % 32 == 0 || lane + 32 * c < D;
          qq[c] = in ? Qs[i * QP + lane + 32 * c] : 0.f;
          dd[c] = in ? Ds[i * QP + lane + 32 * c] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pi = __shfl_sync(0xffffffffu, p[r], i);
          const float si = __shfl_sync(0xffffffffu, ds[r], i);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            av[r][c] += pi * dd[c];
            ak[r][c] += si * qq[c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kpos = k0 + warp * kRows + r;
    if (kpos >= S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (D % 32 == 0 || lane + 32 * c < D) {
        dk[ko + kpos * kv_row + lane + 32 * c] = ak[r][c] * scale;
        dv[ko + kpos * kv_row + lane + 32 * c] = av[r][c];
      }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* di, void* dq, void* dk,
               void* dv, int B, int S, int Hq, int Hkv, float scale,
               int causal, int window, float softcap, cudaStream_t stream) {
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* dp = static_cast<const float*>(dout);
  const size_t q_smem = sizeof(float) * (2 * kT * D + 2 * kT * (D + 4));
  const size_t kv_smem =
      sizeof(float) * (2 * kT * D + 2 * kT * (D + 4) + 2 * kT);
  const long long tiles = (S + kT - 1) / kT;
  const long long q_blocks = static_cast<long long>(B) * Hq * tiles;
  const long long kv_blocks = static_cast<long long>(B) * Hkv * tiles;
  if (q_blocks == 0) return 0;
  if (q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(q_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_f32_kernel<D><<<static_cast<unsigned>(kv_blocks), kWarps * 32, kv_smem,
                       stream>>>(qp, kp, vp, dp, lse, di,
                                 static_cast<float*>(dk),
                                 static_cast<float*>(dv), S, Hq, Hkv, scale,
                                 causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_f32_kernel<D><<<static_cast<unsigned>(q_blocks), kWarps * 32, q_smem,
                     stream>>>(qp, kp, vp, dp, lse, di,
                               static_cast<float*>(dq), S, Hq, Hkv, scale,
                               causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16, D 64 and D 128: a pre-pass, one warpgroup-MMA kernel, a post-pass
// ---------------------------------------------------------------------------

namespace wgk {

constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kThreads = 128 + kConsumers; // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kTileFloats = 4096;        // a staged dQ partial, 16 KB

// How the two consumer warpgroups share a work tile: by keys, 64 each
// (`consume`, D 64), or by roles, warpgroup 0 forming P and dV and
// warpgroup 1 dS, dK and dQ over the same 64 keys (`consume_roles`, D 128
// and 256). At D 16 they share none: each runs a pipeline of its own
// (`consume16`).
template <int D>
constexpr bool kByRoles = D == 128 || D == 256;
// A work tile's keys and a query tile's positions: 128 keys shared by
// keys, 64 by roles, 128 a D 16 pipeline (two 64-key halves, each one
// 64-row wgmma tile); 64-position query tiles, 32 at D 256 (what fits
// the 227 KB of shared memory beside a 64-key K and V of 256 columns).
template <int D>
constexpr int kBc = kByRoles<D> ? 64 : 128;
template <int D>
constexpr int kBr = D == 256 ? 32 : 64;
// Work tiles a key tile is dealt as: shared by roles, one per 128 output
// columns of dK, dV and dQ (two at D 256, each forming S and dP over the
// whole head: 14 D operations a pair for 10, so that a warpgroup holds 64
// accumulators of dK or dV and stays inside the ~168 registers with which
// ptxas keeps the wgmmas pipelined); otherwise one.
template <int D>
constexpr int kColSplit = kByRoles<D> ? D / 128 : 1;
// Floats of a staged dQ partial: 64 x 64 (D 64, 128), 128 columns x 32
// positions, transposed (D 256), or a query tile's 64 x 16 (D 16).
template <int D>
constexpr int kTile = D == 16 ? kBr<16> * 16 : kTileFloats;
// dQ partials a (key tile, query tile) pair stages.
template <int D>
constexpr int kAdds = kBr<D> * D / kTile<D>;

template <int D>
struct Smem {                            // byte offsets, 1024-aligned tiles
  static constexpr int kStages = D == 64 ? 3 : 2;     // Q / dO / lse / Di
  static constexpr int kBufs = D == 64 ? 3 : 2;       // dQ staging, per ring
  static constexpr int kHalves = D / 64; // 128-byte column blocks of a row
  static constexpr int kKV = kBc<D> * D * 2, kKVHalf = kBc<D> * 128;
  static constexpr int kQ = kBr<D> * D * 2, kQHalf = kBr<D> * 128;
  // dS^T [key][query] (dS [query][key] at D 256), bf16: two buffers by
  // query tile (`consume`), one (`consume_roles`)
  static constexpr int kDS = kBc<D> * kBr<D> * 2;
  // F^T of `consume_roles`, float32, two buffers by query tile
  static constexpr int kF = kByRoles<D> ? kBc<D> * kBr<D> * 4 : 0;
  static constexpr int oK = 0, oV = oK + kKV, oQ = oV + kKV;
  static constexpr int oDO = oQ + kStages * kQ;
  static constexpr int oDS = oDO + kStages * kQ;
  static constexpr int oF = oDS + (kByRoles<D> ? 1 : 2) * kDS;
  static constexpr int oStage = oF + 2 * kF;          // [2 rings][kBufs]
  static constexpr int oL = oStage + 2 * kBufs * kTileFloats * 4;  // lse2
  static constexpr int oI = oL + kStages * kBr<D> * 4;  // Di per stage
  // full[kStages], empty[kStages], kv_full, kv_empty, dq_full[2][kBufs],
  // dq_empty[2][kBufs]; then the tile slot and the partials' notes
  static constexpr int oBar = oI + kStages * kBr<D> * 4;
  static constexpr int kBars = 2 * kStages + 2 + 4 * kBufs;
  static constexpr int oTile = oBar + kBars * 8;
  static constexpr int oNote = oTile + 16;
  static constexpr int kBytes = oNote + 2 * kBufs * 16 + 1024;  // + slack
  static_assert(kBytes <= 232448, "past a block's shared memory");
};

struct Args {
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* dq_acc;          // (B, Hq, Tq, kAdds) tiles of kTile floats
  const float* lse2;      // (B, Hq, S_pad): lse in log2 units, +inf past S
  const float* di;        // (B, Hq, S_pad), 0 past S
  int* counters;          // (B, Hq, Tq): dQ partials added per query tile
  int* next_tile;         // the work-tile dispenser
  int B, S, Hq, Hkv, Tq, S_pad, n_tiles;
  float scale, c_exp, softcap;
  int causal, window;
};

// What a consumer warpgroup tells the producer about a staged dQ
// partial: where it goes, which counter orders it and the count to wait
// for; or that the warpgroup is done.
struct Note {
  long long tile;         // float offset of its tile in dq_acc
  int ctr, target, done, pad;
};

// A key tile n and a query tile m see each other when some pair (key,
// query) of theirs is visible: key <= query (causal) and key > query -
// window (a window). Tile n sees the query tiles [m_first, m_last]; tile m
// is seen by the key tiles from n_first on, a contiguous run.
template <int D>
__device__ __forceinline__ int m_first(const Args& a, int n) {
  return a.causal ? n * kBc<D> / kBr<D> : 0;
}
template <int D>
__device__ __forceinline__ int m_last(const Args& a, int n) {
  if (a.window <= 0) return a.Tq - 1;
  const int k_last = min(n * kBc<D> + kBc<D>, a.S) - 1;
  return min(a.Tq - 1, (k_last + a.window - 1) / kBr<D>);
}
template <int D>
__device__ __forceinline__ int n_first(const Args& a, int m) {
  if (a.window <= 0) return 0;
  const int x = m * kBr<D> - a.window + 1;
  return x <= 0 ? 0 : x / kBc<D>;
}

// Di = rowsum(dO * O) and the lse in log2 units (+inf where it is -inf:
// the row saw no key), both padded to S_pad with 0 / +inf; the counters
// zeroed. 8 threads a row, 16-byte loads.
template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ di,
                   float* __restrict__ lse2, int* __restrict__ counters,
                   int B, int S, int Hq,
                   int S_pad, int n_counters) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long rows = static_cast<long long>(B) * S * Hq;
  const int sub = threadIdx.x & 7, lane8 = (threadIdx.x & 31) >> 3;
  // the loop test is the warp's first row, so the shuffles stay whole
  for (long long r = tid >> 3; r - lane8 < rows; r += threads >> 3) {
    float acc = 0.f;
    if (r < rows) {
#pragma unroll
      for (int c = sub; c < D / 8; c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(o + r * D + 8 * c);
        const uint4 y =
            *reinterpret_cast<const uint4*>(dout + r * D + 8 * c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
          const float2 yf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
          acc = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, acc));
        }
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < rows && sub == 0) {
      // r = (b * S + s) * Hq + h
      const int h = static_cast<int>(r % Hq);
      const long long bs = r / Hq;
      const long long b = bs / S;
      const int s = static_cast<int>(bs % S);
      const long long at = (b * Hq + h) * S_pad + s;
      di[at] = acc;
      lse2[at] = lse_log2(lse[(b * Hq + h) * S + s]);
    }
  }
  const long long pad = static_cast<long long>(B) * Hq * (S_pad - S);
  for (long long i = tid; i < pad; i += threads) {
    const long long bh = i / (S_pad - S);
    const long long at = bh * S_pad + S + i % (S_pad - S);
    di[at] = 0.f;
    lse2[at] = INFINITY;
  }
  for (long long i = tid; i < n_counters; i += threads) counters[i] = 0;
}

// dq = bf16(scale * dq_acc). A dq_acc tile holds a dQ partial as the
// consumer warpgroup staged it: float4 (c, t) of thread t at c * 128 + t,
// its accumulators 4 c .. 4 c + 3 (t = 32 w + 4 grp + tig).
// D 64 / 128 (dQ, 64 rows x 64 columns): rows 16 w + grp and + 8, columns
// 8 c + 2 tig and + 1. A thread takes the 4 float4 of one (c, w, grp),
// tig 0..3 (64 contiguous bytes), and writes the 8 columns 8 c .. 8 c + 7
// of its two rows as two 16-byte stores; c runs fastest, so 8
// neighbouring threads write a row's 64 columns.
// D 256 (dQ^T, a warpgroup's 128 columns x 32 positions, float4 c = 4 c2 +
// j): columns 64 c2 + 16 w + grp and + 8, positions 8 j + 2 tig and + 1.
// A thread takes the 8 float4 of one (c, w, tig), grp 0..7, and writes
// the 16 columns 64 c2 + 16 w .. + 15 of its two positions as four
// 16-byte stores.
// D 16 (dQ, 64 rows x 16 columns, float4 c = 0, 1): rows 16 w + grp and
// + 8, columns 8 c + 2 tig and + 1. A thread takes the 8 float4 of one
// (w, grp), tig 0..3 and c 0..1, and writes its two rows of 32 bytes.
template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_post_kernel(const float* __restrict__ acc,
                   __nv_bfloat16* __restrict__ dq, int B, int S, int Hq,
                   int Tq, float scale) {
  constexpr int kPer = D == 64 || D == 128 ? 4 : 8;  // float4 a thread
  constexpr int kItems = kTile<D> / (4 * kPer);      // threads a tile
  const long long n =
      static_cast<long long>(B) * Hq * Tq * kAdds<D> * kItems;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long f = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       f < n; f += threads) {
    const long long tile = f / kItems;
    const int within = static_cast<int>(f % kItems);
    const int cb = static_cast<int>(tile % kAdds<D>);
    const long long rest = tile / kAdds<D>;
    const int m = static_cast<int>(rest % Tq);
    const long long bh = rest / Tq;
    const int h = static_cast<int>(bh % Hq);
    const long long b = bh / Hq;
    const float4* src = reinterpret_cast<const float4*>(acc) +
                        tile * (kTile<D> / 4);
    float4 v[kPer];
    if constexpr (D == 16) {
      const int w = within / 8, grp = within % 8;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int tig = 0; tig < 4; ++tig)
          v[4 * c + tig] = src[c * 128 + 32 * w + 4 * grp + tig];
      const int s0 = m * kBr<D> + 16 * w + grp;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (s0 + 8 * e >= S) continue;
        uint32_t x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          x[i] = e ? tc::pack_bf16(v[i].z * scale, v[i].w * scale)
                   : tc::pack_bf16(v[i].x * scale, v[i].y * scale);
        uint4* out = reinterpret_cast<uint4*>(
            dq + ((b * S + s0 + 8 * e) * Hq + h) * D);
        out[0] = make_uint4(x[0], x[1], x[2], x[3]);
        out[1] = make_uint4(x[4], x[5], x[6], x[7]);
      }
    } else if constexpr (D == 256) {
      const int tig = within % 4, w = (within / 4) % 4, c = within / 16;
#pragma unroll
      for (int g = 0; g < 8; ++g) v[g] = src[c * 128 + 32 * w + 4 * g + tig];
      const int col = 128 * cb + 64 * (c / 4) + 16 * w;
      const int s0 = m * kBr<D> + 8 * (c % 4) + 2 * tig;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (s0 + e >= S) continue;
        uint32_t x[8];
#pragma unroll
        for (int g = 0; g < 8; g += 2) {
          x[g / 2] = e ? tc::pack_bf16(v[g].y * scale, v[g + 1].y * scale)
                       : tc::pack_bf16(v[g].x * scale, v[g + 1].x * scale);
          x[4 + g / 2] =
              e ? tc::pack_bf16(v[g].w * scale, v[g + 1].w * scale)
                : tc::pack_bf16(v[g].z * scale, v[g + 1].z * scale);
        }
        uint4* out = reinterpret_cast<uint4*>(
            dq + ((b * S + s0 + e) * Hq + h) * D + col);
        out[0] = make_uint4(x[0], x[1], x[2], x[3]);
        out[1] = make_uint4(x[4], x[5], x[6], x[7]);
      }
    } else {
      const int c = within % 8, wg = within / 8;     // wg = 8 w + grp
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = src[c * 128 + 4 * wg + k];
      const int col = 64 * cb + 8 * c;
      const int s0 = m * kBr<D> + 16 * (wg >> 3) + (wg & 7);
      if (s0 < S)
        *reinterpret_cast<uint4*>(dq + ((b * S + s0) * Hq + h) * D + col) =
            make_uint4(tc::pack_bf16(v[0].x * scale, v[0].y * scale),
                       tc::pack_bf16(v[1].x * scale, v[1].y * scale),
                       tc::pack_bf16(v[2].x * scale, v[2].y * scale),
                       tc::pack_bf16(v[3].x * scale, v[3].y * scale));
      if (s0 + 8 < S)
        *reinterpret_cast<uint4*>(dq + ((b * S + s0 + 8) * Hq + h) * D +
                                  col) =
            make_uint4(tc::pack_bf16(v[0].z * scale, v[0].w * scale),
                       tc::pack_bf16(v[1].z * scale, v[1].w * scale),
                       tc::pack_bf16(v[2].z * scale, v[2].w * scale),
                       tc::pack_bf16(v[3].z * scale, v[3].w * scale));
    }
  }
}

// The loader (one thread of the producer warpgroup): takes work tiles
// (key tile ascending, then batch row and KV head) from the dispenser,
// loads each tile's K and V, and streams the Q / dO / lse / Di tiles of
// its walk through the ring, in the consumers' order.
template <int D>
__device__ __forceinline__ void load(const Args& a, const CUtensorMap* tq,
                                     const CUtensorMap* tdo,
                                     const CUtensorMap* tk,
                                     const CUtensorMap* tv, uint8_t* sm) {
  using L = Smem<D>;
  constexpr int kStages = L::kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::oBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  uint64_t* kv_empty = kv_full + 1;
  volatile int* tile_slot = reinterpret_cast<volatile int*>(sm + L::oTile);
  const int G = a.Hq / a.Hkv, pairs = a.B * a.Hkv;
  int qt = 0;
  for (int it = 0;; ++it) {
    hop::mbar_wait(kv_empty, (it & 1) ^ 1);
    const int t = atomicAdd(a.next_tile, 1);
    *tile_slot = t;
    if (t >= a.n_tiles) {
      hop::mbar_arrive(kv_full);
      return;
    }
    const int n = t / pairs / kColSplit<D>, b = (t % pairs) / a.Hkv;
    const int hk = t % a.Hkv;
    hop::mbar_expect(kv_full, 2 * L::kKV);
#pragma unroll
    for (int c = 0; c < L::kHalves; ++c) {
      hop::tma_load_4d(sm + L::oK + c * L::kKVHalf, tk, 64 * c, hk,
                       n * kBc<D>, b, kv_full);
      hop::tma_load_4d(sm + L::oV + c * L::kKVHalf, tv, 64 * c, hk,
                       n * kBc<D>, b, kv_full);
    }
    const int lo = m_first<D>(a, n);
    for (int m = m_last<D>(a, n); m >= lo; --m)
      for (int g = 0; g < G; ++g, ++qt) {
        const int s = qt % kStages;
        hop::mbar_wait(empty + s, ((qt / kStages) & 1) ^ 1);
        const int h = hk * G + g;
        constexpr int kR = kBr<D>;
        hop::mbar_expect(full + s, 2 * L::kQ + 2 * kR * 4);
#pragma unroll
        for (int c = 0; c < L::kHalves; ++c) {
          hop::tma_load_4d(sm + L::oQ + s * L::kQ + c * L::kQHalf, tq,
                           64 * c, h, m * kR, b, full + s);
          hop::tma_load_4d(sm + L::oDO + s * L::kQ + c * L::kQHalf, tdo,
                           64 * c, h, m * kR, b, full + s);
        }
        const long long row =
            (static_cast<long long>(b) * a.Hq + h) * a.S_pad + m * kR;
        hop::bulk_load(sm + L::oL + s * kR * 4, a.lse2 + row, kR * 4,
                       full + s);
        hop::bulk_load(sm + L::oI + s * kR * 4, a.di + row, kR * 4,
                       full + s);
      }
  }
}

// A dQ writer (one thread of the producer warpgroup for each consumer
// warpgroup): takes the warpgroup's staged partials in order; once a
// partial's counter shows that every earlier key tile of its query tile
// has added, one bulk reduce-add of its 16 KB (4 KB at D 16) into dq_acc
// (a bulk store for the first). Two are kept in flight: when a third is
// issued, the oldest has completed, and its counter and staging buffer
// are released.
// Before any wait it releases what it has issued, so that a block waiting
// on this one never waits on work this one holds back.
// `kBufs` staging buffers of `kFloats` floats at `stage`, each with its
// note and its full / empty barriers.
template <int kBufs, int kFloats>
__device__ __forceinline__ void write_ring(const Args& a, uint64_t* dq_full,
                                           uint64_t* dq_empty,
                                           const volatile Note* notes,
                                           const uint8_t* stage) {
  int* held[2];                          // counters of the partials in flight
  int n_held = 0, k = 0;
  auto release = [&](int count) {        // the oldest `count` have completed
    hop::fence_async_global();
    __threadfence();
    for (int i = 0; i < count; ++i) {
      atomicAdd(held[i], 1);
      hop::mbar_arrive(dq_empty + (k - n_held + i) % kBufs);
    }
    for (int i = count; i < n_held; ++i) held[i - count] = held[i];
    n_held -= count;
  };
  for (;;) {
    const int buf = k % kBufs;
    const uint32_t parity = (k / kBufs) & 1;
    if (!hop::mbar_test(dq_full + buf, parity)) {
      if (n_held) {
        hop::bulk_wait_all();
        release(n_held);
      }
      hop::mbar_wait(dq_full + buf, parity);
    }
    const volatile Note& note = notes[buf];
    if (note.done) {
      if (n_held) {
        hop::bulk_wait_all();
        release(n_held);
      }
      return;
    }
    int* ctr = a.counters + note.ctr;
    if (hop::ld_acquire(ctr) < note.target) {
      if (n_held) {
        hop::bulk_wait_all();
        release(n_held);
      }
      hop::spin_until_at_least(ctr, note.target);
    }
    hop::fence_async_global();
    const uint8_t* src = stage + buf * kFloats * 4;
    if (note.target == 0)                // the query tile's first partial
      hop::bulk_store(a.dq_acc + note.tile, src, kFloats * 4);
    else
      hop::bulk_reduce_add(a.dq_acc + note.tile, src, kFloats * 4);
    held[n_held++] = ctr;
    ++k;                                 // in flight: k - n_held .. k - 1
    if (n_held == 2) {
      hop::bulk_wait_one();              // all but the newest completed
      release(1);
    }
  }
}

template <int D>
__device__ __forceinline__ void write_dq(const Args& a, uint8_t* sm, int w) {
  using L = Smem<D>;
  constexpr int kBufs = L::kBufs;
  uint64_t* dq_full =
      reinterpret_cast<uint64_t*>(sm + L::oBar) + 2 * L::kStages + 2 +
      w * kBufs;
  write_ring<kBufs, kTileFloats>(
      a, dq_full, dq_full + 2 * kBufs,
      reinterpret_cast<const volatile Note*>(sm + L::oNote) + w * kBufs,
      sm + L::oStage + w * kBufs * kTileFloats * 4);
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64)
    hop::wgmma_rs_n64<1>(d, a, db, 1);
  else
    hop::wgmma_rs_n128<1>(d, a, db, 1);
}

// S^T (or dP^T) of a warpgroup's 64 keys and N queries, both operands
// K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_scores(float (&d)[N / 2], uint64_t da,
                                             uint64_t db) {
  if constexpr (N == 32)
    hop::wgmma_ss_n32<0, 0>(d, da, db, 1);
  else
    hop::wgmma_ss_n64<0, 0>(d, da, db, 1);
}

// Accumulators as the bf16 A operand of k-steps of 16 of their columns.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&out)[N / 16][4],
                                       const float (&f)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      out[kk][r] = tc::pack_bf16(f[8 * kk + 2 * r], f[8 * kk + 2 * r + 1]);
}

// A consumer warpgroup sharing a work tile by keys (D 64):
// the 64 keys key0.. of each work tile. Per query
// tile: S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in shared
// memory), P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q
// (wgmma, A from registers), dS^T to shared memory, and dQ_partial = dS K
// over the tile's 128 keys (wgmma from shared memory): at D 128 each
// warpgroup its 64 columns, at D 64 the two take turns by query tile.
// The partial is staged in shared memory for the producer to add.
template <int D>
__device__ __forceinline__ void consume(const Args& a, uint8_t* sm, int wg,
                                        int tid) {
  using L = Smem<D>;
  constexpr int kStages = L::kStages;
  constexpr int NA = D / 2;              // dK / dV accumulators a thread
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::oBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  uint64_t* kv_empty = kv_full + 1;
  constexpr int kBufs = L::kBufs;
  uint64_t* dq_full = kv_empty + 1 + wg * kBufs;  // this warpgroup's ring
  uint64_t* dq_empty = dq_full + 2 * kBufs;
  const volatile int* tile_slot =
      reinterpret_cast<const volatile int*>(sm + L::oTile);
  Note* notes = reinterpret_cast<Note*>(sm + L::oNote) + wg * kBufs;
  const uint32_t base = hop::smem_u32(sm);
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const int G = a.Hq / a.Hkv, pairs = a.B * a.Hkv;
  float dk[NA], dv[NA];
  int qt = 0, staged = 0;
  // waits for this warpgroup's next staging buffer; returns it
  auto next_stage = [&]() {
    const int buf = staged % kBufs;
    hop::mbar_wait(dq_empty + buf, ((staged / kBufs) & 1) ^ 1);
    return buf;
  };
  for (int it = 0;; ++it) {
    hop::mbar_wait(kv_full, it & 1);
    const int t = *tile_slot;
    if (t >= a.n_tiles) {
      const int buf = next_stage();
      if (tid == 0) notes[buf].done = 1;
      hop::mbar_arrive(dq_full + buf);
      return;
    }
    const int n = t / pairs, b = (t % pairs) / a.Hkv, hk = t % a.Hkv;
    const int key0 = n * kBc<D> + 64 * wg;  // this warpgroup's first key
    const int kr = 64 * wg + 16 * warp + grp;  // its rows kr, kr + 8
#pragma unroll
    for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
    const int lo = m_first<D>(a, n);
    for (int m = m_last<D>(a, n); m >= lo; --m)
      for (int g = 0; g < G; ++g, ++qt) {
        const int s = qt % kStages;
        hop::mbar_wait(full + s, (qt / kStages) & 1);
        const uint32_t qs = base + L::oQ + s * L::kQ;
        const uint32_t dos = base + L::oDO + s * L::kQ;
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        hop::fence_regs(sc);
        hop::fence_regs(dp);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * L::kKVHalf + wg * 64 * 128 +
                               (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * L::kQHalf + (kk % 4) * 32;
          hop::wgmma_ss_n64<0, 0>(sc, hop::desc_sw128(base + L::oK + off, 16),
                                  hop::desc_sw128(qs + qoff, 16), 1);
          hop::wgmma_ss_n64<0, 0>(dp, hop::desc_sw128(base + L::oV + off, 16),
                                  hop::desc_sw128(dos + qoff, 16), 1);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        hop::fence_regs(dp);

        const int q0 = m * kBr<D>;
        const float* ls = reinterpret_cast<const float*>(sm + L::oL) +
                          s * kBr<D>;
        const float* is = reinterpret_cast<const float*>(sm + L::oI) +
                          s * kBr<D>;
        // every pair of this warpgroup's block visible: no mask
        const bool open = key0 + 63 < a.S && q0 + kBr<D> <= a.S &&
                          (!a.causal || q0 >= key0 + 63) &&
                          (a.window <= 0 ||
                           q0 + kBr<D> - 1 - a.window < key0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * tig + (e & 1);
            const int key = key0 + 16 * warp + grp + 8 * (e >> 1);
            const int q = q0 + col;
            const bool ok = open || (key < a.S && q < a.S &&
                                     sees(key, q, a.causal, a.window));
            float p, dsv;
            score_grad(sc[4 * j + e], dp[4 * j + e], is[col], ls[col],
                       a.scale, a.c_exp, a.softcap, p, dsv);
            sc[4 * j + e] = ok ? p : 0.f;
            dp[4 * j + e] = ok ? dsv : 0.f;
          }
        uint32_t pa[4][4], da[4][4];     // A of k-step kk: queries 16 kk..
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = tc::pack_bf16(sc[8 * kk + 2 * r],
                                      sc[8 * kk + 2 * r + 1]);
            da[kk][r] = tc::pack_bf16(dp[8 * kk + 2 * r],
                                      dp[8 * kk + 2 * r + 1]);
          }
        // dS^T, swizzled as the tiles TMA writes: row = key, 64 queries
        uint8_t* dsb = sm + L::oDS + (qt & 1) * L::kDS;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(dsb + (kr + 8 * h) * 128 +
                                         ((j ^ grp) << 4) + 4 * tig) =
                da[j >> 1][(j & 1) * 2 + h];
        hop::fence_async_smem();
        hop::named_sync(1, kConsumers);  // both halves of dS^T written

        const bool does_dq = D == 128 || (qt & 1) == wg;
        const int cb = D == 128 ? wg : 0;  // dQ's 64-column block
        float dq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;
        hop::fence_regs(dq);
        hop::fence_regs(pa);
        hop::fence_regs(da);
        hop::wgmma_fence();
        // the three products' k-steps interleaved, so that their chains
        // overlap (faster on the card than one product after another)
        const uint32_t dsu = hop::smem_u32(dsb);
        const uint32_t kb = base + L::oK + cb * L::kKVHalf;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<D>(dv, pa[kk],
                      hop::desc_sw128(dos + kk * 2048, L::kQHalf));
          wgmma_rs<D>(dk, da[kk], hop::desc_sw128(qs + kk * 2048, L::kQHalf));
          if (does_dq)
#pragma unroll
            for (int k2 = 2 * kk; k2 < 2 * kk + 2; ++k2)
              hop::wgmma_ss_n64<1, 1>(
                  dq, hop::desc_sw128(dsu + k2 * 2048, L::kDS),
                  hop::desc_sw128(kb + k2 * 2048, L::kKVHalf), 1);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(dv);
        hop::fence_regs(dk);
        hop::fence_regs(dq);
        hop::fence_regs(pa);
        hop::fence_regs(da);
        if (lane == 0) hop::mbar_arrive(empty + s);

        if (does_dq) {
          // stage the partial (float4 c of thread t at c * 128 + t: no bank
          // conflicts) with the note the producer orders it by
          const int buf = next_stage();
          float4* stage = reinterpret_cast<float4*>(
              sm + L::oStage + (wg * kBufs + buf) * kTileFloats * 4);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            stage[c * 128 + tid] = make_float4(dq[4 * c], dq[4 * c + 1],
                                               dq[4 * c + 2], dq[4 * c + 3]);
          if (tid == 0) {
            const int h = hk * G + g;
            const long long ctr = (static_cast<long long>(b) * a.Hq + h) *
                                      a.Tq + m;
            Note& note = notes[buf];
            note.tile = (ctr * kAdds<D> + cb) * kTileFloats;
            note.ctr = static_cast<int>(ctr);
            note.target = kAdds<D> * (n - n_first<D>(a, m));
            note.done = 0;
          }
          hop::fence_async_smem();
          hop::mbar_arrive(dq_full + buf);
          ++staged;
        }
      }
    if (lane == 0) hop::mbar_arrive(kv_empty);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = key0 + 16 * warp + grp + 8 * h;
        if (key >= a.S) continue;
        const long long at =
            ((static_cast<long long>(b) * a.S + key) * a.Hkv + hk) * D +
            8 * j + 2 * tig;
        *reinterpret_cast<uint32_t*>(a.dk + at) = tc::pack_bf16(
            dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + at) =
            tc::pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
  }
}

// The two consumer warpgroups sharing a work tile by roles (`kByRoles`, D
// 128 and 256): a work tile is 64 keys and 128 output columns c0 ..
// (`kColSplit`), and both warpgroups take all 64 keys. Warpgroup 0 forms
// S^T = K Q^T, P^T and dV += P^T dO; warpgroup 1 dP^T = V dO^T, dS^T, dK
// += dS^T Q and dQ. Warpgroup 0 hands P on through shared memory in
// float32 as F^T = P^T (1 - (t / softcap)^2) (P^T itself without a
// softcap), so that dS^T = F^T (dP^T - Di): each warpgroup holds 64
// accumulators of dV or dK and one of S^T, dP^T. With dK and dV and both
// score tiles in one warpgroup (128 keys shared by halves, D 128's first
// design), ptxas spilled and serialised the wgmmas. Warpgroup 1 forms
// dQ on the tile's columns as dQ partials, each staged into a writer's
// ring: at D 128 dQ = dS K, two of 64 columns, from dS^T [key][query]; at
// D 256 dQ^T = K^T dS^T, one of 128 columns in two 64-column chunks, from
// dS [query][key] (32 positions are too few rows for a wgmma's 64, 64
// columns are not).
template <int D>
__device__ __forceinline__ void consume_roles(const Args& a, uint8_t* sm,
                                              int wg, int tid) {
  using L = Smem<D>;
  constexpr int kStages = L::kStages;
  constexpr int kBufs = L::kBufs;
  constexpr int NQ = kBr<D>;             // queries a tile: 64 (D 128), 32
  constexpr int NS = NQ / 2;             // S^T or dP^T accumulators
  constexpr int kParts = kAdds<D> / kColSplit<D>;  // dQ partials a tile
  constexpr int kChunks = D == 256 ? 2 : 1;        // wgmmas a partial
  constexpr int NC = 32 / kChunks;       // accumulators a chunk
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::oBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* dq_full = kv_empty + 1;      // writer w's ring at + w * kBufs
  uint64_t* dq_empty = dq_full + 2 * kBufs;
  const volatile int* tile_slot =
      reinterpret_cast<const volatile int*>(sm + L::oTile);
  Note* notes = reinterpret_cast<Note*>(sm + L::oNote);
  const uint32_t base = hop::smem_u32(sm);
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const int G = a.Hq / a.Hkv, pairs = a.B * a.Hkv;
  // F^T by query tile parity: float4 j of thread t at j * 128 + t
  float4* fbuf = reinterpret_cast<float4*>(sm + L::oF);
  uint8_t* dsb = sm + L::oDS;
  const uint32_t dsu = hop::smem_u32(dsb);
  float acc[64];                         // dV (warpgroup 0) or dK (1)
  int qt = 0, staged[2] = {0, 0};
  auto next_stage = [&](int w) {
    const int buf = staged[w] % kBufs;
    hop::mbar_wait(dq_empty + w * kBufs + buf,
                   ((staged[w] / kBufs) & 1) ^ 1);
    return buf;
  };
  for (int it = 0;; ++it) {
    hop::mbar_wait(kv_full, it & 1);
    const int t = *tile_slot;
    if (t >= a.n_tiles) {
      if (wg == 1)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int buf = next_stage(w);
          if (tid == 0) notes[w * kBufs + buf].done = 1;
          hop::mbar_arrive(dq_full + w * kBufs + buf);
        }
      return;
    }
    const int n = t / pairs / kColSplit<D>, half = (t / pairs) % kColSplit<D>;
    const int b = (t % pairs) / a.Hkv, hk = t % a.Hkv;
    const int key0 = n * kBc<D>, c0 = 128 * half;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const int lo = m_first<D>(a, n);
    for (int m = m_last<D>(a, n); m >= lo; --m)
      for (int g = 0; g < G; ++g, ++qt) {
        const int s = qt % kStages;
        hop::mbar_wait(full + s, (qt / kStages) & 1);
        const uint32_t qs = base + L::oQ + s * L::kQ;
        const uint32_t dos = base + L::oDO + s * L::kQ;
        // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1), over the head
        const uint32_t xa = base + (wg == 0 ? L::oK : L::oV);
        const uint32_t xb = wg == 0 ? qs : dos;
        float sc[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] = 0.f;
        hop::fence_regs(sc);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * L::kKVHalf + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * L::kQHalf + (kk % 4) * 32;
          wgmma_scores<NQ>(sc, hop::desc_sw128(xa + off, 16),
                           hop::desc_sw128(xb + qoff, 16));
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);

        const int q0 = m * NQ;
        const float* ls = reinterpret_cast<const float*>(sm + L::oL) + s * NQ;
        const float* is = reinterpret_cast<const float*>(sm + L::oI) + s * NQ;
        float4* fb = fbuf + (qt & 1) * (NS / 4) * 128;
        // the tile's 128 columns of dO (warpgroup 0) or Q (1), MN-major
        const uint32_t cols = (wg == 0 ? dos : qs) + 2 * half * L::kQHalf;
        uint32_t pa[NQ / 16][4];
        if (wg == 0) {
          // every pair of the block visible: no mask
          const bool open = key0 + 63 < a.S && q0 + NQ <= a.S &&
                            (!a.causal || q0 >= key0 + 63) &&
                            (a.window <= 0 || q0 + NQ - 1 - a.window < key0);
#pragma unroll
          for (int j = 0; j < NQ / 8; ++j) {
            float f[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * tig + (e & 1);
              const int key = key0 + 16 * warp + grp + 8 * (e >> 1);
              const int q = q0 + col;
              const bool ok = open || (key < a.S && q < a.S &&
                                       sees(key, q, a.causal, a.window));
              float p, fv;
              score_p(sc[4 * j + e], ls[col], a.scale, a.c_exp, a.softcap,
                      p, fv);
              sc[4 * j + e] = ok ? p : 0.f;
              f[e] = ok ? fv : 0.f;
            }
            fb[j * 128 + tid] = make_float4(f[0], f[1], f[2], f[3]);
          }
          hop::named_arrive(2 + (qt & 1), kConsumers);  // F^T written
          pack_a<NQ>(pa, sc);
          hop::fence_regs(pa);
          hop::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NQ / 16; ++kk)
            hop::wgmma_rs_n128<1>(
                acc, pa[kk], hop::desc_sw128(cols + kk * 2048, L::kQHalf),
                1);
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::fence_regs(acc);
          hop::fence_regs(pa);
          if (lane == 0) hop::mbar_arrive(empty + s);
          continue;
        }
        hop::named_sync(2 + (qt & 1), kConsumers);      // F^T of this tile
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          const float4 f = fb[j * 128 + tid];
          const float fe[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = fe[e] * (sc[4 * j + e] - is[8 * j + 2 * tig +
                                                        (e & 1)]);
        }
        pack_a<NQ>(pa, sc);
        if constexpr (D == 256) {
          // dS [query][key], 128-byte swizzled: the 16-byte chunk c (keys
          // 8 c ..) of query row q at chunk c ^ (q % 8)
#pragma unroll
          for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = 8 * j + 2 * tig + (e & 1);
              const int key = 16 * warp + grp + 8 * (e >> 1);
              const uint32_t pair = pa[j >> 1][(j & 1) * 2 + (e >> 1)];
              *reinterpret_cast<uint16_t*>(
                  dsb + q * 128 + (((key >> 3) ^ (q & 7)) << 4) +
                  2 * (key & 7)) =
                  static_cast<uint16_t>((e & 1) ? pair >> 16
                                                : pair & 0xffffu);
            }
        } else {
          // dS^T [key][query], swizzled as the tiles TMA writes
#pragma unroll
          for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint32_t*>(
                  dsb + (16 * warp + grp + 8 * h) * 128 +
                  ((j ^ grp) << 4) + 4 * tig) = pa[j >> 1][(j & 1) * 2 + h];
        }
        hop::fence_async_smem();
        hop::fence_regs(pa);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
          hop::wgmma_rs_n128<1>(
              acc, pa[kk], hop::desc_sw128(cols + kk * 2048, L::kQHalf), 1);
        hop::wgmma_commit();
        hop::named_sync(4, 128);         // the warpgroup's dS is written
        // dK in before dQ's products are issued: with dK's A registers
        // still held, ptxas put dQ's accumulators on them and serialised
        // every wgmma of the kernel
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
        hop::fence_regs(pa);
        if (lane == 0) hop::mbar_arrive(empty + s);
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          const int cb = half * kParts + part;   // the partial's dq_acc tile
          const int w = kParts == 1 ? (qt & 1) : part;  // its writer
          const int buf = next_stage(w);
          float4* stage = reinterpret_cast<float4*>(
              sm + L::oStage + (w * kBufs + buf) * kTileFloats * 4);
#pragma unroll
          for (int c2 = 0; c2 < kChunks; ++c2) {
            float dq[NC];
#pragma unroll
            for (int i = 0; i < NC; ++i) dq[i] = 0.f;
            hop::fence_regs(dq);
            hop::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBc<D> / 16; ++kk) {
              if constexpr (D == 256)   // dQ^T, 64 columns x 32 positions
                hop::wgmma_ss_n32<1, 0>(
                    dq, hop::desc_sw128(base + L::oK + (2 * cb + c2) *
                                        L::kKVHalf + kk * 2048, L::kKVHalf),
                    hop::desc_sw128(dsu + kk * 32, 16), 1);
              else                      // dQ, 64 positions x 64 columns
                hop::wgmma_ss_n64<1, 1>(
                    dq, hop::desc_sw128(dsu + kk * 2048, L::kDS),
                    hop::desc_sw128(base + L::oK + cb * L::kKVHalf +
                                    kk * 2048, L::kKVHalf), 1);
            }
            hop::wgmma_commit();
            hop::wgmma_wait<0>();
            hop::fence_regs(dq);
#pragma unroll
            for (int c = 0; c < NC / 4; ++c)
              stage[(c2 * NC / 4 + c) * 128 + tid] = make_float4(
                  dq[4 * c], dq[4 * c + 1], dq[4 * c + 2], dq[4 * c + 3]);
          }
          if (tid == 0) {
            const int h = hk * G + g;
            const long long ctr =
                (static_cast<long long>(b) * a.Hq + h) * a.Tq + m;
            Note& note = notes[w * kBufs + buf];
            note.tile = (ctr * kAdds<D> + cb) * kTileFloats;
            note.ctr = static_cast<int>(ctr);
            note.target = kAdds<D> * (n - n_first<D>(a, m));
            note.done = 0;
          }
          hop::fence_async_smem();
          hop::mbar_arrive(dq_full + w * kBufs + buf);
          ++staged[w];
        }
      }
    if (lane == 0) hop::mbar_arrive(kv_empty);
    // dV unscaled, dK times the scale
    __nv_bfloat16* out = wg == 0 ? a.dv : a.dk;
    const float mul = wg == 0 ? 1.f : a.scale;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = key0 + 16 * warp + grp + 8 * h;
        if (key >= a.S) continue;
        const long long at =
            ((static_cast<long long>(b) * a.S + key) * a.Hkv + hk) * D +
            c0 + 8 * j + 2 * tig;
        *reinterpret_cast<uint32_t*>(out + at) = tc::pack_bf16(
            acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 D 16: two pipelines a block (`consume16`)
// ---------------------------------------------------------------------------
// At D 16 the products are the small part of the work: each score costs
// an exp on the SFU (16 a clock an SM) and ~5 float32 operations, against
// 5 x 16 multiply-adds on the tensor cores. So each consumer warpgroup
// runs a pipeline of its own, with its own loader, ring, dQ writer and
// work tiles: the two meet at no barrier, and while one waits on its
// wgmmas the other's warps issue their exps. A work tile is 128 keys (two
// 64-row halves). For each 64-position query tile a warpgroup forms S^T
// and dP^T of a half (wgmma m64n64k16, one k-step each), P^T and dS^T in
// registers (each score's exp once), dV += P^T dO and dK += dS^T Q
// (m64n16, A from registers), dS^T [key][query] into shared memory; then
// the query tile's dQ partial = dS K over the 128 keys (m64n16, both
// operands in shared memory), staged for its writer. Heads of 16
// are rows of 32 bytes, which TMA loads 32-byte swizzled
// (`hop::desc_sw32`); dS^T keeps 128-byte rows of 64 queries.

// Pipelines a block (at most two: their loaders and dQ writers take a
// warp each of one producer warpgroup).
constexpr int k16Pipes = 2;
static_assert(k16Pipes <= 2, "one producer warpgroup hosts the roles");
constexpr int k16Threads = 128 * (1 + k16Pipes);

struct Smem16 {                          // one pipeline, byte offsets
  static constexpr int kStages = 4;      // Q / dO / lse / Di
  static constexpr int kBufs = 4;        // dQ staging
  static constexpr int kKV = kBc<16> * 32;           // K or V of a work tile
  static constexpr int kQ = kBr<16> * 32;            // Q or dO of a query tile
  static constexpr int kDS = kBc<16> * kBr<16> * 2;  // dS^T, bf16
  static constexpr int oK = 0, oV = oK + 2 * kKV;    // two work tiles each
  static constexpr int oDS = oV + 2 * kKV;
  static constexpr int oQ = oDS + kDS, oDO = oQ + kStages * kQ;
  static constexpr int oStage = oDO + kStages * kQ;
  static constexpr int oL = oStage + kBufs * kTile<16> * 4;  // lse2
  static constexpr int oI = oL + kStages * kBr<16> * 4;      // Di
  // full[kStages], empty[kStages], kv_full[2], kv_empty[2],
  // dq_full[kBufs], dq_empty[kBufs]; then the two tile slots and the
  // partials' notes
  static constexpr int oBar = oI + kStages * kBr<16> * 4;
  static constexpr int kBars = 2 * kStages + 4 + 2 * kBufs;
  static constexpr int oTile = oBar + kBars * 8;
  static constexpr int oNote = oTile + 16;
  static constexpr int kPipe = (oNote + kBufs * 16 + 1023) / 1024 * 1024;
  static constexpr int kBytes = k16Pipes * kPipe + 1024;  // + alignment
  static_assert(kBytes <= 232448, "past a block's shared memory");
};

struct Bars16 {                          // a pipeline's mbarriers
  uint64_t *full, *empty, *kv_full, *kv_empty, *dq_full, *dq_empty;
  __device__ explicit Bars16(uint8_t* sm) {
    full = reinterpret_cast<uint64_t*>(sm + Smem16::oBar);
    empty = full + Smem16::kStages;
    kv_full = empty + Smem16::kStages;
    kv_empty = kv_full + 2;
    dq_full = kv_empty + 2;
    dq_empty = dq_full + Smem16::kBufs;
  }
};

// S^T (or dP^T) of 64 keys and 64 queries: the 64 rows of 16 at x times
// those at y, both K-major (one k-step). d is only written, so that
// nothing defines it while other wgmmas are in flight: ptxas serialises
// every wgmma of a kernel that defines an accumulator there.
__device__ __forceinline__ void scores16(float (&d)[32], uint32_t x,
                                         uint32_t y) {
  hop::wgmma_ss_n64_set<0, 0>(d, hop::desc_sw32(x, 16),
                              hop::desc_sw32(y, 16));
}

// dV += P^T dO and dK += dS^T Q of one 64-key half (64 x 16 each): A the
// packed 64 x 64 accumulators pa, da (k-steps of 16 queries), B the 64
// rows of 16 at dos, qs (MN-major). The two chains' k-steps interleaved,
// so that no wgmma waits on the one before it.
__device__ __forceinline__ void dkdv16(float (&dv)[8], float (&dk)[8],
                                       const uint32_t (&pa)[4][4],
                                       const uint32_t (&da)[4][4],
                                       uint32_t dos, uint32_t qs) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hop::wgmma_rs_n16<1>(
        dv, pa[kk], hop::desc_sw32(dos + kk * 512, Smem16::kQ), 1);
    hop::wgmma_rs_n16<1>(
        dk, da[kk], hop::desc_sw32(qs + kk * 512, Smem16::kQ), 1);
  }
}

// A warp's packed dS^T rows `row` and `row` + 8 (keys; row % 8 = grp) into
// ds [key][64 queries], 128-byte swizzled as TMA would write it.
__device__ __forceinline__ void store_ds16(uint8_t* ds, int row, int tig,
                                           const uint32_t (&da)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(ds + (row + 8 * hh) * 128 +
                                   ((j ^ (row & 7)) << 4) + 4 * tig) =
          da[j >> 1][(j & 1) * 2 + hh];
}

// dQ (64 queries x 16) = dS K over the 128 keys as two sums, one a
// 64-key half (dq0 + dq1; their k-steps interleaved, each sum's first
// product only writes it, as in scores16): dS^T at ds (MN-major A), K's
// rows of 16 at k (MN-major B).
__device__ __forceinline__ void dq16(float (&dq0)[8], float (&dq1)[8],
                                     uint32_t ds, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k2 = 4 * h + kk;
      const uint64_t da = hop::desc_sw128(ds + k2 * 2048, Smem16::kDS);
      const uint64_t db = hop::desc_sw32(k + k2 * 512, Smem16::kKV);
      float (&d)[8] = h ? dq1 : dq0;
      if (kk == 0)
        hop::wgmma_ss_n16_set<1, 1>(d, da, db);
      else
        hop::wgmma_ss_n16<1, 1>(d, da, db, 1);
    }
}

// P^T and dS^T of one half in place of S^T (sc) and dP^T (dp): the keys
// key, key + 8 of this thread, the queries q0 + 8 j + 2 tig (+ 1). kMask:
// some pair of the half may be hidden (causal, window, past S).
template <bool kCap, bool kMask>
__device__ __forceinline__ void score_math16(const Args& a, float (&sc)[32],
                                             float (&dp)[32], const float* ls,
                                             const float* is, int key,
                                             int q0, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * tig);
    const float2 di = *reinterpret_cast<const float2*>(is + 8 * j + 2 * tig);
#pragma unroll
    for (int e = 0; e < 4; e += 2) {     // one key, two queries
      float* s2 = sc + 4 * j + e;
      float* d2 = dp + 4 * j + e;
      float p[2], f[2];
      if constexpr (kCap) {
        score_p(s2[0], l2.x, a.scale, a.c_exp, a.softcap, p[0], f[0]);
        score_p(s2[1], l2.y, a.scale, a.c_exp, a.softcap, p[1], f[1]);
      } else {
        f[0] = p[0] = tc::exp2_approx(fmaf(s2[0], a.c_exp, -l2.x));
        f[1] = p[1] = tc::exp2_approx(fmaf(s2[1], a.c_exp, -l2.y));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ds = f[i] * (d2[i] - (i ? di.y : di.x));
        if constexpr (kMask) {
          const int k = key + 4 * e, q = q0 + 8 * j + 2 * tig + i;
          const bool ok =
              k < a.S && q < a.S && sees(k, q, a.causal, a.window);
          p[i] = ok ? p[i] : 0.f;
          ds = ok ? ds : 0.f;
        }
        s2[i] = p[i];
        d2[i] = ds;
      }
    }
  }
}

// A pipeline's loader (one thread): takes work tiles from the dispenser,
// loads each one's K and V into one of two buffers (the next tile's while
// the consumers finish this one), and streams the Q / dO / lse / Di tiles
// of its walk through the ring.
__device__ __forceinline__ void load16(const Args& a, const CUtensorMap* tq,
                                       const CUtensorMap* tdo,
                                       const CUtensorMap* tk,
                                       const CUtensorMap* tv, uint8_t* sm) {
  using L = Smem16;
  constexpr int kR = kBr<16>;
  const Bars16 bar(sm);
  volatile int* slot = reinterpret_cast<volatile int*>(sm + L::oTile);
  const int G = a.Hq / a.Hkv, pairs = a.B * a.Hkv;
  int qt = 0;
  for (int it = 0;; ++it) {
    const int kb = it & 1;
    hop::mbar_wait(bar.kv_empty + kb, ((it >> 1) & 1) ^ 1);
    const int t = atomicAdd(a.next_tile, 1);
    slot[kb] = t;
    if (t >= a.n_tiles) {
      hop::mbar_arrive(bar.kv_full + kb);
      return;
    }
    const int n = t / pairs, b = (t % pairs) / a.Hkv, hk = t % a.Hkv;
    hop::mbar_expect(bar.kv_full + kb, 2 * L::kKV);
    hop::tma_load_4d(sm + L::oK + kb * L::kKV, tk, 0, hk, n * kBc<16>, b,
                     bar.kv_full + kb);
    hop::tma_load_4d(sm + L::oV + kb * L::kKV, tv, 0, hk, n * kBc<16>, b,
                     bar.kv_full + kb);
    const int lo = m_first<16>(a, n);
    for (int m = m_last<16>(a, n); m >= lo; --m)
      for (int g = 0; g < G; ++g, ++qt) {
        const int s = qt % L::kStages;
        hop::mbar_wait(bar.empty + s, ((qt / L::kStages) & 1) ^ 1);
        const int h = hk * G + g;
        hop::mbar_expect(bar.full + s, 2 * L::kQ + 2 * kR * 4);
        hop::tma_load_4d(sm + L::oQ + s * L::kQ, tq, 0, h, m * kR, b,
                         bar.full + s);
        hop::tma_load_4d(sm + L::oDO + s * L::kQ, tdo, 0, h, m * kR, b,
                         bar.full + s);
        const long long row =
            (static_cast<long long>(b) * a.Hq + h) * a.S_pad + m * kR;
        hop::bulk_load(sm + L::oL + s * kR * 4, a.lse2 + row, kR * 4,
                       bar.full + s);
        hop::bulk_load(sm + L::oI + s * kR * 4, a.di + row, kR * 4,
                       bar.full + s);
      }
  }
}

// A pipeline's consumer warpgroup (see the section's note). A query
// tile takes three round trips to the tensor cores: S^T and dP^T of half
// 0; those of half 1 with dV and dK of half 0; dV and dK of half 1 with
// dQ. Both halves are always formed (a half that sees no pair of the
// query tile is masked to zero: the causal diagonal and the ragged edge),
// so that what is in flight never depends on the tile, and nothing but
// a wgmma defines an accumulator while one is in flight (ptxas
// serialises every wgmma of the kernel otherwise).
__device__ __forceinline__ void consume16(const Args& a, uint8_t* block,
                                          int wg, int tid) {
  using L = Smem16;
  constexpr int kR = kBr<16>;
  uint8_t* sm = block + wg * L::kPipe;
  const Bars16 bar(sm);
  const volatile int* slot =
      reinterpret_cast<const volatile int*>(sm + L::oTile);
  Note* notes = reinterpret_cast<Note*>(sm + L::oNote);
  const uint32_t base = hop::smem_u32(sm);
  uint8_t* dsb = sm + L::oDS;
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const int G = a.Hq / a.Hkv, pairs = a.B * a.Hkv;
  float dk[2][8], dv[2][8];              // a half each
  uint32_t pa[4][4], da[4][4];           // P^T, dS^T as A of k-steps of 16
  int qt = 0, staged = 0;
  for (int it = 0;; ++it) {
    const int kb = it & 1;
    hop::mbar_wait(bar.kv_full + kb, (it >> 1) & 1);
    const int t = slot[kb];
    if (t >= a.n_tiles) {
      const int buf = staged % L::kBufs;
      hop::mbar_wait(bar.dq_empty + buf, ((staged / L::kBufs) & 1) ^ 1);
      if (tid == 0) notes[buf].done = 1;
      hop::mbar_arrive(bar.dq_full + buf);
      return;
    }
    const int n = t / pairs, b = (t % pairs) / a.Hkv, hk = t % a.Hkv;
    const int key0 = n * kBc<16>;
    const uint32_t ks = base + L::oK + kb * L::kKV;
    const uint32_t vs = base + L::oV + kb * L::kKV;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i) dk[h][i] = dv[h][i] = 0.f;
    const int lo = m_first<16>(a, n);
    for (int m = m_last<16>(a, n); m >= lo; --m)
      for (int g = 0; g < G; ++g, ++qt) {
        const int s = qt % L::kStages;
        hop::mbar_wait(bar.full + s, (qt / L::kStages) & 1);
        const uint32_t qs = base + L::oQ + s * L::kQ;
        const uint32_t dos = base + L::oDO + s * L::kQ;
        const float* ls = reinterpret_cast<const float*>(sm + L::oL) + s * kR;
        const float* is = reinterpret_cast<const float*>(sm + L::oI) + s * kR;
        const int q0 = m * kR;
        // P^T and dS^T of half h from S^T and dP^T, packed into pa, da,
        // dS^T stored
        auto half = [&](float (&sc)[32], float (&dp)[32], int h) {
          const int kh = key0 + 64 * h;
          // every pair of the half visible: no mask
          const bool open = kh + 63 < a.S && q0 + kR <= a.S &&
                            (!a.causal || q0 >= kh + 63) &&
                            (a.window <= 0 || q0 + kR - 1 - a.window < kh);
          const int key = kh + 16 * warp + grp;
          if (a.softcap > 0.f) {
            if (open)
              score_math16<true, false>(a, sc, dp, ls, is, key, q0, tig);
            else
              score_math16<true, true>(a, sc, dp, ls, is, key, q0, tig);
          } else if (open) {
            score_math16<false, false>(a, sc, dp, ls, is, key, q0, tig);
          } else {
            score_math16<false, true>(a, sc, dp, ls, is, key, q0, tig);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              pa[kk][r] = tc::pack_bf16(sc[8 * kk + 2 * r],
                                        sc[8 * kk + 2 * r + 1]);
              da[kk][r] = tc::pack_bf16(dp[8 * kk + 2 * r],
                                        dp[8 * kk + 2 * r + 1]);
            }
          store_ds16(dsb, 64 * h + 16 * warp + grp, tig, da);
        };
        float sc[32], dp[32];            // written by the wgmmas
        hop::wgmma_fence();
        scores16(sc, ks, qs);
        scores16(dp, vs, dos);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        hop::fence_regs(dp);
        half(sc, dp, 0);
        hop::fence_regs(pa);
        hop::fence_regs(da);
        hop::wgmma_fence();
        scores16(sc, ks + 2048, qs);
        scores16(dp, vs + 2048, dos);
        dkdv16(dv[0], dk[0], pa, da, dos, qs);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        hop::fence_regs(dp);
        hop::fence_regs(dv[0]);
        hop::fence_regs(dk[0]);
        hop::fence_regs(pa);
        hop::fence_regs(da);
        half(sc, dp, 1);
        hop::fence_async_smem();
        hop::named_sync(1 + wg, 128);    // the four warps' dS^T rows
        float dq0[8], dq1[8];            // written by the wgmmas
        hop::fence_regs(pa);
        hop::fence_regs(da);
        hop::wgmma_fence();
        dkdv16(dv[1], dk[1], pa, da, dos, qs);
        dq16(dq0, dq1, base + L::oDS, ks);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(dv[1]);
        hop::fence_regs(dk[1]);
        hop::fence_regs(pa);
        hop::fence_regs(da);
        hop::fence_regs(dq0);
        hop::fence_regs(dq1);
        if (lane == 0) hop::mbar_arrive(bar.empty + s);
        // stage the partial (float4 c of thread t at c * 128 + t) with the
        // note its writer orders it by
        const int buf = staged % L::kBufs;
        hop::mbar_wait(bar.dq_empty + buf, ((staged / L::kBufs) & 1) ^ 1);
        float4* stage =
            reinterpret_cast<float4*>(sm + L::oStage + buf * kTile<16> * 4);
        stage[tid] = make_float4(dq0[0] + dq1[0], dq0[1] + dq1[1],
                                 dq0[2] + dq1[2], dq0[3] + dq1[3]);
        stage[128 + tid] = make_float4(dq0[4] + dq1[4], dq0[5] + dq1[5],
                                       dq0[6] + dq1[6], dq0[7] + dq1[7]);
        if (tid == 0) {
          const int h = hk * G + g;
          const long long ctr =
              (static_cast<long long>(b) * a.Hq + h) * a.Tq + m;
          Note& note = notes[buf];
          note.tile = ctr * kTile<16>;
          note.ctr = static_cast<int>(ctr);
          note.target = n - n_first<16>(a, m);
          note.done = 0;
        }
        hop::fence_async_smem();
        hop::mbar_arrive(bar.dq_full + buf);
        ++staged;
      }
    if (lane == 0) hop::mbar_arrive(bar.kv_empty + kb);
    // dV unscaled, dK times the scale
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = key0 + 64 * h + 16 * warp + grp + 8 * hh;
          if (key >= a.S) continue;
          const long long at =
              ((static_cast<long long>(b) * a.S + key) * a.Hkv + hk) * 16 +
              8 * j + 2 * tig;
          *reinterpret_cast<uint32_t*>(a.dk + at) =
              tc::pack_bf16(dk[h][4 * j + 2 * hh] * a.scale,
                            dk[h][4 * j + 2 * hh + 1] * a.scale);
          *reinterpret_cast<uint32_t*>(a.dv + at) = tc::pack_bf16(
              dv[h][4 * j + 2 * hh], dv[h][4 * j + 2 * hh + 1]);
        }
  }
}

// The D 16 main kernel's roles: in the producer warpgroup, lane 0 of
// warp p loads for pipeline p and lane 0 of warp k16Pipes + p writes its
// dQ partials; consumer warpgroup 1 + p runs pipeline p.
__device__ __forceinline__ void run16(const Args& a, const CUtensorMap* tq,
                                      const CUtensorMap* tdo,
                                      const CUtensorMap* tk,
                                      const CUtensorMap* tv, uint8_t* sm) {
  using L = Smem16;
  if (threadIdx.x == 0) {
    for (int p = 0; p < k16Pipes; ++p) {
      const Bars16 bar(sm + p * L::kPipe);
      for (int s = 0; s < L::kStages; ++s) {
        hop::mbar_init(bar.full + s, 1);
        hop::mbar_init(bar.empty + s, 4);      // a consumer's warps
      }
      for (int i = 0; i < 2; ++i) {
        hop::mbar_init(bar.kv_full + i, 1);
        hop::mbar_init(bar.kv_empty + i, 4);
      }
      for (int i = 0; i < L::kBufs; ++i) {
        hop::mbar_init(bar.dq_full + i, 128);
        hop::mbar_init(bar.dq_empty + i, 1);
      }
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {
    hop::setmaxnreg_dec<kProducerRegs>();
    const int w = threadIdx.x / 32;
    if (threadIdx.x % 32 != 0 || w >= 2 * k16Pipes) return;
    if (w < k16Pipes) {
      load16(a, tq, tdo, tk, tv, sm + w * L::kPipe);
    } else {
      uint8_t* pipe = sm + (w - k16Pipes) * L::kPipe;
      const Bars16 bar(pipe);
      write_ring<L::kBufs, kTile<16>>(
          a, bar.dq_full, bar.dq_empty,
          reinterpret_cast<const volatile Note*>(pipe + L::oNote),
          pipe + L::oStage);
    }
  } else {
    hop::setmaxnreg_inc<kConsumerRegs>();
    consume16(a, sm, wgi - 1, threadIdx.x % 128);
  }
}

// A card test of the D 16 operand layouts (tests/test_torch_kernels_cuda.py):
// one warpgroup loads x (128 rows of 16), y (64) and w (128) by TMA as the
// kernel loads K, Q and dO, and with the kernel's helpers writes, float32
// row-major: s (128 x 64) = x y^T a 64-row half at a time (S^T = K Q^T);
// pw (128 x 16) = bf16(s_h) w[0:64] a half at a time (dV += P^T dO; both
// chains of dkdv16 alike, else NaN); dq (64 x 16) = bf16(s)^T w, dS^T
// through shared memory (dQ = dS K).
__global__ void __launch_bounds__(128)
fa_bwd_d16_probe_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap ty,
                        const __grid_constant__ CUtensorMap tw,
                        float* __restrict__ s, float* __restrict__ pw,
                        float* __restrict__ dq) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int oX = 0, oY = 4096, oW = 8192, oDS = 16384, oBar = 32768;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + oBar);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  if (tid == 0) {
    hop::mbar_init(bar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hop::mbar_expect(bar, 4096 + 2048 + 4096);
    hop::tma_load_4d(sm + oX, &tx, 0, 0, 0, 0, bar);
    hop::tma_load_4d(sm + oY, &ty, 0, 0, 0, 0, bar);
    hop::tma_load_4d(sm + oW, &tw, 0, 0, 0, 0, bar);
  }
  hop::mbar_wait(bar, 0);
  const uint32_t base = hop::smem_u32(sm);
  for (int h = 0; h < 2; ++h) {
    float sc[32], acc[8], acc2[8];
    uint32_t pa[4][4];
    for (int i = 0; i < 8; ++i) acc[i] = acc2[i] = 0.f;
    hop::wgmma_fence();
    scores16(sc, base + oX + h * 2048, base + oY);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    for (int kk = 0; kk < 4; ++kk)
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = tc::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    store_ds16(sm + oDS, 64 * h + 16 * warp + grp, tig, pa);
    hop::fence_regs(pa);
    hop::fence_regs(acc);
    hop::fence_regs(acc2);
    hop::wgmma_fence();
    dkdv16(acc, acc2, pa, pa, base + oW, base + oW);  // both chains alike
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    hop::fence_regs(acc2);
    hop::fence_regs(pa);
    for (int i = 0; i < 32; ++i) {
      const int row = 64 * h + 16 * warp + grp + 8 * ((i & 3) >> 1);
      s[row * 64 + 8 * (i >> 2) + 2 * tig + (i & 1)] = sc[i];
    }
    for (int i = 0; i < 8; ++i) {
      const int row = 64 * h + 16 * warp + grp + 8 * ((i & 3) >> 1);
      pw[row * 16 + 8 * (i >> 2) + 2 * tig + (i & 1)] =
          acc[i] == acc2[i] ? acc[i] : NAN;
    }
  }
  hop::fence_async_smem();
  __syncthreads();
  float dq0[8], dq1[8];
  hop::wgmma_fence();
  dq16(dq0, dq1, base + oDS, base + oW);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(dq0);
  hop::fence_regs(dq1);
  for (int i = 0; i < 8; ++i) {
    const int row = 16 * warp + grp + 8 * ((i & 3) >> 1);
    dq[row * 16 + 8 * (i >> 2) + 2 * tig + (i & 1)] = dq0[i] + dq1[i];
  }
}

// The producer warpgroup (warps 0-3: the loader in warp 0, a dQ writer
// in each of warps 1 and 2) and two consumer warpgroups (warps 4-11).
// setmaxnreg moves registers from the producer to the consumers: a
// quarter of the SM's register file (one sub-partition) holds 3 warps,
// 40 + 2 x 232 registers a thread.
template <int D>
__device__ __forceinline__ void run(const Args& a, const CUtensorMap* tq,
                                    const CUtensorMap* tdo,
                                    const CUtensorMap* tk,
                                    const CUtensorMap* tv, uint8_t* sm) {
  using L = Smem<D>;
  constexpr int kStages = L::kStages;
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::oBar);
    constexpr int kConsumerWarps = kConsumers / 32;
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(bars + s, 1);                            // full
      hop::mbar_init(bars + kStages + s, kConsumerWarps);     // empty
    }
    hop::mbar_init(bars + 2 * kStages, 1);                    // kv_full
    hop::mbar_init(bars + 2 * kStages + 1, kConsumerWarps);   // kv_empty
    for (int i = 0; i < 2 * L::kBufs; ++i) {
      hop::mbar_init(bars + 2 * kStages + 2 + i, 128);        // dq_full
      hop::mbar_init(bars + 2 * kStages + 2 + 2 * L::kBufs + i, 1);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  // the warpgroup index from lane 0: provably the same across the warp,
  // which setmaxnreg (.sync.aligned) needs for ptxas to use the new counts
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) load<D>(a, tq, tdo, tk, tv, sm);
    if (threadIdx.x == 32) write_dq<D>(a, sm, 0);
    if (threadIdx.x == 64) write_dq<D>(a, sm, 1);
  } else {
    hop::setmaxnreg_inc<kConsumerRegs>();
    if constexpr (kByRoles<D>)
      consume_roles<D>(a, sm, wgi - 1, threadIdx.x % 128);
    else
      consume<D>(a, sm, wgi - 1, threadIdx.x % 128);
  }
}

template <int D>
__global__ void __launch_bounds__(D == 16 ? k16Threads : kThreads, 1)
fa_bwd_main_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  if constexpr (D == 16)
    run16(a, &tq, &tdo, &tk, &tv, sm);
  else
    run<D>(a, &tq, &tdo, &tk, &tv, sm);
}

// The main kernel's shared memory.
template <int D>
constexpr int main_bytes() {
  if constexpr (D == 16)
    return Smem16::kBytes;
  else
    return Smem<D>::kBytes;
}

struct Workspace {                       // carved from the wrapper's bytes
  long long dq_acc, di, lse2, counters, bytes;   // float / int offsets
};

Workspace workspace(int B, int S, int Hq, int D) {
  const long long br = D == 256 ? kBr<256> : kBr<64>;
  const long long s_pad = (S + br - 1) / br * br;
  const long long tq = s_pad / br;
  Workspace w;
  w.dq_acc = 0;
  w.di = static_cast<long long>(B) * Hq * s_pad * D;
  w.lse2 = w.di + B * Hq * s_pad;
  w.counters = w.lse2 + B * Hq * s_pad;
  w.bytes = 4 * (w.counters + B * Hq * tq + 1);
  return w;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           void* work, int B, int S, int Hq, int Hkv, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const int Tq = (S + kBr<D> - 1) / kBr<D>, Tk = (S + kBc<D> - 1) / kBc<D>;
  const long long n_tiles =
      static_cast<long long>(Tk) * kColSplit<D> * B * Hkv;
  if (n_tiles == 0) return 0;
  if (n_tiles > 0x7fffffffLL || static_cast<long long>(B) * Hq * Tq >
                                    0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int sms = hop::sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorNoDevice);
  const Workspace ws = workspace(B, S, Hq, D);
  float* wf = static_cast<float*>(work);
  Args a;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dq_acc = wf + ws.dq_acc;
  a.di = wf + ws.di;
  a.lse2 = wf + ws.lse2;
  a.counters = reinterpret_cast<int*>(wf + ws.counters);
  a.next_tile = a.counters + static_cast<long long>(B) * Hq * Tq;
  a.B = B; a.S = S; a.Hq = Hq; a.Hkv = Hkv; a.Tq = Tq; a.S_pad = Tq * kBr<D>;
  a.n_tiles = static_cast<int>(n_tiles);
  a.scale = scale; a.c_exp = scale * kLog2e; a.softcap = softcap;
  a.causal = causal; a.window = window;

  fa_bwd_prep_kernel<D><<<4 * sms, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, wf + ws.di,
      wf + ws.lse2, a.counters, B, S, Hq, a.S_pad,
      B * Hq * Tq + 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // after a launch: the runtime has made its context current on this
  // thread (autograd's backward runs on a worker thread), which the
  // driver's encoder needs
  CUtensorMap tq, tdo, tk, tv;
  if (hop::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  constexpr int kCols = D == 16 ? 16 : 64;       // a box's columns
  if (!hop::tensor_map(&tq, q, B, S, Hq, D, kBr<D>, 1, kCols) ||
      !hop::tensor_map(&tdo, dout, B, S, Hq, D, kBr<D>, 1, kCols) ||
      !hop::tensor_map(&tk, k, B, S, Hkv, D, kBc<D>, 1, kCols) ||
      !hop::tensor_map(&tv, v, B, S, Hkv, D, kBc<D>, 1, kCols))
    return static_cast<int>(cudaErrorInvalidPitchValue);
  constexpr int kBytes = main_bytes<D>();
  constexpr int kPipes = D == 16 ? k16Pipes : 1;   // work tiles at a time
  err = cudaFuncSetAttribute(fa_bwd_main_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_tiles + kPipes - 1) / kPipes;
  const int grid = static_cast<int>(blocks < sms ? blocks : sms);
  fa_bwd_main_kernel<D><<<grid, D == 16 ? k16Threads : kThreads, kBytes,
                          stream>>>(tq, tdo, tk, tv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_post_kernel<D><<<4 * sms, 256, 0, stream>>>(
      a.dq_acc, static_cast<__nv_bfloat16*>(dq), B, S, Hq, Tq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgk

template <typename T>
int launch_di(const void* o, const void* dout, float* di, int B, int S,
              int Hq, int D, cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(B) * S * Hq;
  if (n_rows == 0) return 0;
  constexpr int kRowsPerDiBlock = 8;
  const long long blocks = (n_rows + kRowsPerDiBlock - 1) / kRowsPerDiBlock;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  di_kernel<T><<<static_cast<unsigned>(blocks), 32 * kRowsPerDiBlock, 0,
                 stream>>>(static_cast<const T*>(o),
                           static_cast<const T*>(dout), di, n_rows, S, Hq, D);
  return static_cast<int>(cudaGetLastError());
}

// bf16 takes the warpgroup kernels at every head dimension.
bool warpgroup_path(int D, int dtype) {
  return dtype == 1 && (D == 16 || D == 64 || D == 128 || D == 256);
}

}  // namespace

// Bytes of the float32 workspace the wrapper allocates for one call:
// (B, Hq, S) of Di for the FMA kernels; for the warpgroup kernels dq_acc
// (B, Hq, S_pad, D in tiles of kTile floats), Di and the lse in log2
// units (B, Hq, S_pad; S_pad a whole number of query tiles), the
// counters and the dispenser.
extern "C" long long flash_attention_bwd_workspace_bytes(int B, int S,
                                                         int Hq, int D,
                                                         int dtype) {
  if (warpgroup_path(D, dtype)) return wgk::workspace(B, S, Hq, D).bytes;
  return 4LL * B * Hq * S;
}

// The D 16 operand-layout probe (`wgk::fa_bwd_d16_probe_kernel`) on x
// (128 rows of 16 bf16), y (64 rows) and w (128 rows), writing s (128 x
// 64), pw (128 x 16) and dq (64 x 16) float32, row-major. Returns
// cudaGetLastError() (0 = ok).
extern "C" int flash_attention_bwd_d16_probe(const void* x, const void* y,
                                             const void* w, float* s,
                                             float* pw, float* dq,
                                             void* stream) {
  constexpr int kBytes = 32768 + 64 + 1024;        // + alignment slack
  // a runtime call first: the encoder wants the runtime's context current
  cudaError_t err = cudaFuncSetAttribute(
      wgk::fa_bwd_d16_probe_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hop::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tx, ty, tw;
  if (!hop::tensor_map(&tx, x, 1, 128, 1, 16, 128, 1, 16) ||
      !hop::tensor_map(&ty, y, 1, 64, 1, 16, 64, 1, 16) ||
      !hop::tensor_map(&tw, w, 1, 128, 1, 16, 128, 1, 16))
    return static_cast<int>(cudaErrorInvalidPitchValue);
  wgk::fa_bwd_d16_probe_kernel<<<1, 128, kBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      tx, ty, tw, s, pw, dq);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (tensor cores); D in
// {16, 64, 128, 256} (the wrapper checks). work: the workspace above.
// bf16: the pre-pass, the warpgroup kernel and the post-pass; float32:
// the Di pass, the dk/dv kernel and the dq kernel.
// All on `stream`; returns the first cudaGetLastError() that is not 0
// (0 = ok).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* work, int B, int S, int Hq, int Hkv, int D, int dtype, float scale,
    int causal, int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  if (warpgroup_path(D, dtype)) {
    if (D == 16)
      return wgk::launch<16>(q, k, v, o, ls, dout, dq, dk, dv, work, B, S,
                             Hq, Hkv, scale, causal, window, softcap, st);
    if (D == 64)
      return wgk::launch<64>(q, k, v, o, ls, dout, dq, dk, dv, work, B, S,
                             Hq, Hkv, scale, causal, window, softcap, st);
    if (D == 128)
      return wgk::launch<128>(q, k, v, o, ls, dout, dq, dk, dv, work, B, S,
                              Hq, Hkv, scale, causal, window, softcap, st);
    return wgk::launch<256>(q, k, v, o, ls, dout, dq, dk, dv, work, B, S,
                            Hq, Hkv, scale, causal, window, softcap, st);
  }
  float* dis = static_cast<float*>(work);
  int err = dtype == 0 ? launch_di<float>(o, dout, dis, B, S, Hq, D, st)
          : dtype == 1 ? launch_di<__nv_bfloat16>(o, dout, dis, B, S, Hq, D,
                                                  st)
                       : static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
#define FB_CASE(FN, DIM)                                                   \
  return FN<DIM>(q, k, v, dout, ls, dis, dq, dk, dv, B, S, Hq, Hkv, scale, \
                 causal, window, softcap, st)
  if (dtype == 0) {
    if (D == 16) FB_CASE(launch_f32, 16);
    if (D == 64) FB_CASE(launch_f32, 64);
    if (D == 128) FB_CASE(launch_f32, 128);
    if (D == 256) FB_CASE(launch_f32, 256);
  }
#undef FB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
