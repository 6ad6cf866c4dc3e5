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
// lse and the scratch di: (B, Hq, S) float32; dq, dk, dv in the inputs'
// type, sums in float32.
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
// Design (simple and deterministic first: no atomics, so a run repeats
// its bits): three launches.
// 1. `di_kernel`: Di, one warp a row.
// 2. `dkdv_*_kernel`: one block per (batch row, KV head, tile of keys),
//    walking every query row of the group that can see its keys; dK and dV
//    accumulate in registers and are written once. The G heads of a GQA
//    group are packed into the rows of the query tiles as in the forward
//    (packed row r = query head hk * G + r % G at position r / G), so the
//    sum over the group is the same walk.
// 3. `dq_*_kernel`: one block per (batch row, KV head, tile of packed query
//    rows), walking the key tiles it can see; dQ accumulates in registers.
// S and dP are computed in both 2 and 3 (seven products instead of five):
// the price of writing each gradient from one block without atomics.
//
// bf16: mma.sync m16n8k16 (tensor_core.cuh), fragments exactly as in the
// forward. Every product is one of the forward's two shapes: X Y^T with X
// and Y rows in shared memory (S = Q K^T, dP = dO V^T; in the dk/dv kernel
// S^T = K Q^T and dP^T = V dO^T), or A B with A a float32 accumulator
// fragment rounded to bf16 in registers and B rows read with
// ldmatrix.trans (dQ += dS K; dV += P^T dO; dK += dS^T Q). Tiles stream
// through two shared-memory stages with cp.async. A fragments are read
// from shared memory at each k-step (no register copy of Q or K), which
// leaves the float32 accumulators the registers. At D 256 the dk/dv kernel
// splits the output columns over two blocks (each 2 x 128 accumulators a
// warp's rows; both recompute S and dP), and from D 128 both kernels take
// 32-key or 32-row tiles: no instance spills. Measured (chip_smoke.py, one
// H100 80GB HBM3 at 700 W): computing each packed row's position r / G
// once per tile instead of once per score took the training shape from
// 6.85 to 5.42 ms; skipping the mask on tiles that every row sees whole
// (as the forward does) to 4.00 ms. P is one FMA and one MUFU op, 2^(s c
// - l2), with c = scale log2(e) and the row's lse held in log2 units
// (+inf for a row that saw no key, so that its P is 0 without a test per
// score). Keeping Q, dO, K and V fragments in registers at D 64
// (with 32-row tiles in the dk/dv kernel to make room) took it to 5.82,
// and was taken out.
//
// float32 (the smoke-width models): FP32 FMAs, as the forward's float32
// kernel: one block of 4 warps per (batch row, head, 32 rows), lane j
// taking key (or query) j of a 32-wide tile, columns lane + 32 c.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

}  // namespace

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (tensor cores); D in
// {16, 64, 128, 256} (the wrapper checks). di: (B, Hq, S) float32 scratch.
// Launches the Di pass, the dk/dv kernel and the dq kernel on `stream`;
// returns the first cudaGetLastError() that is not 0 (0 = ok).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* di, int B, int S, int Hq, int Hkv, int D, int dtype, float scale,
    int causal, int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* dis = static_cast<float*>(di);
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
  } else {
    if (D == 16) FB_CASE(launch_bf16, 16);
    if (D == 64) FB_CASE(launch_bf16, 64);
    if (D == 128) FB_CASE(launch_bf16, 128);
    if (D == 256) FB_CASE(launch_bf16, 256);
  }
#undef FB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
