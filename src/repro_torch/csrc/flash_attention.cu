// Attention forward with online softmax: causal, sliding window, tanh
// logit softcap, grouped-query heads.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at :126).
// q: (B, S, Hq, D), k and v: (B, S, Hkv, D), bf16 or f32, contiguous;
// output (B, S, Hq, D) in q's type.
//
// What bounds it on an H100: at the trust evaluator's shape (B = 4096,
// S = 31, D = 64, 9 query heads over 3 KV heads) one call moves 390 MB of
// q, k, v and o for 4.68 GFLOP, ~12 FLOP per byte, far below the ~295 at
// which the tensor cores would become the limit: the bytes bound it
// (0.116 ms at 3.35 TB/s). The long causal prefill (B = 1, S = 1984) does
// ~2000 FLOP per byte and leans on the tensor cores instead.
//
// bf16 (the evaluator and prefill): `flash_attention_bf16_kernel`, on the
// tensor cores through mma.sync m16n8k16 (tensor_core.cuh).
// - GQA packing: one block per (batch row, KV head, tile of 16 packed
//   query rows per warp), packed row r being query head hk * G + r % G at
//   position r / G. Such rows are D contiguous elements at stride Hq * D,
//   so Q loads and O stores are whole 16-byte chunks, and one K/V tile in
//   shared memory feeds all G heads of the group: K and V are read once
//   per KV head, not G times. At the evaluator's shape a pair's 93 packed
//   rows fit one block of 6 warps and one 64-key tile.
// - Q, K and V are staged in bf16 with 16-byte cp.async copies, rows
//   padded by 16 bytes so that the 8 rows of each ldmatrix fall in
//   distinct bank groups. K/V tiles stream through a ring of kStages
//   slots, so that the next tiles' copies are in flight while this one is
//   multiplied (the prefill's long S); a short S takes only the slots it
//   has tiles for.
// - QK^T accumulates in float32 fragments; the softcap and the causal and
//   window masks (on the packed row's position r / G, skipped for a tile
//   every row of the warp sees whole) are applied to the fragments in
//   registers, the row max and sum are quad shuffles, and the running max,
//   denominator and output stay in float32 registers. p = 2^(s c - m c)
//   is one FMA and one MUFU op. P is split in registers into two bf16
//   terms, hi = bf16(p) and lo = bf16(p - hi), each the A fragment of one
//   PV product on the same V fragments (read with ldmatrix.trans): PV
//   keeps ~16 bits of p. bf16 p alone, as the reference's jnp path rounds
//   it, held each call within 2e-2 but moved the decode logits of the
//   30-layer model past the full forward's by 0.1016 (the chip check's
//   limit is 0.1); the split costs ~6% at the evaluator's shape.
// - Tiles wholly above the causal diagonal or behind the window are not
//   loaded; a warp skips the 16-key steps past its last row's position.
//   Blocks are ordered heaviest causal tile first.
// - Why mma.sync and not wgmma/TMA: the evaluator's shape is bound by
//   bytes, and mma.sync gives far more than the ~40 TFLOP/s that 4.68
//   GFLOP in 0.12 ms needs; wgmma's 64-row shared-memory operands and
//   descriptors would buy nothing at 93 rows per pair.
//
// float32 (the smoke-width evaluator, D = 16): `flash_attention_f32_kernel`
// in FP32 FMAs, since TF32 tensor cores would miss the 1e-4 float32
// tolerance. One block of 4 warps per (batch, query head, 32-row query
// tile); lane j scores key j of a 32-key tile against the warp's 8 rows,
// then accumulates output columns lane + 32 c over the tile's keys.
//
// D 256 (Gemma-2: 8 query heads over 4, softcap 50, a 4096-key window on
// alternate layers): the same bf16 kernel with two K/V stages instead of
// three (three would need 270,336 B of shared memory at 8 warps, over the
// 232,448 a block may have) and the Q fragments read from shared memory at
// each k-step rather than held in registers, which leaves the 128 float32
// accumulators of a thread's output rows the registers they need. The
// float32 kernel takes D 256 as it is (99,328 B of shared memory).
//
// Both accept any S (rows and keys past S are masked) and D in {16, 64,
// 128, 256}; a row that sees no key writes zeros.
//
// Training: given an `lse` pointer, both kernels also write each row's
// natural log-sum-exp of its scaled, softcapped, masked scores, (B, Hq, S)
// float32 (-inf for a row that sees no key), which the backward
// (flash_attention_bwd.cu) reads to rebuild the softmax: one float a row,
// from the statistics the online softmax already holds. It is a template
// flag, so the serving path (a null pointer) runs the same instance as
// before; the write kept live across the key loop took the D 256 bf16
// instance from a 24-byte spill to 48.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16: tensor cores, GQA group packed into the rows of a tile
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;        // keys per K/V tile
constexpr int kMaxWarps = 8;     // 16 packed query rows each
constexpr int kLongWarps = 4;    // warps per block when S * G is long

// K/V tiles in the ring: 3, or 2 at D 256, where 3 would take 270,336 B of
// shared memory with kMaxWarps of Q rows (a block may have 232,448).
template <int D>
constexpr int kStages = D > 128 ? 2 : 3;

// Q fragments stay in registers for the whole key loop up to D 128; at D
// 256 they would take 64 registers a thread beside the 128 of the output
// accumulator, so they are read from the staged Q rows at each k-step.
template <int D>
constexpr bool kQInRegisters = D <= 128;

template <int D>
constexpr int kPaddedRow = D + 8;  // bf16 elements of a shared row, +16 bytes

// K/V ring slots a launch needs: no more than S has tiles.
template <int D>
__host__ __device__ inline int kv_slots(int S) {
  const int tiles = (S + kKeys - 1) / kKeys;
  return tiles < kStages<D> ? (tiles > 0 ? tiles : 1) : kStages<D>;
}

// Q (later O) rows, then the K and V tiles of the ring.
template <int D>
size_t bf16_smem_bytes(int n_warps, int S) {
  const int stages = kv_slots<D>(S);
  return sizeof(__nv_bfloat16) * kPaddedRow<D> *
         (16 * n_warps + stages * 2 * kKeys);
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int B, int S,
                            int Hq, int Hkv, int n_tiles, float scale,
                            int causal, int window, float softcap) {
  constexpr int DP = kPaddedRow<D>;
  constexpr int CPR = D / 8;               // 16-byte chunks per row
  constexpr int KS = D / 16;               // k-steps of QK^T
  constexpr int NT = kKeys / 8;            // n-tiles of S per key tile
  constexpr int kSt = kStages<D>;
  constexpr bool kQRegs = kQInRegisters<D>;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int n_warps = blockDim.x >> 5;
  const int M = 16 * n_warps;
  const int stages = kv_slots<D>(S);
  __nv_bfloat16* Qs = smem;                // [M][DP], later O
  __nv_bfloat16* Ks = Qs + M * DP;         // [stages][kKeys][DP]
  __nv_bfloat16* Vs = Ks + stages * kKeys * DP;

  const int G = Hq / Hkv;
  const int rows = S * G;                  // packed rows of a pair
  const long long pairs = static_cast<long long>(B) * Hkv;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x / pairs);
  const long long pair = blockIdx.x % pairs;
  const long long b = pair / Hkv;
  const int hk = static_cast<int>(pair % Hkv);
  const int r0 = tile * M;
  const long long q_pos = static_cast<long long>(Hq) * D;  // position stride
  const long long kv_pos = static_cast<long long>(Hkv) * D;
  const __nv_bfloat16* qb =
      q + b * S * q_pos + static_cast<long long>(hk) * G * D;
  const __nv_bfloat16* kb = k + b * S * kv_pos + static_cast<long long>(hk) * D;
  const __nv_bfloat16* vb = v + b * S * kv_pos + static_cast<long long>(hk) * D;
  __nv_bfloat16* ob = o + b * S * q_pos + static_cast<long long>(hk) * G * D;

  // Packed row r of the pair lives at (r / G) * Hq * D + (r % G) * D.
  for (int i = threadIdx.x; i < M * CPR; i += blockDim.x) {
    const int rr = i / CPR, c = i % CPR, r = r0 + rr;
    const bool ok = r < rows;
    const __nv_bfloat16* src =
        ok ? qb + (r / G) * q_pos + (r % G) * D + c * 8 : qb;
    tc::cp_async16(Qs + rr * DP + c * 8, src, ok);
  }

  // Key tiles the block's rows can see.
  const int p_lo = r0 / G, p_hi = (min(r0 + M, rows) - 1) / G;
  const int kv_end = causal ? p_hi + 1 : S;
  const int kv_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int t_begin = kv_begin / kKeys;
  const int t_end = (kv_end + kKeys - 1) / kKeys;

  auto load_kv = [&](int t, int stage) {
    __nv_bfloat16* ks = Ks + stage * kKeys * DP;
    __nv_bfloat16* vs = Vs + stage * kKeys * DP;
    for (int i = threadIdx.x; i < kKeys * CPR; i += blockDim.x) {
      const int j = i / CPR, c = i % CPR, pos = t * kKeys + j;
      const bool ok = pos < S;
      const long long off = ok ? pos * kv_pos + c * 8 : 0;
      tc::cp_async16(ks + j * DP + c * 8, kb + off, ok);
      tc::cp_async16(vs + j * DP + c * 8, vb + off, ok);
    }
  };
  // Q and the first kSt - 1 tiles, one commit group each (empty past the
  // last tile), so that a fixed wait count finds each tile landed.
#pragma unroll
  for (int i = 0; i < kSt - 1; ++i) {
    if (t_begin + i < t_end) load_kv(t_begin + i, i);
    tc::cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wr0 = r0 + 16 * warp;          // the warp's first packed row
  const bool live = wr0 < rows;
  const int pos_row[2] = {(wr0 + grp) / G, (wr0 + grp + 8) / G};
  const int w_lo = wr0 / G;                // the warp's first position
  const int w_hi = live ? (min(wr0 + 16, rows) - 1) / G : -1;
  const int w_kend = causal ? min(w_hi + 1, S) : S;   // keys it may see
  const int w_kbegin = window > 0 ? max(0, w_lo - window + 1) : 0;
  // p = 2^(s * c - m * c): c folds the scale and log2(e) into one FMA; with
  // the softcap, s is first mapped to softcap * log2(e) * tanh(s * scale /
  // softcap) and c = 1. m is the running row max in the units of s.
  const float c_exp = softcap > 0.f ? 1.f : scale * kLog2e;
  const float cap_in = scale / softcap, cap_out = softcap * kLog2e;

  uint32_t qf[kQRegs ? KS : 1][4];
  const __nv_bfloat16* q_frag =            // this lane's ldmatrix row of Q
      Qs + (16 * warp + (lane & 15)) * DP + (lane >> 4) * 8;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin;
    if (t + kSt - 1 < t_end) load_kv(t + kSt - 1, (it + kSt - 1) % kSt);
    tc::cp_async_commit();
    tc::cp_async_wait<kSt - 1>();          // this tile (and Q) landed
    __syncthreads();
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          tc::ldmatrix_x4(qf[ks], q_frag + ks * 16);
      }
    }
    const int k0 = t * kKeys;
    if (live && k0 < w_kend && k0 + kKeys > w_kbegin) {
      const __nv_bfloat16* ks = Ks + (it % kSt) * kKeys * DP;
      const __nv_bfloat16* vs = Vs + (it % kSt) * kKeys * DP;
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        if (k0 + 16 * jp >= w_kend) continue;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t kf[4];
          if constexpr (!kQRegs) tc::ldmatrix_x4(qf[0], q_frag + kk * 16);
          const uint32_t(&a)[4] = qf[kQRegs ? kk : 0];
          tc::ldmatrix_x4(kf, ks + (16 * jp + (lane & 7) + (lane >> 4) * 8) *
                                      DP + kk * 16 + ((lane >> 3) & 1) * 8);
          tc::mma_bf16(s[2 * jp], a, kf[0], kf[1]);
          tc::mma_bf16(s[2 * jp + 1], a, kf[2], kf[3]);
        }
      }
      if (softcap > 0.f) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = cap_out * tanhf(s[n][e] * cap_in);
      }
      // The causal and window masks on the packed rows' positions, unless
      // every key of the tile is visible to every row of the warp.
      const bool open = k0 + kKeys <= S &&
                        (!causal || k0 + kKeys - 1 <= w_lo) &&
                        (window <= 0 || k0 > w_hi - window);
      if (!open) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * n + 2 * tig + (e & 1);
            const int qpos = pos_row[e >> 1];
            bool ok = kpos < S;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) s[n][e] = -INFINITY;
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        const float m_new = fmaxf(m[h], tc::quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = tc::exp2_approx((m[h] - m_use) * c_exp);
        const float off = -m_use * c_exp;
        m[h] = m_new;
        l[h] *= corr;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * h] *= corr;
          acc[n][2 * h + 1] *= corr;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[n][e] = tc::exp2_approx(fmaf(s[n][e], c_exp, off));
            l[h] += s[n][e];
          }
      }
      // O += P V: P's fragments become the A operand, in bf16.
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if (k0 + 16 * kk >= w_kend) continue;
        uint32_t pa[4], pl[4];
        tc::split_bf16(s[2 * kk][0], s[2 * kk][1], pa[0], pl[0]);
        tc::split_bf16(s[2 * kk][2], s[2 * kk][3], pa[1], pl[1]);
        tc::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pl[2]);
        tc::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pl[3]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t vf[4];
          tc::ldmatrix_x4_trans(vf, vs + (16 * kk + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * DP +
                                        16 * np + (lane >> 4) * 8);
          tc::mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
          tc::mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
          tc::mma_bf16(acc[2 * np], pl, vf[0], vf[1]);
          tc::mma_bf16(acc[2 * np + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                       // the stage may be refilled
  }
  if (!live) return;

  // Normalise, stage the warp's 16 rows in its own Q rows, store whole
  // 16-byte chunks of the rows that exist.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float den = tc::quad_sum(l[h]);
    inv[h] = den > 0.f ? 1.f / den : 0.f;
    // m is in the units of s, m * c_exp in log2 units
    const int r = wr0 + grp + 8 * h;
    if (kLse && tig == 0 && r < rows)
      lse[(b * Hq + hk * G + r % G) * static_cast<long long>(S) + r / G] =
          den > 0.f ? (m[h] * c_exp + log2f(den)) * kLn2 : -INFINITY;
  }
  __nv_bfloat16* os = Qs + 16 * warp * DP;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(os + grp * DP + 8 * n + 2 * tig) =
        tc::pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (grp + 8) * DP + 8 * n + 2 * tig) =
        tc::pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int rr = i / CPR, c = i % CPR, r = wr0 + rr;
    if (r < rows)
      *reinterpret_cast<uint4*>(ob + (r / G) * q_pos + (r % G) * D + c * 8) =
          *reinterpret_cast<const uint4*>(os + rr * DP + c * 8);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Hq, int Hkv, float scale,
                int causal, int window, float softcap, cudaStream_t stream) {
  auto kernel = lse != nullptr ? flash_attention_bf16_kernel<D, true>
                               : flash_attention_bf16_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bf16_smem_bytes<D>(kMaxWarps, kStages<D> * kKeys)));
  if (err != cudaSuccess) return static_cast<int>(err);
  // A pair whose packed rows fit kMaxWarps warps takes one block of just
  // enough warps (the evaluator: 93 rows, 6 warps); longer ones take tiles
  // of kLongWarps warps, blocks ordered heaviest first.
  const long long rows = static_cast<long long>(S) * (Hq / Hkv);
  const int need = static_cast<int>((rows + 15) / 16);
  const int n_warps = need <= kMaxWarps ? need : kLongWarps;
  const long long n_tiles = (rows + 16 * n_warps - 1) / (16 * n_warps);
  const long long blocks = static_cast<long long>(B) * Hkv * n_tiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), 32 * n_warps,
           bf16_smem_bytes<D>(n_warps, S), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, B, S, Hq, Hkv, static_cast<int>(n_tiles), scale, causal, window,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: FP32 FMAs
// ---------------------------------------------------------------------------

constexpr int kBQ = 32;            // query rows per block
constexpr int kBK = 32;            // keys per tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;  // query rows per warp

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int S, int Hq, int Hkv,
                           float scale, int causal, int window,
                           float softcap) {
  constexpr int DP = D + 4;        // padded K row: conflict-free float4 reads
  constexpr int C = (D + 31) / 32; // output columns per lane
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;               // [kBQ][D]
  float* Ks = Qs + kBQ * D;        // [kBK][DP]
  float* Vs = Ks + kBK * DP;       // [kBK][D]

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % Hq;
  const long long b = blockIdx.x / (static_cast<long long>(n_qt) * Hq);
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const long long q_row = static_cast<long long>(Hq) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const float* qb = q + b * S * q_row + static_cast<long long>(h) * D;
  const float* kb = k + b * S * kv_row + static_cast<long long>(hk) * D;
  const float* vb = v + b * S * kv_row + static_cast<long long>(hk) * D;
  float* ob = o + b * S * q_row + static_cast<long long>(h) * D;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    Qs[idx] = s < S ? qb[s * q_row + d] : 0.f;
  }

  // Key tiles the block's rows can see.
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m[kRows], l[kRows], acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();               // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
      const int r = idx / D, d = idx % D, s = k0 + r;
      Ks[r * DP + d] = s < S ? kb[s * kv_row + d] : 0.f;
      Vs[idx] = s < S ? vb[s * kv_row + d] : 0.f;
    }
    __syncthreads();

    // Scores: lane = key of the tile, rows of this warp.
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) p[r] = 0.f;
    const float* krow = Ks + lane * DP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(Qs + (warp * kRows + r) * D + d);
        p[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      float s = p[r] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      bool ok = kpos < S;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float m_new = fmaxf(m[r], warp_max(ok ? s : -INFINITY));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      p[r] = ok ? expf(s - m_use) : 0.f;
      const float corr = expf(m[r] - m_use);
      l[r] = l[r] * corr + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= corr;
    }

    // Output: lane owns columns lane + 32 c.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        vv[c] = (D % 32 == 0 || lane + 32 * c < D)
                    ? Vs[j * D + lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] += pj * vv[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= S) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    if (kLse && lane == 0)
      lse[(b * Hq + h) * S + qpos] =
          l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (D % 32 == 0 || lane + 32 * c < D)
        ob[qpos * q_row + lane + 32 * c] = acc[r][c] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int Hq, int Hkv, float scale,
               int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 4) + kBK * D);
  auto kernel = lse != nullptr ? flash_attention_f32_kernel<D, true>
                               : flash_attention_f32_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * Hq * ((S + kBQ - 1) / kBQ);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Hq, Hkv,
      scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel). D
// must be 16, 64, 128 or 256 (the wrapper checks, and zero-pads a head
// narrower than 16 to 16; 16 is the smoke-width evaluators' head, 256
// Gemma-2's). `lse`: null, or (B, Hq, S) float32 to receive each row's
// log-sum-exp. Launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int S, int Hq, int Hkv, int D,
                                      int dtype, float scale, int causal,
                                      int window, float softcap,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
#define FA_CASE(FN, DIM)                                                  \
  return FN<DIM>(q, k, v, o, ls, B, S, Hq, Hkv, scale, causal, window,    \
                 softcap, st)
  if (dtype == 0) {
    if (D == 16) FA_CASE(launch_f32, 16);
    if (D == 64) FA_CASE(launch_f32, 64);
    if (D == 128) FA_CASE(launch_f32, 128);
    if (D == 256) FA_CASE(launch_f32, 256);
  } else if (dtype == 1) {
    if (D == 16) FA_CASE(launch_bf16, 16);
    if (D == 64) FA_CASE(launch_bf16, 64);
    if (D == 128) FA_CASE(launch_bf16, 128);
    if (D == 256) FA_CASE(launch_bf16, 256);
  }
#undef FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
