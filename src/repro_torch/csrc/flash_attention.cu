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
// ~2000 FLOP per byte and leans on the tensor cores instead, as does
// training (B = 8, S = 4096: 1.55e11 FLOP, 0.156 ms at 989 TFLOP/s).
//
// Three bf16 instances. `long_instance` and `short_instance` in
// kernels/flash_attention.py hold the shape rules, mirrored in
// `launch_bf16` in that order: from S >= LONG_FROM on, D 256 (gemma2,
// with or without its window and softcap) and D 64 or 128 with no window
// and no softcap take `fa_fwd_wgmma_kernel`; up to S <= SHORT_TO (one key
// tile of 32), D 64 or 128 with no window and no softcap and at most 256
// packed rows a (batch row, KV head) pair (the evaluators' S 31 at
// smollm's and the Qwen models' heads) take `fa_fwd_short_kernel`;
// everything else (D 16, gemma2's D 256 at S 31, prefills from S 33 to
// LONG_FROM, D 64 and 128 with a window or a softcap) takes
// `flash_attention_bf16_kernel`. A call a rule sends to an instance
// launches it or fails; none stands in for another.
//
// bf16, long sequences (training, prefills): `fa_fwd_wgmma_kernel`.
// - A work tile is 128 query positions of one (batch row, query head), as
//   two consumer warpgroups of 64 rows. K and V are read per query head:
//   packing the group into the rows, as the evaluator's instance does,
//   would give every row its own causal limit and the TMA boxes ragged
//   rows, and a (batch row, KV head)'s K and V (1 MB at S 4096) stay in
//   L2 for the G heads that read them.
// - A persistent grid, one block an SM: tiles ordered longest causal walk
//   first, dealt to the blocks as a snake (no counter to reset). Tiles
//   wholly above the diagonal are not loaded; only the diagonal tiles and
//   the ragged edge are masked.
// - A producer warp's thread loads each tile's Q once, into one of two
//   buffers (the next tile's Q lands while this one runs; one at D 256,
//   where a Q tile is 64 KB), and streams K/V tiles of 48 to 128 keys
//   (Cfg::kBN) with TMA, 128-byte swizzled, through a ring of 64 KB each
//   (at D 256 three stages of 48 keys) on mbarriers; setmaxnreg moves its
//   registers to the consumers.
// - Windows (D 256): a tile's key walk starts at the first key tile its
//   earliest row sees; only the diagonal tiles, the window's edge and the
//   ragged edge are masked. A window of S or more is no window.
// - S = Q K^T is wgmma with both operands in shared memory; the online
//   softmax runs in float32 registers (p = 2^(s c - m c): one FMA and one
//   MUFU op a score, the row max and sum as four partial chains); P,
//   packed to bf16 in registers, is the A operand of O += P V, with V an
//   MN-major descriptor.
// - At D 64 the softmax's ex2 count at the training shape (~6.0e8 MUFU
//   ops, ~0.155 ms at 16 a clock an SM) is as large as the tensor cores'
//   bound, so the two must overlap: the consumer warpgroups take turns on
//   named barriers to issue their products, so that one's softmax runs
//   while the other's products do; and each issues tile j's S with tile
//   j - 1's P V before it runs tile j's softmax. Measured on an H100, the
//   loop runs as fast with no K/V loads at all: the consumers bound it,
//   not the loads or L2. A quarter of the ex2 moved to the FMA pipe (a
//   cubic) made it slower, so MUFU alone does not bound it either.
// - Softcap (D 256): s -> softcap log2(e) tanh(s scale / softcap) in
//   registers before the online softmax, tanh as one ex2 and one rcp
//   (tc::tanh_ex2, the function the backward rebuilds P with), then c =
//   1. At gemma2's training shape that is ~4e8 MUFU ops beside the tensor
//   cores' 0.139 ms. The warpgroups run without turns: with them ptxas
//   spilled ~1.3 KB at D 256, serialised the wgmma, and the kernel ran
//   2.2x slower (PERF.md).
// - P's precision: the instance that writes the lse (training, reached
//   only through FlashAttentionFn) multiplies bf16 P by V once, as the
//   reference rounds it (src/repro/models/attention.py:104,
//   p.astype(v_blk.dtype)). The serving instance (prefills) keeps the
//   hi/lo split described below, two P V products: with bf16 P alone the
//   decode logits missed the chip check's 0.1 by 0.1016.
//
// bf16, short sequences (the evaluators' S 31 at D 64 and 128):
// `fa_fwd_short_kernel`. At these shapes the call is bound by bytes (~12
// FLOP a byte); the mma.sync instance below reached 0.40-0.73 of the
// bytes' bound, because a pair too big for one block was cut into tiles
// that each read K and V again, blocks far apart in the launch, and
// because nothing overlapped within a block (load, wait, compute, store,
// exit). This instance:
// - A persistent grid, one block an SM (a loader warp, three consumer
//   warpgroups at D 64, two at D 128); a block walks the (batch row, KV
//   head) pairs b Hkv + hk in a static stride. No counter: two calls
//   give equal bits.
// - The loader streams each pair whole into a ring of up to 8 stages, as
//   many as 227 KB hold in a multiple of the consumer warpgroups, each of
//   which owns its stages (6 at smollm's 24 KB, 2 at qwen2.5's 64 KB and
//   qwen3-moe's 80 KB, 6 at moonshot's 32 KB), with TMA: Q as one box of (64 columns, G heads, S
//   positions) a 64-column half from head hk G, which TMA writes in the
//   packed-row order of the mma.sync instance (row r: position r / G,
//   head r % G), 128-byte swizzled; K and V as one 32-key box of head hk,
//   zero-filled past S. A pair's K and V are read once.
// - The consumer warpgroups take the pairs in turn, so nothing inside a
//   pair waits on another warpgroup. For each 64-row tile: S = Q K^T
//   (wgmma m64n32, both operands in shared memory); the softmax of the one
//   key tile in float32 registers (no running max); O = P V with P from
//   registers (the serving instance's hi/lo split, the lse instance's
//   bf16 P once, as the wgmma instance) and V MN-major; O normalised and
//   written as bf16 over the tile's Q rows in the same swizzle. The rows
//   past S G of the last tile hold stale data and touch only themselves.
// - One TMA store a half over the same (64, G, S) box writes the pair's
//   O (never the padded rows); the stage goes back to the loader once the
//   store has read it, while the other warpgroups and the loads of the
//   next stages run.
// Measured on an H100 (PERF.md): 0.78-0.88 of the bytes' bound at the
// evaluator shapes, 1.2-2.1x as fast as the mma.sync instance.
//
// bf16, everything else: `flash_attention_bf16_kernel`, on the tensor
// cores through mma.sync m16n8k16 (tensor_core.cuh).
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
// - It took the evaluators' S 31 until the short instance above, whose
//   gain is in how the bytes move (whole pairs streamed through a ring),
//   not in the products: 4.68 GFLOP in 0.12 ms needs ~40 TFLOP/s.
//
// float32 (the smoke-width evaluator, D = 16): `flash_attention_f32_kernel`
// in FP32 FMAs, since TF32 tensor cores would miss the 1e-4 float32
// tolerance. One block of 4 warps per (batch, query head, 32-row query
// tile); lane j scores key j of a 32-key tile against the warp's 8 rows,
// then accumulates output columns lane + 32 c over the tile's keys.
//
// D 256 (Gemma-2: 8 query heads over 4, softcap 50, a 4096-key window on
// alternate layers): S 31 (the evaluator) and prefills shorter than
// LONG_FROM take the mma.sync bf16 kernel with two K/V stages instead of
// three (three would need 270,336 B of shared memory at 8 warps, over the
// 232,448 a block may have) and the Q fragments read from shared memory at
// each k-step rather than held in registers, which leaves the 128 float32
// accumulators of a thread's output rows the registers they need; longer
// ones the wgmma kernel (above). The float32 kernel takes D 256 as it is
// (99,328 B of shared memory).
//
// All accept any S (rows and keys past S are masked) and their D; a row
// that sees no key writes zeros.
//
// Training: given an `lse` pointer, the kernels also write each row's
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
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bf16, D 64, 128 and 256, long sequences: warp-specialised wgmma on TMA
// stages
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBM = 128;                   // query rows a work tile
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = 128 + kConsumers; // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// Named barriers 1 and 2: warpgroup w waits at 1 + w for its turn to
// issue its products, and hands the turn on at 2 - w. The column split:
// warpgroup w arrives at 3 + 2 (j % 2) + w once its half of key tile j's P
// is written, and the other waits there; both meet at 7 over the rows'
// sums.
constexpr int kTurnBar = 1, kHandBar = 3, kSumBar = 7;

// A block's dynamic shared memory, the most a block may have.
constexpr int kSmemLimit = 232448;
// Design (b) at D 256, the column split (`consume_cols`); off: measured
// slower than the row split (PERF.md), built by launch/ab_attention.py's
// variant d256_col_split.
constexpr bool kColSplitD256 = false;

// kSplit: P V as two products, P's bf16 hi and lo terms (the serving
// instance); else bf16 P once (the lse instance).
template <int D, bool kSplit>
struct Cfg {
  // Design (b), for the lse instance only (`consume_cols`): each
  // consumer warpgroup forms S and the softmax of its 64 rows, hands bf16
  // P and the rows' corrections over through shared memory, and owns 128
  // of O's 256 columns for all 128 rows of the tile.
  static constexpr bool kColSplit = kColSplitD256 && D == 256 && !kSplit;
  // Keys a K/V tile. D 64: 128 keys (S 64 floats a thread, O 32, P 32),
  // 96 with the split (48 + 32 + 2 x 24; at 128 its wgmma were serialised
  // and spilled); D 128: 96 (48 + 64 + 24), 64 with the split (32 + 64 +
  // 2 x 16). D 256: 48 (S 24 floats, O 128, P 12, and P's fresh copy 12;
  // with the split 200 floats in all: ptxas does give the consumers more
  // than the launch's 168 registers a thread after setmaxnreg, and spills
  // nothing); with one Q buffer the ring holds 3 stages of 48 keys. 80
  // keys spilled and serialised the split instance. Measured on an H100
  // with launch/ab_attention.py (PERF.md): 96 keys against 64 took the D
  // 128 lse instance from 0.649 to 0.609 ms at (2, 4096, 40/8), the D 64
  // split one from 0.0338 to 0.0330 ms at the prefill (1, 1984, 9/3); at D
  // 256, 48 keys against 32 took the lse instance from 0.370 to 0.300 ms
  // at (2, 4096, 8/4, softcap 50) (two Q buffers and 2 stages: 0.437).
  static constexpr int kBN =
      D == 64 ? (kSplit ? 96 : 128) : D == 128 ? (kSplit ? 64 : 96)
                                               : (kColSplit ? 64 : 48);
  static constexpr int kHalves = D / 64;   // 128-byte column blocks of a row
  static constexpr int kQHalf = kBM * 128, kKVHalf = kBN * 128;
  static constexpr int kQ = kBM * D * 2;   // bytes of Q, of a K (V) tile
  static constexpr int kKV = kBN * D * 2;
  // The column split's hand-over: bf16 P of the tile's 128 rows, two
  // buffers (kBN 64: one 128-byte row a query row), and two buffers of
  // the rows' corrections and one of their sums, float32.
  static constexpr int kPBuf = kBM * kBN * 2;
  static constexpr int kHandOver = kColSplit ? 2 * kPBuf + 3 * kBM * 4 : 0;
  // Two Q buffers (the next tile's Q lands while this one runs), one
  // where two would leave the ring fewer than 3 stages (a Q tile is 64 KB
  // at D 256: the ring's depth counted for more than Q's overlap with the
  // tile before); 1280 bytes for the barriers and the 1024-byte
  // alignment.
  static constexpr int kFree = kSmemLimit - 1280 - kHandOver;
  static constexpr int kQBufs = kFree - 2 * kQ < 3 * 2 * kKV ? 1 : 2;
  // D 64 and 128: a ring of 64 KB of K and of V, and at least 3 stages (2
  // in use); D 256: as many stages as the shared memory holds.
  static constexpr int kStages =
      D == 256 ? (kFree - kQBufs * kQ) / (2 * kKV)
               : (65536 / kKV < 3 ? 3 : 65536 / kKV);
  static constexpr int oQ = 0, oK = kQBufs * kQ, oV = oK + kStages * kKV;
  static constexpr int oP = oV + kStages * kKV, oX = oP + 2 * kPBuf;
  // q_full[kQBufs], q_empty[kQBufs], full[kStages], empty[kStages]
  static constexpr int oBar = oP + kHandOver;
  static constexpr int kBytes =
      oBar + (2 * kQBufs + 2 * kStages) * 8 + 1024;
  static_assert(kBytes <= kSmemLimit, "shared memory");
  static constexpr int NS = kBN / 2;       // S accumulators a thread
  static constexpr int NO = D / 2;         // O accumulators a thread
  static constexpr int KP = kBN / 16;      // k-steps of P V
  // The consumers take turns to issue their products at D 64, where the
  // softmax is about as long as the products (without the turns the lse
  // instance took 0.379 ms at the training shape, with them 0.363); at
  // D 128, where it is shorter, they slowed the split instance (0.844
  // against 0.807 ms).
  static constexpr bool kTurns = D == 64;
  // Windows and softcaps: the rule sends them here only at D 256
  // (gemma2), so D 64 and 128 compile without them.
  static constexpr bool kMasks = D == 256;
};

struct Args {
  __nv_bfloat16* o;
  float* lse;
  int B, S, Hq, Hkv, Tq, n_tiles;
  float c_exp;                             // scale * log2(e); 1 with a cap
  int causal;
  int window;                              // 0: none (nor one >= S)
  float cap_in, cap_out;                   // scale / softcap, softcap log2 e
};

struct Tile {
  int b, h, m;                             // batch row, query head, tile
  int j0, n_kv;                            // its first key tile, how many
};

// Work tiles are numbered longest walk first: query tile Tq - 1 of every
// (batch row, head), then Tq - 2, ... A walk runs from the first key tile
// the tile's earliest row sees (with a window) to the diagonal (causal):
// its length does not fall as the query tile rises.
template <int kBN, bool kMasks>
__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  const int bh_n = a.B * a.Hq, bh = t % bh_n;
  Tile w;
  w.m = a.Tq - 1 - t / bh_n;
  w.b = bh / a.Hq;
  w.h = bh % a.Hq;
  const int kv_end = a.causal ? min((w.m + 1) * kBM, a.S) : a.S;
  w.j0 = kMasks && a.window > 0 ? max(0, w.m * kBM - a.window + 1) / kBN
                                : 0;
  w.n_kv = (kv_end + kBN - 1) / kBN - w.j0;
  return w;
}

// This block's tile of round r: a snake over the tiles in that order
// (round r takes r * grid + block, odd rounds from the other end), so
// that the blocks' sums of walks even out with no counter to reset.
__device__ __forceinline__ int tile_at(int r) {
  const int g = gridDim.x;
  return r * g + ((r & 1) ? g - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x));
}

// The loader (one thread of the producer warpgroup): each tile's Q into
// its buffer once both consumers are done with the tile that used it
// last, then its K/V tiles through the ring, from the window's edge up to
// the diagonal.
template <int D, bool kSplit>
__device__ __forceinline__ void load(const Args& a, const CUtensorMap* tq,
                                     const CUtensorMap* tk,
                                     const CUtensorMap* tv, uint8_t* sm) {
  using C = Cfg<D, kSplit>;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::oBar);
  uint64_t* q_empty = q_full + C::kQBufs;
  uint64_t* full = q_full + 2 * C::kQBufs;
  uint64_t* empty = full + C::kStages;
  const int G = a.Hq / a.Hkv;
  int it = 0, ti = 0;
  for (int r = 0; r * static_cast<int>(gridDim.x) < a.n_tiles; ++r) {
    const int t = tile_at(r);
    if (t >= a.n_tiles) continue;
    const Tile w = tile_of<C::kBN, C::kMasks>(a, t);
    const int qb = ti % C::kQBufs;
    hop::mbar_wait(q_empty + qb, ((ti / C::kQBufs) & 1) ^ 1);
    hop::mbar_expect(q_full + qb, C::kQ);
#pragma unroll
    for (int c = 0; c < C::kHalves; ++c)
      hop::tma_load_4d(sm + C::oQ + qb * C::kQ + c * C::kQHalf, tq, 64 * c,
                       w.h, w.m * kBM, w.b, q_full + qb);
    const int hk = w.h / G;
    for (int j = 0; j < w.n_kv; ++j, ++it) {
      const int s = it % C::kStages;
      hop::mbar_wait(empty + s, ((it / C::kStages) & 1) ^ 1);
      hop::mbar_expect(full + s, 2 * C::kKV);
#pragma unroll
      for (int c = 0; c < C::kHalves; ++c) {
        hop::tma_load_4d(sm + C::oK + s * C::kKV + c * C::kKVHalf, tk,
                         64 * c, hk, (w.j0 + j) * C::kBN, w.b, full + s);
        hop::tma_load_4d(sm + C::oV + s * C::kKV + c * C::kKVHalf, tv,
                         64 * c, hk, (w.j0 + j) * C::kBN, w.b, full + s);
      }
    }
    ++ti;
  }
}

// S = Q K^T for one warpgroup's 64 rows: both operands K-major in shared
// memory (dq: the descriptor of the warpgroup's first Q row, dk: of the K
// tile). A descriptor's low 14 bits hold its address / 16, and every
// address here is below 256 KB, so an offset is added to it as offset /
// 16 with no carry.
template <int D, bool kSplit>
__device__ __forceinline__ void s_product(
    float (&s)[Cfg<D, kSplit>::NS], uint64_t dq0, uint64_t dk0) {
  using C = Cfg<D, kSplit>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t dq = dq0 + ((kk / 4) * C::kQHalf + (kk % 4) * 32) / 16;
    const uint64_t dk = dk0 + ((kk / 4) * C::kKVHalf + (kk % 4) * 32) / 16;
    if constexpr (C::kBN == 128)
      hop::wgmma_ss_n128<0, 0>(s, dq, dk, kk > 0);
    else if constexpr (C::kBN == 96)
      hop::wgmma_ss_n96<0, 0>(s, dq, dk, kk > 0);
    else if constexpr (C::kBN == 80)
      hop::wgmma_ss_n80<0, 0>(s, dq, dk, kk > 0);
    else if constexpr (C::kBN == 64)
      hop::wgmma_ss_n64<0, 0>(s, dq, dk, kk > 0);
    else if constexpr (C::kBN == 48)
      hop::wgmma_ss_n48<0, 0>(s, dq, dk, kk > 0);
    else
      hop::wgmma_ss_n32<0, 0>(s, dq, dk, kk > 0);
  }
  hop::wgmma_commit();
}

// O += P V: P from registers (k-step kk's A fragment p[kk]), V MN-major
// in shared memory (dv0: the V tile's descriptor); with the split, a
// second product of the same V with P's low bf16 terms `lo`.
template <int D, bool kSplit>
__device__ __forceinline__ void pv_product(
    float (&o)[Cfg<D, kSplit>::NO],
    const uint32_t (&p)[Cfg<D, kSplit>::KP][4],
    const uint32_t (&lo)[Cfg<D, kSplit>::KP][4], uint64_t dv0) {
  using C = Cfg<D, kSplit>;
#pragma unroll
  for (int kk = 0; kk < C::KP; ++kk) {
    const uint64_t dv = dv0 + kk * 2048 / 16;
    if constexpr (D == 64) {
      hop::wgmma_rs_n64<1>(o, p[kk], dv, 1);
      if constexpr (kSplit) hop::wgmma_rs_n64<1>(o, lo[kk], dv, 1);
    } else if constexpr (D == 128) {
      hop::wgmma_rs_n128<1>(o, p[kk], dv, 1);
      if constexpr (kSplit) hop::wgmma_rs_n128<1>(o, lo[kk], dv, 1);
    } else {
      hop::wgmma_rs_n256<1>(o, p[kk], dv, 1);
      if constexpr (kSplit) hop::wgmma_rs_n256<1>(o, lo[kk], dv, 1);
    }
  }
  hop::wgmma_commit();
}

// The online softmax of a key tile's scores s (a warpgroup's 64 rows from
// row0; this thread's rows r_lo and r_lo + 8, its columns 2 tig, 2 tig + 1
// of each 8): p = 2^(s c - m c) with c = scale log2(e), one FMA and one
// MUFU op a score (with the softcap, s is first mapped to softcap log2(e)
// tanh(s scale / softcap), two MUFU ops more, and c = 1); the causal,
// window and ragged-edge masks only off the open tiles; row max and sum as
// four partial chains. s becomes p; m and l are the rows' running max and
// sum, corr O's correction.
template <class C, int NS>
__device__ __forceinline__ void softmax_tile(const Args& a, float (&s)[NS],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0,
                                             int row0, int r_lo, int tig) {
  constexpr int kBN = C::kBN;
  if constexpr (C::kMasks) {
    if (a.cap_out > 0.f) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = a.cap_out * tc::tanh_ex2(s[i] * a.cap_in);
    }
  }
  // every key of the tile seen by every row of the warpgroup
  const bool open =
      k0 + kBN <= a.S && (!a.causal || k0 + kBN - 1 <= row0) &&
      (!C::kMasks || a.window <= 0 || k0 > row0 + 63 - a.window);
  if (!open) {
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * tig + (e & 1);
        const int row = r_lo + 8 * (e >> 1);
        if (key >= a.S || (a.causal && key > row) ||
            (C::kMasks && a.window > 0 && key <= row - a.window))
          s[4 * n + e] = -INFINITY;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
      mx[n % 4] = fmaxf(mx[n % 4],
                        fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
    const float m_new = fmaxf(
        m[h], tc::quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))));
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    corr[h] = tc::exp2_approx((m[h] - m_use) * a.c_exp);
    const float off = -m_use * a.c_exp;
    m[h] = m_new;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[4 * n + e] = tc::exp2_approx(fmaf(s[4 * n + e], a.c_exp, off));
        sum[n % 4] += s[4 * n + e];
      }
    l[h] = l[h] * corr[h] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

// A consumer warpgroup: rows 64 wg .. 64 wg + 63 of each work tile. Per
// K/V tile j, in its turn: S_j = Q K_j^T; O rescaled by tile j - 1's
// correction (only S_j in flight); O += P_{j-1} V_{j-1}. Then, while the
// other warpgroup issues its products and P_{j-1} V_{j-1} runs, the
// softmax of S_j once it is in, packed to bf16 into fresh registers,
// which become P once P_{j-1} V_{j-1} is in. (Packed into P's own
// registers, ptxas raised that wait above the softmax: 0.385 against
// 0.363 ms at the training shape; PERF.md.)
template <int D, bool kLse>
__device__ __forceinline__ void consume(const Args& a, uint8_t* sm, int wg,
                                        int tid) {
  constexpr bool kSplit = !kLse;
  using C = Cfg<D, kSplit>;
  constexpr int kBN = C::kBN, NS = C::NS, NO = C::NO, KP = C::KP;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::oBar);
  uint64_t* q_empty = q_full + C::kQBufs;
  uint64_t* full = q_full + 2 * C::kQBufs;
  uint64_t* empty = full + C::kStages;
  const uint32_t base = hop::smem_u32(sm);
  const uint64_t k_desc = hop::desc_sw128(base + C::oK, 16);
  const uint64_t v_desc = hop::desc_sw128(base + C::oV, C::kKVHalf);
  constexpr int kStageDesc = C::kKV / 16;  // descriptor step of a stage
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const int my_turn = kTurnBar + wg, next_turn = kTurnBar + 1 - wg;
  auto take_turn = [&]() {
    if constexpr (C::kTurns) hop::named_sync(my_turn, kConsumers);
  };
  auto pass_turn = [&]() {
    if constexpr (C::kTurns) hop::named_arrive(next_turn, kConsumers);
  };
  if (C::kTurns && wg == 1)                // 0 goes first
    hop::named_arrive(kTurnBar, kConsumers);

  float s[NS], o[NO];
  uint32_t p[KP][4], lo[KP][4];
  int it = 0, ti = 0;
  for (int r = 0; r * static_cast<int>(gridDim.x) < a.n_tiles; ++r) {
    const int t = tile_at(r);
    if (t >= a.n_tiles) continue;
    const Tile w = tile_of<kBN, C::kMasks>(a, t);
    const int qb = ti % C::kQBufs;
    const uint64_t q_desc =
        hop::desc_sw128(base + C::oQ + qb * C::kQ + wg * 64 * 128, 16);
    const int row0 = w.m * kBM + 64 * wg;  // the warpgroup's first row
    const int r_lo = row0 + 16 * warp + grp;  // this thread's rows, + 8
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;

    float corr[2];
    auto softmax = [&](int j) {
      softmax_tile<C>(a, s, m, l, corr, (w.j0 + j) * kBN, row0, r_lo, tig);
    };
    // P as the A fragments of the k-steps of P V (with the split, hi and
    // lo = bf16(p - hi)), packed into fresh registers (pn, ln) while the
    // last P V may still read p and lo: copied in after its wait.
    uint32_t pn[KP][4], ln[KP][4];
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (kSplit)
            tc::split_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1],
                           pn[kk][q], ln[kk][q]);
          else
            pn[kk][q] =
                tc::pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
        }
    };
    auto take_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          p[kk][q] = pn[kk][q];
          if constexpr (kSplit) lo[kk][q] = ln[kk][q];
        }
    };
    // O rescaled by the correction of the tile whose P V comes next
    auto rescale = [&]() {
#pragma unroll
      for (int n = 0; n < NO / 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];
    };
    // after each wait: the registers an asynchronous product read or
    // wrote stay put until here
    auto fence_pv = [&]() {
      hop::fence_regs(s);
      hop::fence_regs(o);
      hop::fence_regs(p);
      if constexpr (kSplit) hop::fence_regs(lo);
    };
    auto release_q = [&]() {
      if (lane == 0) hop::mbar_arrive(q_empty + qb);
    };
    auto release_stage = [&](int stage) {
      if (lane == 0) hop::mbar_arrive(empty + stage);
    };

    hop::mbar_wait(q_full + qb, (ti / C::kQBufs) & 1);
    {                                      // S_0
      const int st = it % C::kStages;
      hop::mbar_wait(full + st, (it / C::kStages) & 1);
      take_turn();
      hop::fence_regs(s);
      hop::wgmma_fence();
      s_product<D, kSplit>(s, q_desc, k_desc + st * kStageDesc);
      pass_turn();
      hop::wgmma_wait<0>();
      hop::fence_regs(s);
      if (w.n_kv == 1) release_q();
      softmax(0);
      pack();
      take_p();
    }
    for (int j = 1; j < w.n_kv; ++j) {
      const int st = (it + j) % C::kStages;
      const int prev = (it + j - 1) % C::kStages;
      hop::mbar_wait(full + st, ((it + j) / C::kStages) & 1);
      take_turn();
      fence_pv();
      hop::wgmma_fence();
      s_product<D, kSplit>(s, q_desc, k_desc + st * kStageDesc);
      rescale();
      hop::fence_regs(o);
      hop::wgmma_fence();
      pv_product<D, kSplit>(o, p, lo, v_desc + prev * kStageDesc);
      pass_turn();
      hop::wgmma_wait<1>();                // S_j is in
      hop::fence_regs(s);
      if (j == w.n_kv - 1) release_q();
      softmax(j);
      pack();
      hop::wgmma_wait<0>();                // P_{j-1} V_{j-1} is in
      fence_pv();
      release_stage(prev);
      take_p();
    }
    {                                      // the last P V
      const int last = (it + w.n_kv - 1) % C::kStages;
      take_turn();
      rescale();
      fence_pv();
      hop::wgmma_fence();
      pv_product<D, kSplit>(o, p, lo, v_desc + last * kStageDesc);
      pass_turn();
      hop::wgmma_wait<0>();
      fence_pv();
      release_stage(last);
    }
    it += w.n_kv;
    ++ti;

    // Normalise and store the rows that exist, 4 bytes a column pair; the
    // lse from the running max and sum (-inf for a row that saw no key).
    const long long q_pos = static_cast<long long>(a.Hq) * D;
    __nv_bfloat16* ob = a.o + static_cast<long long>(w.b) * a.S * q_pos +
                        static_cast<long long>(w.h) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + 8 * h;
      const float den = tc::quad_sum(l[h]);
      const float inv = den > 0.f ? 1.f / den : 0.f;
      if (row >= a.S) continue;
      if (kLse && tig == 0)
        a.lse[(static_cast<long long>(w.b) * a.Hq + w.h) * a.S + row] =
            den > 0.f ? (m[h] * a.c_exp + log2f(den)) * kLn2 : -INFINITY;
#pragma unroll
      for (int n = 0; n < NO / 4; ++n)
        *reinterpret_cast<uint32_t*>(ob + row * q_pos + 8 * n + 2 * tig) =
            tc::pack_bf16(o[4 * n + 2 * h] * inv, o[4 * n + 2 * h + 1] * inv);
    }
  }
  // warpgroup 1's hand-over after its last turn
  if (C::kTurns && wg == 0) hop::named_sync(kTurnBar, kConsumers);
}

// Design (b), the column split (`Cfg::kColSplit`): warpgroup wg forms S
// and the softmax of rows 64 wg .. 64 wg + 63 as `consume` does, writes
// that bf16 P and the rows' corrections into shared memory (two buffers
// by key tile), and owns O's columns 128 wg .. 128 wg + 127 of all 128
// rows: per k-step two m64n128 products, P and V from shared memory. Per
// key tile j: S_j; once the other half of P_{j-1} is in, O rescaled by
// corr_{j-1} and O += P_{j-1} V_{j-1}; the softmax of S_j; P_j handed
// over once P_{j-1} V_{j-1} is in.
template <int D, bool kLse>
__device__ __forceinline__ void consume_cols(const Args& a, uint8_t* sm,
                                             int wg, int tid) {
  using C = Cfg<D, !kLse>;
  constexpr int kBN = C::kBN, NS = C::NS, KP = C::KP;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::oBar);
  uint64_t* q_empty = q_full + C::kQBufs;
  uint64_t* full = q_full + 2 * C::kQBufs;
  uint64_t* empty = full + C::kStages;
  const uint32_t base = hop::smem_u32(sm);
  const uint64_t k_desc = hop::desc_sw128(base + C::oK, 16);
  // this warpgroup's 128 columns of V: 64-column blocks 2 wg and 2 wg + 1
  const uint64_t v_desc =
      hop::desc_sw128(base + C::oV + 2 * wg * C::kKVHalf, C::kKVHalf);
  constexpr int kStageDesc = C::kKV / 16;
  float* xc = reinterpret_cast<float*>(sm + C::oX);   // corr[2][kBM]
  float* xl = xc + 2 * kBM;                           // l[kBM]
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const int wrow = 16 * warp + grp;        // this thread's row of a half

  float s[NS], o[2][64];                   // o[half]: rows 64 half ..
  int it = 0, ti = 0;
  for (int r = 0; r * static_cast<int>(gridDim.x) < a.n_tiles; ++r) {
    const int t = tile_at(r);
    if (t >= a.n_tiles) continue;
    const Tile w = tile_of<kBN, C::kMasks>(a, t);
    const int qb = ti % C::kQBufs;
    const uint64_t q_desc =
        hop::desc_sw128(base + C::oQ + qb * C::kQ + wg * 64 * 128, 16);
    const int row0 = w.m * kBM + 64 * wg;
    const int r_lo = row0 + wrow;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[h][i] = 0.f;

    auto release_q = [&]() {
      if (lane == 0) hop::mbar_arrive(q_empty + qb);
    };
    auto s_of = [&](int j) {               // S_j issued
      const int st = (it + j) % C::kStages;
      hop::mbar_wait(full + st, ((it + j) / C::kStages) & 1);
      hop::fence_regs(s);
      hop::wgmma_fence();
      s_product<D, !kLse>(s, q_desc, k_desc + st * kStageDesc);
    };
    auto hand_over = [&](int j) {          // P_j, corr_j into buffer j % 2
      uint8_t* pb = sm + C::oP + (j & 1) * C::kPBuf + wg * 64 * 128;
#pragma unroll
      for (int n = 0; n < NS / 4; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(pb + (wrow + 8 * h) * 128 +
                                       ((n ^ grp) << 4) + 4 * tig) =
              tc::pack_bf16(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]);
      if (tig == 0) {
        xc[(j & 1) * kBM + 64 * wg + wrow] = corr[0];
        xc[(j & 1) * kBM + 64 * wg + wrow + 8] = corr[1];
      }
      hop::fence_async_smem();
      hop::named_arrive(kHandBar + 2 * (j & 1) + wg, kConsumers);
    };
    auto pv_of = [&](int j) {              // O by corr_j, O += P_j V_j
      hop::named_sync(kHandBar + 2 * (j & 1) + 1 - wg, kConsumers);
      const float* cj = xc + (j & 1) * kBM;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float c0 = cj[64 * h + wrow], c1 = cj[64 * h + wrow + 8];
#pragma unroll
        for (int i = 0; i < 64; ++i) o[h][i] *= (i & 2) ? c1 : c0;
      }
      hop::fence_regs(o[0]);
      hop::fence_regs(o[1]);
      hop::wgmma_fence();
      const uint64_t dp =
          hop::desc_sw128(base + C::oP + (j & 1) * C::kPBuf, 16);
      const uint64_t dv = v_desc + ((it + j) % C::kStages) * kStageDesc;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          hop::wgmma_ss_n128<0, 1>(o[h], dp + (h * 64 * 128 + kk * 32) / 16,
                                   dv + kk * 2048 / 16, 1);
      hop::wgmma_commit();
    };
    auto release_stage = [&](int j) {
      if (lane == 0) hop::mbar_arrive(empty + (it + j) % C::kStages);
    };

    hop::mbar_wait(q_full + qb, (ti / C::kQBufs) & 1);
    s_of(0);
    hop::wgmma_wait<0>();
    hop::fence_regs(s);
    if (w.n_kv == 1) release_q();
    softmax_tile<C>(a, s, m, l, corr, w.j0 * kBN, row0, r_lo, tig);
    hand_over(0);
    for (int j = 1; j < w.n_kv; ++j) {
      s_of(j);
      pv_of(j - 1);
      hop::wgmma_wait<1>();                // S_j is in
      hop::fence_regs(s);
      if (j == w.n_kv - 1) release_q();
      softmax_tile<C>(a, s, m, l, corr, (w.j0 + j) * kBN, row0, r_lo, tig);
      hop::wgmma_wait<0>();                // P_{j-1} V_{j-1} is in
      hop::fence_regs(o[0]);
      hop::fence_regs(o[1]);
      release_stage(j - 1);
      hand_over(j);
    }
    pv_of(w.n_kv - 1);
    hop::wgmma_wait<0>();
    hop::fence_regs(o[0]);
    hop::fence_regs(o[1]);
    release_stage(w.n_kv - 1);
    it += w.n_kv;
    ++ti;

    // The rows' sums to both warpgroups; each stores its columns of all
    // 128 rows, and the lse of its own.
    float den[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      den[h] = tc::quad_sum(l[h]);
      if (tig == 0) xl[64 * wg + wrow + 8 * h] = den[h];
    }
    hop::named_sync(kSumBar, kConsumers);
    const long long q_pos = static_cast<long long>(a.Hq) * D;
    __nv_bfloat16* ob = a.o + static_cast<long long>(w.b) * a.S * q_pos +
                        static_cast<long long>(w.h) * D + 128 * wg;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = 64 * half + wrow + 8 * h;
        const int row = w.m * kBM + rr;
        const float dn = xl[rr];
        const float inv = dn > 0.f ? 1.f / dn : 0.f;
        if (row >= a.S) continue;
        if (kLse && half == wg && tig == 0)
          a.lse[(static_cast<long long>(w.b) * a.Hq + w.h) * a.S + row] =
              den[h] > 0.f ? (m[h] * a.c_exp + log2f(den[h])) * kLn2
                           : -INFINITY;
#pragma unroll
        for (int n = 0; n < 16; ++n)
          *reinterpret_cast<uint32_t*>(ob + row * q_pos + 8 * n + 2 * tig) =
              tc::pack_bf16(o[half][4 * n + 2 * h] * inv,
                            o[half][4 * n + 2 * h + 1] * inv);
      }
  }
}

// The producer warpgroup (the loader is its thread 0) and two consumer
// warpgroups; setmaxnreg moves registers from the producer to the
// consumers (40 + 2 x 232 a thread in a quarter of the register file).
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = Cfg<D, !kLse>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::oBar);
    uint64_t* ring = bars + 2 * C::kQBufs;
    for (int i = 0; i < C::kQBufs; ++i) {
      hop::mbar_init(bars + i, 1);                            // q_full
      hop::mbar_init(bars + C::kQBufs + i, kConsumerWarps);   // q_empty
    }
    for (int s = 0; s < C::kStages; ++s) {
      hop::mbar_init(ring + s, 1);                            // full
      hop::mbar_init(ring + C::kStages + s, kConsumerWarps);  // empty
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  // the warpgroup index from lane 0: provably the same across the warp,
  // which setmaxnreg (.sync.aligned) needs
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) load<D, !kLse>(a, &tq, &tk, &tv, sm);
  } else {
    hop::setmaxnreg_inc<kConsumerRegs>();
    if constexpr (C::kColSplit)
      consume_cols<D, kLse>(a, sm, wgi - 1, threadIdx.x % 128);
    else
      consume<D, kLse>(a, sm, wgi - 1, threadIdx.x % 128);
  }
}

template <int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Hq, int Hkv, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  using C = Cfg<D, !kLse>;
  const long long Tq = (S + kBM - 1) / kBM;
  const long long n_tiles = static_cast<long long>(B) * Hq * Tq;
  if (n_tiles == 0) return 0;
  if (n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int sms = hop::sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorNoDevice);
  // a runtime call first: cuTensorMapEncodeTiled wants its context
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_wgmma_kernel<D, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  if (hop::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  if (!hop::tensor_map(&tq, q, B, S, Hq, D, kBM) ||
      !hop::tensor_map(&tk, k, B, S, Hkv, D, C::kBN) ||
      !hop::tensor_map(&tv, v, B, S, Hkv, D, C::kBN))
    return static_cast<int>(cudaErrorInvalidPitchValue);
  Args a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = lse;
  a.B = B; a.S = S; a.Hq = Hq; a.Hkv = Hkv;
  a.Tq = static_cast<int>(Tq);
  a.n_tiles = static_cast<int>(n_tiles);
  a.c_exp = softcap > 0.f ? 1.f : scale * kLog2e;
  a.causal = causal;
  // a window of S or more hides no key (causal or not)
  a.window = window < S ? window : 0;
  a.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  a.cap_out = softcap > 0.f ? softcap * kLog2e : 0.f;
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  fa_fwd_wgmma_kernel<D, kLse><<<grid, kThreads, C::kBytes, stream>>>(
      tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16, D 64 and 128, short sequences (the evaluators' S 31): a persistent
// TMA-fed kernel over (batch row, KV head) pairs
// ---------------------------------------------------------------------------

namespace sq {

constexpr int kKeys = 32;                  // the one key tile of a pair
constexpr int kTileRows = 64;              // rows of a wgmma tile
constexpr int kMaxTiles = 4;               // 64-row tiles of a pair's rows
// Consumer warpgroups, taking the pairs in turn: three at D 64, where a
// pair's products are short beside its softmax, epilogue and store; two
// at D 128 (PERF.md).
template <int D>
constexpr int kConsumerWGs = D == 64 ? 3 : 2;
template <int D>
constexpr int kThreads = 128 * kConsumerWGs<D> + 32;  // + the loader's warp
// Stages of the ring, at most, rounded down to a multiple of the consumer
// warpgroups: each warpgroup owns its stages. (A stage shared in turn
// would let a warpgroup that waits for its fill k while fill k - 1, another
// warpgroup's, has not landed see that phase parity as complete: TMA loads
// land in no fixed order. With 4 stages for 3 warpgroups that faulted
// within ~100 calls.)
constexpr int kMaxStages = 8;
// The ring's barriers in the first 1024 bytes, the stages after them; and
// 1024 bytes to align the dynamic shared memory to the swizzle's period.
constexpr int kHead = 1024, kSlack = 1024;

template <int D>
struct Cfg {
  static constexpr int kHalves = D / 64;   // 128-byte column blocks of a row
  static constexpr int kTileHalf = kTileRows * 128;  // bytes of a tile half
  static constexpr int kKVHalf = kKeys * 128;        // of a K (V) half
  static constexpr int kKV = kHalves * kKVHalf;
  static constexpr int NS = kKeys / 2;     // S accumulators a thread
  static constexpr int NO = D / 2;         // O accumulators a thread
  static constexpr int KP = kKeys / 16;    // k-steps of P V
};

// Bytes of a stage: Q (then O) as T 64-row tiles in each 64-column half,
// then K and V.
template <int D>
__host__ __device__ inline int stage_bytes(int T) {
  using C = Cfg<D>;
  return C::kHalves * T * C::kTileHalf + 2 * C::kKV;
}

struct Args {
  float* lse;
  int S, Hq, Hkv, G, T, pairs;
  int per_wg, stage_bytes;                 // stages a warpgroup owns
  float c_exp;                             // scale * log2(e)
  int causal;
};

// Whether a pair fits the kernel: one key tile, at most kMaxTiles tiles.
__host__ __device__ inline bool fits(int S, int G) {
  return S >= 1 && S <= kKeys && S * G <= kMaxTiles * kTileRows;
}

// Pair i of this block (p = blockIdx.x + i gridDim.x) belongs to consumer
// warpgroup i % C, as its pair j = i / C, in that warpgroup's stage j %
// per_wg (stage w + C (j % per_wg) of the ring), its fill j / per_wg.
template <int D>
__device__ __forceinline__ int stage_of(const Args& a, int w, int j) {
  return w + kConsumerWGs<D> * (j % a.per_wg);
}

// The loader (one thread): pair i into its stage once the pair that used
// the stage last is stored: Q as one box of (64
// columns, G heads, S positions) a half, starting at head hk G, which TMA
// writes in the packed-row order (row r: position r / G, head r % G); K
// and V as 32 positions of head hk, zero-filled past S.
template <int D>
__device__ __forceinline__ void load(const Args& a, const CUtensorMap* tq,
                                     const CUtensorMap* tk,
                                     const CUtensorMap* tv, uint8_t* ring,
                                     uint64_t* full, uint64_t* empty) {
  using C = Cfg<D>;
  const uint32_t tx = C::kHalves * (a.G * a.S * 128 + 2 * C::kKVHalf);
  const int q_half = a.T * C::kTileHalf;
  int i = 0;
  for (int p = blockIdx.x; p < a.pairs; p += gridDim.x, ++i) {
    const int j = i / kConsumerWGs<D>;
    const int st = stage_of<D>(a, i % kConsumerWGs<D>, j);
    hop::mbar_wait(empty + st, ((j / a.per_wg) & 1) ^ 1);
    hop::mbar_expect(full + st, tx);
    const int b = p / a.Hkv, hk = p % a.Hkv;
    uint8_t* q = ring + st * a.stage_bytes;
    uint8_t* k = q + C::kHalves * q_half;
#pragma unroll
    for (int c = 0; c < C::kHalves; ++c) {
      hop::tma_load_4d(q + c * q_half, tq, 64 * c, hk * a.G, 0, b, full + st);
      hop::tma_load_4d(k + c * C::kKVHalf, tk, 64 * c, hk, 0, b, full + st);
      hop::tma_load_4d(k + C::kKV + c * C::kKVHalf, tv, 64 * c, hk, 0, b,
                       full + st);
    }
  }
}

// A consumer warpgroup: pairs wg, wg + kConsumerWGs<D>, ... of this block,
// each a 64-row tile at a time: S = Q_t K^T (both K-major in shared
// memory), the softmax of the one key tile in float32 registers (no
// running max: every key is in the tile), O = P V with P from registers
// (hi and lo terms with the split) and V MN-major, O normalised and
// written as bf16 over Q_t's rows in the same swizzle. Then one TMA store
// a half over the same (64, G, S) box, so that the padded rows past S G
// are never written; the stage goes back to the loader once the store has
// read it.
template <int D, bool kLse>
__device__ __forceinline__ void consume(const Args& a, const CUtensorMap* to,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int wg, int tid) {
  using C = Cfg<D>;
  constexpr bool kSplit = !kLse;
  constexpr int NS = C::NS, NO = C::NO, KP = C::KP;
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const int rows = a.G * a.S;
  const int q_half = a.T * C::kTileHalf;
  float s[NS], o[NO];
  uint32_t p[KP][4], lo[KP][4];
  int j = 0;
  for (int pr = blockIdx.x + wg * gridDim.x; pr < a.pairs;
       pr += kConsumerWGs<D> * gridDim.x, ++j) {
    const int st = stage_of<D>(a, wg, j);
    uint8_t* q = ring + st * a.stage_bytes;
    const uint32_t q0 = hop::smem_u32(q);
    const uint32_t k0 = q0 + C::kHalves * q_half, v0 = k0 + C::kKV;
    const int b = pr / a.Hkv, hk = pr % a.Hkv;
    hop::mbar_wait(full + st, (j / a.per_wg) & 1);
    // the warp together again (lane 0 may come from the last pair's
    // store) before the .aligned wgmma instructions
    __syncwarp();
    for (int t = 0; t < a.T; ++t) {
      hop::fence_regs(s);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::wgmma_ss_n32<0, 0>(
            s,
            hop::desc_sw128(q0 + (kk / 4) * q_half + t * C::kTileHalf +
                                (kk % 4) * 32, 16),
            hop::desc_sw128(k0 + (kk / 4) * C::kKVHalf + (kk % 4) * 32, 16),
            kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(s);

      // this thread's rows r_lo and r_lo + 8 of the pair, at positions
      // r / G; the padded rows past S G see every key and are not stored
      const int r_lo = kTileRows * t + 16 * warp + grp;
      float m[2], l[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = (r_lo + 8 * h) / a.G;
        const int k_end = a.causal ? min(pos + 1, a.S) : a.S;
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NS / 4; ++n)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            if (8 * n + 2 * tig + (e & 1) >= k_end) s[4 * n + e] = -INFINITY;
            mx = fmaxf(mx, s[4 * n + e]);
          }
        m[h] = tc::quad_max(mx);
        const float off = -(m[h] == -INFINITY ? 0.f : m[h]) * a.c_exp;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NS / 4; ++n)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[4 * n + e] = tc::exp2_approx(fmaf(s[4 * n + e], a.c_exp, off));
            sum += s[4 * n + e];
          }
        l[h] = tc::quad_sum(sum);
      }
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kSplit)
            tc::split_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], p[kk][j],
                           lo[kk][j]);
          else
            p[kk][j] = tc::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
        }

      hop::fence_regs(o);
      hop::fence_regs(p);
      if constexpr (kSplit) hop::fence_regs(lo);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        const uint64_t dv = hop::desc_sw128(v0 + kk * 2048, C::kKVHalf);
        if constexpr (D == 64) {
          hop::wgmma_rs_n64<1>(o, p[kk], dv, kk > 0);
          if constexpr (kSplit) hop::wgmma_rs_n64<1>(o, lo[kk], dv, 1);
        } else {
          hop::wgmma_rs_n128<1>(o, p[kk], dv, kk > 0);
          if constexpr (kSplit) hop::wgmma_rs_n128<1>(o, lo[kk], dv, 1);
        }
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
      hop::fence_regs(p);
      if constexpr (kSplit) hop::fence_regs(lo);

      // O_t over Q_t (its last reader, S_t, is done); the lse of the rows
      // that exist, at (b, hk G + r % G, r / G)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
        if (kLse && tig == 0 && r < rows)
          a.lse[(static_cast<long long>(b) * a.Hq + hk * a.G + r % a.G) *
                    a.S + r / a.G] =
              l[h] > 0.f ? (m[h] * a.c_exp + log2f(l[h])) * kLn2 : -INFINITY;
        uint8_t* row = q + t * C::kTileHalf + (16 * warp + grp + 8 * h) * 128 +
                       4 * tig;
#pragma unroll
        for (int j = 0; j < NO / 4; ++j)
          *reinterpret_cast<uint32_t*>(row + (j / 8) * q_half +
                                       (((j % 8) ^ grp) << 4)) =
              tc::pack_bf16(o[4 * j + 2 * h] * inv,
                            o[4 * j + 2 * h + 1] * inv);
      }
    }
    // the pair's O, a box a half; the stage back once the store read it
    hop::fence_async_smem();
    hop::named_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < C::kHalves; ++c)
        hop::tma_store_4d(to, q + c * q_half, 64 * c, hk * a.G, 0, b);
      hop::bulk_wait_read();
      hop::mbar_arrive(empty + st);
    }
  }
  if (tid == 0) hop::bulk_wait_all();
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads<D>, 1)
fa_fwd_short_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + kMaxStages;
  uint8_t* ring = sm + kHead;
  if (threadIdx.x == 0) {
    for (int st = 0; st < a.per_wg * kConsumerWGs<D>; ++st) {
      hop::mbar_init(full + st, 1);
      hop::mbar_init(empty + st, 1);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kConsumerWGs<D>) {
    if (threadIdx.x == 128 * kConsumerWGs<D>)
      load<D>(a, &tq, &tk, &tv, ring, full, empty);
  } else {
    consume<D, kLse>(a, &to, ring, full, empty, wg, threadIdx.x % 128);
  }
}

template <int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Hq, int Hkv, float scale, int causal,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (!fits(S, G)) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(B) * Hkv;
  if (pairs == 0) return 0;
  if (pairs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int sms = hop::sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorNoDevice);
  Args a;
  a.lse = lse;
  a.S = S; a.Hq = Hq; a.Hkv = Hkv; a.G = G;
  a.T = (S * G + kTileRows - 1) / kTileRows;
  a.pairs = static_cast<int>(pairs);
  a.stage_bytes = stage_bytes<D>(a.T);
  int stages = (wg::kSmemLimit - kHead - kSlack) / a.stage_bytes;
  if (stages > kMaxStages) stages = kMaxStages;
  a.per_wg = stages / kConsumerWGs<D>;
  if (a.per_wg < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.c_exp = scale * kLog2e;
  a.causal = causal;
  const int bytes =
      kHead + kSlack + a.per_wg * kConsumerWGs<D> * a.stage_bytes;
  // a runtime call first: cuTensorMapEncodeTiled wants its context
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_short_kernel<D, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv, to;
  if (hop::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  if (!hop::tensor_map(&tq, q, B, S, Hq, D, S, G) ||
      !hop::tensor_map(&tk, k, B, S, Hkv, D, kKeys) ||
      !hop::tensor_map(&tv, v, B, S, Hkv, D, kKeys) ||
      !hop::tensor_map(&to, o, B, S, Hq, D, S, G))
    return static_cast<int>(cudaErrorInvalidPitchValue);
  const int grid = static_cast<int>(pairs < sms ? pairs : sms);
  fa_fwd_short_kernel<D, kLse><<<grid, kThreads<D>, bytes, stream>>>(
      tq, tk, tv, to, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sq

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Hq, int Hkv, float scale,
                int causal, int window, float softcap, int long_from,
                int short_to, cudaStream_t stream) {
  // The shape rules of `long_instance` and `short_instance` in
  // kernels/flash_attention.py, the long one first.
  if constexpr (D != 16) {
    if (S >= long_from && (D == 256 || (window <= 0 && softcap <= 0.f)))
      return lse != nullptr
                 ? wg::launch<D, true>(q, k, v, o, lse, B, S, Hq, Hkv,
                                       scale, causal, window, softcap,
                                       stream)
                 : wg::launch<D, false>(q, k, v, o, lse, B, S, Hq, Hkv,
                                        scale, causal, window, softcap,
                                        stream);
  }
  if constexpr (D == 64 || D == 128) {
    if (S <= short_to && sq::fits(S, Hq / Hkv) && window <= 0 &&
        softcap <= 0.f)
      return lse != nullptr
                 ? sq::launch<D, true>(q, k, v, o, lse, B, S, Hq, Hkv, scale,
                                       causal, stream)
                 : sq::launch<D, false>(q, k, v, o, lse, B, S, Hq, Hkv,
                                        scale, causal, stream);
  }
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
               int causal, int window, float softcap, int /*long_from*/,
               int /*short_to*/, cudaStream_t stream) {
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
// log-sum-exp. `long_from`: bf16 calls at D 256, and at D 64 or 128 with
// no window and no softcap, take the wgmma instance from this S on (the
// wrapper passes its LONG_FROM). `short_to`: bf16 calls at D 64 or 128 with
// no window and no softcap take the short instance up to this S, where a
// pair's keys fit one tile and its packed rows four (the wrapper passes
// its SHORT_TO; 0: never). Launches on `stream`; returns
// cudaGetLastError() (0 = ok).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int S, int Hq, int Hkv, int D,
                                      int dtype, float scale, int causal,
                                      int window, float softcap,
                                      int long_from, int short_to,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
#define FA_CASE(FN, DIM)                                                  \
  return FN<DIM>(q, k, v, o, ls, B, S, Hq, Hkv, scale, causal, window,    \
                 softcap, long_from, short_to, st)
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
