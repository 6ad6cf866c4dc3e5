// One-token decode attention against a KV cache: split-K flash-decoding
// with a combine pass. Per-row lengths, optional sliding window and tanh
// logit softcap, grouped-query heads. Two instances: the TMA instance
// (namespace td, below: bf16 at D 256, gemma2-2b's decode) and the
// pieces kernel (every other shape).
//
// Replaces the TPU kernel `flash_decode` / `_decode_kernel` in
// src/repro/kernels/flash_decode.py (pallas_call at :110).
// q: (B, Hq, D); k_cache, v_cache: (B, L, Hkv, D); lengths: (B,) int32,
// the valid positions of each row including the newest token. bf16 or
// f32, contiguous; output (B, Hq, D) in q's type. Position t of row b is
// seen when t < lengths[b] and, with window > 0, t >= lengths[b] - window.
// A row that sees no position (length 0) writes zeros, as the TPU kernel
// does.
//
// What bounds it on an H100: the bytes of the valid cache. Each key and
// value row is read once for the G = Hq / Hkv query heads of its group,
// ~4 G FLOP per cache byte in bf16; at the decode shape (B = 128, Hkv = 3,
// D = 64, mean length ~1034) one launch reads ~102 MB, ~30 us at
// 3.35 TB/s. So the design keeps the whole card reading the valid cache,
// whatever the spread of lengths, and reads nothing else of size.
//
// Design of the pieces kernel:
// - Balance. The valid range [lo, hi) of each (batch row, KV head) is cut
//   into pieces of `piece_len` positions, so a row's number of pieces
//   follows its length. `piece_len` is a multiple of the 32-position tile
//   chosen from the shape (flash_decode_piece_len: about two pieces per
//   resident warp if every row were full, 32 to 256). Pieces are
//   numbered row by row, KV head by KV head. A persistent grid (as many
//   blocks as fit on the SMs) walks that list: warp w of the W in the grid
//   takes pieces w, w + W, ..., locating each by a running warp-wide
//   prefix sum over `lengths` (read by the warp itself: no host sync and
//   no extra launch). No warp carries more than one piece beyond the mean.
//   Each piece leaves its partial state (max, denominator, unnormalised
//   output, float32) in its slot of a scratch sized for the worst case,
//   B * Hkv * ceil(L / piece_len) pieces, and the combine pass merges the
//   ceil((hi - lo) / piece_len) slots of each row.
// - Pipelining. Each warp owns a cp.async ring of kStages tiles (K and V
//   rows of 32 positions, rows padded by 16 bytes) and keeps the next
//   tiles in flight, across piece boundaries, while it computes the
//   current one. Positions past the length or before the window are never
//   read: their rows are zero-filled.
// - bf16 products on the tensor cores (mma.sync m16n8k16, tensor_core.cuh):
//   the G <= 8 query heads are rows 0..G-1 of the A tile (rows 8..15 are
//   zero), QK^T is one mma per 8 positions and 16 of depth, the softmax
//   runs on the fragments with quad shuffles, and P enters PV as two bf16
//   terms (hi + lo, two mma on the same V fragments), keeping ~16 bits of
//   p as flash_attention.cu does. At D 256 (bf16 only through a forced
//   call, or float32) the q rows of a piece are staged in the warp's
//   shared memory and read at each depth step, not held in registers
//   beside the 128-float accumulator, and a block has 2 warps (shared
//   memory). float32 keeps FP32 FMAs
//   (TF32 would miss the 1e-4 tolerance) under the same split: lane j
//   scores position j of the tile for every head, and the output columns
//   are accumulated lane by lane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTile = 32;          // positions per warp tile
constexpr int kMaxG = 8;           // query heads per KV head
constexpr int kMaxPieceTiles = 8;  // a piece is at most 8 tiles long
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
// A tile descriptor's info word: valid positions, then two flags.
constexpr int kValidMask = 63;
constexpr int kOpens = 64;         // the first tile of its piece
constexpr int kCloses = 128;       // the last tile of its piece

// bf16 at D 256 keeps the q rows in shared memory: in registers they would
// take 64 a thread beside the 128 of the output accumulator.
template <int D>
constexpr bool kBf16QInSmem = D > 128;

template <typename T, int D>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kStages = kBf16 ? 3 : 2;
  static constexpr int kRowElems = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kRowBytes = kRowElems * static_cast<int>(sizeof(T));
  // K and V rows of a tile, then the tile's descriptor (16 bytes)
  static constexpr int kStageBytes = 2 * kTile * kRowBytes + 16;
  // the warp's q rows, where they are staged in shared memory
  static constexpr int kQBytes =
      kBf16 ? (kBf16QInSmem<D> ? kMaxG * D * 2 : 0) : kMaxG * D * 4;
  static constexpr int kWarpBytes = kStages * kStageBytes + kQBytes;
  // as many warps (4, 2 or 1) as fit 220 KB: D 256 takes 2 in bf16
  // (211,040 B), 1 in float32 (141,344 B)
  static constexpr int kWarps = 4 * kWarpBytes <= 220 * 1024   ? 4
                                : 2 * kWarpBytes <= 220 * 1024 ? 2
                                                               : 1;
  static constexpr int kSmemBytes = kWarps * kWarpBytes;
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The valid range [lo, hi) of a row of length `len`.
__device__ __forceinline__ void valid_range(int len, int L, int window,
                                            int& lo, int& hi) {
  hi = min(max(len, 0), L);
  lo = window > 0 ? min(max(len - window, 0), hi) : 0;
}

struct Shape {
  const int* lengths;
  int B, L, Hkv, window, piece_len;
};

// A warp's walk over its pieces, one 32-position tile at a time. `x` is
// the flattened piece id; `chunk` and `base` carry the prefix sum over the
// rows of `lengths` (32 at a time) so that ids are located in order.
struct Cursor {
  int x, chunk, base;
  bool valid;
  int b, hk, piece, beg, end, pos;

  __device__ void locate(const Shape& sh, int lane) {
    valid = false;
    while (chunk * 32 < sh.B) {
      const int r = chunk * 32 + lane;
      int lo = 0, hi = 0;
      if (r < sh.B) valid_range(sh.lengths[r], sh.L, sh.window, lo, hi);
      const int per = (hi - lo + sh.piece_len - 1) / sh.piece_len;
      const int cnt = per * sh.Hkv;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      if (x < base + total) {
        const int owner = __popc(__ballot_sync(kFull, base + incl <= x));
        const int first = base + __shfl_sync(kFull, incl - cnt, owner);
        const int o_per = __shfl_sync(kFull, per, owner);
        const int o_lo = __shfl_sync(kFull, lo, owner);
        const int o_hi = __shfl_sync(kFull, hi, owner);
        const int local = x - first;
        b = chunk * 32 + owner;
        hk = local / o_per;
        piece = local % o_per;
        beg = o_lo + piece * sh.piece_len;
        end = min(beg + sh.piece_len, o_hi);
        pos = beg;
        valid = true;
        return;
      }
      base += total;
      ++chunk;
    }
  }

  __device__ void advance(const Shape& sh, int stride, int lane) {
    pos += kTile;
    if (pos < end) return;
    x += stride;
    locate(sh, lane);
  }
};

// bf16: the group's heads are rows 0..G-1 of an m16n8k16 A tile.
template <int D>
struct Bf16Math {
  static constexpr int KS = D / 16;        // depth steps of QK^T
  static constexpr bool kQSmem = kBf16QInSmem<D>;
  static constexpr int KQ = kQSmem ? 1 : KS;
  uint32_t qa[KQ][2];                      // a0, a2 (rows 8..15 are zero)
  uint32_t qn[KQ][2];                      // the next piece's, in flight
  __nv_bfloat16* qs;                       // kQSmem: the warp's [G][D] q rows
  const __nv_bfloat16* qg_next;            // kQSmem: the next piece's q rows
  int G;
  float m, l;                              // head grp, log2 units
  float acc[D / 8][4];                     // c0, c1: head grp

  // Start loading the q rows of a piece (global loads into registers,
  // consumed by the next begin); with kQSmem only note where they are.
  __device__ void fetch(const __nv_bfloat16* qg, int G_, int lane) {
    if constexpr (kQSmem) {
      qg_next = qg;
    } else {
      const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* p = qg + grp * D + ks * 16 + 2 * tig;
        qn[ks][0] = grp < G_ ? *reinterpret_cast<const uint32_t*>(p) : 0u;
        qn[ks][1] = grp < G_ ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
      }
    }
  }

  __device__ void begin(int G_, int lane) {
    G = G_;
    if constexpr (kQSmem) {
      __syncwarp();                        // the last piece's reads are done
      for (int i = lane; i < G * D / 8; i += 32)
        reinterpret_cast<uint4*>(qs)[i] =
            reinterpret_cast<const uint4*>(qg_next)[i];
      __syncwarp();
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        qa[ks][0] = qn[ks][0];
        qa[ks][1] = qn[ks][1];
      }
    }
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  __device__ void tile(const unsigned char* kv, int n_valid, float scale,
                       float softcap, int lane) {
    constexpr int RE = Layout<__nv_bfloat16, D>::kRowElems;
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(kv);
    const __nv_bfloat16* vs = ks + kTile * RE;
    const int grp = lane >> 2, tig = lane & 3;
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int jp = 0; jp < kTile / 16; ++jp) {
      if (16 * jp >= n_valid) continue;
#pragma unroll
      for (int ks_ = 0; ks_ < KS; ++ks_) {
        uint32_t a[4] = {0u, 0u, 0u, 0u};
        if constexpr (kQSmem) {
          const __nv_bfloat16* p = qs + grp * D + ks_ * 16 + 2 * tig;
          if (grp < G) {
            a[0] = *reinterpret_cast<const uint32_t*>(p);
            a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
          }
        } else {
          a[0] = qa[ks_][0];
          a[2] = qa[ks_][1];
        }
        uint32_t kf[4];
        tc::ldmatrix_x4(kf, ks + (16 * jp + (lane & 7) + (lane >> 4) * 8) *
                                     RE + ks_ * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * jp], a, kf[0], kf[1]);
        tc::mma_bf16(s[2 * jp + 1], a, kf[2], kf[3]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = 8 * n + 2 * tig + e < n_valid ? x * kLog2e : -INFINITY;
        s[n][e] = x;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m, tc::quad_max(mx));   // n_valid >= 1
    const float corr = tc::exp2_approx(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = tc::exp2_approx(s[n][e] - m_new);
        l += s[n][e];
      }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if (16 * kk >= n_valid) continue;
      uint32_t pa[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
      tc::split_bf16(s[2 * kk][0], s[2 * kk][1], pa[0], pl[0]);
      tc::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pl[2]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vf[4];
        tc::ldmatrix_x4_trans(vf, vs + (16 * kk + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * RE +
                                      16 * np + (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
        tc::mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
        tc::mma_bf16(acc[2 * np], pl, vf[0], vf[1]);
        tc::mma_bf16(acc[2 * np + 1], pl, vf[2], vf[3]);
      }
    }
  }

  __device__ void finish(float* pm, float* pl, float* pacc, int G,
                         int lane) {
    const int grp = lane >> 2, tig = lane & 3;
    const float den = tc::quad_sum(l);
    if (grp >= G) return;
    if (tig == 0) {
      pm[grp] = m;
      pl[grp] = den;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(pacc + grp * D + 8 * n + 2 * tig) =
          make_float2(acc[n][0], acc[n][1]);
  }
};

// float32: lane j scores position j of the tile for every head; lane c
// accumulates output columns c + 32 i.
template <int D>
struct F32Math {
  static constexpr int C = (D + 31) / 32;
  float* qs;                               // the warp's [G][D] q rows
  const float* qn;                         // the next piece's q rows
  int G;
  float m[kMaxG], l[kMaxG], acc[kMaxG][C];

  __device__ void fetch(const float* qg, int, int) { qn = qg; }

  __device__ void begin(int G_, int lane) {
    G = G_;
    __syncwarp();                          // the last piece's reads are done
    for (int i = lane; i < G * D; i += 32) qs[i] = qn[i];
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] = 0.f;
    }
  }

  __device__ void tile(const unsigned char* kv, int n_valid, float scale,
                       float softcap, int lane) {
    constexpr int RB = Layout<float, D>::kRowBytes;
    const unsigned char* ks = kv;
    const unsigned char* vs = kv + kTile * RB;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    const float* krow = reinterpret_cast<const float*>(ks + lane * RB);
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float4 qq = *reinterpret_cast<const float4*>(qs + g * D + d);
        s[g] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y,
                    fmaf(qq.z, kk.z, fmaf(qq.w, kk.w, s[g]))));
      }
    }
    const bool ok = lane < n_valid;
    float p[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float x = s[g] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x *= kLog2e;
      const float m_new = fmaxf(m[g], warp_max(ok ? x : -INFINITY));
      p[g] = ok ? exp2f(x - m_new) : 0.f;  // n_valid >= 1: m_new is finite
      const float corr = exp2f(m[g] - m_new);
      l[g] = l[g] * corr + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] *= corr;
    }
    for (int j = 0; j < n_valid; ++j) {
      const float* vrow = reinterpret_cast<const float*>(vs + j * RB);
      float vf[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        vf[c] = (D % 32 == 0 || lane + 32 * c < D) ? vrow[lane + 32 * c]
                                                  : 0.f;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float pj = __shfl_sync(kFull, p[g], j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[g][c] = fmaf(pj, vf[c], acc[g][c]);
      }
    }
  }

  __device__ void finish(float* pm, float* pl, float* pacc, int G_,
                         int lane) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G_) break;
      if (lane == 0) {
        pm[g] = m[g];
        pl[g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (D % 32 == 0 || lane + 32 * c < D)
          pacc[g * D + lane + 32 * c] = acc[g][c];
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(Layout<T, D>::kWarps * 32)
flash_decode_pieces_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, Shape sh,
                           float* __restrict__ part_m,
                           float* __restrict__ part_l,
                           float* __restrict__ part_acc, int G,
                           int max_pieces, float scale, float softcap) {
  using Lay = Layout<T, D>;
  using Math = typename std::conditional<Lay::kBf16, Bf16Math<D>,
                                         F32Math<D>>::type;
  constexpr int E = 16 / sizeof(T);        // elements per 16-byte chunk
  constexpr int CPR = D / E;               // chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = smem + warp * Lay::kWarpBytes;
  const int stride = gridDim.x * Lay::kWarps;
  const long long row_stride = static_cast<long long>(sh.Hkv) * D;

  // Only the loading cursor walks the piece list. With each tile it
  // leaves a descriptor in the tile's stage: the piece's scratch slot, the
  // valid positions (0 ends the walk), whether the tile opens or closes
  // its piece, and the piece's batch row and KV head.
  auto desc = [&](int stage) {
    return reinterpret_cast<int4*>(ring + stage * Lay::kStageBytes +
                                   2 * kTile * Lay::kRowBytes);
  };
  auto load_tile = [&](Cursor& c, int stage) {
    if (!c.valid) {
      if (lane == 0) *desc(stage) = make_int4(0, 0, 0, 0);
      return;
    }
    unsigned char* ks = ring + stage * Lay::kStageBytes;
    unsigned char* vs = ks + kTile * Lay::kRowBytes;
    const long long base = static_cast<long long>(c.b) * sh.L * row_stride +
                           static_cast<long long>(c.hk) * D;
    for (int i = lane; i < kTile * CPR; i += 32) {
      const int j = i / CPR, part = i % CPR, p = c.pos + j;
      const bool ok = p < c.end;
      const long long off = ok ? base + p * row_stride + part * E : 0;
      tc::cp_async16(ks + j * Lay::kRowBytes + part * 16, k + off, ok);
      tc::cp_async16(vs + j * Lay::kRowBytes + part * 16, v + off, ok);
    }
    if (lane == 0) {
      const int slot = (c.b * sh.Hkv + c.hk) * max_pieces + c.piece;
      const int info = min(kTile, c.end - c.pos) |
                       (c.pos == c.beg ? kOpens : 0) |
                       (c.pos + kTile >= c.end ? kCloses : 0);
      *desc(stage) = make_int4(slot, info, c.b, c.hk);
    }
    c.advance(sh, stride, lane);
  };
  const int Hq = sh.Hkv * G;
  auto q_rows = [&](const int4& d) {
    return q + (static_cast<long long>(d.z) * Hq +
                static_cast<long long>(d.w) * G) * D;
  };

  Cursor ld{static_cast<int>(blockIdx.x) * Lay::kWarps + warp, 0, 0, false};
  ld.locate(sh, lane);
#pragma unroll
  for (int s = 0; s < Lay::kStages - 1; ++s) {
    load_tile(ld, s);
    tc::cp_async_commit();
  }

  Math math;
  if constexpr (Lay::kQBytes > 0)
    math.qs = reinterpret_cast<decltype(math.qs)>(ring + Lay::kStages *
                                                             Lay::kStageBytes);
  bool fetched = false;                    // q of the next piece in flight
  for (int stage = 0;; stage = (stage + 1) % Lay::kStages) {
    load_tile(ld, (stage + Lay::kStages - 1) % Lay::kStages);
    tc::cp_async_commit();
    tc::cp_async_wait<Lay::kStages - 1>();   // this stage's tile landed
    __syncwarp();
    const int4 d = *desc(stage);
    const int n_valid = d.y & kValidMask;
    if (n_valid == 0) break;
    if (d.y & kOpens) {
      if (!fetched) math.fetch(q_rows(d), G, lane);
      math.begin(G, lane);
    }
    // The next stage's descriptor is written and visible: start loading
    // the q rows of the piece it opens, if any.
    const int4 dn = *desc((stage + 1) % Lay::kStages);
    fetched = (dn.y & kValidMask) != 0 && (dn.y & kOpens) != 0;
    if (fetched) math.fetch(q_rows(dn), G, lane);
    math.tile(ring + stage * Lay::kStageBytes, n_valid, scale, softcap,
              lane);
    if (d.y & kCloses) {
      const long long slot = d.x;
      math.finish(part_m + slot * G, part_l + slot * G,
                  part_acc + slot * G * D, G, lane);
    }
    __syncwarp();                            // the stage may be refilled
  }
}

// Pass 2: one warp per (batch row, query head) merges the row's pieces,
// lane c holding output columns c + 32 i.
constexpr int kCombineWarps = 4;
constexpr int kCombineCols = 8;    // columns a lane holds: D <= 256

// With kLse, each (row, head) also gets its log-sum-exp over the keys
// it saw, in natural-log units (-inf where it saw none): the sequence-
// sharded decode merges the pieces of several ranks with it.
template <typename T, bool kLse>
__global__ void __launch_bounds__(kCombineWarps * 32)
flash_decode_combine_kernel(const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const float* __restrict__ part_acc,
                            T* __restrict__ o, float* __restrict__ lse,
                            Shape sh, int G, int D, int max_pieces) {
  const int lane = threadIdx.x & 31;
  const int Hq = sh.Hkv * G;
  const long long task =
      static_cast<long long>(blockIdx.x) * kCombineWarps + (threadIdx.x >> 5);
  if (task >= static_cast<long long>(sh.B) * Hq) return;
  const long long b = task / Hq;
  const int h = static_cast<int>(task % Hq), g = h % G;
  int lo, hi;
  valid_range(sh.lengths[b], sh.L, sh.window, lo, hi);
  const int n = (hi - lo + sh.piece_len - 1) / sh.piece_len;
  const long long row = (b * sh.Hkv + h / G) * max_pieces;
  // Pieces 32 at a time: lane s holds piece s0 + s's max and sum; the
  // running max, sum and output are rescaled as the max grows.
  float mx = -INFINITY, den = 0.f, num[kCombineCols];
#pragma unroll
  for (int c = 0; c < kCombineCols; ++c) num[c] = 0.f;
  for (int s0 = 0; s0 < n; s0 += 32) {
    const int s = s0 + lane;
    const float ms = s < n ? part_m[(row + s) * G + g] : -INFINITY;
    const float ls = s < n ? part_l[(row + s) * G + g] : 0.f;
    const float m_new = fmaxf(mx, warp_max(ms));     // finite: n > s0
    const float corr = tc::exp2_approx(mx - m_new);
    const float w = tc::exp2_approx(ms - m_new);
    den = den * corr + warp_sum(ls * w);
    mx = m_new;
#pragma unroll
    for (int c = 0; c < kCombineCols; ++c) num[c] *= corr;
    const int count = min(32, n - s0);
#pragma unroll 8
    for (int j = 0; j < count; ++j) {
      const float wj = __shfl_sync(kFull, w, j);
      const float* a = part_acc + ((row + s0 + j) * G + g) * D;
#pragma unroll
      for (int c = 0; c < kCombineCols; ++c)
        if (lane + 32 * c < D) num[c] = fmaf(wj, a[lane + 32 * c], num[c]);
    }
  }
  T* out = o + (b * Hq + h) * D;
#pragma unroll
  for (int c = 0; c < kCombineCols; ++c)
    if (lane + 32 * c < D)
      out[lane + 32 * c] = from_float<T>(den > 0.f ? num[c] / den : 0.f);
  if constexpr (kLse) {
    // mx is in log2 units of the scaled scores
    if (lane == 0)
      lse[b * Hq + h] = den > 0.f ? mx * 0.69314718055994531f + logf(den)
                                  : -INFINITY;
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess || count <= 0)
      count = 132;
  }
  return count;
}

// Raises the pieces kernel's shared-memory limit and gives the number of
// its blocks resident on the card at once (the persistent grid).
template <typename T, int D>
int resident_blocks(int* blocks) {
  using Lay = Layout<T, D>;
  auto pieces = flash_decode_pieces_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      pieces, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pieces, Lay::kWarps * 32, Lay::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
  }
  *blocks = per_sm * sm_count();
  return 0;
}

template <typename T, int D>
int piece_len(int B, int Hkv, int L) {
  int blocks = 0;
  const int err = resident_blocks<T, D>(&blocks);
  if (err != 0) return -err;
  // About two pieces per resident warp if every row were full, so that
  // a long batch takes long pieces (less partial state to merge) and a
  // short one still spreads over the card: 32 to 256 positions.
  const long long warps = static_cast<long long>(blocks) * Layout<T, D>::kWarps;
  const long long positions = static_cast<long long>(B) * Hkv * L;
  long long tiles = (positions + 2 * warps * kTile - 1) / (2 * warps * kTile);
  if (tiles < 1) tiles = 1;
  if (tiles > kMaxPieceTiles) tiles = kMaxPieceTiles;
  return static_cast<int>(tiles) * kTile;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const Shape& sh,
           float* part_m, float* part_l, float* part_acc, void* o,
           float* lse, int G, int max_pieces, float scale, float softcap,
           cudaStream_t stream) {
  using Lay = Layout<T, D>;
  int resident = 0;
  const int status = resident_blocks<T, D>(&resident);
  if (status != 0) return status;
  if (sh.B == 0) return 0;
  const long long worst = static_cast<long long>(sh.B) * sh.Hkv * max_pieces;
  const long long needed = (worst + Lay::kWarps - 1) / Lay::kWarps;
  const long long blocks = resident < needed ? resident : needed;
  if (blocks > 0) {
    flash_decode_pieces_kernel<T, D>
        <<<static_cast<unsigned>(blocks), Lay::kWarps * 32, Lay::kSmemBytes,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), sh, part_m, part_l, part_acc,
                     G, max_pieces, scale, softcap);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tasks = static_cast<long long>(sh.B) * sh.Hkv * G;
  auto combine = lse != nullptr ? flash_decode_combine_kernel<T, true>
                                : flash_decode_combine_kernel<T, false>;
  combine<<<static_cast<unsigned>((tasks + kCombineWarps - 1) / kCombineWarps),
            kCombineWarps * 32, 0, stream>>>(part_m, part_l, part_acc,
                                             static_cast<T*>(o), lse, sh, G,
                                             D, max_pieces);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// The TMA instance: bf16, D 256, G <= 8 (gemma2-2b's decode).
//
// One block an SM, each a producer warp and a consumer warpgroup. The
// valid positions [lo, hi) of every (batch row, KV head) are cut into
// tiles of kTile positions starting at lo (only a row's last tile is
// short), laid end to end in row order, and grouped into units of
// kUnitTiles tiles within a row; consumer w takes units [w U / W, (w + 1)
// U / W), so no consumer carries more than one unit beyond the mean, and
// a row may be cut at any unit boundary. Every warp finds its block's
// range from `lengths` by a warp prefix sum: no host sync, no extra
// launch. Each row segment a consumer touches leaves one partial (max,
// denominator, unnormalised O, float32) in slot row + w: a consumer's
// tiles are contiguous in row order, so no two segments share a slot,
// and the scratch holds B * Hkv + W of them.
//
// The producer (one thread) streams each tile into a ring of kStages
// stages by TMA: K and V as four 128-byte-swizzled boxes of 64 columns x
// kTile positions each, and the group's q rows as four boxes of 64
// columns x G heads (rows G..7 stay zero). The box starts at the tile's
// first position, so nothing before lo is read; the last tile of a row
// reads up to kTile - 1 positions past hi (zeros past L).
//
// The consumer warpgroup runs wgmma with the roles of the operands
// swapped, so that the group's heads are the narrow N side:
// S^T = K Q^T is m64n8k16 x 16 (A the K tile, K-major; B the q rows), 4
// floats a thread; scale, softcap (tc::tanh_ex2), the mask, and an online
// max and sum per head column, the tile's max crossing the four warps
// through shared memory; P^T goes to shared memory as bf16 hi and lo
// (about 16 bits of p, as the pieces kernel keeps), and O^T += V^T P^T is
// m64n8k16 x 32 (A the V tile read MN-major, over 4 chunks of 64 rows of
// D and 4 steps of 16 positions), 16 floats a thread. Positions past hi
// are masked in the scores, and their V rows are zeroed in shared memory
// before P V (0 x NaN is NaN), so that whatever the cache holds there
// never reaches the output.
//
// What bounds it is the TMA stream: with the math taken out, a call takes
// nearly as long (launch/ab_attention.py --decode, `tma_no_math`).
//
// The combine pass runs one warp per (row, query head, kCombineCols
// output columns) and merges a row's partials in consumer order, so two
// calls give equal bits (no counter, no atomics). It is launched as a
// programmatic dependent of the main kernel (kDependentCombine).
namespace td {

constexpr int kTile = 64;                 // positions a tile
constexpr int kD = 256;
constexpr int kBlocks = kD / 64;          // 64-column blocks of a row
constexpr int kStages = 3;
constexpr int kUnitTiles = 1;             // tiles a unit of the split
constexpr bool kSplitP = true;            // P in P V as bf16 hi + lo
constexpr int kCombineCols = 64;          // columns a combine warp merges
// The combine pass launched as a programmatic dependent of the main
// kernel: it is scheduled as the main kernel's blocks end, with no launch
// gap between the two, and waits (griddepcontrol.wait) for the partials.
// The main kernel does not trigger it earlier: that gains nothing, and a
// profile would charge the combine for its wait under the main kernel.
constexpr bool kDependentCombine = true;
constexpr int kConsumerThreads = 128;
constexpr int kThreads = kConsumerThreads + 32;
constexpr int kBoxBytes = kTile * 128;    // one 64-column block of a tile
constexpr int kKV = kBlocks * kBoxBytes;  // K (or V) of a tile
constexpr int kQ = kBlocks * 1024;        // 8 q rows a 64-column block
constexpr int kStageBytes = 2 * kKV + kQ;
// the barriers and the warps' exchange in the first 1024 bytes, then
// P^T (hi, lo), then the stages; 1024 bytes to align to the swizzle
constexpr int kHead = 1024;
constexpr int kPBytes = 8 * kTile * 2;    // P^T: 8 heads x kTile bf16
constexpr int oStages = kHead + 2 * kPBytes;
constexpr int kSmemBytes = oStages + kStages * kStageBytes + 1024;
static_assert(kSmemBytes <= 232448, "shared memory");
static_assert(kPBytes == 1024, "P^T is one swizzle atom");

struct Args {
  const int* lengths;
  float* part_m;
  float* part_l;
  float* part_acc;
  int B, L, Hkv, G, window, W, box_rows;
  float c_score;                  // scale * log2(e), without a softcap
  float cap_in, cap_out;          // scale / softcap, softcap * log2(e)
  int capped;
};

// Tiles of batch row b's rows (each of its Hkv rows has the same).
__device__ __forceinline__ int row_tiles(const Args& a, int b, int& lo,
                                         int& hi) {
  valid_range(a.lengths[b], a.L, a.window, lo, hi);
  return (hi - lo + kTile - 1) / kTile;
}
__device__ __forceinline__ int units_of(int tiles) {
  return (tiles + kUnitTiles - 1) / kUnitTiles;
}

// Units of all rows (warp-collective).
__device__ int total_units(const Args& a, int lane) {
  int total = 0;
  for (int c0 = 0; c0 < a.B; c0 += 32) {
    int lo, hi;
    const int r = c0 + lane;
    const int u = r < a.B ? units_of(row_tiles(a, r, lo, hi)) : 0;
    total += __reduce_add_sync(kFull, u) * a.Hkv;
  }
  return total;
}

// A consumer's walk over its tiles: batch row b, KV head hk, tile j of
// the row's `tiles`, `left` units of its range not yet finished.
struct Walk {
  int b, hk, j, tiles, lo, hi, left;

  // Consumer w's first tile; false if its range is empty (warp-
  // collective: the prefix sum of `Cursor::locate`, over units).
  __device__ bool start(const Args& a, int w, int lane) {
    const long long U = total_units(a, lane);
    const long long u0 = w * U / a.W, u1 = (w + 1) * U / a.W;
    left = static_cast<int>(u1 - u0);
    if (left == 0) return false;
    long long base = 0;
    for (int c0 = 0;; c0 += 32) {          // u0 < U: found before B
      const int r = c0 + lane;
      int rlo = 0, rhi = 0, t = 0;
      if (r < a.B) t = row_tiles(a, r, rlo, rhi);
      const int cnt = units_of(t) * a.Hkv;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int sum = __shfl_sync(kFull, incl, 31);
      if (u0 < base + sum) {
        const int owner = __popc(__ballot_sync(kFull, base + incl <= u0));
        const long long first = base + __shfl_sync(kFull, incl - cnt, owner);
        b = c0 + owner;
        tiles = __shfl_sync(kFull, t, owner);
        lo = __shfl_sync(kFull, rlo, owner);
        hi = __shfl_sync(kFull, rhi, owner);
        const int per = units_of(tiles);
        const int local = static_cast<int>(u0 - first);
        hk = local / per;
        j = (local % per) * kUnitTiles;
        return true;
      }
      base += sum;
    }
  }

  // Whether this tile ends a segment: the row's last, or the range's.
  __device__ bool closes() const {
    return j + 1 == tiles || (left == 1 && (j + 1) % kUnitTiles == 0);
  }

  // On to the next tile; false past the range's end.
  __device__ bool advance(const Args& a) {
    ++j;
    if (j == tiles || j % kUnitTiles == 0) --left;
    if (left == 0) return false;
    if (j == tiles) {
      j = 0;
      if (++hk == a.Hkv) {
        hk = 0;
        do {
          ++b;
          tiles = row_tiles(a, b, lo, hi);
        } while (tiles == 0);
      }
    }
    return true;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
flash_decode_tma_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tq,
                        const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(sm + 256);   // [warp][head] maxima
  float* lred = red + 32;                            // [warp][head] sums
  uint8_t* p_hi = sm + kHead;
  uint8_t* p_lo = p_hi + kPBytes;
  uint8_t* stages = sm + oStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hop::mbar_init(full + st, 1);
      hop::mbar_init(empty + st, kConsumerThreads / 32);
    }
    hop::mbar_fence_init();
  }
  // rows G..7 of every stage's q tile are zero: the products' columns
  // past the group read them (the boxes write rows 0..G-1 only)
  for (int x = threadIdx.x; x < kStages * kBlocks * 64; x += kThreads)
    if (x % 64 >= a.G * 8)
      reinterpret_cast<uint4*>(stages + (x / (kBlocks * 64)) * kStageBytes +
                               2 * kKV)[x % (kBlocks * 64)] =
          make_uint4(0u, 0u, 0u, 0u);
  hop::fence_async_smem();
  __syncthreads();

  Walk wk;
  if (!wk.start(a, blockIdx.x, lane)) return;        // the block's range

  if (warp == kConsumerThreads / 32) {
    // the producer
    if (lane != 0) return;
    const uint32_t tx = 2 * kBlocks * a.box_rows * 128 + kBlocks * a.G * 128;
    for (int i = 0;; ++i) {
      const int st = i % kStages;
      hop::mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
      hop::mbar_expect(full + st, tx);
      uint8_t* kp = stages + st * kStageBytes;
      const int pos = wk.lo + wk.j * kTile;
#pragma unroll
      for (int c = 0; c < kBlocks; ++c) {
        hop::tma_load_4d(kp + c * kBoxBytes, &tk, 64 * c, wk.hk, pos, wk.b,
                         full + st);
        hop::tma_load_4d(kp + kKV + c * kBoxBytes, &tv, 64 * c, wk.hk, pos,
                         wk.b, full + st);
        hop::tma_load_4d(kp + 2 * kKV + c * 1024, &tq, 64 * c, wk.hk * a.G,
                         0, wk.b, full + st);
      }
      if (!wk.advance(a)) break;
    }
    return;
  }

  // the consumer warpgroup: this thread's score rows are positions
  // 16 warp + grp (+ 8), its O^T rows d = 64 c + 16 warp + grp (+ 8), and
  // both its columns heads 2 tig and 2 tig + 1
  const int tid = threadIdx.x, grp = lane >> 2, tig = lane & 3;
  const int h0 = 2 * tig;
  const uint32_t ph = hop::smem_u32(p_hi), pl = hop::smem_u32(p_lo);
  float s[4], o[kBlocks][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  for (int i = 0;; ++i) {
    const int st = i % kStages;
    uint8_t* kp = stages + st * kStageBytes;
    const uint32_t k0 = hop::smem_u32(kp), v0 = k0 + kKV, q0 = k0 + 2 * kKV;
    const int n_valid = min(kTile, wk.hi - (wk.lo + wk.j * kTile));
    hop::mbar_wait(full + st, (i / kStages) & 1);
    __syncwarp();

    hop::fence_regs(s);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      hop::wgmma_ss_n8<0, 0>(
          s, hop::desc_sw128(k0 + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16),
          hop::desc_sw128(q0 + (kk / 4) * 1024 + (kk % 4) * 32, 16), kk > 0);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = a.capped ? a.cap_out * tc::tanh_ex2(s[e] * a.cap_in)
                               : s[e] * a.c_score;
      s[e] = 16 * warp + grp + 8 * (e >> 1) < n_valid ? x : -INFINITY;
      mx[e & 1] = fmaxf(mx[e & 1], s[e]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int x = 4; x < 32; x <<= 1)
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], x));
      if (grp == 0) red[warp * 8 + h0 + h] = mx[h];
    }
    if (n_valid < kTile) {
      // V rows past the row's end: zero (their p is 0, and 0 x NaN is
      // NaN in P V); a row of a 64-column block is 128 contiguous bytes
      for (int x = n_valid * 128 + tid * 16; x < kBoxBytes;
           x += kConsumerThreads * 16)
#pragma unroll
        for (int c = 0; c < kBlocks; ++c)
          *reinterpret_cast<uint4*>(kp + kKV + c * kBoxBytes + x) =
              make_uint4(0u, 0u, 0u, 0u);
    }
    hop::named_sync(1, kConsumerThreads);
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = red[h0 + h];
#pragma unroll
      for (int w = 1; w < 4; ++w) t = fmaxf(t, red[w * 8 + h0 + h]);
      const float m_new = fmaxf(m[h], t);   // finite: a position is valid
      corr[h] = tc::exp2_approx(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = tc::exp2_approx(s[e] - m[e & 1]);
      l[e & 1] += s[e];
      const int p = 16 * warp + grp + 8 * (e >> 1), h = h0 + (e & 1);
      const int off = h * 128 + ((((p >> 3) ^ h) & 7) << 4) + (p & 7) * 2;
      const __nv_bfloat16 hi = __float2bfloat16(s[e]);
      *reinterpret_cast<__nv_bfloat16*>(p_hi + off) = hi;
      if constexpr (kSplitP)
        *reinterpret_cast<__nv_bfloat16*>(p_lo + off) =
            __float2bfloat16(s[e] - __bfloat162float(hi));
    }
#pragma unroll
    for (int c = 0; c < kBlocks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] *= corr[e & 1];
    hop::fence_async_smem();               // P^T and zeroed V rows
    hop::named_sync(1, kConsumerThreads);

    hop::fence_regs(o);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kBlocks; ++c) {
        const uint64_t dv =
            hop::desc_sw128(v0 + c * kBoxBytes + kk * 2048, kBoxBytes);
        hop::wgmma_ss_n8<1, 0>(o[c], dv, hop::desc_sw128(ph + kk * 32, 16),
                               1);
        if constexpr (kSplitP)
          hop::wgmma_ss_n8<1, 0>(o[c], dv,
                                 hop::desc_sw128(pl + kk * 32, 16), 1);
      }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
    if (lane == 0) hop::mbar_arrive(empty + st);

    if (wk.closes()) {
      // the segment's partial: the denominators over the lanes of one
      // tig, then the four warps, in a fixed order
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 4; x < 32; x <<= 1)
          l[h] += __shfl_xor_sync(kFull, l[h], x);
        if (grp == 0) lred[warp * 8 + h0 + h] = l[h];
      }
      hop::named_sync(1, kConsumerThreads);
      const long long slot = static_cast<long long>(wk.b) * a.Hkv + wk.hk +
                             blockIdx.x;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (warp == 0 && grp == 0 && h0 + h < a.G) {
          a.part_m[slot * a.G + h0 + h] = m[h];
          a.part_l[slot * a.G + h0 + h] = lred[h0 + h] + lred[8 + h0 + h] +
                                          lred[16 + h0 + h] +
                                          lred[24 + h0 + h];
        }
      float* acc = a.part_acc + slot * a.G * kD;
#pragma unroll
      for (int c = 0; c < kBlocks; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = h0 + (e & 1);
          if (h < a.G)
            acc[h * kD + 64 * c + 16 * warp + grp + 8 * (e >> 1)] = o[c][e];
          o[c][e] = 0.f;
        }
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
    }
    if (!wk.advance(a)) break;
  }
}

// The consumer that takes unit u: the w with w U / W <= u < (w + 1) U / W.
__device__ __forceinline__ int owner(long long u, long long U, int W) {
  return static_cast<int>(((u + 1) * W - 1) / U);
}

// One warp per (row, query head, kCombineCols output columns): the row's
// partials, slots row + w for the consumers w that touched it, merged in
// consumer order. With kLse, the lse as the pieces kernel's combine.
template <bool kLse>
__global__ void __launch_bounds__(128)
flash_decode_tma_combine_kernel(const Args a, __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse) {
  constexpr int kChunks = kD / kCombineCols, N2 = kCombineCols / 64;
  const int lane = threadIdx.x & 31;
  const long long task =
      static_cast<long long>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (task >= static_cast<long long>(a.B) * a.Hkv * a.G * kChunks) return;
  const int chunk = static_cast<int>(task % kChunks);
  const long long rg = task / kChunks;
  const int g = static_cast<int>(rg % a.G);
  const long long row = rg / a.G;
  const int b = static_cast<int>(row / a.Hkv), hk = static_cast<int>(row % a.Hkv);
  const int Hq = a.Hkv * a.G;
  // the units before this row and in all rows
  long long before = 0, U = 0;
  for (int c0 = 0; c0 < a.B; c0 += 32) {
    int lo, hi;
    const int r = c0 + lane;
    const int u = r < a.B ? units_of(row_tiles(a, r, lo, hi)) : 0;
    before += __reduce_add_sync(kFull, r < b ? u : 0);
    U += __reduce_add_sync(kFull, u);
  }
  int lo, hi;
  const int per = units_of(row_tiles(a, b, lo, hi));
  const long long u0 = before * a.Hkv + static_cast<long long>(hk) * per;
  U *= a.Hkv;
  float mx = -INFINITY, den = 0.f, num[N2][2];
#pragma unroll
  for (int i = 0; i < N2; ++i) num[i][0] = num[i][1] = 0.f;
  // the main kernel's partials are complete and visible past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (per > 0) {
    const int w1 = owner(u0 + per - 1, U, a.W);
    for (int w = owner(u0, U, a.W);;) {
      const long long slot = row + w;
      const float ms = a.part_m[slot * a.G + g];
      const float ls = a.part_l[slot * a.G + g];
      const float2* acc = reinterpret_cast<const float2*>(
          a.part_acc + (slot * a.G + g) * kD + chunk * kCombineCols);
      const float m_new = fmaxf(mx, ms);
      const float corr = tc::exp2_approx(mx - m_new);
      const float wt = tc::exp2_approx(ms - m_new);
      den = den * corr + ls * wt;
#pragma unroll
      for (int i = 0; i < N2; ++i) {
        const float2 x = acc[32 * i + lane];
        num[i][0] = fmaf(wt, x.x, num[i][0] * corr);
        num[i][1] = fmaf(wt, x.y, num[i][1] * corr);
      }
      mx = m_new;
      if (w == w1) break;
      w = owner((w + 1) * U / a.W, U, a.W);   // the next that has units
    }
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
      o + (static_cast<long long>(b) * Hq + hk * a.G + g) * kD +
      chunk * kCombineCols);
#pragma unroll
  for (int i = 0; i < N2; ++i)
    out[32 * i + lane] =
        __floats2bfloat162_rn(num[i][0] * inv, num[i][1] * inv);
  if constexpr (kLse) {
    if (chunk == 0 && lane == 0)
      lse[static_cast<long long>(b) * Hq + hk * a.G + g] =
          den > 0.f ? mx * 0.69314718055994531f + logf(den) : -INFINITY;
  }
}

int launch(const void* q, const void* k, const void* v, const Shape& sh,
           float* part_m, float* part_l, float* part_acc, void* o,
           float* lse, int G, int slots, float scale, float softcap,
           cudaStream_t stream) {
  const int W = sm_count();
  if (static_cast<long long>(slots) !=
      static_cast<long long>(sh.B) * sh.Hkv + W)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sh.B == 0) return 0;
  // a runtime call first: cuTensorMapEncodeTiled wants its context
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hop::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  const int rows = sh.L < kTile ? sh.L : kTile;
  CUtensorMap tk, tv, tq;
  if (!hop::tensor_map(&tk, k, sh.B, sh.L, sh.Hkv, kD, rows) ||
      !hop::tensor_map(&tv, v, sh.B, sh.L, sh.Hkv, kD, rows) ||
      !hop::tensor_map(&tq, q, sh.B, 1, sh.Hkv * G, kD, 1, G))
    return static_cast<int>(cudaErrorInvalidPitchValue);
  Args a;
  a.lengths = sh.lengths;
  a.part_m = part_m;
  a.part_l = part_l;
  a.part_acc = part_acc;
  a.B = sh.B; a.L = sh.L; a.Hkv = sh.Hkv; a.G = G; a.window = sh.window;
  a.W = W;
  a.box_rows = rows;
  a.c_score = scale * kLog2e;
  a.capped = softcap > 0.f;
  a.cap_in = a.capped ? scale / softcap : 0.f;
  a.cap_out = softcap * kLog2e;
  flash_decode_tma_kernel<<<W, kThreads, kSmemBytes, stream>>>(tk, tv, tq,
                                                               a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tasks =
      static_cast<long long>(sh.B) * sh.Hkv * G * (kD / kCombineCols);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((tasks + 3) / 4));
  cfg.blockDim = dim3(128);
  cfg.stream = stream;
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = kDependentCombine;
  cfg.attrs = dependent;
  cfg.numAttrs = 1;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  err = lse != nullptr
            ? cudaLaunchKernelEx(&cfg, flash_decode_tma_combine_kernel<true>,
                                 a, out, lse)
            : cudaLaunchKernelEx(&cfg, flash_decode_tma_combine_kernel<false>,
                                 a, out, lse);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace td

}  // namespace

#define FD_DISPATCH(CALL)                                   \
  if (dtype == 0) {                                         \
    if (D == 16) return CALL(float, 16);                    \
    if (D == 32) return CALL(float, 32);                    \
    if (D == 64) return CALL(float, 64);                    \
    if (D == 128) return CALL(float, 128);                  \
    if (D == 256) return CALL(float, 256);                  \
  } else if (dtype == 1) {                                  \
    if (D == 16) return CALL(__nv_bfloat16, 16);            \
    if (D == 32) return CALL(__nv_bfloat16, 32);            \
    if (D == 64) return CALL(__nv_bfloat16, 64);            \
    if (D == 128) return CALL(__nv_bfloat16, 128);          \
    if (D == 256) return CALL(__nv_bfloat16, 256);          \
  }

// Positions per piece for this shape (a multiple of 32), or a negative
// CUDA error code.
extern "C" int flash_decode_piece_len(int B, int Hkv, int L, int dtype,
                                      int D) {
#define FD_PIECE(TYPE, DIM) piece_len<TYPE, DIM>(B, Hkv, L)
  FD_DISPATCH(FD_PIECE)
#undef FD_PIECE
  return -static_cast<int>(cudaErrorInvalidValue);
}

// The TMA instance's consumers on this card: one a block, one block an
// SM (its scratch holds B * Hkv + consumers partials).
extern "C" int flash_decode_tma_consumers() { return sm_count(); }

// dtype: 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128, 256}; G <= 8;
// instance: 0 = the pieces kernel, piece_len from flash_decode_piece_len
// and slots = B * Hkv * ceil(L / piece_len); 1 = the TMA instance (bf16,
// D 256), piece_len 0 and slots = B * Hkv + flash_decode_tma_consumers().
// part_m, part_l: (slots, G) and part_acc: (slots, G, D) float32 scratch;
// lse: null, or (B, Hq) float32 to receive each row's log-sum-exp.
// Launches both passes on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   float* part_m, float* part_l,
                                   float* part_acc, void* o, float* lse,
                                   int B, int L,
                                   int Hkv, int G, int D, int piece_len,
                                   int slots, int dtype, float scale,
                                   int window, float softcap, int instance,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kMaxG || B < 0 || L < 1 || Hkv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (instance == 1) {
    if (dtype != 1 || D != td::kD || piece_len != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const Shape sh{lengths, B, L, Hkv, window, 0};
    return td::launch(q, k, v, sh, part_m, part_l, part_acc, o, lse, G,
                      slots, scale, softcap, st);
  }
  if (instance != 0 || piece_len < kTile || piece_len % kTile ||
      static_cast<long long>(slots) != static_cast<long long>(B) * Hkv *
                                           ((L + piece_len - 1) / piece_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const int max_pieces = (L + piece_len - 1) / piece_len;
  const Shape sh{lengths, B, L, Hkv, window, piece_len};
#define FD_LAUNCH(TYPE, DIM)                                              \
  launch<TYPE, DIM>(q, k, v, sh, part_m, part_l, part_acc, o, lse, G,   \
                    max_pieces, scale, softcap, st)
  FD_DISPATCH(FD_LAUNCH)
#undef FD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
