// The trust evaluators' scoring head in one kernel: each position's
// log-probability of its target token, out[p] = logit[p, tgt[p]] -
// logsumexp_v logit[p, v], where logit[p, v] = bf16(x[p] . w_v) is the
// vocabulary product rounded to bf16 as the plain path's bf16 GEMM output
// is. No logit reaches device memory.
//
// Replaces no TPU kernel: the JAX package leaves the head to XLA, which
// fuses the vocabulary product's log-softmax into its consumers. The
// port's plain path (models/transformer.py, the chunked loop) writes each
// chunk's bf16 logits, casts them to float32 and runs torch.logsumexp's
// four passes over them: 32 bytes of device traffic a logit, 150 GB a
// smollm step of 3,072 rows x 31 positions x 49,152 entries (>= 45 ms at
// 3.35 TB/s), against the product's 5.39 TFLOP (5.45 ms at 989 TFLOP/s).
// This kernel is bound by that product: P x d bf16 of x and the V x d
// weight are read, P int32 targets read and P float32 results written.
//
// x: (P, d) bf16, contiguous; w: the vocabulary weight, bf16, either
// (V, d) (a tied embedding table: K-major, the reduction along a row) or
// (d, V) (an untied unembedding: MN-major), a template flag, so that no
// weight is transposed or copied; tgt: (P,) int32 in [0, V); out: (P,)
// float32. d a multiple of 64; an MN-major V a multiple of 8 (TMA's
// 16-byte strides).
//
// Design (attention's online softmax with the vocabulary as keys and no
// V operand):
// - A persistent grid, one block an SM: a block owns a tile of 128
//   positions at a time (blockIdx, blockIdx + grid, ...) and walks every
//   vocabulary tile of 256 entries in the same order as the other blocks,
//   so that the blocks running together share each weight tile in L2.
// - A producer thread streams, for each vocabulary tile, the d / 64 steps
//   of the product through a ring of 4 stages with TMA: the positions'
//   128 x 64 slice of x (16 KB) and the tile's 256 x 64 slice of the
//   weight (32 KB; MN-major: four 64 x 64 boxes, only those that hold
//   entries below V), 128-byte swizzled; rows past P and entries past V
//   read as zeros. setmaxnreg moves its registers to the consumers.
// - Two consumer warpgroups, 64 positions each, run wgmma m64n256k16 with
//   both operands in shared memory into 128 float32 accumulators a
//   thread; a stage goes back to the producer once both have read it.
//   Warpgroup 1 starts kLag steps behind warpgroup 0, so that each one's
//   softmax update runs while the other's last products of the tile do.
// - Per tile, in registers: each accumulator rounded to bf16 (the plain
//   path's logit), entries past V masked to -inf, the target's logit
//   picked where its id falls in the tile, then a running max and sum of
//   2^((s - m) log2 e) for each of the thread's two rows over its own
//   columns. After the walk the four threads of a row merge theirs: only
//   the order of summation differs from the plain path.
// - No atomics and no counters: two calls give equal bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBM = 128;                  // positions a tile
constexpr int kBN = 256;                  // vocabulary entries a tile
constexpr int kBK = 64;                   // d a stage: one 128-byte row
constexpr int kStages = 4;
constexpr int kXBytes = kBM * kBK * 2;    // 16 KB
constexpr int kWBytes = kBN * kBK * 2;    // 32 KB
constexpr int kWBox = kBK * kBK * 2;      // an MN-major box: 64 x 64
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int oBar = kStages * kStageBytes;
// the ring, full[kStages] and empty[kStages], and the 1024-byte alignment
constexpr int kSmemBytes = oBar + 2 * kStages * 8 + 1024;
static_assert(kSmemBytes <= 232448, "shared memory");
constexpr int kThreads = 384;             // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// Steps of the product by which warpgroup 1 starts behind warpgroup 0
// (at most kStages, which warpgroup 0 can take alone). Measured on an
// H100 at smollm's step (PERF.md): 2 took 8.58 ms, 0, 1 and 3 8.84-8.91.
constexpr int kLag = 2;
static_assert(kLag >= 0 && kLag <= kStages, "the lag");
constexpr int kLagBar = 1;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const int* tgt;
  float* out;
  int P, V;
  int n_k;                                // d / 64
  int n_m, n_v;                           // position tiles, vocabulary tiles
};

// The producer (one thread): for each of the block's position tiles and
// each vocabulary tile, the d / 64 stages of x and w.
template <bool kMN>
__device__ __forceinline__ void load(const Args& a, const CUtensorMap* tx,
                                     const CUtensorMap* tw, uint8_t* sm) {
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + oBar);
  uint64_t* empty = full + kStages;
  int it = 0;
  for (int t = blockIdx.x; t < a.n_m; t += gridDim.x)
    for (int j = 0; j < a.n_v; ++j) {
      const int v0 = j * kBN;
      const int boxes = kMN ? min(kBN / 64, (a.V - v0 + 63) / 64) : 1;
      for (int c = 0; c < a.n_k; ++c, ++it) {
        const int s = it % kStages;
        hop::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        uint8_t* st = sm + s * kStageBytes;
        hop::mbar_expect(full + s, kXBytes + (kMN ? boxes * kWBox : kWBytes));
        hop::tma_load_4d(st, tx, c * kBK, 0, t * kBM, 0, full + s);
        if constexpr (kMN) {
          for (int b = 0; b < boxes; ++b)
            hop::tma_load_4d(st + kXBytes + b * kWBox, tw, v0 + 64 * b, 0,
                             c * kBK, 0, full + s);
        } else {
          hop::tma_load_4d(st + kXBytes, tw, c * kBK, 0, v0, 0, full + s);
        }
      }
    }
}

// One vocabulary tile's scores s (this thread's rows r and r + 8 of its
// warpgroup, columns 8 j + 2 tig + {0, 1}) into the rows' running max m,
// sum l (of 2^((s - m) log2 e), over this thread's columns) and target
// logit tl.
__device__ __forceinline__ void update(float (&s)[128], int v0, int V,
                                       int tig, const int (&tg)[2],
                                       float (&m)[2], float (&l)[2],
                                       float (&tl)[2]) {
  // the plain path's logits: the float32 sums rounded to bf16
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
    s[2 * i] = __low2float(b);
    s[2 * i + 1] = __high2float(b);
  }
  if (v0 + kBN > V) {                     // the ragged last tile
#pragma unroll
    for (int i = 0; i < 128; ++i)
      if (v0 + 8 * (i / 4) + 2 * tig + (i & 1) >= V) s[i] = -INFINITY;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ct = tg[h] - v0;            // the target's column in the tile
    if (ct >= 0 && ct < kBN && ((ct >> 1) & 3) == tig) {
      const int jt = ct >> 3;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        if (j == jt) tl[h] = (ct & 1) ? s[4 * j + 2 * h + 1] : s[4 * j + 2 * h];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      mx[j % 4] = fmaxf(mx[j % 4], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    const float m_new =
        fmaxf(m[h], fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])));
    // a thread all of whose columns so far lie past V keeps m -inf, l 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = tc::exp2_approx((m[h] - m_use) * kLog2e);
    const float off = -m_use * kLog2e;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      sum[j % 4] += tc::exp2_approx(fmaf(s[4 * j + 2 * h], kLog2e, off));
      sum[j % 4] += tc::exp2_approx(fmaf(s[4 * j + 2 * h + 1], kLog2e, off));
    }
    l[h] = l[h] * corr + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
    m[h] = m_new;
  }
}

// A consumer warpgroup: positions 64 wg .. 64 wg + 63 of each of the
// block's tiles. Per vocabulary tile, the d / 64 steps of S = X W^T
// (each step's stage released once the next step's products are issued
// and the step's are in), then `update`; after the walk, each row's
// result from its four threads.
template <bool kMN>
__device__ __forceinline__ void consume(const Args& a, uint8_t* sm, int wg,
                                        int tid) {
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + oBar);
  uint64_t* empty = full + kStages;
  const uint32_t base = hop::smem_u32(sm);
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  auto release = [&](int i) {
    if (lane == 0) hop::mbar_arrive(empty + i % kStages);
  };
  const int lag = min(kLag, a.n_k);
  bool first = true;                      // the block's first tile walk
  float s[128];
  int it = 0;
  for (int t = blockIdx.x; t < a.n_m; t += gridDim.x) {
    const int r0 = t * kBM + 64 * wg + 16 * warp + grp;  // rows r0, r0 + 8
    int tg[2];
    float m[2], l[2], tl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tg[h] = r0 + 8 * h < a.P ? a.tgt[r0 + 8 * h] : -1;
      m[h] = -INFINITY;
      l[h] = 0.f;
      tl[h] = -INFINITY;
    }
    for (int j = 0; j < a.n_v; ++j) {
      for (int c = 0; c < a.n_k; ++c, ++it) {
        const int st = it % kStages;
        if (first && wg == 1 && c == 0 && kLag > 0)
          hop::named_sync(kLagBar, 2 * 128);
        hop::mbar_wait(full + st, (it / kStages) & 1);
        const uint32_t sb = base + st * kStageBytes;
        const uint64_t da = hop::desc_sw128(sb + wg * 64 * 128, 16);
        const uint64_t db = hop::desc_sw128(sb + kXBytes, kMN ? kWBox : 16);
        if (c == 0) hop::fence_regs(s);     // `update` is done with s
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          hop::wgmma_ss_n256<0, kMN ? 1 : 0>(
              s, da + kk * 32 / 16, db + (kMN ? kk * 2048 : kk * 32) / 16,
              c > 0 || kk > 0);
        hop::wgmma_commit();
        if (first && wg == 0 && c == lag - 1 && kLag > 0)
          hop::named_arrive(kLagBar, 2 * 128);
        if (c > 0) {
          hop::wgmma_wait<1>();             // step c - 1 is in
          release(it - 1);
        }
      }
      first = false;
      hop::wgmma_wait<0>();
      hop::fence_regs(s);
      release(it - 1);
      update(s, j * kBN, a.V, tig, tg, m, l, tl);
    }
    // the four threads of each row: max, rescaled sums, the target
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mr = tc::quad_max(m[h]);
      const float mu = mr == -INFINITY ? 0.f : mr;
      const float lr = tc::quad_sum(l[h] * tc::exp2_approx((m[h] - mu) * kLog2e));
      const float tr = tc::quad_max(tl[h]);
      const int row = r0 + 8 * h;
      if (tig == 0 && row < a.P) a.out[row] = tr - (mr + logf(lr));
    }
  }
}

template <bool kMN>
__global__ void __launch_bounds__(kThreads, 1)
score_head_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + oBar);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(full + kStages + s, kConsumerWarps);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  // the warpgroup index from lane 0: provably the same across the warp,
  // which setmaxnreg (.sync.aligned) needs
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) load<kMN>(a, &tx, &tw, sm);
  } else {
    hop::setmaxnreg_inc<kConsumerRegs>();
    consume<kMN>(a, sm, wgi - 1, threadIdx.x % 128);
  }
}

template <bool kMN>
int launch(const void* x, const void* w, const int* tgt, float* out, int P,
           int d, int V, cudaStream_t stream) {
  if (P == 0) return 0;
  const int sms = hop::sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorNoDevice);
  // a runtime call first: cuTensorMapEncodeTiled wants its context
  cudaError_t err = cudaFuncSetAttribute(
      score_head_kernel<kMN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hop::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tx, tw;
  // x as (1, P, 1, d): boxes of 64 columns x 128 positions; w (V, d) as
  // boxes of 64 columns x 256 entries, or w (d, V) as 64 entries x 64
  // rows of d
  const bool ok = hop::tensor_map(&tx, x, 1, P, 1, d, kBM) &&
                  (kMN ? hop::tensor_map(&tw, w, 1, d, 1, V, kBK)
                       : hop::tensor_map(&tw, w, 1, V, 1, d, kBN));
  if (!ok) return static_cast<int>(cudaErrorInvalidPitchValue);
  Args a;
  a.tgt = tgt;
  a.out = out;
  a.P = P;
  a.V = V;
  a.n_k = d / kBK;
  a.n_m = (P + kBM - 1) / kBM;
  a.n_v = (V + kBN - 1) / kBN;
  const int grid = a.n_m < sms ? a.n_m : sms;
  score_head_kernel<kMN><<<grid, kThreads, kSmemBytes, stream>>>(tx, tw, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[p] = logit[p, tgt[p]] - logsumexp(logit[p, :]) for p < P (see the
// note at the top). w_mn_major: w is (d, V); else (V, d). Returns a
// cudaError_t (0: launched).
extern "C" int score_head_launch(const void* x, const void* w,
                                 const void* tgt, void* out, int P, int d,
                                 int V, int w_mn_major, void* stream) {
  if (P < 0 || d <= 0 || d % kBK != 0 || V <= 0 ||
      (w_mn_major && V % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* t = static_cast<const int*>(tgt);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_mn_major ? launch<true>(x, w, t, o, P, d, V, s)
                    : launch<false>(x, w, t, o, P, d, V, s);
}
