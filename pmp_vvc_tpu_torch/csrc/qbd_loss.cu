// K11a: the Down-Up-CNN's training loss and its gradient, for Hopper (sm_90a).
//
// Replaces the loss half of the JAX package's jitted training steps
// (pmp_vvc_tpu/train/trainer.py:76-83, 100-108, 125-134: jax.value_and_grad
// of train/losses.py:msbd_loss (57) / qbd_loss (79) with direction_weights
// (47)). Three modes:
//   0 "q"   mean|qt_out - qt_label|                      (trainer.py:77-79)
//   1 "bd"  msbd_loss over the three branch outputs
//   2 "qbd" w.q * mean|qt_out - qt_label| + msbd_loss
// msbd_loss, per branch i with depth d_i = bd_i[:,0], direction p_i =
// bd_i[:,1], labels t_i = bt[:,i], r_i = dire[:,i] and wd_i = r_i^2 + m_i
// (wd_0 = 1 at QP 22):
//   b_i * mean|d_i - t_i|
// + d_i * mean|wd_i p_i - wd_i r_i|
// + resb_i * mean|wd_0 d_0 - wd_0 t_0|                        (i = 0)
//   resb_i * mean|wd_i (d_i - d_{i-1}) - wd_i (t_i - t_{i-1})| (i > 0)
// One call writes the loss and its gradient with respect to qt_out and each
// bd_i, which the autograd function saves and its backward scales.
//
// Arithmetic. Every elementwise value is formed in float32 in the JAX
// package's operation order with __f*_rn (no FMA contraction). The gradient
// of |x| is JAX's (lax.abs's JVP, select(x >= 0, g, -g)): +1 at 0, where
// predictions meet quantised labels exactly. Each term's gradient is its
// scale g = weight / count (formed on the host as autograd forms it) times
// that sign, times wd_i where wd_i multiplies. The depth gradient of branch i
// sums three terms: -(g sign wd_{i+1}) of branch i+1's residual term, then
// branch i's residual term, then its L1 term. The ten means are sums of
// |x| in float64, rounded once to float32; the loss then combines them in
// float32 in the JAX package's order.
//
// Bound: memory, and at training batches the launch. At batch 32 in mode
// qbd a call reads 0.61 MB (outputs and labels once) and writes 0.41 MB of
// gradients: 0.18 us at 3.35 TB/s, below one launch (~1 us). What a call
// costs beyond the launch is the chain of dependent steps of one warp, with
// one or two warps an SM, so the design spends one launch a call, one
// memory round trip a thread and few instructions:
// - a block of 64 threads (K11A_THREADS), a thread K11A_PPT consecutive
//   label positions (n, y, x), all three branches in registers: one 16-byte
//   load of each row segment of the outputs and labels (an 8-byte or a
//   4-byte one for 2 or 1 positions), all issued before any store, and one
//   16-byte store of each gradient segment; where any pointer of the call
//   is not 16-byte aligned (a view), the scalar instantiation loads and
//   stores element by element;
// - the ten sums, in a fixed order with no float atomics: a thread sums its
//   positions in index order, then block_sum (runs of 16 threads in turn
//   through shared memory, then the runs in turn) leaves term k's sum in
//   thread k; threads 0-9 write the block's ten float64 partials and fence,
//   and thread 0 takes a ticket from a 32-bit counter with
//   atomicInc(counter, blocks - 1), which wraps the counter back to 0 on the
//   last ticket; the block that draws ticket blocks - 1 sums every block's
//   partials in block order (thread t blocks t, t + 64, ..., then the same
//   block_sum, a second round of the same code), thread k divides term k's
//   sum by its count, and thread 0 combines the means. The order of every
//   addition depends on block and thread indices only, never on which block
//   ends last: card runs repeat exactly, and the counter is 0 again after
//   every call.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K11A_PPT          // label positions a thread: 1, 2 or 4
#define K11A_PPT 4
#endif
#ifndef K11A_THREADS      // threads a block
#define K11A_THREADS 64
#endif

namespace {

constexpr int kPPT = K11A_PPT;
constexpr int kThreads = K11A_THREADS;
constexpr int kTerms = 10;  // q, A0-2 (depth L1), B0-2 (direction), C0-2 (residual)
constexpr int kUnroll = 4;  // blocks' partials a thread of the last block loads at once
constexpr int kRun = 16;    // threads' sums a run of block_sum adds in turn
constexpr int kRuns = kThreads / kRun;
static_assert(kPPT == 1 || kPPT == 2 || kPPT == 4, "K11A_PPT is 1, 2 or 4");
static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 512,
              "K11A_THREADS is a multiple of 32 up to 512");

struct LossParams {
  float m[3];       // direction weights of the QP
  float qp22;       // 1: wd_0 = 1
  float c[kTerms];  // term weights: q, b0-2, d0-2, resb0-2
  float g[kTerms];  // gradient scales: c / count
  double count[2];  // the element counts of the q term (n * 64) and the others (n * 256)
  double inv[2];    // their reciprocals, rounded to nearest
};

// d|x|/dx as JAX forms it: +1 for x >= 0 (-0 included), else -1
__device__ __forceinline__ float sgn(float x) {
  return x >= 0.f ? 1.f : -1.f;
}

// kPPT consecutive floats: one vector access where VEC, else one a float
template <bool VEC>
__device__ __forceinline__ void load_seg(const float* __restrict__ p, float (&v)[kPPT]) {
  if constexpr (VEC && kPPT == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (VEC && kPPT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < kPPT; ++j) v[j] = p[j];
  }
}

template <bool VEC>
__device__ __forceinline__ void store_seg(float* __restrict__ p, const float (&v)[kPPT]) {
  if constexpr (VEC && kPPT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC && kPPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < kPPT; ++j) p[j] = v[j];
  }
}

// Shared memory of block_sum: every thread's sums (rows padded to 11
// doubles against bank conflicts), then each run's.
struct Scratch {
  double v[kThreads][kTerms + 1];
  double run[kTerms][kRuns];
};

// The sum of v over the block in a fixed order, in thread k for term k <
// kTerms: every thread stores its sums, thread (k, g) adds term k of threads
// 16g .. 16g + 15 in turn, then thread k adds its term's runs in turn. Some
// 30 instructions a thread on two barriers; a shuffle tree of ten float64
// sums takes 150 a warp, in a chain that a block of few warps cannot hide.
__device__ __forceinline__ double block_sum(const double (&v)[kTerms], Scratch& sm) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) sm.v[t][k] = v[k];
  __syncthreads();
  if (t < kTerms * kRuns) {
    const int k = t / kRuns, g = t % kRuns;
    double a = sm.v[g * kRun][k];
#pragma unroll
    for (int r = 1; r < kRun; ++r) a += sm.v[g * kRun + r][k];
    sm.run[k][g] = a;
  }
  __syncthreads();
  double tot = 0.0;
  if (t < kTerms) {
    tot = sm.run[t][0];
#pragma unroll
    for (int g = 1; g < kRuns; ++g) tot += sm.run[t][g];
  }
  return tot;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
qbd_loss_kernel(LossParams p, int mode, int n, const float* __restrict__ qt_out,
                const float* __restrict__ qt_label, const float* __restrict__ bd0,
                const float* __restrict__ bd1, const float* __restrict__ bd2,
                const float* __restrict__ bt, const float* __restrict__ dire,
                float* __restrict__ g_qt, float* __restrict__ g0, float* __restrict__ g1,
                float* __restrict__ g2, double* __restrict__ partials,
                unsigned int* __restrict__ counter, float* __restrict__ loss) {
  __shared__ Scratch sm;
  __shared__ bool last;
  double s[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) s[k] = 0.0;
  const int pos = (blockIdx.x * kThreads + threadIdx.x) * kPPT;  // first position
  const bool has_q = mode != 1 && pos < n * 64;
  const bool has_bd = mode != 0 && pos < n * 256;
  const float* bd[3] = {bd0, bd1, bd2};
  float* gb[3] = {g0, g1, g2};
  const int b = pos >> 8, yx = pos & 255;  // the segment lies in one CTU: 256 % kPPT == 0

  // every load first
  float qo[kPPT], ql[kPPT];
  float dep[3][kPPT], dir[3][kPPT], t[3][kPPT], r[3][kPPT];
  if (has_q) {
    load_seg<VEC>(qt_out + pos, qo);
    load_seg<VEC>(qt_label + pos, ql);
  }
  if (has_bd) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      load_seg<VEC>(bd[i] + b * 512 + yx, dep[i]);
      load_seg<VEC>(bd[i] + b * 512 + 256 + yx, dir[i]);
      load_seg<VEC>(bt + b * 768 + i * 256 + yx, t[i]);
      load_seg<VEC>(dire + b * 768 + i * 256 + yx, r[i]);
    }
  }

  if (has_q) {
    float gq[kPPT];
#pragma unroll
    for (int j = 0; j < kPPT; ++j) {
      const float d = __fsub_rn(qo[j], ql[j]);
      s[0] += fabsf(d);
      gq[j] = __fmul_rn(p.g[0], sgn(d));
    }
    store_seg<VEC>(g_qt + pos, gq);
  }
  if (has_bd) {
    float gdep[3][kPPT], gdir[3][kPPT];
#pragma unroll
    for (int j = 0; j < kPPT; ++j) {
      float wd[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) wd[i] = __fadd_rn(__fmul_rn(r[i][j], r[i][j]), p.m[i]);
      if (p.qp22 != 0.f) wd[0] = 1.f;
      float gres[3];  // g sign wd of each branch's residual term
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float a = __fsub_rn(dep[i][j], t[i][j]);
        const float bdir = __fsub_rn(__fmul_rn(wd[i], dir[i][j]), __fmul_rn(wd[i], r[i][j]));
        const float c = i == 0
            ? __fsub_rn(__fmul_rn(wd[0], dep[0][j]), __fmul_rn(wd[0], t[0][j]))
            : __fsub_rn(__fmul_rn(wd[i], __fsub_rn(dep[i][j], dep[i - 1][j])),
                        __fmul_rn(wd[i], __fsub_rn(t[i][j], t[i - 1][j])));
        s[1 + i] += fabsf(a);
        s[4 + i] += fabsf(bdir);
        s[7 + i] += fabsf(c);
        gres[i] = __fmul_rn(__fmul_rn(p.g[7 + i], sgn(c)), wd[i]);
        gdir[i][j] = __fmul_rn(__fmul_rn(p.g[4 + i], sgn(bdir)), wd[i]);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float ga = __fmul_rn(p.g[1 + i], sgn(__fsub_rn(dep[i][j], t[i][j])));
        const float gd = i < 2 ? __fadd_rn(-gres[i + 1], gres[i]) : gres[i];
        gdep[i][j] = __fadd_rn(gd, ga);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      store_seg<VEC>(gb[i] + b * 512 + yx, gdep[i]);
      store_seg<VEC>(gb[i] + b * 512 + 256 + yx, gdir[i]);
    }
  }

  // two rounds of one code path, so that the last block's second round runs
  // code its SM has just run: this block's sums, then (in the block that
  // draws the last ticket) every block's partials
  const int lane = threadIdx.x & 31;
  double total;
#pragma unroll 1
  for (int round = 0;; ++round) {
    total = block_sum(s, sm);
    if (round == 1) break;
    if (threadIdx.x < 32) {
      if (lane < kTerms) {
        partials[blockIdx.x * kTerms + lane] = total;
        __threadfence();
      }
      __syncwarp();
      if (lane == 0) last = atomicInc(counter, gridDim.x - 1) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
#pragma unroll
    for (int k = 0; k < kTerms; ++k) s[k] = 0.0;
    // blocks t, t + kThreads, ... in order, kUnroll blocks' loads at a time
    for (int blk0 = threadIdx.x; blk0 < (int)gridDim.x; blk0 += kUnroll * kThreads) {
      double v[kUnroll][kTerms];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int blk = blk0 + u * kThreads;
#pragma unroll
        for (int k = 0; k < kTerms; ++k)
          v[u][k] = blk < (int)gridDim.x ? __ldcg(partials + blk * kTerms + k) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kTerms; ++k) s[k] += v[u][k];
      }
    }
  }
  if (threadIdx.x >= 32) return;
  // thread k: the mean of term k, rounded once; thread 0 combines them
  // total / count rounded to nearest by Markstein's correction: with y =
  // RN(1 / count) from the host, q0 = RN(total y) is within an ulp, its
  // residual r = total - q0 count is exact by FMA, and RN(q0 + r y) is the
  // quotient rounded to nearest, as the division gives it, whose inline code
  // with its slow path is some 400 instructions of the tail
  const double y = lane ? p.inv[1] : p.inv[0], c = lane ? p.count[1] : p.count[0];
  const double q0 = __dmul_rn(total, y), q = __fma_rn(__fma_rn(-q0, c, total), y, q0);
  const float m = lane < kTerms ? (float)q : 0.f;
  float mean[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) mean[k] = __shfl_sync(0xffffffffu, m, k);
  if (lane != 0) return;
  if (mode == 0) {
    *loss = mean[0];
    return;
  }
  float msbd = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    msbd = __fadd_rn(msbd, __fmul_rn(p.c[1 + i], mean[1 + i]));
    msbd = __fadd_rn(msbd, __fmul_rn(p.c[4 + i], mean[4 + i]));
    msbd = __fadd_rn(msbd, __fmul_rn(p.c[7 + i], mean[7 + i]));
  }
  *loss = mode == 1 ? msbd : __fadd_rn(__fmul_rn(p.c[0], mean[0]), msbd);
}

bool aligned16(const void* q) {
  return q == nullptr || (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

}  // namespace

// The grid of one call (mode, batch n): its blocks, each writing ten
// partials. 0 for a bad mode or batch.
extern "C" int pmp_qbd_loss_blocks(int mode, int n) {
  if (mode < 0 || mode > 2 || n <= 0) return 0;
  const int positions = n * (mode == 0 ? 64 : 256);
  return (positions + kThreads * kPPT - 1) / (kThreads * kPPT);
}

// mode 0 (q), 1 (bd), 2 (qbd); n: the batch. qt_out, qt_label, g_qt:
// (n,1,8,8) (modes 0, 2; else null); bd0-2, g0-2: (n,2,16,16); bt, dire:
// (n,3,16,16) (modes 1, 2; else null); params: 24 floats on the host
// (LossParams' order); partials: pmp_qbd_loss_blocks(mode, n) * 10 doubles
// of scratch; counter: one unsigned int, 0 before the call and 0 after it,
// used by one stream at a time; loss: one float. All float32, contiguous.
// One launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pmp_qbd_loss(int mode, int n, const float* qt_out, const float* qt_label,
                            const float* bd0, const float* bd1, const float* bd2,
                            const float* bt, const float* dire, const float* params,
                            float* g_qt, float* g0, float* g1, float* g2, double* partials,
                            unsigned int* counter, float* loss, void* stream) {
  const int blocks = pmp_qbd_loss_blocks(mode, n);
  if (blocks == 0 || !partials || !counter || !loss) return (int)cudaErrorInvalidValue;
  if ((mode != 1 && (!qt_out || !qt_label || !g_qt)) ||
      (mode != 0 && (!bd0 || !bd1 || !bd2 || !bt || !dire || !g0 || !g1 || !g2)))
    return (int)cudaErrorInvalidValue;
  LossParams p;
  for (int i = 0; i < 3; ++i) p.m[i] = params[i];
  p.qp22 = params[3];
  for (int k = 0; k < kTerms; ++k) {
    p.c[k] = params[4 + k];
    p.g[k] = params[4 + kTerms + k];
  }
  for (int k = 0; k < 2; ++k) {
    p.count[k] = (double)n * (k ? 256 : 64);
    p.inv[k] = 1.0 / p.count[k];
  }
  const void* ptrs[] = {qt_out, qt_label, bd0, bd1, bd2, bt, dire, g_qt, g0, g1, g2};
  bool vec = true;
  for (const void* q : ptrs) vec = vec && aligned16(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    qbd_loss_kernel<true><<<blocks, kThreads, 0, s>>>(p, mode, n, qt_out, qt_label, bd0, bd1,
                                                      bd2, bt, dire, g_qt, g0, g1, g2,
                                                      partials, counter, loss);
  else
    qbd_loss_kernel<false><<<blocks, kThreads, 0, s>>>(p, mode, n, qt_out, qt_label, bd0, bd1,
                                                       bd2, bt, dire, g_qt, g0, g1, g2,
                                                       partials, counter, loss);
  return (int)cudaGetLastError();
}
