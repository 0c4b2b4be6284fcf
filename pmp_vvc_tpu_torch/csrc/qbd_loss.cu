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
// Determinism. The reduction is a fixed-order two-pass one, with no float
// atomics: the first kernel writes each block's ten partial sums (a fixed
// shuffle tree per warp, then warp 0 over the warps in order), the second
// kernel, one block, sums the partials in block order and combines them.
// Card runs repeat exactly.
//
// Bound: memory, and at training batches launch latency. At batch 32 in
// mode qbd a call reads 0.61 MB (outputs and labels once) and writes 0.41 MB
// of gradients: under 0.4 us at 3.35 TB/s, below one launch. Design: one
// thread per label position (n, y, x), all three branches in registers, so
// each value is read once and each gradient written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTerms = 10;  // q, A0-2 (depth L1), B0-2 (direction), C0-2 (residual)

struct LossParams {
  float m[3];       // direction weights of the QP
  float qp22;       // 1: wd_0 = 1
  float c[kTerms];  // term weights: q, b0-2, d0-2, resb0-2
  float g[kTerms];  // gradient scales: c / count
};

// d|x|/dx as JAX forms it: +1 for x >= 0 (-0 included), else -1
__device__ __forceinline__ float sgn(float x) {
  return x >= 0.f ? 1.f : -1.f;
}

// Sum of v over the block, in a fixed order; valid in thread 0.
__device__ __forceinline__ void block_sum(double (&v)[kTerms], double (*smem)[kTerms]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) smem[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
#pragma unroll
      for (int k = 0; k < kTerms; ++k) v[k] += smem[w][k];
    }
  }
}

__global__ void qbd_terms_kernel(LossParams p, int mode, int n,
                                 const float* __restrict__ qt_out,
                                 const float* __restrict__ qt_label,
                                 const float* __restrict__ bd0, const float* __restrict__ bd1,
                                 const float* __restrict__ bd2, const float* __restrict__ bt,
                                 const float* __restrict__ dire, float* __restrict__ g_qt,
                                 float* __restrict__ g0, float* __restrict__ g1,
                                 float* __restrict__ g2, double* __restrict__ partials) {
  __shared__ double smem[kThreads / 32][kTerms];
  double s[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) s[k] = 0.0;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;

  if (mode != 1 && tid < n * 64) {
    const float d = __fsub_rn(qt_out[tid], qt_label[tid]);
    s[0] = fabsf(d);
    g_qt[tid] = __fmul_rn(p.g[0], sgn(d));
  }
  if (mode != 0 && tid < n * 256) {
    const int b = tid >> 8, yx = tid & 255;
    const float* bd[3] = {bd0, bd1, bd2};
    float* gb[3] = {g0, g1, g2};
    float dep[3], dir[3], t[3], r[3], wd[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dep[i] = bd[i][b * 512 + yx];
      dir[i] = bd[i][b * 512 + 256 + yx];
      t[i] = bt[b * 768 + i * 256 + yx];
      r[i] = dire[b * 768 + i * 256 + yx];
      wd[i] = __fadd_rn(__fmul_rn(r[i], r[i]), p.m[i]);
    }
    if (p.qp22 != 0.f) wd[0] = 1.f;
    float gres[3];  // g sign wd of each branch's residual term
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a = __fsub_rn(dep[i], t[i]);
      const float bdir = __fsub_rn(__fmul_rn(wd[i], dir[i]), __fmul_rn(wd[i], r[i]));
      const float c = i == 0
          ? __fsub_rn(__fmul_rn(wd[0], dep[0]), __fmul_rn(wd[0], t[0]))
          : __fsub_rn(__fmul_rn(wd[i], __fsub_rn(dep[i], dep[i - 1])),
                      __fmul_rn(wd[i], __fsub_rn(t[i], t[i - 1])));
      s[1 + i] = fabsf(a);
      s[4 + i] = fabsf(bdir);
      s[7 + i] = fabsf(c);
      gres[i] = __fmul_rn(__fmul_rn(p.g[7 + i], sgn(c)), wd[i]);
      gb[i][b * 512 + 256 + yx] = __fmul_rn(__fmul_rn(p.g[4 + i], sgn(bdir)), wd[i]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float ga = __fmul_rn(p.g[1 + i], sgn(__fsub_rn(dep[i], t[i])));
      const float gd = i < 2 ? __fadd_rn(-gres[i + 1], gres[i]) : gres[i];
      gb[i][b * 512 + yx] = __fadd_rn(gd, ga);
    }
  }
  block_sum(s, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) partials[blockIdx.x * kTerms + k] = s[k];
  }
}

__global__ void qbd_combine_kernel(LossParams p, int mode, int n, int blocks,
                                   const double* __restrict__ partials,
                                   float* __restrict__ loss) {
  __shared__ double smem[kThreads / 32][kTerms];
  double s[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) s[k] = 0.0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) s[k] += partials[b * kTerms + k];
  }
  block_sum(s, smem);
  if (threadIdx.x != 0) return;
  float mean[kTerms];
  mean[0] = (float)(s[0] / (double)(n * 64));
#pragma unroll
  for (int k = 1; k < kTerms; ++k) mean[k] = (float)(s[k] / (double)(n * 256));
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

}  // namespace

// mode 0 (q), 1 (bd), 2 (qbd); n: the batch. qt_out, qt_label, g_qt:
// (n,1,8,8) (modes 0, 2; else null); bd0-2, g0-2: (n,2,16,16); bt, dire:
// (n,3,16,16) (modes 1, 2; else null); params: 24 floats on the host
// (LossParams' order); partials: ceil(positions / 256) * 10 doubles of
// scratch, positions n*256 (modes 1, 2) or n*64; loss: one float. All
// float32, contiguous. Launches both kernels on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int pmp_qbd_loss(int mode, int n, const float* qt_out, const float* qt_label,
                            const float* bd0, const float* bd1, const float* bd2,
                            const float* bt, const float* dire, const float* params,
                            float* g_qt, float* g0, float* g1, float* g2, double* partials,
                            float* loss, void* stream) {
  if (mode < 0 || mode > 2 || n <= 0) return (int)cudaErrorInvalidValue;
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
  const int positions = n * (mode == 0 ? 64 : 256);
  const int blocks = (positions + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  qbd_terms_kernel<<<blocks, kThreads, 0, s>>>(p, mode, n, qt_out, qt_label, bd0, bd1, bd2,
                                               bt, dire, g_qt, g0, g1, g2, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qbd_combine_kernel<<<1, kThreads, 0, s>>>(p, mode, n, blocks, partials, loss);
  return (int)cudaGetLastError();
}
