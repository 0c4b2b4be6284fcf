// K11b: the Adam update of every parameter tensor in one launch, for Hopper
// (sm_90a).
//
// Replaces the optimizer half of the JAX package's jitted training steps
// (pmp_vvc_tpu/train/trainer.py:53-56, 81-83: optax.inject_hyperparams(
// optax.adam), b1 0.9, b2 0.999, eps 1e-8, eps_root 0, then
// optax.apply_updates). In optax's operation order, per element:
//   mu = (1-b1) g + b1 mu
//   nu = (1-b2) (g g) + b2 nu
//   u  = (mu / bc1) / (sqrt(nu / bc2) + eps)
//   p  = p + (-lr) u
// with __f*_rn so that nvcc contracts nothing into an FMA. The bias
// corrections bc = 1 - b^count and -lr come from the host each step, so the
// kernel and its plain version divide by the same float32 values.
//
// Bound: memory. Each element reads p, g, mu, nu and writes p, mu, nu: 28 B.
// The luma Q + BD pair (92 tensors, 1.54 M floats) moves 43 MB, 13 us at
// 3.35 TB/s. Design: one launch over all tensors. A table of pointers and
// offsets goes by value in the kernel's parameters (3,100 B for 128
// tensors); each tensor owns whole blocks of 1,024 elements, and a block
// finds its tensor by a binary search of the table's first blocks. mu and nu
// are flat buffers in parameter order. Loads and stores are coalesced,
// four elements a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 128;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;

struct AdamTable {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  int off[kMaxTensors + 1];     // element offsets into mu and nu
  int block0[kMaxTensors + 1];  // first block of each tensor
  int count;
};

struct AdamScalars {
  float b1, omb1, b2, omb2, eps, bc1, bc2, neg_lr;
};

__global__ void adam_kernel(const __grid_constant__ AdamTable tab, AdamScalars s,
                            float* __restrict__ mu, float* __restrict__ nu) {
  const int blk = blockIdx.x;
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {  // the last tensor whose first block is <= blk
    const int mid = (lo + hi + 1) >> 1;
    if (tab.block0[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const int t = lo;
  const int n = tab.off[t + 1] - tab.off[t];
  float* p = tab.p[t];
  const float* g = tab.g[t];
  float* m = mu + tab.off[t];
  float* v = nu + tab.off[t];
  const int base = (blk - tab.block0[t]) * kChunk + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = base + k * kThreads;
    if (i >= n) break;
    const float gi = g[i];
    const float mi = __fadd_rn(__fmul_rn(s.omb1, gi), __fmul_rn(s.b1, m[i]));
    const float vi = __fadd_rn(__fmul_rn(s.omb2, __fmul_rn(gi, gi)), __fmul_rn(s.b2, v[i]));
    const float u = __fdiv_rn(__fdiv_rn(mi, s.bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, s.bc2)), s.eps));
    m[i] = mi;
    v[i] = vi;
    p[i] = __fadd_rn(p[i], __fmul_rn(s.neg_lr, u));
  }
}

}  // namespace

// k tensors: p[i] (updated in place) and g[i], numel[i] floats each; mu, nu:
// the flat moments, sum(numel) floats, in the same order; scalars: 8 floats
// on the host (b1, 1-b1, b2, 1-b2, eps, bc1, bc2, -lr). One launch per 128
// tensors on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pmp_adam_update(int k, float* const* p, const float* const* g,
                               const int64_t* numel, float* mu, float* nu,
                               const float* scalars, void* stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  AdamScalars s = {scalars[0], scalars[1], scalars[2], scalars[3],
                   scalars[4], scalars[5], scalars[6], scalars[7]};
  int64_t off = 0;
  for (int first = 0; first < k; first += kMaxTensors) {
    AdamTable tab;
    tab.count = k - first < kMaxTensors ? k - first : kMaxTensors;
    int blocks = 0, local = 0;
    for (int i = 0; i < tab.count; ++i) {
      const int64_t n = numel[first + i];
      if (n < 0 || off + local + n > INT32_MAX) return (int)cudaErrorInvalidValue;
      tab.p[i] = p[first + i];
      tab.g[i] = g[first + i];
      tab.off[i] = local;
      tab.block0[i] = blocks;
      local += (int)n;
      blocks += n > 0 ? (int)((n + kChunk - 1) / kChunk) : 0;
    }
    tab.off[tab.count] = local;
    tab.block0[tab.count] = blocks;
    if (blocks > 0) {
      adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          tab, s, mu + off, nu + off);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    off += local;
  }
  return 0;
}
