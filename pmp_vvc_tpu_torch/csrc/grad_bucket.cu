// K12c: the data-parallel training step's gradient bucket, for Hopper
// (sm_90a).
//
// Replaces the gradient combiner XLA puts in front of the gradient psum of
// the JAX package's sharded training steps (pmp_vvc_tpu/train/trainer.py:
// _shard_batch 63-70 shards the batch; value_and_grad in the jitted steps
// 85, 110, 136 then sums each gradient over the mesh). One launch copies
// every gradient tensor and the step's loss into one flat float32 buffer,
// each value multiplied by `scale` (1/D on a mesh of D ranks: each rank's
// loss is the mean over its own block, so the sum over the ranks of the
// scaled bucket is the mean over the global batch that JAX's loss takes).
// The all-reduce then runs once over the bucket, and the Adam update (K11b)
// reads the gradients as views of it; the loss is its last element.
//
// Bound: memory. Every value is read once and written once: 8 B. The luma
// Q + BD pair (92 tensors, 1,540,255 values, and the loss) moves 12.32 MB,
// 3.68 us at 3.35 TB/s. Design: as csrc/adam.cu, a table of pointers and
// offsets goes by value in the kernel's parameters (up to 128 sources); each
// source owns whole blocks of 1,024 values, and a block finds its source by
// a binary search of the table's first blocks. Loads and stores are
// coalesced, four values a thread; the product is __fmul_rn so that the
// kernel rounds as its plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 128;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;

struct BucketTable {
  const float* src[kMaxTensors];
  int off[kMaxTensors + 1];     // value offsets into the bucket
  int block0[kMaxTensors + 1];  // first block of each source
  int count;
};

__global__ void bucket_pack_kernel(const __grid_constant__ BucketTable tab, float scale,
                                   float* __restrict__ dst) {
  const int blk = blockIdx.x;
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {  // the last source whose first block is <= blk
    const int mid = (lo + hi + 1) >> 1;
    if (tab.block0[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const int t = lo;
  const int n = tab.off[t + 1] - tab.off[t];
  const float* src = tab.src[t];
  float* out = dst + tab.off[t];
  const int base = (blk - tab.block0[t]) * kChunk + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = base + k * kThreads;
    if (i >= n) break;
    out[i] = __fmul_rn(src[i], scale);
  }
}

}  // namespace

// k sources: src[i], numel[i] contiguous floats each, packed in order into
// dst (sum(numel) floats) times `scale`. One launch per 128 sources on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pmp_bucket_pack(int k, const float* const* src, const int64_t* numel,
                               float* dst, float scale, void* stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  int64_t off = 0;
  for (int first = 0; first < k; first += kMaxTensors) {
    BucketTable tab;
    tab.count = k - first < kMaxTensors ? k - first : kMaxTensors;
    int blocks = 0, local = 0;
    for (int i = 0; i < tab.count; ++i) {
      const int64_t n = numel[first + i];
      if (n < 0 || off + local + n > INT32_MAX) return (int)cudaErrorInvalidValue;
      tab.src[i] = src[first + i];
      tab.off[i] = local;
      tab.block0[i] = blocks;
      local += (int)n;
      blocks += n > 0 ? (int)((n + kChunk - 1) / kChunk) : 0;
    }
    tab.off[tab.count] = local;
    tab.block0[tab.count] = blocks;
    if (blocks > 0) {
      bucket_pack_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          tab, scale, dst + off);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    off += local;
  }
  return 0;
}
