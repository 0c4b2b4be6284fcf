// K8: structural vote on the Down-Up-CNN's QT-depth maps, for Hopper (sm_90a).
//
// Replaces pmp_vvc_tpu/pmp/structural.py:structural_vote, the jitted program
// that follows the Q-net in pmp_vvc_tpu/pmp/predict.py. For each CTU it takes
// the raw 8x8 QT-depth map, 2x2 max-pools it to 4x4, rounds half to even
// (rintf, as jnp.round and torch.round do; not roundf), clamps to [0,3],
// repairs the 4x4 map by majority vote so that it describes a legal quadtree,
// and writes the 2x nearest upsample back as 8x8.
//
// Bound: memory. A CTU reads 256 B, writes 256 B and does under 200 scalar
// operations. At the prediction path's batch (512 CTUs, 0.26 MB in and out)
// the launch latency bounds the kernel long before the bytes do.
// Design: one thread per CTU, grid-strided over N. The 16 pooled values stay
// in registers, so the vote takes one pass: one read of the input and one
// write of the output, with no shared memory and no second launch.
// Inputs are finite (the Q-net's output); NaN is outside the contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void structural_vote_kernel(const float* __restrict__ in,
                                       float* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += stride) {
    // Row 2r of the 8x8 map is float4s 4r, 4r+1; row 2r+1 is 4r+2, 4r+3.
    const float4* src = reinterpret_cast<const float4*>(in + c * 64);
    float p[16];  // pooled 4x4 map, row-major
    int num0 = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 a0 = src[4 * r], a1 = src[4 * r + 1];
      const float4 b0 = src[4 * r + 2], b1 = src[4 * r + 3];
      const float m[4] = {fmaxf(fmaxf(a0.x, a0.y), fmaxf(b0.x, b0.y)),
                          fmaxf(fmaxf(a0.z, a0.w), fmaxf(b0.z, b0.w)),
                          fmaxf(fmaxf(a1.x, a1.y), fmaxf(b1.x, b1.y)),
                          fmaxf(fmaxf(a1.z, a1.w), fmaxf(b1.z, b1.w))};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = fminf(fmaxf(rintf(m[j]), 0.f), 3.f);
        p[4 * r + j] = v;
        num0 += (v == 0.f);
      }
    }

    if (num0 <= 12) {
      // Case A: promote zeros to 1, then harmonise each 2x2 quadrant whose
      // sum lies in [5, 10]: fewer than three 1s -> the 1s become 2,
      // otherwise the whole quadrant becomes 1.
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = (p[i] == 0.f) ? 1.f : p[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = (q >> 1) * 8 + (q & 1) * 2;  // top-left cell of quadrant
        const int idx[4] = {b, b + 1, b + 4, b + 5};
        float qsum = 0.f;
        int n1 = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          qsum += p[idx[k]];
          n1 += (p[idx[k]] == 1.f);
        }
        if (qsum >= 5.f && qsum <= 10.f) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            p[idx[k]] = (n1 < 3) ? (p[idx[k]] == 1.f ? 2.f : p[idx[k]]) : 1.f;
        }
      }
    } else if (num0 < 16) {
      // Case B: mostly zeros -> all zeros. num0 == 16 is already all zeros.
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = 0.f;
    }

    float4* dst = reinterpret_cast<float4*>(out + c * 64);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 lo = make_float4(p[4 * r], p[4 * r], p[4 * r + 1], p[4 * r + 1]);
      const float4 hi = make_float4(p[4 * r + 2], p[4 * r + 2], p[4 * r + 3], p[4 * r + 3]);
      dst[4 * r] = lo;
      dst[4 * r + 1] = hi;
      dst[4 * r + 2] = lo;
      dst[4 * r + 3] = hi;
    }
  }
}

}  // namespace

// in, out: n contiguous 8x8 float32 maps, 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int pmp_structural_vote(const float* in, float* out, int64_t n,
                                   void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  structural_vote_kernel<<<(unsigned)blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return (int)cudaGetLastError();
}
