// K10d: SATD of K candidates against one block with VTM's tile rule, for the
// sequential FrameEncoder.
//
// Replaces pmp_vvc_tpu/ops/distortion.py:satd (86) with _tile_shape (39) and
// _satd_tiles (59) (RdCost.cpp xGetHADs :2828-2951): the block is cut into
// 8x16, 16x8, 4x8, 8x4, 8x8, 4x4 or 2x2 tiles (the first that fits, in
// that order); each tile's 2-D Walsh-Hadamard transform of org - cur, the sum
// of |coefficients| with the DC term replaced by |DC| >> 2, then
// (s + 2) >> 2 for 8x8, (s + 1) >> 1 for 4x4, s for 2x2, and for the
// non-square tiles trunc(float32(s) * float32(2 / sqrt(th * tw))): the JAX
// package multiplies its float32 tile sum by that Python float, which it
// rounds to float32 first, in one float32 product; __fmul_rn on the same
// float32 scale rounds alike and is never contracted. The Hadamard sums are
// integers (exact in float32 while below 2^24, as at these sizes), summed
// here in int32.
//
// One block of threads per candidate, one thread per tile (the butterflies
// in registers), the tiles' sum by a block reduction (csrc/satd.cuh).
//
// Bound: bytes. A 64x64 block's 67 candidates read 1.1 MB of int32 samples
// at ~20 integer operations per sample.
#include <cuda_runtime.h>
#include <stdint.h>

#include "satd.cuh"

#define NT 128

// In-place Walsh-Hadamard (Sylvester order) of a th x tw tile, rows then
// columns; the sum of |coefficients| with |DC| >> 2 for the DC term.
static __device__ int had_sum(int* d, int th, int tw) {
    for (int i = 0; i < th; ++i)
        for (int len = 1; len < tw; len <<= 1)
            for (int j = 0; j < tw; j += len << 1)
                for (int k = j; k < j + len; ++k) {
                    const int a = d[i * tw + k], b = d[i * tw + k + len];
                    d[i * tw + k] = a + b;
                    d[i * tw + k + len] = a - b;
                }
    for (int j = 0; j < tw; ++j)
        for (int len = 1; len < th; len <<= 1)
            for (int i = 0; i < th; i += len << 1)
                for (int k = i; k < i + len; ++k) {
                    const int a = d[k * tw + j], b = d[(k + len) * tw + j];
                    d[k * tw + j] = a + b;
                    d[(k + len) * tw + j] = a - b;
                }
    int s = 0;
    for (int i = 0; i < th * tw; ++i) s += abs(d[i]);
    const int dc = abs(d[0]);
    return s - dc + (dc >> 2);
}

__global__ void seq_satd_kernel(const int32_t* __restrict__ org,
                                const int32_t* __restrict__ cur, int org_step,
                                int w, int h, int th, int tw, float scale,
                                int32_t* __restrict__ out) {
    __shared__ int red[NT / 32];
    const int k = blockIdx.x;
    const int32_t* o = org + (size_t)k * org_step;
    const int32_t* c = cur + (size_t)k * w * h;
    const int nx = w / tw, ntiles = (h / th) * nx;
    int total = 0;
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
        const int r0 = (t / nx) * th, c0 = (t % nx) * tw;
        int d[128];
        for (int i = 0; i < th; ++i)
            for (int j = 0; j < tw; ++j) {
                const int p = (r0 + i) * w + c0 + j;
                d[i * tw + j] = o[p] - c[p];
            }
        const int s = had_sum(d, th, tw);
        int v;
        if (th == 8 && tw == 8) v = (s + 2) >> 2;
        else if (th == 4 && tw == 4) v = (s + 1) >> 1;
        else if (th == 2 && tw == 2) v = s;
        else v = (int)truncf(__fmul_rn((float)s, scale));
        total += v;
    }
    const int sum = block_sum(total, red);
    if (threadIdx.x == 0) out[k] = sum;
}

extern "C" int pmp_seq_satd(const int32_t* org, const int32_t* cur, int K,
                            int org_step, int w, int h, int th, int tw,
                            float scale, int32_t* out, cudaStream_t stream) {
    if (K == 0) return 0;
    if (th * tw > 128 || w % tw || h % th) return (int)cudaErrorInvalidValue;
    seq_satd_kernel<<<K, NT, 0, stream>>>(org, cur, org_step, w, h, th, tw, scale,
                                          out);
    return (int)cudaGetLastError();
}
