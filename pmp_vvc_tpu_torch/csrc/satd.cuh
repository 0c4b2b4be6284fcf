// SATD device code shared by K2 (csrc/intra_rmd.cu), K3 (csrc/mip_rmd.cu),
// K6a (csrc/cclm.cu) and K9 (csrc/rdo_leaf.cu), so that the angular, MIP,
// CCLM and RDO costs round the same way.
//
// The port of pmp_vvc_tpu/ops/tq_generic.py:satd_generic (160): 8x8
// Walsh-Hadamard tiles when min(w, h) >= 8, else 4x4, over the CU's (h, w)
// region of two P-strided tiles; each tile's sum of |coefficients| with VTM's
// DC/4 and rounding. All in int32: a 64x64 CU of 10-bit samples stays below
// 2^23, so the JAX package's float32 sums of the same integers are exact.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

static __device__ int block_sum(int v, int* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    int s = 0;
    if (threadIdx.x == 0)
        for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
    return s;                          // valid in thread 0
}

// SATD of one ts x ts tile (ts 4 or 8) of differences ``d``, row-major,
// transformed in place: Walsh-Hadamard (Sylvester order) on rows, then
// columns; the sum of |coefficients| with VTM's DC/4 and rounding.
static __device__ int tile_satd(int* d, int ts) {
    for (int i = 0; i < ts; ++i)
        for (int len = 1; len < ts; len <<= 1)
            for (int j = 0; j < ts; j += len << 1)
                for (int k = j; k < j + len; ++k) {
                    const int a = d[i * ts + k], b = d[i * ts + k + len];
                    d[i * ts + k] = a + b;
                    d[i * ts + k + len] = a - b;
                }
    for (int j = 0; j < ts; ++j)
        for (int len = 1; len < ts; len <<= 1)
            for (int i = 0; i < ts; i += len << 1)
                for (int k = i; k < i + len; ++k) {
                    const int a = d[k * ts + j], b = d[(k + len) * ts + j];
                    d[k * ts + j] = a + b;
                    d[(k + len) * ts + j] = a - b;
                }
    int s = 0;
    for (int i = 0; i < ts * ts; ++i) s += abs(d[i]);
    const int dc = abs(d[0]);
    const int tv = s - dc + (dc >> 2);
    return ts == 8 ? (tv + 2) >> 2 : (tv + 1) >> 1;
}

// SATD of (org - pred) over the (h, w) CU; every thread of the block must
// call it. ``red`` holds blockDim.x / 32 ints of shared memory. The result is
// valid in thread 0. Sides are 4 or more: a caller with a side of 2 (K6a's
// chroma CUs of a 4-sample luma side) passes it rounded up to 4, with both
// tiles zero beyond the CU, which gives the plain version's masked tiles.
static __device__ int satd(int w, int h, int P, const int32_t* org,
                           const int32_t* pred, int* red) {
    const int ts = min(w, h) >= 8 ? 8 : 4;
    const int nx = w / ts, ntiles = (h / ts) * nx;
    int total = 0;
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
        const int r0 = (t / nx) * ts, c0 = (t % nx) * ts;
        int d[64];
        for (int i = 0; i < ts; ++i)
            for (int j = 0; j < ts; ++j) {
                const int o = (r0 + i) * P + c0 + j;
                d[i * ts + j] = org[o] - pred[o];
            }
        total += tile_satd(d, ts);
    }
    return block_sum(total, red);
}
