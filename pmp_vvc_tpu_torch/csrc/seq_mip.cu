// K10b: every MIP candidate of one block, for the sequential FrameEncoder.
//
// Replaces pmp_vvc_tpu/ops/mip.py:predict_mip_all (75), which
// codec/encoder.py:_jit_mip (64) jits per block size.
//
// One block of threads per (block, candidate): grid (2 * n_modes, N). Each
// loads the unfiltered top and left references (index 1.. of the 2W+3 /
// 2H+3 rows, index 0 being the corner), derives the packed boundaries and
// writes candidate t * n_modes + m, the prediction of mode m with transpose
// flag t, to device memory; the candidate itself is csrc/mip.cuh, shared
// with K3.
//
// Bound: bytes. A 16x16 block writes 12 candidates of 256 samples (12 KB)
// from ~140 bytes of references, at ~10 integer operations per upsampled
// sample; at these sizes the launch and the host's read-back dominate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mip.cuh"

#define NT 128

__global__ void seq_mip_kernel(const int32_t* __restrict__ top,
                               const int32_t* __restrict__ left,
                               const int32_t* __restrict__ mats, int w, int h,
                               int bd, int32_t* __restrict__ out) {
    __shared__ int32_t stop[MIP_MAXP], sleft[MIP_MAXP];
    __shared__ int32_t sh[8 * MIP_MAXP];
    __shared__ int32_t sred[64];
    __shared__ int32_t sbdry[2 * 8];
    const int n = blockIdx.y, b = blockIdx.x;
    Mip c;
    mip_size_class(c, w, h);
    c.P = w; c.bd = bd;
    c.top = stop; c.left = sleft; c.mats = mats; c.bdry = sbdry;
    c.sred = sred; c.sh = sh;
    const int32_t* tn = top + (size_t)n * (2 * w + 3);
    const int32_t* ln = left + (size_t)n * (2 * h + 3);
    for (int i = threadIdx.x; i < w; i += blockDim.x) stop[i] = tn[1 + i];
    for (int i = threadIdx.x; i < h; i += blockDim.x) sleft[i] = ln[1 + i];
    __syncthreads();
    if (threadIdx.x == 0) mip_boundaries(c, sbdry);
    __syncthreads();
    const int t = b / c.n_modes, m = b % c.n_modes;
    mip_candidate(c, t * 16 + m, out + ((size_t)n * 2 * c.n_modes + b) * w * h);
}

extern "C" int pmp_seq_mip(const int32_t* top, const int32_t* left,
                           const int32_t* mats, int N, int w, int h, int bd,
                           int32_t* out, cudaStream_t stream) {
    if (N == 0) return 0;
    if (w < 4 || h < 4 || w > MIP_MAXP || h > MIP_MAXP) return (int)cudaErrorInvalidValue;
    const int n_modes = (w == 4 && h == 4) ? 16 : (w == 4 || h == 4 || (w == 8 && h == 8)) ? 8 : 6;
    dim3 grid(2 * n_modes, N);
    seq_mip_kernel<<<grid, NT, 0, stream>>>(top, left, mats, w, h, bd, out);
    return (int)cudaGetLastError();
}
