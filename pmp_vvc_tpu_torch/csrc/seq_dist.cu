// K10e: SAD or SSE of K blocks against their originals, summed over the
// last two axes.
//
// Replaces pmp_vvc_tpu/ops/distortion.py:sad (99) and sse (105): the sum of
// |org - cur| or (org - cur)^2 over each block's samples. The JAX package
// sums in int32 (x64 off), where the sum wraps; the kernel accumulates in
// uint32_t, whose sums wrap the same way (signed overflow is undefined in
// C++), and returns the bits as int32. The difference and the square wrap
// alike, and |INT_MIN| stays INT_MIN, as in XLA.
//
// One block per block of samples (leading index), a strided loop over its
// n samples and a warp-shuffle sum.
//
// Bound: bytes. Three integer operations per sample against eight bytes
// read.
#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256

__global__ void seq_dist_kernel(const int32_t* __restrict__ org,
                                const int32_t* __restrict__ cur, int n, int org_step,
                                int square, int32_t* __restrict__ out) {
    __shared__ uint32_t red[NT / 32];
    const int k = blockIdx.x;
    const int32_t* o = org + (size_t)k * org_step;
    const int32_t* c = cur + (size_t)k * n;
    uint32_t acc = 0;
    for (int i = threadIdx.x; i < n; i += NT) {
        const uint32_t d = (uint32_t)o[i] - (uint32_t)c[i];
        acc += square ? d * d : ((int32_t)d < 0 ? 0u - d : d);
    }
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, s);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        uint32_t total = 0;
        for (int w = 0; w < NT / 32; ++w) total += red[w];
        out[k] = (int32_t)total;
    }
}

extern "C" int pmp_seq_dist(const int32_t* org, const int32_t* cur, int K, int n,
                            int org_step, int square, int32_t* out, cudaStream_t stream) {
    if (K == 0) return 0;
    if (n < 0) return (int)cudaErrorInvalidValue;
    seq_dist_kernel<<<K, NT, 0, stream>>>(org, cur, n, org_step, square, out);
    return (int)cudaGetLastError();
}
