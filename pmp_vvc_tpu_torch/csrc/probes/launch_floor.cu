// The launch floor: an empty kernel, on no path of the port.
//
// Replaces no TPU kernel. chip_smoke.py builds it (it lies outside csrc/*.cu,
// so the port's build skips it) and times it at K1's and K7's launch shapes
// (50 launches in one CUDA graph): what any launch of that many blocks and
// threads costs, against what their own work adds.
//
// Bound: neither bytes nor operations; it does nothing.
#include <cuda_runtime.h>

__global__ void null_kernel() {}

extern "C" int pmp_launch_floor(int blocks, int threads, cudaStream_t stream) {
    if (blocks <= 0 || threads <= 0) return (int)cudaErrorInvalidValue;
    null_kernel<<<blocks, threads, 0, stream>>>();
    return (int)cudaGetLastError();
}
