// Integer helpers shared by the device headers (intra_pred.cuh, tq.cuh,
// mip.cuh), defined once so that a source may include any of them together.
#pragma once
#include <cuda_runtime.h>

static __device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static __device__ __forceinline__ int ilog2(int v) {   // v a power of two
    return 31 - __clz(v);
}
