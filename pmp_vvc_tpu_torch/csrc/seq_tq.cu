// K10c: the integer transform-quantisation stages of one TU, for the
// sequential FrameEncoder.
//
// Replaces pmp_vvc_tpu/ops/transforms.py:forward_transform (68) and
// inverse_transform (115), ops/quant.py:quantize (47) and dequantize (62),
// and their fusion codec/encoder.py:_jit_tq (72). One entry point runs the
// stages of a mask in this order: forward transform (1), quantisation (2),
// dequantisation (4), inverse transform (8), each on the previous stage's
// output (the first on the input), and writes every stage's output, so
// that each of the encoder's call sites is one launch: the fused round trip
// returns the coefficients, levels, dequantised coefficients and residual.
//
// One block of threads per TU, the (h, w) tiles in dynamic shared memory.
// Two-dimensional TUs take csrc/tq.cuh's fwd_transform (DCT-2 from the
// 64-point core by stride, sides 2-64; DST-7 / DCT-8 from the 4..32-point
// cores; the zero-out of DCT-2 beyond 32 and DST-7 / DCT-8 beyond 16),
// quantize and dequant over the whole (h, w) tile, and the inverse with
// the full matrices, as transforms.py's does. The 1xN and Nx1 TUs of ISP
// take transforms.py's one-dimensional branch: one stage over the coded
// side with the first stage's shift log2(n) + bd - 9 forward and 21 - bd
// inverse. Quantisation follows Quant.cpp with dead zone 171 at the
// internal QP (up to 63 + the bit-depth offset). All int32: the products
// and sums stay below 2^31 at 10 bits.
//
// Bound: operations at 64x64 (two 64-term products per coefficient for each
// transform); bytes below that. At the encoder's sizes the launch and the
// host's read-back dominate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tq.cuh"

#define SEQ_NT 256
#define ST_FWD 1
#define ST_QUANT 2
#define ST_DEQUANT 4
#define ST_INV 8

// Round-shift by s, or a left shift by -s where s <= 0 (transforms.py
// _rshift).
static __device__ __forceinline__ int rshift_any(int x, int s) {
    return s > 0 ? (x + (1 << (s - 1))) >> s : (int)((uint32_t)x << -s);
}

// One-dimensional forward transform of the n samples of ``src``.
static __device__ void fwd_1d(const int32_t* src, int32_t* dst, int n, int kind, int bd,
                              const int32_t* d64, const int32_t* mts) {
    const int ln = ilog2(n), k = keep(kind, n), s = ln + bd + 6 - 15;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        int acc = 0;
        if (i < k)
            for (int j = 0; j < n; ++j) acc += src[j] * tcore(d64, mts, kind, ln, i, j);
        dst[i] = i < k ? rshift_any(acc, s) : 0;
    }
    __syncthreads();
}

// One-dimensional inverse transform, all n coefficients, clipped.
static __device__ void inv_1d(const int32_t* src, int32_t* dst, int n, int kind, int bd,
                              const int32_t* d64, const int32_t* mts) {
    const int ln = ilog2(n), s = (6 + 15 - 1) - bd + 1;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        int acc = 0;
        for (int i = 0; i < n; ++i) acc += src[i] * tcore(d64, mts, kind, ln, i, j);
        dst[j] = clampi(rshift_any(acc, s), COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
}

// Two-dimensional inverse with the full (h, h) and (w, w) matrices: the
// vertical stage clipped after a shift of 7, the horizontal after 20 - bd.
static __device__ void inv_2d(const Tile& t, const int32_t* src, int32_t* tmp, int32_t* dst,
                              int kind_w, int kind_h, const int32_t* d64,
                              const int32_t* mts) {
    const int w = t.w, h = t.h;
    for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
        const int y = e / w, i = e % w;
        int acc = 0;
        for (int k = 0; k < h; ++k) acc += tcore(d64, mts, kind_h, t.lh, k, y) * src[k * w + i];
        tmp[y * w + i] = clampi(rshift_any(acc, 7), COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
        const int y = e / w, j = e % w;
        int acc = 0;
        for (int i = 0; i < w; ++i) acc += tmp[y * w + i] * tcore(d64, mts, kind_w, t.lw, i, j);
        dst[y * w + j] = clampi(rshift_any(acc, 6 + 15 - 1 - t.bd), COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
}

__global__ void seq_tq_kernel(const int32_t* __restrict__ x,
                              const int32_t* __restrict__ d64,
                              const int32_t* __restrict__ mts, int w, int h,
                              int kind_h, int kind_v, int qp, int bd, int stages,
                              int32_t* __restrict__ out) {
    extern __shared__ int32_t smem[];
    const int n = blockIdx.x, hw = h * w, N = gridDim.x;
    int32_t* a = smem;                 // the current stage's input
    int32_t* b = smem + hw;            // its output
    int32_t* tmp = smem + 2 * hw;
    for (int i = threadIdx.x; i < hw; i += blockDim.x) a[i] = x[(size_t)n * hw + i];
    __syncthreads();
    const Tile t = make_tile(w, w, h, qp, bd);
    const bool one_d = w == 1 || h == 1;
    const int n1 = w == 1 ? h : w, kind1 = w == 1 ? kind_v : kind_h;
    int slot = 0;
    for (int st = ST_FWD; st <= ST_INV; st <<= 1) {
        if (!(stages & st)) continue;
        if (st == ST_FWD) {
            if (one_d) {
                fwd_1d(a, b, n1, kind1, bd, d64, mts);
            } else {
                for (int i = threadIdx.x; i < hw; i += blockDim.x) b[i] = 0;
                __syncthreads();
                fwd_transform(t, a, tmp, b, kind_h, kind_v, d64, mts);
            }
        } else if (st == ST_QUANT) {
            quantize(t, a, b, h, w);
        } else if (st == ST_DEQUANT) {           // the level clipped first
            for (int i = threadIdx.x; i < hw; i += blockDim.x)
                b[i] = clampi(dequant(clampi(a[i], COEFF_MIN, COEFF_MAX), t.iscale, t.rs),
                              COEFF_MIN, COEFF_MAX);
            __syncthreads();
        } else if (one_d) {
            inv_1d(a, b, n1, kind1, bd, d64, mts);
        } else {
            inv_2d(t, a, tmp, b, kind_h, kind_v, d64, mts);
        }
        int32_t* o = out + ((size_t)slot * N + n) * hw;
        for (int i = threadIdx.x; i < hw; i += blockDim.x) o[i] = b[i];
        ++slot;
        int32_t* s = a;                // this stage's output feeds the next
        a = b;
        b = s;
        __syncthreads();
    }
}

extern "C" int pmp_seq_tq(const int32_t* x, const int32_t* d64, const int32_t* mts, int N,
                          int w, int h, int kind_h, int kind_v, int qp, int bd,
                          int stages, int32_t* out, cudaStream_t stream) {
    if (N == 0) return 0;
    if ((stages & 15) == 0 || (stages & ~15) || w < 1 || h < 1 || w > 64 || h > 64 || qp < 0)
        return (int)cudaErrorInvalidValue;
    const size_t shmem = 3 * (size_t)w * h * sizeof(int32_t);
    seq_tq_kernel<<<N, SEQ_NT, shmem, stream>>>(x, d64, mts, w, h, kind_h, kind_v, qp, bd,
                                                stages, out);
    return (int)cudaGetLastError();
}
