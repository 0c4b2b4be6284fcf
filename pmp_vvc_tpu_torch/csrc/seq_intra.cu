// K10a: one block's intra predictions for a list of modes, for the
// sequential FrameEncoder.
//
// Replaces pmp_vvc_tpu/ops/intra.py:predict_block (356) with its helpers
// _predict_planar, _predict_dc, _pdpc_planar_dc and _predict_angular_batch
// (206-353), which codec/encoder.py:_jit_predict (55) jits per (size, modes).
//
// One block of threads per (CU, mode): grid (M, N). The block copies the
// CU's four reference rows (unfiltered and filtered top, 2W+3 entries, and
// left, 2H+3; index 0 the corner, then the 2W / 2H samples, then two
// replication slots: predict_block's layout, which is also
// csrc/intra_pred.cuh's) into shared memory, each padded to 2P+3 with its
// last entry (P = max(W, H)), which is what predict_block's clamp to the
// row's end reads; then each thread predicts samples with intra_pred.cuh's
// mode_params / predict_sample, shared with K2 and K9, from the (7, 2412)
// per-(size, mode) tables the wrapper uploads (luma or chroma). Sides 2-64.
//
// Bound: bytes at the encoder's shapes. A 64x64 block's 67 modes write 1.1 MB
// of int32 predictions at ~12 integer operations per sample (3.3 M
// operations); the launch and the host's read-back dominate smaller blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_pred.cuh"

#define MAXP 64
#define MAXL (2 * MAXP + 3)
#define NT 256

__global__ void seq_intra_kernel(const int32_t* __restrict__ tu,
                                 const int32_t* __restrict__ lu,
                                 const int32_t* __restrict__ tf,
                                 const int32_t* __restrict__ lf,
                                 const int32_t* __restrict__ modes,
                                 const int32_t* __restrict__ tabs, int M, int w,
                                 int h, int luma, int bd,
                                 int32_t* __restrict__ out) {
    __shared__ int32_t sref[4][MAXL];
    const int mi = blockIdx.x, n = blockIdx.y;
    const int P = max(w, h), L = 2 * P + 3;
    const int lt = 2 * w + 3, ll = 2 * h + 3;
    const int32_t* src[4] = {tu + (size_t)n * lt, lu + (size_t)n * ll,
                             tf + (size_t)n * lt, lf + (size_t)n * ll};
    for (int i = threadIdx.x; i < 4 * L; i += blockDim.x) {
        const int k = i / L, j = i % L, len = (k & 1) ? ll : lt;
        sref[k][j] = src[k][min(j, len - 1)];
    }
    __syncthreads();
    Cu c;
    c.w = w; c.h = h; c.lw = ilog2(w); c.lh = ilog2(h);
    c.P = P; c.L = L; c.pel_max = (1 << bd) - 1; c.luma = luma;
    c.tabs = tabs;
    c.tu = sref[0]; c.lu = sref[1]; c.tf = sref[2]; c.lf = sref[3];
    const Mode p = mode_params(c, modes[mi]);
    int32_t* o = out + ((size_t)n * M + mi) * w * h;
    for (int i = threadIdx.x; i < w * h; i += blockDim.x)
        o[i] = predict_sample(c, p, i / w, i % w);
}

extern "C" int pmp_seq_intra(const int32_t* tu, const int32_t* lu,
                             const int32_t* tf, const int32_t* lf,
                             const int32_t* modes, const int32_t* tabs, int N,
                             int M, int w, int h, int luma, int bd,
                             int32_t* out, cudaStream_t stream) {
    if (N == 0 || M == 0) return 0;
    if (w < 2 || h < 2 || w > MAXP || h > MAXP) return (int)cudaErrorInvalidValue;
    dim3 grid(M, N);
    seq_intra_kernel<<<grid, NT, 0, stream>>>(tu, lu, tf, lf, modes, tabs, M, w, h,
                                              luma, bd, out);
    return (int)cudaGetLastError();
}
