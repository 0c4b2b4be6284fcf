// K2: intra prediction with rough mode decision (luma) or DM (chroma).
//
// Replaces pmp_vvc_tpu/ops/intra_generic.py:predict_generic (142) with
// _planar_dc (90), ops/tq_generic.py:satd_generic (160), and the RMD of
// codec/wavefront.py:_make_class_apply (373-401).
//
// One block per (CU, plane). Luma: each of the 35 RMD candidates (planar,
// DC, the 33 even angulars) is predicted into shared memory and scored by
// a masked Hadamard SATD (csrc/satd.cuh) against the original, without
// writing the candidate to device memory; the first minimum wins (strict <, in
// candidate order), then clip(m -+ 1, 2, 66) are scored in the order
// [best, m-1, m+1], and the chosen mode's prediction is written. Chroma:
// the DM mode is read from the luma mode grid at the CU centre and
// predicted with the 2-tap filter on the unfiltered references.
//
// The prediction itself is csrc/intra_pred.cuh, shared with K9: each
// angular sample computed directly from the references, horizontal modes in
// transposed space, per-(size, mode) parameters from the (7, 6*6*67) tables
// the wrapper uploads.
//
// Bound: operations. A 64x64 luma CU costs 37 candidate predictions of
// 4096 samples (~20 integer operations each) plus their Hadamard SATDs;
// the bytes (references, the original tile, the prediction written) are
// small beside that. All arithmetic is int32: the SATD sums of a CU stay
// far below 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_pred.cuh"
#include "satd.cuh"

#define MAXP 64
#define MAXL (2 * MAXP + 3)
#define NT 256

__global__ void intra_rmd_kernel(const int32_t* __restrict__ refs,
                                 const int32_t* __restrict__ org,
                                 const uint8_t* __restrict__ mg,
                                 const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ tabs, int B,
                                 int P, int luma, int bd, int H, int W,
                                 int GH, int GW, int32_t* __restrict__ modes,
                                 int32_t* __restrict__ pred_out) {
    const int b = blockIdx.x, pl = blockIdx.y, L = 2 * P + 3;
    const int32_t* r = rows + 8 * b;
    int32_t* out = pred_out + ((size_t)pl * B + b) * P * P;
    if (r[6] <= 0) {                   // padding row
        for (int i = threadIdx.x; i < P * P; i += blockDim.x) out[i] = 0;
        if (threadIdx.x == 0 && pl == 0) modes[b] = 0;
        return;
    }
    __shared__ int32_t sref[4][MAXL];
    __shared__ int32_t sorg[MAXP * MAXP];
    __shared__ int32_t spred[MAXP * MAXP];
    __shared__ int red[NT / 32];
    __shared__ int s_best;

    const int scale = luma ? 1 : 2;
    const int fi = r[0], xs = r[1] / scale, ys = r[2] / scale;
    Cu c;
    c.w = r[3] / scale; c.h = r[4] / scale;
    c.lw = ilog2(c.w); c.lh = ilog2(c.h);
    c.P = P; c.L = L; c.pel_max = (1 << bd) - 1; c.luma = luma;
    c.tabs = tabs;
    for (int i = threadIdx.x; i < 4 * L; i += blockDim.x) {
        const int k = i / L, j = i % L;
        sref[k][j] = refs[((size_t)(pl * 4 + k) * B + b) * L + j];
    }
    c.tu = sref[0]; c.lu = sref[1]; c.tf = sref[2]; c.lf = sref[3];
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) spred[i] = 0;
    __syncthreads();

    int best;
    if (!luma) {
        const int gy = clampi((r[2] + r[4] / 2) / 4, 0, GH - 1);
        const int gx = clampi((r[1] + r[3] / 2) / 4, 0, GW - 1);
        best = mg[((size_t)fi * GH + gy) * GW + gx];
    } else {
        for (int i = threadIdx.x; i < c.h * c.w; i += blockDim.x) {
            const int y = i / c.w, x = i % c.w;
            sorg[y * P + x] = org[((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W +
                                  clampi(xs + x, 0, W - 1)];
        }
        int best_cost = 0x7fffffff;
        best = 0;
        for (int k = 0; k < 35; ++k) {              // planar, DC, 2, 4, ..., 66
            const int m = k < 2 ? k : 2 * (k - 1);
            const Mode p = mode_params(c, m);
            __syncthreads();
            predict_tile(c, p, spred);
            __syncthreads();
            const int cost = satd(c.w, c.h, P, sorg, spred, red);
            if (threadIdx.x == 0 && cost < best_cost) {
                best_cost = cost;
                best = m;
            }
        }
        if (threadIdx.x == 0) s_best = best;
        __syncthreads();
        const int m_a = s_best;
        if (m_a >= 2) {                              // +-1 refinement
            const int cand[2] = {clampi(m_a - 1, 2, 66), clampi(m_a + 1, 2, 66)};
            for (int k = 0; k < 2; ++k) {
                const Mode p = mode_params(c, cand[k]);
                __syncthreads();
                predict_tile(c, p, spred);
                __syncthreads();
                const int cost = satd(c.w, c.h, P, sorg, spred, red);
                if (threadIdx.x == 0 && cost < best_cost) {
                    best_cost = cost;
                    best = cand[k];
                }
            }
        }
        if (threadIdx.x == 0) s_best = best;
        __syncthreads();
        best = s_best;
    }
    const Mode p = mode_params(c, best);
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
        const int y = i / P, x = i % P;
        out[i] = (y < c.h && x < c.w) ? predict_sample(c, p, y, x) : 0;
    }
    if (threadIdx.x == 0 && pl == 0) modes[b] = best;
}

extern "C" int pmp_intra_rmd(const int32_t* refs, const int32_t* org,
                             const uint8_t* mg, const int32_t* rows,
                             const int32_t* tabs, int B, int P, int nplanes,
                             int luma, int bd, int H, int W, int GH, int GW,
                             int32_t* modes, int32_t* pred, cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > MAXP || (luma && nplanes != 1)) return (int)cudaErrorInvalidValue;
    dim3 grid(B, nplanes);
    intra_rmd_kernel<<<grid, NT, 0, stream>>>(refs, org, mg, rows, tabs, B, P,
                                              luma, bd, H, W, GH, GW, modes,
                                              pred);
    return (int)cudaGetLastError();
}
