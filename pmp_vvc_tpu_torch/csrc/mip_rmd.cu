// K3: the MIP candidates of the wave step's luma CUs against K2's winner.
//
// Replaces pmp_vvc_tpu/ops/mip_generic.py:predict_mip_generic (54), with its
// _mip_table (32) and sid_generic (48) (the candidate itself is csrc/mip.cuh,
// shared with K10b), the SATD of its candidates
// (ops/tq_generic.py:satd_generic, 160) and the MIP decision of
// codec/wavefront.py:_make_class_apply (402-425).
//
// One block per CU, the candidates in turn. The block derives the size class
// (sid, the boundary size red_b, the reduced size red_p, n_modes), Haar-
// downsamples the unfiltered top and left references, then for each of the
// 2 x 16 candidates (t, m) with m < n_modes: the reduced prediction from the
// (3, 16, 64, 8) weight table (a product of at most 8 terms per reduced
// sample, the sizeId-2 matrix at input columns 1..7), the horizontal linear
// upsampling against the left boundary and the vertical one against the top
// row into shared memory, and the SATD against the original with the code K2
// uses (csrc/satd.cuh). The first minimum wins (strict <, in t*16+m order);
// the MIP winner replaces K2's prediction only when its SATD is strictly
// below K2's winner's, which the block scores from K2's prediction with the
// same code. A MIP CU gets mode 0 (PLANAR) and code 1 + t*16 + m; any other
// CU keeps K2's mode and prediction with code 0. Nothing but the final
// prediction and the two small outputs goes to device memory.
//
// Bound: operations. A 64x64 CU costs 12 candidates of 4096 upsampled
// samples (about 10 integer operations each) and their Hadamard SATDs; the
// bytes (references, the original tile, K2's prediction in, the prediction
// out) are small beside that.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mip.cuh"
#include "satd.cuh"

#define MAXP 64
#define NT 256
#define NCAND 32                      // 2 transposes x 16 modes
#define NO_COST 0x40000000            // above every real SATD

__global__ void mip_rmd_kernel(const int32_t* __restrict__ refs,
                               const int32_t* __restrict__ org,
                               const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ mats,
                               const int32_t* __restrict__ pred_in,
                               const int32_t* __restrict__ best_in, int B,
                               int P, int bd, int H, int W,
                               int32_t* __restrict__ best_out,
                               int32_t* __restrict__ pred_out,
                               int32_t* __restrict__ code_out) {
    const int b = blockIdx.x, L = 2 * P + 3;
    const int32_t* r = rows + 8 * b;
    const size_t tile = (size_t)b * P * P;
    const int32_t* pin = pred_in + tile;
    int32_t* out = pred_out + tile;
    if (r[6] <= 0) {                   // padding row
        for (int i = threadIdx.x; i < P * P; i += blockDim.x) out[i] = 0;
        if (threadIdx.x == 0) {
            best_out[b] = best_in[b];
            code_out[b] = 0;
        }
        return;
    }
    __shared__ int32_t sorg[MAXP * MAXP];
    __shared__ int32_t spred[MAXP * MAXP];
    __shared__ int32_t sh[8 * MIP_MAXP];
    __shared__ int32_t sred[64];
    __shared__ int32_t stop[MAXP], sleft[MAXP];
    __shared__ int32_t sbdry[2 * 8];
    __shared__ int red[NT / 32];
    __shared__ int s_k;

    const int fi = r[0], xs = r[1], ys = r[2];
    Mip c;
    mip_size_class(c, r[3], r[4]);
    c.P = P; c.bd = bd;
    c.top = stop; c.left = sleft; c.mats = mats; c.bdry = sbdry;
    c.sred = sred; c.sh = sh;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        stop[i] = refs[(size_t)b * L + 1 + i];               // refs[0][0][b]
        sleft[i] = refs[((size_t)B + b) * L + 1 + i];        // refs[0][1][b]
    }
    for (int i = threadIdx.x; i < c.h * c.w; i += blockDim.x) {
        const int y = i / c.w, x = i % c.w;
        sorg[y * P + x] = org[((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W +
                              clampi(xs + x, 0, W - 1)];
    }
    __syncthreads();
    if (threadIdx.x == 0) mip_boundaries(c, sbdry);
    __syncthreads();

    const int cost_ang = satd(c.w, c.h, P, sorg, pin, red);   // thread 0
    int best_cost = NO_COST, best_k = 0;
    for (int k = 0; k < NCAND; ++k) {
        if ((k & 15) >= c.n_modes) continue;                  // uniform
        mip_candidate(c, k, spred);
        const int cost = satd(c.w, c.h, P, sorg, spred, red);
        if (threadIdx.x == 0 && cost < best_cost) {
            best_cost = cost;
            best_k = k;
        }
    }
    if (threadIdx.x == 0) s_k = best_cost < cost_ang ? best_k : -1;
    __syncthreads();
    const int k = s_k;
    if (k >= 0) mip_candidate(c, k, spred);
    const int32_t* src = k >= 0 ? spred : pin;
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
        const int y = i / P, x = i % P;
        out[i] = (y < c.h && x < c.w) ? src[i] : 0;
    }
    if (threadIdx.x == 0) {
        best_out[b] = k >= 0 ? 0 : best_in[b];
        code_out[b] = k >= 0 ? 1 + k : 0;
    }
}

extern "C" int pmp_mip_rmd(const int32_t* refs, const int32_t* org,
                           const int32_t* rows, const int32_t* mats,
                           const int32_t* pred_in, const int32_t* best_in,
                           int B, int P, int bd, int H, int W,
                           int32_t* best_out, int32_t* pred_out,
                           int32_t* code_out, cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > MAXP || P < 4) return (int)cudaErrorInvalidValue;
    mip_rmd_kernel<<<B, NT, 0, stream>>>(refs, org, rows, mats, pred_in, best_in,
                                         B, P, bd, H, W, best_out, pred_out,
                                         code_out);
    return (int)cudaGetLastError();
}
