// K4: fused transform-quantisation round trip of the wave step.
//
// Replaces pmp_vvc_tpu/ops/tq_generic.py forward_transform_generic (96),
// inverse_transform_generic (113), quantize_generic (135),
// dequantize_generic (149) and rd_cleanup_generic (198),
// ops/sdh_generic.py:apply_sdh_generic (66), codec/wavefront.py:_bits_proxy
// (68), and the coded-vs-zero TU decision of _tq_generic (134-179): the
// chroma TQ of the wave step (luma runs K5, csrc/tq_mts.cu).
//
// One block per (CU, plane), the P x P tile in shared memory:
//   resid = org - pred over the CU; DCT-2 in two int32 stages with the
//   per-CU round shifts (matrices: the 64-point core by stride, zero-out
//   beyond 32); dead-zone (171) quantisation; RDOQ-lite zeroing of 4x4
//   coefficient groups (skipped when min(w, h) < 4); with sdh, sign-data
//   hiding on the groups of the grouped diagonal scan; dequantisation; the
//   inverse with a clip to [COEFF_MIN, COEFF_MAX] after each stage; the
//   rate proxy 8 + nz + sum(2 * bitlen|l| + 1); then the coded TU against
//   the zero TU, and rec = clip(pred + rr), with the cost dw * SSE +
//   lam * bits against the zero TU's dw * SSE0 + 2 lam.
//
// With ``lfnst_active`` (single tree), a CU whose luma chose LFNST keeps
// its chroma levels inside the LFNST-signallable region after the RD zeroing
// and before sign-data hiding (wavefront.py:543-557): diagonal scan
// positions < 8 of 4x4 and 8x8 TBs, < 16 of the others, no constraint where
// a side is below 4.
//
// The stages, sign-data hiding (one thread per coefficient group) and the
// exact cost sums are the device code of csrc/tq.cuh, shared with K5.
//
// Bound: at the wave step's shapes, bytes by a small factor (the full
// P x P tiles of prediction, levels and recon); the four integer products
// (about 4 * w * h * min(w, 32) multiply-adds per CU) come close for the
// largest CUs. chip_smoke.py computes the bound of each call it times.
#include "tq.cuh"

__global__ void tq_kernel(const int32_t* __restrict__ o0,
                          const int32_t* __restrict__ o1,
                          const int32_t* __restrict__ pred,
                          const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ d64,
                          const int32_t* __restrict__ cgtab,
                          const int32_t* __restrict__ lfnst_active, int B, int P,
                          int scale, int qp, int bd, int rd_quant,
                          int H, int W, int sdh_on, int ncg,
                          float lam, float lam2,
                          float lam3, float dw, int32_t* __restrict__ lev_out,
                          int32_t* __restrict__ rec_out) {
    extern __shared__ int32_t smem[];
    __shared__ long long red64[NT / 32];
    __shared__ int red32[NT / 32];
    __shared__ int s_coded;
    const int b = blockIdx.x, pl = blockIdx.y, PP = P * P;
    const size_t tile = ((size_t)pl * B + b) * PP;
    const int32_t* r = rows + 8 * b;
    const int pel_max = (1 << bd) - 1;
    if (r[6] <= 0) {                   // padding row
        for (int i = threadIdx.x; i < PP; i += blockDim.x)
            lev_out[tile + i] = rec_out[tile + i] = 0;
        return;
    }
    int32_t* S0 = smem;                // residual
    int32_t* S1 = smem + PP;           // stage 1 / dequantised / inverse
    int32_t* S2 = smem + 2 * PP;       // coefficients / inverse stage 1
    int32_t* S3 = smem + 3 * PP;       // levels
    const int fi = r[0], xs = r[1] / scale, ys = r[2] / scale;
    const Tile t = make_tile(P, r[3] / scale, r[4] / scale, qp, bd);
    const int w = t.w, h = t.h, kw = keep(0, w), kh = keep(0, h);
    const int32_t* org = (pl ? o1 : o0) + (size_t)fi * H * W;
    const int32_t* pr = pred + tile;

    for (int i = threadIdx.x; i < PP; i += blockDim.x) {
        const int y = i / P, x = i % P;
        S0[i] = (y < h && x < w)
                    ? org[clampi(ys + y, 0, H - 1) * W + clampi(xs + x, 0, W - 1)] - pr[i]
                    : 0;
        S3[i] = 0;
    }
    __syncthreads();
    fwd_transform(t, S0, S1, S2, 0, 0, d64, nullptr);
    quantize(t, S2, S3, kh, kw);
    if (rd_quant && min(w, h) >= 4) rd_cleanup(t, S2, S3, kh, kw, lam, lam3);
    if (lfnst_active != nullptr && lfnst_active[b] && w >= 4 && h >= 4) {
        // outside the top-left 4x4 group, then its diagonal positions from
        // n_allow on
        const int n_allow = (w == 4 && h == 4) || (w == 8 && h == 8) ? 8 : 16;
        for (int e = threadIdx.x; e < kh * kw; e += blockDim.x)
            if (e / kw >= 4 || e % kw >= 4) S3[(e / kw) * P + e % kw] = 0;
        for (int k = n_allow + threadIdx.x; k < 16; k += blockDim.x)
            S3[DIAG4_Y[k] * P + DIAG4_X[k]] = 0;
        __syncthreads();
    }
    if (sdh_on) sdh(t, cgtab, ncg, S2, S3);
    dequantize(t, S3, S1, kh, kw);
    inv_transform(t, S1, S2, S1, 0, 0, d64, nullptr);
    long long sse, sse0;
    int bits, unused;
    tile_sums(t, S0, S1, S3, red64, red32, &sse, &bits);
    tile_sums(t, S0, nullptr, nullptr, red64, red32, &sse0, &unused);
    if (threadIdx.x == 0) {
        const float cost_code =
            __fadd_rn(__fmul_rn(dw, __ll2float_rn(sse)), __fmul_rn(lam, (float)bits));
        s_coded = __fadd_rn(__fmul_rn(dw, __ll2float_rn(sse0)), lam2) > cost_code;
    }
    __syncthreads();
    const int coded = s_coded;
    for (int i = threadIdx.x; i < PP; i += blockDim.x) {
        const int y = i / P, x = i % P;
        const bool in = y < h && x < w;
        lev_out[tile + i] = in && coded ? S3[i] : 0;
        rec_out[tile + i] = in ? clampi(pr[i] + (coded ? S1[i] : 0), 0, pel_max) : 0;
    }
}

extern "C" int pmp_tq(const int32_t* o0, const int32_t* o1, const int32_t* pred,
                      const int32_t* rows, const int32_t* d64,
                      const int32_t* cgtab, const int32_t* lfnst_active,
                      int nplanes, int B, int P,
                      int scale, int qp, int bd, int rd_quant,
                      int H, int W, int sdh, int ncg, float lam, float lam2,
                      float lam3, float dw, int32_t* lev, int32_t* rec,
                      cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > 64 || P < 4) return (int)cudaErrorInvalidValue;
    const int smem = 4 * P * P * (int)sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        tq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B, nplanes);
    tq_kernel<<<grid, NT, smem, stream>>>(o0, o1, pred, rows, d64, cgtab,
                                          lfnst_active, B, P, scale, qp, bd,
                                          rd_quant, H, W, sdh, ncg,
                                          lam, lam2, lam3, dw, lev, rec);
    return (int)cudaGetLastError();
}
