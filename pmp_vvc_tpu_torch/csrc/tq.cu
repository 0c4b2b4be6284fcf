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
// With ``jccr`` (K6c, codec/wavefront.py:_chroma_part 598-633), one block
// per CU runs the U and V round trips, then the joint Cb-Cr trial (mask 3,
// Cr = -Cb): the joint residual round((res_u - res_v) / 2), half to even,
// in integers, takes a third round trip at qp_j as U's residual with the
// same LFNST region and sign-data hiding; Cr is clip(pred_v - rr_j) from the
// unclipped reconstructed residual after that TU's coded-vs-zero decision.
// The separate and joint costs are dw * (SSE_U + SSE_V) + lam * bits over
// the reconstructions, each SSE exact in int64 and rounded once, bits the
// coded TUs' rate proxies (1 for an uncoded TU) + 1, or the joint TU's + 3,
// in float32 in the JAX package's operation order. Joint wins where its TU
// is coded and its cost is strictly lower: both planes then take its levels
// and reconstructions, and use_joint is 1.
//
// With ``crs_on`` (K6b, LMCS chroma residual scaling, codec/wavefront.py:
// _chroma_part 558-590 and _tq_generic 146-171), the block first derives its
// CU's scale: the 64x64 VPDU's left column and above row of mapped luma
// recon ``ry``, 64 samples each read clamped to the frame, summed by a block
// reduction where the chroma coding-order grid ``og`` says the side's first
// sample precedes the CU; their average (s + (32 << max(n - 1, 0))) >>
// (5 + n), or 1 << (bd - 1) with no side; the scale lut[average], or 1 << 11
// for CUs of 4 or fewer chroma samples. Every round trip (U, V and the joint
// TU) then codes sgn * min(((|r| << 11) + c / 2) / c, 2^bd - 1) and scales
// its reconstructed residual back, sgn * ((|rr| * c + 2^10) >> 11) after a
// clip to [-2^bd, 2^bd - 1], clipped to 16 bits; both costs measure the
// unscaled residual, kept in a fifth tile. ``crs_out`` (may be null)
// receives the scales.
//
// The stages, sign-data hiding (one thread per coefficient group) and the
// exact cost sums are the device code of csrc/tq.cuh, shared with K5.
//
// Bound: at the wave step's shapes, bytes by a small factor (the full
// P x P tiles of prediction, levels and recon); the four integer products
// (about 4 * w * h * min(w, 32) multiply-adds per CU) come close for the
// largest CUs. chip_smoke.py computes the bound of each call it times.
#include "tq.cuh"

#define CRS_UNIT (1 << 11)             // CSCALE_FP_PREC: the identity scale
#define VPDU 64

// LMCS chroma residual scaling of one residual sample before the forward
// transform, and of one reconstructed residual sample after the inverse.
static __device__ __forceinline__ int crs_fwd(int r, int c, int bd) {
    const int m = min(((abs(r) << 11) + (c >> 1)) / c, (1 << bd) - 1);
    return r < 0 ? -m : m;
}

static __device__ __forceinline__ int crs_inv(int r, int c, int bd) {
    const int rs = clampi(r, -(1 << bd), (1 << bd) - 1);
    const int m = (abs(rs) * c + (1 << 10)) >> 11;
    return clampi(rs < 0 ? -m : m, COEFF_MIN, COEFF_MAX);
}

// The CU's CRS scale (row ``r`` in luma units), returned to every thread.
static __device__ int crs_scale(const int32_t* ry, const int32_t* og, const int32_t* lut,
                                const int32_t* r, int HL, int WL, int bd, int* red32,
                                int* s_val) {
    const int fi = r[0], vx = r[1] / VPDU * VPDU, vy = r[2] / VPDU * VPDU, oi = r[5];
    const int GH = HL / 4, GW = WL / 4;
    const int32_t* g = og + (size_t)fi * GH * GW;
    const int32_t* p = ry + (size_t)fi * HL * WL;
    // a side counts where the leaf covering its first sample precedes the CU
    const int id_l = g[clampi(vy / 4, 0, GH - 1) * GW + clampi(max(vx - 4, 0) / 4, 0, GW - 1)];
    const int id_a = g[clampi(max(vy - 4, 0) / 4, 0, GH - 1) * GW + clampi(vx / 4, 0, GW - 1)];
    const bool left = vx > 0 && id_l >= 0 && id_l < oi;
    const bool above = vy > 0 && id_a >= 0 && id_a < oi;
    const int i = threadIdx.x;
    int v = 0;
    if (i < VPDU && left)
        v = p[min(vy + i, HL - 1) * WL + max(vx - 1, 0)];
    else if (i >= VPDU && i < 2 * VPDU && above)
        v = p[max(vy - 1, 0) * WL + min(vx + i - VPDU, WL - 1)];
    const int s = block_sum(v, red32);
    if (threadIdx.x == 0) {
        const int n = left + above;
        const int avg = n == 0 ? 1 << (bd - 1) : (s + (32 << max(n - 1, 0))) >> (5 + n);
        *s_val = (r[3] / 2) * (r[4] / 2) > 4 ? lut[clampi(avg, 0, (1 << bd) - 1)] : CRS_UNIT;
    }
    __syncthreads();
    return *s_val;
}

// The CU's residual org - pred into R (zero outside the CU), scaled by ``crs``
// (0: none) into S0, which may be R; S3 cleared.
static __device__ void load_resid(const Tile& t, const int32_t* org, int H, int W,
                                  int xs, int ys, const int32_t* pr, int crs, int32_t* R,
                                  int32_t* S0, int32_t* S3) {
    for (int i = threadIdx.x; i < t.P * t.P; i += blockDim.x) {
        const int y = i / t.P, x = i % t.P;
        const int res = (y < t.h && x < t.w)
                            ? org[clampi(ys + y, 0, H - 1) * W + clampi(xs + x, 0, W - 1)] -
                                  pr[i]
                            : 0;
        R[i] = res;
        S0[i] = crs ? crs_fwd(res, crs, t.bd) : res;
        S3[i] = 0;
    }
    __syncthreads();
}

// One round trip of the (scaled) residual in S0: the levels in S3 and the
// reconstructed residual, scaled back by ``crs`` (0: none), in S1, before
// the coded-vs-zero decision, which it returns to every thread; both costs
// measure the unscaled residual R. ``bits`` (thread 0) is the levels' rate
// proxy.
static __device__ int round_trip(const Tile& t, int32_t* S0, const int32_t* R, int crs,
                                 int32_t* S1, int32_t* S2,
                                 int32_t* S3, const int32_t* d64, const int32_t* cgtab,
                                 int ncg, bool region, int rd_quant, int sdh_on,
                                 float lam, float lam2, float lam3, float dw,
                                 long long* red64, int* red32, int* s_coded, int* bits) {
    const int w = t.w, h = t.h, P = t.P, kw = keep(0, w), kh = keep(0, h);
    fwd_transform(t, S0, S1, S2, 0, 0, d64, nullptr);
    quantize(t, S2, S3, kh, kw);
    if (rd_quant && min(w, h) >= 4) rd_cleanup(t, S2, S3, kh, kw, lam, lam3);
    if (region) {
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
    if (crs) {
        for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
            const int o = (e / w) * P + e % w;
            S1[o] = crs_inv(S1[o], crs, t.bd);
        }
        __syncthreads();
    }
    long long sse, sse0;
    int unused;
    tile_sums(t, R, S1, S3, red64, red32, &sse, bits);
    tile_sums(t, R, nullptr, nullptr, red64, red32, &sse0, &unused);
    if (threadIdx.x == 0) {
        const float cost_code =
            __fadd_rn(__fmul_rn(dw, __ll2float_rn(sse)), __fmul_rn(lam, (float)*bits));
        *s_coded = __fadd_rn(__fmul_rn(dw, __ll2float_rn(sse0)), lam2) > cost_code;
    }
    __syncthreads();
    return *s_coded;
}

__global__ void tq_kernel(const int32_t* __restrict__ o0,
                          const int32_t* __restrict__ o1,
                          const int32_t* __restrict__ pred,
                          const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ d64,
                          const int32_t* __restrict__ cgtab,
                          const int32_t* __restrict__ lfnst_active,
                          const int32_t* __restrict__ ry, const int32_t* __restrict__ og,
                          const int32_t* __restrict__ lut, int B, int P,
                          int scale, int qp, int bd, int rd_quant,
                          int H, int W, int sdh_on, int ncg, int jccr, int qp_j, int crs_on,
                          float lam, float lam2, float lam3, float dw,
                          int32_t* __restrict__ lev_out, int32_t* __restrict__ rec_out,
                          int32_t* __restrict__ joint_out, int32_t* __restrict__ crs_out) {
    extern __shared__ int32_t smem[];
    __shared__ long long red64[NT / 32];
    __shared__ int red32[NT / 32];
    __shared__ int s_coded, s_use, s_crs;
    __shared__ long long s_sse[2];
    __shared__ int s_bits[2];
    const int b = blockIdx.x, PP = P * P;
    // without jccr one block per (CU, plane); with it one block per CU
    const int pl0 = jccr ? 0 : blockIdx.y, npl = jccr ? 2 : 1;
    const int32_t* r = rows + 8 * b;
    const int pel_max = (1 << bd) - 1;
    if (r[6] <= 0) {                   // padding row
        for (int pl = pl0; pl < pl0 + npl; ++pl) {
            const size_t tile = ((size_t)pl * B + b) * PP;
            for (int i = threadIdx.x; i < PP; i += blockDim.x)
                lev_out[tile + i] = rec_out[tile + i] = 0;
        }
        if (threadIdx.x == 0 && pl0 == 0) {
            if (jccr) joint_out[b] = 0;
            if (crs_out) crs_out[b] = CRS_UNIT;
        }
        return;
    }
    int32_t* S0 = smem;                // residual (scaled with CRS)
    int32_t* S1 = smem + PP;           // stage 1 / dequantised / inverse
    int32_t* S2 = smem + 2 * PP;       // coefficients / inverse stage 1
    int32_t* S3 = smem + 3 * PP;       // levels
    int32_t* R = crs_on ? smem + 4 * PP : S0;   // the unscaled residual
    const int crs = crs_on ? crs_scale(ry, og, lut, r, H * scale, W * scale, bd, red32,
                                       &s_crs)
                           : 0;
    if (crs_out && threadIdx.x == 0 && pl0 == 0) crs_out[b] = crs;
    const int fi = r[0], xs = r[1] / scale, ys = r[2] / scale;
    const Tile t = make_tile(P, r[3] / scale, r[4] / scale, qp, bd);
    const int w = t.w, h = t.h;
    const bool region = lfnst_active != nullptr && lfnst_active[b] && w >= 4 && h >= 4;
    const int32_t* org[2] = {o0 + (size_t)fi * H * W, o1 ? o1 + (size_t)fi * H * W : nullptr};

    for (int pl = pl0; pl < pl0 + npl; ++pl) {
        const size_t tile = ((size_t)pl * B + b) * PP;
        const int32_t* pr = pred + tile;
        load_resid(t, org[pl], H, W, xs, ys, pr, crs, R, S0, S3);
        int bits;
        const int coded = round_trip(t, S0, R, crs, S1, S2, S3, d64, cgtab, ncg, region, rd_quant,
                                     sdh_on, lam, lam2, lam3, dw, red64, red32, &s_coded,
                                     &bits);
        long long sse = 0;             // JCCR: reconstruction against the original
        for (int i = threadIdx.x; i < PP; i += blockDim.x) {
            const int y = i / P, x = i % P;
            const bool in = y < h && x < w;
            const int rec = in ? clampi(pr[i] + (coded ? S1[i] : 0), 0, pel_max) : 0;
            lev_out[tile + i] = in && coded ? S3[i] : 0;
            rec_out[tile + i] = rec;
            if (jccr && in) {
                const long long d = (long long)rec - (R[i] + pr[i]);
                sse += d * d;
            }
        }
        if (jccr) {
            sse = block_sum(sse, red64);
            if (threadIdx.x == 0) {
                s_sse[pl] = sse;
                s_bits[pl] = coded && bits > 8 ? bits : 0;   // 0: no coded level
            }
        }
        __syncthreads();               // S0 and S3 are refilled next
    }
    if (!jccr) return;

    // the joint residual round((res_u - res_v) / 2), half to even
    const int32_t *pu = pred + (size_t)b * PP, *pv = pred + ((size_t)B + b) * PP;
    for (int i = threadIdx.x; i < PP; i += blockDim.x) {
        const int y = i / P, x = i % P;
        int j = 0;
        if (y < h && x < w) {
            const int o = clampi(ys + y, 0, H - 1) * W + clampi(xs + x, 0, W - 1);
            const int d = (org[0][o] - pu[i]) - (org[1][o] - pv[i]);
            j = d >> 1;
            if ((d & 1) && (j & 1)) ++j;
        }
        R[i] = j;
        S0[i] = crs ? crs_fwd(j, crs, bd) : j;
        S3[i] = 0;
    }
    __syncthreads();
    const Tile tj = make_tile(P, w, h, qp_j, bd);
    int bits_j;
    const int coded_j = round_trip(tj, S0, R, crs, S1, S2, S3, d64, cgtab, ncg, region, rd_quant,
                                   sdh_on, lam, lam2, lam3, dw, red64, red32, &s_coded,
                                   &bits_j);
    long long sse_ju = 0, sse_jv = 0;
    for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
        const int i = (e / w) * P + e % w;
        const int o = clampi(ys + e / w, 0, H - 1) * W + clampi(xs + e % w, 0, W - 1);
        const int rr = coded_j ? S1[i] : 0;
        const long long du = (long long)clampi(pu[i] + rr, 0, pel_max) - org[0][o];
        const long long dv = (long long)clampi(pv[i] - rr, 0, pel_max) - org[1][o];
        sse_ju += du * du;
        sse_jv += dv * dv;
    }
    sse_ju = block_sum(sse_ju, red64);
    sse_jv = block_sum(sse_jv, red64);
    if (threadIdx.x == 0) {
        const float bits_s =
            __fadd_rn(__fadd_rn(s_bits[0] ? (float)s_bits[0] : 1.0f,
                                s_bits[1] ? (float)s_bits[1] : 1.0f), 1.0f);
        const float cost_s = __fadd_rn(
            __fmul_rn(dw, __fadd_rn(__ll2float_rn(s_sse[0]), __ll2float_rn(s_sse[1]))),
            __fmul_rn(lam, bits_s));
        const float cost_j = __fadd_rn(
            __fmul_rn(dw, __fadd_rn(__ll2float_rn(sse_ju), __ll2float_rn(sse_jv))),
            __fmul_rn(lam, __fadd_rn((float)bits_j, 3.0f)));
        s_use = coded_j && bits_j > 8 && cost_j < cost_s;
        joint_out[b] = s_use;
    }
    __syncthreads();
    if (!s_use) return;
    for (int i = threadIdx.x; i < PP; i += blockDim.x) {
        const int y = i / P, x = i % P;
        const bool in = y < h && x < w;
        const int lev = in ? S3[i] : 0, rr = in ? S1[i] : 0;
        lev_out[(size_t)b * PP + i] = lev_out[((size_t)B + b) * PP + i] = lev;
        rec_out[(size_t)b * PP + i] = in ? clampi(pu[i] + rr, 0, pel_max) : 0;
        rec_out[((size_t)B + b) * PP + i] = in ? clampi(pv[i] - rr, 0, pel_max) : 0;
    }
}

extern "C" int pmp_tq(const int32_t* o0, const int32_t* o1, const int32_t* pred,
                      const int32_t* rows, const int32_t* d64,
                      const int32_t* cgtab, const int32_t* lfnst_active,
                      const int32_t* ry, const int32_t* og, const int32_t* lut,
                      int nplanes, int B, int P,
                      int scale, int qp, int bd, int rd_quant,
                      int H, int W, int sdh, int ncg, int jccr, int qp_j, int crs_on,
                      float lam, float lam2, float lam3, float dw, int32_t* lev, int32_t* rec,
                      int32_t* joint, int32_t* crs_out, cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > 64 || P < 4 || (jccr && nplanes != 2) ||
        (crs_on && (!ry || !og || !lut)) || (crs_out && !crs_on))
        return (int)cudaErrorInvalidValue;
    const int smem = (crs_on ? 5 : 4) * P * P * (int)sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        tq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B, jccr ? 1 : nplanes);
    tq_kernel<<<grid, NT, smem, stream>>>(o0, o1, pred, rows, d64, cgtab,
                                          lfnst_active, ry, og, lut, B, P, scale, qp,
                                          bd, rd_quant, H, W, sdh, ncg, jccr, qp_j,
                                          crs_on, lam, lam2, lam3, dw, lev, rec, joint,
                                          crs_out);
    return (int)cudaGetLastError();
}
