// K5: candidate transform-quantisation of a luma CU (MTS, LFNST, transform
// skip), with sign-data hiding on every candidate but transform skip. Every
// luma step of the wave scan runs it; with the three tools off only DCT-2
// and the zero TU remain, the luma TQ of the configurations without them.
//
// Replaces pmp_vvc_tpu/codec/wavefront.py:_tq_luma_mts (188-319) with
// ops/lfnst_generic.py:fwd_lfnst_generic (120) and inv_lfnst_generic (136),
// and the transform, quantisation, RD zeroing and sign-data hiding it calls
// (csrc/tq.cuh, shared with K4).
//
// One block per CU, the P x P tiles in shared memory: the residual and its
// DCT-2 coefficients are computed once; the candidates run in turn, in the
// order of the JAX package's argmin:
//   0     DCT-2 (mts_idx 0, 1 bin), always legal;
//   1..4  with mts, DST-7/DCT-8 pairs mts_idx 2..5 (2, 3, 4, 4 bins), legal
//         with a level beyond DC and w, h <= 32;
//   5, 6  with lfnst, LFNST 1 and 2 on the DCT-2 coefficients (2 bins):
//         the 8x8 or 4x4 top-left region gathered (plain or transposed by
//         the mode's kernel set), the 16 x 48 int product, (s + 64) >> 7,
//         placed on the 4x4 diagonal scan (8 outputs for 4x4 and 8x8 TUs);
//         quantisation, RD zeroing and sign-data hiding on them; the inverse
//         product clipped to 16 bits and scattered back, then the inverse
//         DCT-2; legal with a level beyond DC, except on MIP CUs below 16x16;
//   7     with ts_max, transform skip (mts_idx 1, 1 bin): the TS quantiser
//         on the residual at qp_ts (dead zone 171, qBits 14 + qp_ts/6), its
//         dequantiser, no RD zeroing, no sign-data hiding; legal with
//         w, h <= ts_max and a nonzero level.
// cost = SSE + lam * (rate proxy + bins) in float32 (luma_cost_of). The
// running best (levels, reconstructed residual, cost, mts_idx, lfnst_idx)
// stays in shared memory and a candidate replaces it only on a strict <, so
// the first minimum wins; an illegal candidate is skipped, as +inf would be.
// Then the zero TU (SSE0 + 2 lam) wins where its cost is <=.
//
// Bound: at the wave step's shapes, operations: up to seven separable round
// trips (four integer products each) and two 16 x 48 products per CU against
// the P x P tiles read and written once. chip_smoke.py computes the bound of
// each call it times from the candidates these rows run.
#include "tq.cuh"

__constant__ int MODE_SHIFT[6] = {0, 6, 10, 12, 14, 15};
// mts_idx 0, 2..5: horizontal and vertical core kinds (0 DCT-2, 1 DCT-8,
// 2 DST-7) and bins; then LFNST 1, 2 and transform skip.
__constant__ int CAND_TR[8] = {0, 2, 3, 4, 5, 0, 0, 1};
__constant__ int CAND_LF[8] = {0, 0, 0, 0, 0, 1, 2, 0};
__constant__ int CAND_KW[8] = {0, 2, 1, 2, 1, 0, 0, 0};
__constant__ int CAND_KH[8] = {0, 2, 2, 1, 1, 0, 0, 0};
__constant__ float CAND_BINS[8] = {1.0f, 2.0f, 3.0f, 4.0f, 4.0f, 2.0f, 2.0f, 1.0f};

// A candidate's cost SSE + lam * (bits + bins), in float32.
static __device__ __forceinline__ float luma_cost_of(long long sse, int bits, float lam,
                                                  float bins) {
    return __fadd_rn(__ll2float_rn(sse), __fmul_rn(lam, __fadd_rn((float)bits, bins)));
}

__global__ void tq_mts_kernel(
    const int32_t* __restrict__ org_all, const int32_t* __restrict__ pred,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ modes,
    const int32_t* __restrict__ mip_code, const int32_t* __restrict__ d64,
    const int32_t* __restrict__ mts, const int32_t* __restrict__ cgtab,
    const int32_t* __restrict__ lfnst_lut, const int32_t* __restrict__ lfnst_kern,
    const int32_t* __restrict__ lfnst_gather, int B, int P, int qp, int qp_ts, int bd,
    int rd_quant, int H, int W, int sdh_on, int ncg, int use_mts, int use_lfnst,
    int ts_max, float lam, float lam2, float lam3, int32_t* __restrict__ lev_out,
    int32_t* __restrict__ rec_out, int32_t* __restrict__ tr_out,
    int32_t* __restrict__ lf_out) {
    extern __shared__ int32_t smem[];
    __shared__ long long red64[NT / 32];
    __shared__ int red32[NT / 32];
    __shared__ float s_best;
    __shared__ int s_flag, s_tr, s_lf;
    const int b = blockIdx.x, PP = P * P;
    const size_t tile = (size_t)b * PP;
    const int32_t* r = rows + 8 * b;
    const int pel_max = (1 << bd) - 1;
    if (r[6] <= 0) {                   // padding row
        for (int i = threadIdx.x; i < PP; i += blockDim.x)
            lev_out[tile + i] = rec_out[tile + i] = 0;
        if (threadIdx.x == 0) tr_out[b] = lf_out[b] = 0;
        return;
    }
    int32_t* R = smem;                 // residual
    int32_t* D = smem + PP;            // DCT-2 coefficients
    int32_t* C = smem + 2 * PP;        // other coefficients / LFNST primary
    int32_t* L = smem + 3 * PP;        // levels
    int32_t* T1 = smem + 4 * PP;       // transform stage 1
    int32_t* T2 = smem + 5 * PP;       // dequantised / reconstructed residual
    int32_t* BL = smem + 6 * PP;       // best levels
    int32_t* BR = smem + 7 * PP;       // best reconstructed residual
    const int fi = r[0], xs = r[1], ys = r[2];
    const Tile t = make_tile(P, r[3], r[4], qp, bd);
    const int w = t.w, h = t.h;
    const int32_t* org = org_all + (size_t)fi * H * W;
    const int32_t* pr = pred + tile;

    for (int i = threadIdx.x; i < PP; i += blockDim.x) {
        const int y = i / P, x = i % P;
        R[i] = (y < h && x < w)
                   ? org[clampi(ys + y, 0, H - 1) * W + clampi(xs + x, 0, W - 1)] - pr[i]
                   : 0;
        L[i] = 0;
    }
    if (threadIdx.x == 0) s_best = INFINITY;
    __syncthreads();
    // with the tools off DCT-2 is the only candidate: its levels and
    // residual stay in L and T2, with no copy to the running best
    const bool single = !use_mts && !use_lfnst && !ts_max;
    const int32_t* best_lev = single ? L : BL;
    const int32_t* best_rr = single ? T2 : BR;

    // LFNST geometry (lfnst_params_generic): the wide-angle-extended mode's
    // kernel set and transpose, the region variant and the output count
    const int sb8 = w >= 8 && h >= 8;
    const int n16 = (w == 4 && h == 4) || (w == 8 && h == 8) ? 8 : 16;
    const int32_t* gat = lfnst_gather;
    const int32_t* kern_set = lfnst_kern;
    bool lfnst_gate = false;
    if (use_lfnst) {
        const int m = modes[b], shift = MODE_SHIFT[abs(t.lw - t.lh)];
        const bool ang = m > 1 && m <= 66;
        const int wam = ang && w > h && m < 2 + shift ? m + 65
                        : ang && h > w && m > 66 - shift ? m - 65 : m;
        const int ext = wam < 0 ? wam + 14 + 67 : wam >= 67 ? wam + 14 : wam;
        const int tp = ext >= 67 + 14 || (ext < 67 && ext > 34);
        gat = lfnst_gather + ((1 - sb8) * 2 + tp) * 48;
        kern_set = lfnst_kern + (size_t)(sb8 * 4 + lfnst_lut[ext]) * 2 * 16 * 48;
        lfnst_gate = mip_code == nullptr || mip_code[b] == 0 || (w >= 16 && h >= 16);
    }

    for (int c = 0; c < 8; ++c) {
        const int tr = CAND_TR[c], lf = CAND_LF[c];
        const bool is_mts = c >= 1 && c <= 4, is_ts = c == 7;
        if (is_mts && !(use_mts && w <= 32 && h <= 32)) continue;
        if (lf && !(use_lfnst && lfnst_gate)) continue;
        if (is_ts && !(ts_max && w <= ts_max && h <= ts_max)) continue;
        const int kind_w = CAND_KW[c], kind_h = CAND_KH[c];
        const int kw = keep(kind_w, w), kh = keep(kind_h, h);
        if (c > 0)
            for (int i = threadIdx.x; i < PP; i += blockDim.x) L[i] = 0;
        int32_t* cf = c == 0 ? D : C;
        if (is_ts) {
            const int q_bits = 14 + qp_ts / 6, scale = QUANT_SCALES[0][qp_ts % 6];
            const int add = 171 << (q_bits - 9);
            __syncthreads();
            for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
                const int o = (e / w) * P + e % w;
                const int mag = min((abs(R[o]) * scale + add) >> q_bits, COEFF_MAX);
                L[o] = R[o] < 0 ? -mag : mag;
            }
            __syncthreads();
        } else {
            if (lf) {                  // secondary transform of the DCT-2 coefficients
                for (int e = threadIdx.x; e < kh * kw; e += blockDim.x)
                    C[(e / kw) * P + e % kw] = 0;
                __syncthreads();
                const int32_t* kern = kern_set + (size_t)(lf - 1) * 16 * 48;
                if (threadIdx.x < n16) {
                    const int o = threadIdx.x;
                    int acc = 0;
                    for (int j = 0; j < 48; ++j)
                        if (gat[j] < PP) acc += kern[o * 48 + j] * D[gat[j]];
                    C[DIAG4_Y[o] * P + DIAG4_X[o]] = (acc + 64) >> 7;
                }
                __syncthreads();
            } else {
                __syncthreads();
                fwd_transform(t, R, T1, cf, kind_w, kind_h, d64, mts);
            }
            quantize(t, cf, L, kh, kw);
            if (rd_quant && min(w, h) >= 4) rd_cleanup(t, cf, L, kh, kw, lam, lam3);
            if (sdh_on) sdh(t, cgtab, ncg, cf, L);
        }
        // legality from the levels: a level beyond DC (MTS, LFNST), any
        // level (transform skip); DCT-2 is always legal
        if (c > 0) {
            int nz = 0;
            for (int e = threadIdx.x; e < h * w; e += blockDim.x) nz += L[(e / w) * P + e % w] != 0;
            nz = block_sum(nz, red32);
            if (threadIdx.x == 0) s_flag = is_ts ? nz > 0 : nz - (L[0] != 0) > 0;
            __syncthreads();
            if (!s_flag) continue;
        }
        // reconstructed residual into T2
        if (is_ts) {
            const int iscale = INV_QUANT_SCALES[0][qp_ts % 6], rs = 6 - qp_ts / 6;
            for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
                const int o = (e / w) * P + e % w;
                T2[o] = clampi(dequant(clampi(L[o], COEFF_MIN, COEFF_MAX), iscale, rs),
                               COEFF_MIN, COEFF_MAX);
            }
            __syncthreads();
        } else if (lf) {
            dequantize(t, L, T2, kh, kw);
            for (int e = threadIdx.x; e < kh * kw; e += blockDim.x)
                C[(e / kw) * P + e % kw] = 0;
            __syncthreads();
            const int32_t* kern = kern_set + (size_t)(lf - 1) * 16 * 48;
            if (threadIdx.x < 48 && gat[threadIdx.x] < PP) {
                const int j = threadIdx.x;
                int acc = 0;
                for (int k = 0; k < n16; ++k)
                    acc += kern[k * 48 + j] * T2[DIAG4_Y[k] * P + DIAG4_X[k]];
                C[gat[j]] = clampi((acc + 64) >> 7, COEFF_MIN, COEFF_MAX);
            }
            __syncthreads();
            inv_transform(t, C, T1, T2, 0, 0, d64, mts);
        } else {
            dequantize(t, L, T2, kh, kw);
            inv_transform(t, T2, T1, T2, kind_w, kind_h, d64, mts);
        }
        long long sse;
        int bits;
        tile_sums(t, R, T2, L, red64, red32, &sse, &bits);
        if (threadIdx.x == 0) {
            const float cost = luma_cost_of(sse, bits, lam, CAND_BINS[c]);
            s_flag = cost < s_best;
            if (s_flag) s_best = cost, s_tr = tr, s_lf = lf;
        }
        __syncthreads();
        if (s_flag && !single) {
            for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
                const int o = (e / w) * P + e % w;
                BL[o] = L[o];
                BR[o] = T2[o];
            }
        }
        __syncthreads();
    }
    long long sse0;
    int unused;
    tile_sums(t, R, nullptr, nullptr, red64, red32, &sse0, &unused);
    if (threadIdx.x == 0) {
        s_flag = __fadd_rn(__ll2float_rn(sse0), lam2) > s_best;     // coded
        tr_out[b] = s_flag ? s_tr : 0;
        lf_out[b] = s_flag ? s_lf : 0;
    }
    __syncthreads();
    const int coded = s_flag;
    for (int i = threadIdx.x; i < PP; i += blockDim.x) {
        const int y = i / P, x = i % P;
        const bool in = y < h && x < w;
        lev_out[tile + i] = in && coded ? best_lev[i] : 0;
        rec_out[tile + i] = in ? clampi(pr[i] + (coded ? best_rr[i] : 0), 0, pel_max) : 0;
    }
}

extern "C" int pmp_tq_mts(const int32_t* org, const int32_t* pred, const int32_t* rows,
                          const int32_t* modes, const int32_t* mip_code,
                          const int32_t* d64, const int32_t* mts, const int32_t* cgtab,
                          const int32_t* lfnst_lut, const int32_t* lfnst_kern,
                          const int32_t* lfnst_gather, int B, int P, int qp, int qp_ts,
                          int bd, int rd_quant, int H, int W, int sdh, int ncg,
                          int use_mts, int use_lfnst, int ts_max, float lam, float lam2,
                          float lam3, int32_t* lev, int32_t* rec, int32_t* tr,
                          int32_t* lf, cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > 64 || P < 8 || ((use_mts || ts_max) && P > 32)) return (int)cudaErrorInvalidValue;
    const int smem = 8 * P * P * (int)sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        tq_mts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    tq_mts_kernel<<<B, NT, smem, stream>>>(org, pred, rows, modes, mip_code, d64, mts,
                                           cgtab, lfnst_lut, lfnst_kern, lfnst_gather,
                                           B, P, qp, qp_ts, bd, rd_quant, H, W, sdh, ncg,
                                           use_mts, use_lfnst, ts_max, lam, lam2, lam3,
                                           lev, rec, tr, lf);
    return (int)cudaGetLastError();
}
