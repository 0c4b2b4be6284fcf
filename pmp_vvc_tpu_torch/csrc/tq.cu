// K4: fused transform-quantisation round trip of the wave step.
//
// Replaces pmp_vvc_tpu/ops/tq_generic.py forward_transform_generic (96),
// inverse_transform_generic (113), quantize_generic (135),
// dequantize_generic (149) and rd_cleanup_generic (198),
// ops/sdh_generic.py:apply_sdh_generic (66), codec/wavefront.py:_bits_proxy
// (68), and the coded-vs-zero TU decision of _tq_luma_mts (201-235,
// 301-318, DCT-2 only) and _tq_generic (134-179).
//
// One block per (CU, plane), the P x P tile in shared memory:
//   resid = org - pred over the CU; DCT-2 in two int32 stages with the
//   per-CU round shifts (matrices: the 64-point core by stride, zero-out
//   beyond 32); dead-zone (171) quantisation; RDOQ-lite zeroing of 4x4
//   coefficient groups (skipped when min(w, h) < 4); with sdh, sign-data
//   hiding on the groups of the grouped diagonal scan; dequantisation; the
//   inverse with a clip to [COEFF_MIN, COEFF_MAX] after each stage; the
//   rate proxy 8 + nz + sum(2 * bitlen|l| + 1); then the coded TU against
//   the zero TU, and rec = clip(pred + rr).
// Luma (luma_cost = 1): cost = SSE + lam * (bits + 1), zero TU SSE0 + 2 lam.
// Chroma: cost = dw * SSE + lam * bits, zero TU dw * SSE0 + 2 lam.
//
// Sign-data hiding, one thread per coefficient group: the group's 16 scan
// slots come from a (49, ncg, 16) table of flat tile indices (row lw*7+lh,
// -1 where absent) that the wrapper builds from the port's grouped scan.
// Where the first and last nonzero slots are >= 4 apart and the parity of
// the absolute sum disagrees with the first level's sign, the level move of
// least added dequantisation error is applied: +1 in magnitude on a nonzero
// level or -1 on one of magnitude >= 2, in the order up[0..15], down[0..15],
// first minimum; the error (deq(l') - c)^2 - (deq(l) - c)^2 in float32.
//
// Float rounding: SSE is summed exactly in int64 and each group's 16 gains
// in float64, each rounded once to float32; every other float operation is
// written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which the
// compiler never contracts into an FMA, so the costs round as the plain
// PyTorch version's separate operations do.
//
// Bound: at the wave step's shapes, bytes by a small factor (the full
// P x P tiles of prediction, levels and recon); the four integer products
// (about 4 * w * h * min(w, 32) multiply-adds per CU) come close for the
// largest CUs. chip_smoke.py computes the bound of each call it times.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NT 256
#define COEFF_MIN (-32768)
#define COEFF_MAX 32767

__constant__ int QUANT_SCALES[2][6] = {{26214, 23302, 20560, 18396, 16384, 14564},
                                       {18396, 16384, 14564, 13107, 11651, 10280}};
__constant__ int INV_QUANT_SCALES[2][6] = {{40, 45, 51, 57, 64, 72},
                                           {57, 64, 72, 80, 90, 102}};

static __device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static __device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

static __device__ __forceinline__ int rshift(int x, int s) {
    return s > 0 ? (x + (1 << (s - 1))) >> s : x;
}

// Entry (i, j) of the n-point DCT-2 matrix from the 64-point core.
static __device__ __forceinline__ int dct(const int32_t* d64, int ln, int i, int j) {
    return d64[(i << (6 - ln)) * 64 + j];
}

// Unclipped dequantisation of one (already clipped) level.
static __device__ __forceinline__ int dequant(int lvl, int iscale, int rs) {
    const int v = lvl * iscale;
    return rs > 0 ? (v + (1 << (rs - 1))) >> rs : v * (1 << -rs);
}

// Sign-data hiding of one coefficient group; ``ix`` its 16 flat indices.
static __device__ void sdh_group(const int32_t* ix, const int32_t* coef,
                                 int32_t* lev, int iscale, int rs) {
    int lv[16], first = -1, last = -1, sum = 0;
    for (int k = 0; k < 16; ++k) {
        lv[k] = ix[k] >= 0 ? lev[ix[k]] : 0;
        if (lv[k]) {
            if (first < 0) first = k;
            last = k;
        }
        sum += abs(lv[k]);
    }
    if (first < 0 || last - first < 4) return;            // SBH_THRESHOLD
    if ((sum & 1) == (lv[first] < 0 ? 1 : 0)) return;     // parity agrees
    float best = INFINITY;
    int bk = 0;
    for (int k = 0; k < 32; ++k) {
        const int l = lv[k & 15];
        if (k < 16 ? l == 0 : abs(l) < 2) continue;
        const int nl = k < 16 ? l + (l > 0 ? 1 : -1) : l - (l > 0 ? 1 : -1);
        const float cf = (float)coef[ix[k & 15]];
        const float d0 = __fsub_rn((float)dequant(l, iscale, rs), cf);
        const float d1 = __fsub_rn((float)dequant(nl, iscale, rs), cf);
        const float e = __fsub_rn(__fmul_rn(d1, d1), __fmul_rn(d0, d0));
        if (e < best) {
            best = e;
            bk = k;
        }
    }
    const int l = lv[bk & 15];
    lev[ix[bk & 15]] = bk < 16 ? l + (l > 0 ? 1 : -1) : l - (l > 0 ? 1 : -1);
}

template <typename T>
static __device__ T block_sum(T v, T* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    T s = 0;
    if (threadIdx.x == 0)
        for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
    return s;                          // valid in thread 0
}

__global__ void tq_kernel(const int32_t* __restrict__ o0,
                          const int32_t* __restrict__ o1,
                          const int32_t* __restrict__ pred,
                          const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ d64,
                          const int32_t* __restrict__ cgtab, int B, int P,
                          int scale, int qp, int bd, int rd_quant,
                          int luma_cost, int H, int W, int sdh, int ncg,
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
    const int w = r[3] / scale, h = r[4] / scale;
    const int lw = ilog2(w), lh = ilog2(h);
    const int kw = min(w, 32), kh = min(h, 32);
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
    // forward, horizontal: t1[y][i] = rs(sum_j resid[y][j] * T_w[i][j], s1)
    const int s1 = lw + bd + 6 - 15, s2 = lh + 6;
    for (int e = threadIdx.x; e < h * kw; e += blockDim.x) {
        const int y = e / kw, i = e % kw;
        int acc = 0;
        for (int j = 0; j < w; ++j) acc += S0[y * P + j] * dct(d64, lw, i, j);
        S1[y * P + i] = rshift(acc, s1);
    }
    __syncthreads();
    // forward, vertical: coef[k][i] = rs(sum_y T_h[k][y] * t1[y][i], s2)
    for (int e = threadIdx.x; e < kh * kw; e += blockDim.x) {
        const int k = e / kw, i = e % kw;
        int acc = 0;
        for (int y = 0; y < h; ++y) acc += dct(d64, lh, k, y) * S1[y * P + i];
        S2[k * P + i] = rshift(acc, s2);
    }
    __syncthreads();
    // quantise
    const int t_shift = 15 - bd - ((lw + lh) >> 1), sqrt2 = (lw + lh) & 1;
    const int q_bits = 14 + qp / 6 + t_shift - sqrt2;
    const int qscale = QUANT_SCALES[sqrt2][qp % 6];
    const int add = 171 << (q_bits - 9);
    for (int e = threadIdx.x; e < kh * kw; e += blockDim.x) {
        const int o = (e / kw) * P + e % kw;
        const int c = S2[o];
        const int mag = (int)((uint32_t)abs(c) * (uint32_t)qscale + (uint32_t)add) >> q_bits;
        S3[o] = clampi(c < 0 ? -mag : mag, COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
    const int iscale = INV_QUANT_SCALES[sqrt2][qp % 6];
    const int rs = 6 - ((t_shift - sqrt2) + qp / 6);
    // RDOQ-lite: one thread per 4x4 coefficient group
    if (rd_quant && min(w, h) >= 4) {
        const float divisor = ldexpf(1.0f, 2 * t_shift - sqrt2);
        const int gx = kw / 4, ng = (kh / 4) * gx;
        for (int g = threadIdx.x; g < ng; g += blockDim.x) {
            const int r0 = (g / gx) * 4, c0 = (g % gx) * 4;
            float gain[16];
            double gsum = 0.0;
            int nz = 0;
            for (int i = 0; i < 16; ++i) {
                const int o = (r0 + i / 4) * P + c0 + i % 4;
                const float fc = (float)S2[o];
                const float e = __fsub_rn(fc, (float)dequant(S3[o], iscale, rs));
                gain[i] = __fdiv_rn(__fsub_rn(__fmul_rn(fc, fc), __fmul_rn(e, e)), divisor);
                gsum += (double)gain[i];
                nz += S3[o] != 0;
            }
            const float thr = __fmul_rn(lam, __fadd_rn(__fmul_rn(3.0f, (float)nz), 1.5f));
            const bool kill = __double2float_rn(gsum) < thr;
            for (int i = 0; i < 16; ++i) {
                const int o = (r0 + i / 4) * P + c0 + i % 4;
                const int v = kill ? 0 : S3[o];
                S3[o] = (abs(v) == 1 && gain[i] < lam3) ? 0 : v;
            }
        }
        __syncthreads();
    }
    if (sdh) {
        const int32_t* tab = cgtab + (size_t)(lw * 7 + lh) * ncg * 16;
        for (int g = threadIdx.x; g < ncg; g += blockDim.x)
            sdh_group(tab + 16 * g, S2, S3, iscale, rs);
        __syncthreads();
    }
    // dequantise (clipped)
    for (int e = threadIdx.x; e < kh * kw; e += blockDim.x) {
        const int o = (e / kw) * P + e % kw;
        S1[o] = clampi(dequant(S3[o], iscale, rs), COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
    // inverse, vertical: e[y][i] = clip(rs(sum_k T_h[k][y] * deq[k][i], 7))
    for (int e = threadIdx.x; e < h * kw; e += blockDim.x) {
        const int y = e / kw, i = e % kw;
        int acc = 0;
        for (int k = 0; k < kh; ++k) acc += dct(d64, lh, k, y) * S1[k * P + i];
        S2[y * P + i] = clampi(rshift(acc, 7), COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
    // inverse, horizontal: rr[y][j] = clip(rs(sum_i e[y][i] * T_w[i][j], 20 - bd))
    for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
        const int y = e / w, j = e % w;
        int acc = 0;
        for (int i = 0; i < kw; ++i) acc += S2[y * P + i] * dct(d64, lw, i, j);
        S1[y * P + j] = clampi(rshift(acc, 6 + 15 - 1 - bd), COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
    // exact sums: SSE of the coded and of the zero TU, and the rate proxy
    long long sse = 0, sse0 = 0;
    int bits = 0;
    for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
        const int o = (e / w) * P + e % w;
        const long long d = (long long)S1[o] - S0[o];
        sse += d * d;
        sse0 += (long long)S0[o] * S0[o];
        const int a = abs(S3[o]);
        if (a) bits += 2 * (32 - __clz(a)) + 2;       // magnitude + nonzero count
    }
    sse = block_sum(sse, red64);
    sse0 = block_sum(sse0, red64);
    bits = block_sum(bits, red32);
    if (threadIdx.x == 0) {
        const float fb = (float)(bits + 8);
        const float fs = __ll2float_rn(sse), fs0 = __ll2float_rn(sse0);
        float cost_code, cost_zero;
        if (luma_cost) {
            cost_code = __fadd_rn(fs, __fmul_rn(lam, __fadd_rn(fb, 1.0f)));
            cost_zero = __fadd_rn(fs0, lam2);
        } else {
            cost_code = __fadd_rn(__fmul_rn(dw, fs), __fmul_rn(lam, fb));
            cost_zero = __fadd_rn(__fmul_rn(dw, fs0), lam2);
        }
        s_coded = cost_zero > cost_code;
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
                      const int32_t* cgtab, int nplanes, int B, int P,
                      int scale, int qp, int bd, int rd_quant, int luma_cost,
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
    tq_kernel<<<grid, NT, smem, stream>>>(o0, o1, pred, rows, d64, cgtab, B, P,
                                          scale, qp, bd, rd_quant, luma_cost,
                                          H, W, sdh, ncg, lam, lam2, lam3, dw,
                                          lev, rec);
    return (int)cudaGetLastError();
}
