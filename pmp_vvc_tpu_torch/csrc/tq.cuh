// Transform-quantisation device code shared by K4 (csrc/tq.cu) and K5
// (csrc/tq_mts.cu), so that both round trips and their costs round alike.
//
// Ports of pmp_vvc_tpu/ops/tq_generic.py forward_transform_generic (96),
// inverse_transform_generic (113), quantize_generic (135),
// dequantize_generic (149), rd_cleanup_generic (198),
// ops/sdh_generic.py:apply_sdh_generic (66) and codec/wavefront.py:_bits_proxy
// (68), for one CU tile of P x P int32 in shared memory. Every function is
// called by all threads of the block and ends with a __syncthreads where its
// result is read by other threads.
//
// Cores: DCT-2 entries come from the 64-point core by stride (kind 0,
// zero-out beyond 32); DST-7 (kind 2) and DCT-8 (kind 1) from a (2, 4, 32, 32)
// table of the 4..32-point cores, DCT-8 first (zero-out beyond 16).
//
// Float rounding: SSE is summed exactly in int64 and each coefficient
// group's 16 gains in float64, each rounded once to float32; every other
// float operation is written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, which the compiler never contracts into an FMA, so the costs
// round as the plain PyTorch version's separate operations do.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define NT 256
#define COEFF_MIN (-32768)
#define COEFF_MAX 32767

__constant__ int QUANT_SCALES[2][6] = {{26214, 23302, 20560, 18396, 16384, 14564},
                                       {18396, 16384, 14564, 13107, 11651, 10280}};
__constant__ int INV_QUANT_SCALES[2][6] = {{40, 45, 51, 57, 64, 72},
                                           {57, 64, 72, 80, 90, 102}};
// (y, x) of the 4x4 diagonal scan's positions (ops/lfnst.py:_DIAG4): where
// LFNST's secondary coefficients lie, and the order of its signallable region.
__constant__ int DIAG4_Y[16] = {0, 1, 0, 2, 1, 0, 3, 2, 1, 0, 3, 2, 1, 3, 2, 3};
__constant__ int DIAG4_X[16] = {0, 0, 1, 0, 1, 2, 0, 1, 2, 3, 1, 2, 3, 2, 3, 3};

static __device__ __forceinline__ int rshift(int x, int s) {
    return s > 0 ? (x + (1 << (s - 1))) >> s : x;
}

// Unclipped dequantisation of one (already clipped) level.
static __device__ __forceinline__ int dequant(int lvl, int iscale, int rs) {
    const int v = lvl * iscale;
    return rs > 0 ? (v + (1 << (rs - 1))) >> rs : v * (1 << -rs);
}

// Entry (i, j) of the n = 2^ln point core of ``kind``.
static __device__ __forceinline__ int tcore(const int32_t* d64, const int32_t* mts,
                                            int kind, int ln, int i, int j) {
    return kind == 0 ? d64[(i << (6 - ln)) * 64 + j]
                     : mts[(((kind - 1) * 4 + ln - 2) * 32 + i) * 32 + j];
}

// Coefficients kept along a side of n samples (the zero-out rule).
static __device__ __forceinline__ int keep(int kind, int n) {
    return min(n, kind == 0 ? 32 : 16);
}

// The CU tile's geometry and scalar quantiser (TrQuant.cpp:806-893,
// Quant.cpp:954-1031) at internal QP ``qp``.
struct Tile {
    int P, w, h, lw, lh, bd;
    int q_bits, qscale, add, iscale, rs;
    float divisor;                     // 2^(2 tShift - sqrt2), the RD gains'
};

static __device__ Tile make_tile(int P, int w, int h, int qp, int bd) {
    Tile t;
    t.P = P, t.w = w, t.h = h, t.lw = ilog2(w), t.lh = ilog2(h), t.bd = bd;
    const int t_shift = 15 - bd - ((t.lw + t.lh) >> 1), sqrt2 = (t.lw + t.lh) & 1;
    t.q_bits = 14 + qp / 6 + t_shift - sqrt2;
    t.qscale = QUANT_SCALES[sqrt2][qp % 6];
    t.add = 171 << (t.q_bits - 9);
    t.iscale = INV_QUANT_SCALES[sqrt2][qp % 6];
    t.rs = 6 - ((t_shift - sqrt2) + qp / 6);
    t.divisor = ldexpf(1.0f, 2 * t_shift - sqrt2);
    return t;
}

// Forward transform of the (h, w) residual ``src``: ``dst`` over the kept
// (kh, kw) region, ``tmp`` holding the horizontal stage.
static __device__ void fwd_transform(const Tile& t, const int32_t* src, int32_t* tmp,
                                     int32_t* dst, int kind_w, int kind_h,
                                     const int32_t* d64, const int32_t* mts) {
    const int P = t.P, w = t.w, h = t.h, kw = keep(kind_w, w), kh = keep(kind_h, h);
    const int s1 = t.lw + t.bd + 6 - 15, s2 = t.lh + 6;
    // horizontal: tmp[y][i] = rs(sum_j src[y][j] * T_w[i][j], s1)
    for (int e = threadIdx.x; e < h * kw; e += blockDim.x) {
        const int y = e / kw, i = e % kw;
        int acc = 0;
        for (int j = 0; j < w; ++j) acc += src[y * P + j] * tcore(d64, mts, kind_w, t.lw, i, j);
        tmp[y * P + i] = rshift(acc, s1);
    }
    __syncthreads();
    // vertical: dst[k][i] = rs(sum_y T_h[k][y] * tmp[y][i], s2)
    for (int e = threadIdx.x; e < kh * kw; e += blockDim.x) {
        const int k = e / kw, i = e % kw;
        int acc = 0;
        for (int y = 0; y < h; ++y) acc += tcore(d64, mts, kind_h, t.lh, k, y) * tmp[y * P + i];
        dst[k * P + i] = rshift(acc, s2);
    }
    __syncthreads();
}

// Inverse transform of the (kh, kw) coefficients ``src`` into the (h, w)
// residual ``dst`` (which may be ``src``), clipped after each stage.
static __device__ void inv_transform(const Tile& t, const int32_t* src, int32_t* tmp,
                                     int32_t* dst, int kind_w, int kind_h,
                                     const int32_t* d64, const int32_t* mts) {
    const int P = t.P, w = t.w, h = t.h, kw = keep(kind_w, w), kh = keep(kind_h, h);
    // vertical: tmp[y][i] = clip(rs(sum_k T_h[k][y] * src[k][i], 7))
    for (int e = threadIdx.x; e < h * kw; e += blockDim.x) {
        const int y = e / kw, i = e % kw;
        int acc = 0;
        for (int k = 0; k < kh; ++k) acc += tcore(d64, mts, kind_h, t.lh, k, y) * src[k * P + i];
        tmp[y * P + i] = clampi(rshift(acc, 7), COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
    // horizontal: dst[y][j] = clip(rs(sum_i tmp[y][i] * T_w[i][j], 20 - bd))
    for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
        const int y = e / w, j = e % w;
        int acc = 0;
        for (int i = 0; i < kw; ++i) acc += tmp[y * P + i] * tcore(d64, mts, kind_w, t.lw, i, j);
        dst[y * P + j] = clampi(rshift(acc, 6 + 15 - 1 - t.bd), COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
}

// Dead-zone (171) quantisation of the (kh, kw) region of ``coef``.
static __device__ void quantize(const Tile& t, const int32_t* coef, int32_t* lev,
                                int kh, int kw) {
    for (int e = threadIdx.x; e < kh * kw; e += blockDim.x) {
        const int o = (e / kw) * t.P + e % kw;
        const int c = coef[o];
        const int mag = (int)((uint32_t)abs(c) * (uint32_t)t.qscale + (uint32_t)t.add) >> t.q_bits;
        lev[o] = clampi(c < 0 ? -mag : mag, COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
}

// RDOQ-lite zeroing, one thread per 4x4 coefficient group of the (kh, kw)
// region (the caller skips it where min(w, h) < 4).
static __device__ void rd_cleanup(const Tile& t, const int32_t* coef, int32_t* lev,
                                  int kh, int kw, float lam, float lam3) {
    const int P = t.P, gx = kw / 4, ng = (kh / 4) * gx;
    for (int g = threadIdx.x; g < ng; g += blockDim.x) {
        const int r0 = (g / gx) * 4, c0 = (g % gx) * 4;
        float gain[16];
        double gsum = 0.0;
        int nz = 0;
        for (int i = 0; i < 16; ++i) {
            const int o = (r0 + i / 4) * P + c0 + i % 4;
            const float fc = (float)coef[o];
            const float e = __fsub_rn(fc, (float)dequant(lev[o], t.iscale, t.rs));
            gain[i] = __fdiv_rn(__fsub_rn(__fmul_rn(fc, fc), __fmul_rn(e, e)), t.divisor);
            gsum += (double)gain[i];
            nz += lev[o] != 0;
        }
        const float thr = __fmul_rn(lam, __fadd_rn(__fmul_rn(3.0f, (float)nz), 1.5f));
        const bool kill = __double2float_rn(gsum) < thr;
        for (int i = 0; i < 16; ++i) {
            const int o = (r0 + i / 4) * P + c0 + i % 4;
            const int v = kill ? 0 : lev[o];
            lev[o] = (abs(v) == 1 && gain[i] < lam3) ? 0 : v;
        }
    }
    __syncthreads();
}

// Sign-data hiding of one coefficient group; ``ix`` its 16 flat indices.
// Where the first and last nonzero slots are >= 4 apart and the parity of
// the absolute sum disagrees with the first level's sign, the level move of
// least added dequantisation error is applied: +1 in magnitude on a nonzero
// level or -1 on one of magnitude >= 2, in the order up[0..15], down[0..15],
// first minimum; the error (deq(l') - c)^2 - (deq(l) - c)^2 in float32.
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

// Sign-data hiding over the TB's coefficient groups: ``cgtab`` is the
// (49, ncg, 16) table of flat tile indices (row lw*7+lh, -1 where absent)
// that the wrappers build from the port's grouped scan.
static __device__ void sdh(const Tile& t, const int32_t* cgtab, int ncg,
                           const int32_t* coef, int32_t* lev) {
    const int32_t* tab = cgtab + (size_t)(t.lw * 7 + t.lh) * ncg * 16;
    for (int g = threadIdx.x; g < ncg; g += blockDim.x)
        sdh_group(tab + 16 * g, coef, lev, t.iscale, t.rs);
    __syncthreads();
}

// Clipped dequantisation of the (kh, kw) region.
static __device__ void dequantize(const Tile& t, const int32_t* lev, int32_t* out,
                                  int kh, int kw) {
    for (int e = threadIdx.x; e < kh * kw; e += blockDim.x) {
        const int o = (e / kw) * t.P + e % kw;
        out[o] = clampi(dequant(lev[o], t.iscale, t.rs), COEFF_MIN, COEFF_MAX);
    }
    __syncthreads();
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

// Exact sums over the (h, w) CU: SSE of ``rr`` against ``res`` (``rr``
// null: of ``res`` itself, the zero TU) and the rate proxy of ``lev`` (null:
// none), 8 + nz + sum(2 * bitlen|l| + 1). Valid in thread 0.
static __device__ void tile_sums(const Tile& t, const int32_t* res, const int32_t* rr,
                                 const int32_t* lev, long long* red64, int* red32,
                                 long long* sse_out, int* bits_out) {
    long long sse = 0;
    int bits = 0;
    for (int e = threadIdx.x; e < t.h * t.w; e += blockDim.x) {
        const int o = (e / t.w) * t.P + e % t.w;
        const long long d = (long long)(rr ? rr[o] : 0) - res[o];
        sse += d * d;
        if (lev) {
            const int a = abs(lev[o]);
            if (a) bits += 2 * (32 - __clz(a)) + 2;   // magnitude + nonzero count
        }
    }
    *sse_out = block_sum(sse, red64);
    *bits_out = block_sum(bits, red32) + 8;
}
