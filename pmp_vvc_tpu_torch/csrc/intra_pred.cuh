// Intra prediction device code shared by K2 (csrc/intra_rmd.cu), K9
// (csrc/rdo_leaf.cu) and K10a (csrc/seq_intra.cu), so that the wave step's,
// the device RDO's and the sequential encoder's predictions round alike.
//
// The port of pmp_vvc_tpu/ops/intra_generic.py:predict_generic (142) with
// _planar_dc (90) for one CU: per-(size, mode) parameters from the
// (7, 6*6*67) tables the wrappers upload (ops/intra_generic.py:param_tables,
// luma or chroma), each angular sample computed directly from the reference
// rows in shared memory: index off + delta_int + x + k of the extended
// reference (the side projection below the corner, then the main row),
// clamped to the replicated tail; horizontal modes in transposed space;
// planar and DC with their PDPC; chroma with the 2-tap filter.
//
// Who uses what: K2 and K9 read a mode's parameters with mode_table, K10a
// with mode_entries from its block's copy of the size's entries; every
// kernel takes DC's value from warp_dc; planar and DC samples come from
// predict_sample (K2, K9, K10a), angular lines from predict_line (K2, K10a;
// K9's k9a_line is its copy without lane-divergent branches).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

#define NTAB (6 * 6 * 67)

// The luma cubic (DCT-IF) taps by fraction. CHROMA_FILTER is their copy in
// constant memory, which serves the lanes of one line at one address; a
// kernel whose lanes hold many lines stages a copy from CUBIC_TAPS_INIT in
// device memory into shared memory instead (the constant cache serialises
// different addresses).
#define CUBIC_TAPS_INIT                                                          \
    {{0, 64, 0, 0}, {-1, 63, 2, 0}, {-2, 62, 4, 0}, {-2, 60, 7, -1},             \
     {-2, 58, 10, -2}, {-3, 57, 12, -2}, {-4, 56, 14, -2}, {-4, 55, 15, -2},     \
     {-4, 54, 16, -2}, {-5, 53, 18, -2}, {-6, 52, 20, -2}, {-6, 49, 24, -3},     \
     {-6, 46, 28, -4}, {-5, 44, 29, -4}, {-4, 42, 30, -4}, {-4, 39, 33, -4},     \
     {-4, 36, 36, -4}, {-4, 33, 39, -4}, {-4, 30, 42, -4}, {-4, 29, 44, -5},     \
     {-4, 28, 46, -6}, {-3, 24, 49, -6}, {-2, 20, 52, -6}, {-2, 18, 53, -5},     \
     {-2, 16, 54, -4}, {-2, 15, 55, -4}, {-2, 14, 56, -4}, {-2, 12, 57, -3},     \
     {-2, 10, 58, -2}, {-1, 7, 60, -2}, {0, 4, 62, -2}, {0, 2, 63, -1}}

__constant__ int CHROMA_FILTER[32][4] = CUBIC_TAPS_INIT;

struct Cu {
    int w, h, lw, lh, P, L, pel_max, luma;
    const int32_t *tu, *lu, *tf, *lf;    // shared-memory reference rows
    const int32_t* tabs;
};

struct Mode {
    int mode, angle, inv, ver, filt, gauss, pdpc, scale, dc;
};

// A mode's parameters from its size's table entries: ``t`` points at mode
// 0's entry of the first table, entry (k, mode) at t[k * stride + mode]
// (p.dc stays 0: warp_dc gives DC's value).
static __device__ __forceinline__ Mode mode_entries(const int32_t* t, int stride, int m) {
    Mode p;
    p.mode = clampi(m, 0, 66);
    p.angle = t[0 * stride + p.mode];
    p.inv = t[1 * stride + p.mode];
    p.ver = t[2 * stride + p.mode];
    p.filt = t[3 * stride + p.mode];
    p.gauss = t[4 * stride + p.mode];
    p.pdpc = t[5 * stride + p.mode];
    p.scale = t[6 * stride + p.mode];
    if (p.mode <= 1) {                 // planar / DC: mode 0's filter + PDPC
        p.filt = t[3 * stride];
        p.pdpc = t[5 * stride];
    }
    p.dc = 0;
    return p;
}

// A mode's parameters read from the (7, NTAB) tables in device memory.
static __device__ __forceinline__ Mode mode_table(const Cu& c, int m) {
    return mode_entries(c.tabs + ((c.lw - 1) * 6 + (c.lh - 1)) * 67, NTAB, m);
}

// DC's value (Mode.dc), the rounded mean of the unfiltered references of
// the longer side (of both sides of a square CU), summed by the whole warp;
// every lane calls it. The rows may lie in shared or in device memory.
static __device__ int warp_dc(const Cu& c) {
    const int lane = threadIdx.x & 31;
    int s = 0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {      // sides up to 64: every load issued at once
        const int i = lane + 32 * q;
        if (c.w >= c.h && i < c.w) s += c.tu[1 + i];
        if (c.w <= c.h && i < c.h) s += c.lu[1 + i];
    }
    s = __reduce_add_sync(0xffffffffu, s);
    const int denom = c.w == c.h ? c.w << 1 : max(c.w, c.h);
    return (s + (denom >> 1)) >> ilog2(denom);
}

// Prediction of tile sample (r, c) (row, column) for mode p.
static __device__ int predict_sample(const Cu& c, const Mode& p, int r, int col) {
    if (p.mode <= 1) {
        const int32_t* tp = p.mode == 0 && p.filt ? c.tf : c.tu;
        const int32_t* lp = p.mode == 0 && p.filt ? c.lf : c.lu;
        int pred;
        if (p.mode == 0) {
            const int tr = tp[1 + c.w], bl = lp[1 + c.h];
            const int hor = lp[1 + r] * (1 << c.lw) + (col + 1) * (tr - lp[1 + r]);
            const int ver = tp[1 + col] * (1 << c.lh) + (r + 1) * (bl - tp[1 + col]);
            pred = (hor * (1 << c.lh) + ver * (1 << c.lw) + (1 << (c.lw + c.lh)))
                   >> (1 + c.lw + c.lh);
        } else {
            pred = p.dc;
        }
        if (p.pdpc) {
            const int sc = ((c.lw - 2) + (c.lh - 2) + 2) >> 2;
            const int wT = 32 >> min(31, (2 * r) >> sc);
            const int wL = 32 >> min(31, (2 * col) >> sc);
            pred += (wL * (lp[1 + r] - pred) + wT * (tp[1 + col] - pred) + 32) >> 6;
        }
        return pred;
    }
    const int y = p.ver ? r : col, x = p.ver ? col : r;
    const int32_t* main = p.ver ? (p.filt ? c.tf : c.tu) : (p.filt ? c.lf : c.lu);
    const int32_t* side = p.ver ? (p.filt ? c.lf : c.lu) : (p.filt ? c.tf : c.tu);
    const int wp = p.ver ? c.w : c.h, hp = p.ver ? c.h : c.w;
    const int lwp = p.ver ? c.lw : c.lh, lhp = p.ver ? c.lh : c.lw;
    const int P = c.P, L = c.L, ltot = P + L;
    const int dpos = p.angle * (1 + y);
    const int dint = dpos >> 5, dfrac = dpos & 31;
    int f[4];
    if (c.luma && p.gauss) {
        const int half = dfrac >> 1;
        f[0] = 16 - half; f[1] = 32 - half; f[2] = 16 + half; f[3] = half;
    } else if (c.luma) {
        f[0] = CHROMA_FILTER[dfrac][0]; f[1] = CHROMA_FILTER[dfrac][1];
        f[2] = CHROMA_FILTER[dfrac][2]; f[3] = CHROMA_FILTER[dfrac][3];
    } else {
        f[0] = 0; f[1] = 64 - 2 * dfrac; f[2] = 2 * dfrac; f[3] = 0;
    }
    int acc = 0;
    for (int k = 0; k < 4; ++k) {
        const int idx = min(P + dint + x + k, ltot - 1);
        int v;
        if (idx >= P) {
            v = main[idx - P];
        } else {                           // negative-angle side projection
            const int j = P - idx;
            v = side[clampi(min((j * p.inv + 256) >> 9, hp), 0, L - 1)];
        }
        acc += f[k] * v;
    }
    int pred = clampi((acc + 32) >> 6, 0, c.pel_max);
    if (p.pdpc) {
        if (p.angle == 0) {
            const int sc0 = (lwp + lhp - 2) >> 2;
            if (x < min(3 << sc0, wp)) {
                const int wl0 = 32 >> min(31, (2 * x) >> sc0);
                pred = clampi(pred + ((wl0 * (side[1 + y] - main[0]) + 32) >> 6),
                              0, c.pel_max);
            }
        } else if (x < min(16, P) && x < min(3 << p.scale, wp)) {
            const int inv_sum = 256 + (x + 1) * p.inv;
            const int sv = side[clampi(y + (inv_sum >> 9) + 1, 0, L - 1)];
            const int wl = 32 >> min(31, (2 * x) >> p.scale);
            pred += (wl * (sv - pred) + 32) >> 6;
        }
    }
    return pred;
}

// The line form of predict_sample for an angular mode (p.mode >= 2), for the
// warp form of K2: the TS samples x = x0 .. x0 + TS - 1 of line y in the
// mode's own space (a row for a vertical mode; for a horizontal one a CU
// column, transposed), from one window of TS + 3 reference samples and the
// line's one set of filter taps. out[j] equals predict_sample at that
// sample: (y, x0 + j) for a vertical mode, (x0 + j, y) for a horizontal one.
// ``cf`` holds the luma cubic taps (CHROMA_FILTER, or a copy in shared
// memory).
template <int TS>
static __device__ __forceinline__ void predict_line(const Cu& c, const Mode& p, int y, int x0,
                                                    int (&out)[TS],
                                                    const int (*cf)[4] = CHROMA_FILTER) {
    const int32_t* main = p.ver ? (p.filt ? c.tf : c.tu) : (p.filt ? c.lf : c.lu);
    const int32_t* side = p.ver ? (p.filt ? c.lf : c.lu) : (p.filt ? c.tf : c.tu);
    const int wp = p.ver ? c.w : c.h, hp = p.ver ? c.h : c.w;
    const int lwp = p.ver ? c.lw : c.lh, lhp = p.ver ? c.lh : c.lw;
    const int P = c.P, L = c.L, ltot = P + L;
    const int dpos = p.angle * (1 + y);
    const int dint = dpos >> 5, dfrac = dpos & 31;
    int f[4];
    if (c.luma && p.gauss) {
        const int half = dfrac >> 1;
        f[0] = 16 - half; f[1] = 32 - half; f[2] = 16 + half; f[3] = half;
    } else if (c.luma) {
        f[0] = cf[dfrac][0]; f[1] = cf[dfrac][1]; f[2] = cf[dfrac][2]; f[3] = cf[dfrac][3];
    } else {
        f[0] = 0; f[1] = 64 - 2 * dfrac; f[2] = 2 * dfrac; f[3] = 0;
    }
    int v[TS + 3];                         // reference samples x0 + i + dint
#pragma unroll
    for (int i = 0; i < TS + 3; ++i) {
        const int idx = min(P + dint + x0 + i, ltot - 1);
        if (idx >= P) {
            v[i] = main[idx - P];
        } else {                           // negative-angle side projection
            const int j = P - idx;
            v[i] = side[clampi(min((j * p.inv + 256) >> 9, hp), 0, L - 1)];
        }
    }
#pragma unroll
    for (int j = 0; j < TS; ++j) {
        const int x = x0 + j;
        const int acc = f[0] * v[j] + f[1] * v[j + 1] + f[2] * v[j + 2] + f[3] * v[j + 3];
        int pred = clampi((acc + 32) >> 6, 0, c.pel_max);
        if (p.pdpc) {
            if (p.angle == 0) {
                const int sc0 = (lwp + lhp - 2) >> 2;
                if (x < min(3 << sc0, wp)) {
                    const int wl0 = 32 >> min(31, (2 * x) >> sc0);
                    pred = clampi(pred + ((wl0 * (side[1 + y] - main[0]) + 32) >> 6),
                                  0, c.pel_max);
                }
            } else if (x < min(16, P) && x < min(3 << p.scale, wp)) {
                const int inv_sum = 256 + (x + 1) * p.inv;
                const int sv = side[clampi(y + (inv_sum >> 9) + 1, 0, L - 1)];
                const int wl = 32 >> min(31, (2 * x) >> p.scale);
                pred += (wl * (sv - pred) + 32) >> 6;
            }
        }
        out[j] = pred;
    }
}
