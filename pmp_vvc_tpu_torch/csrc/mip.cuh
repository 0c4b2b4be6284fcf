// MIP device code shared by K3 (csrc/mip_rmd.cu) and K10b (csrc/seq_mip.cu),
// so that the wave step's and the sequential encoder's MIP candidates round
// alike.
//
// The port of pmp_vvc_tpu/ops/mip.py:predict_mip_all (75) for one candidate
// (t, m) of one block: the size class (sid, the boundary size red_b, the
// reduced size red_p, n_modes), the Haar-downsampled unfiltered top and left
// references packed as [top, left] (t = 0) and [left, top] (t = 1), the
// reduced prediction from the (3, 16, 64, 8) weight table (a product of at
// most 8 terms per reduced sample, the sizeId-2 matrix at input columns
// 1..7), then the horizontal linear upsampling against the left boundary and
// the vertical one against the top row.
//
// The per-sample formulas (``mip_down``, ``mip_row`` with ``mip_reduce`` or
// ``mip_reduced``, ``mip_up``, ``mip_left``) are the rounding both kernels
// share; each kernel lays its tables out itself: K3 on its cluster, K10b
// on a block a candidate (a few at 4x4).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

#define MIP_MAXP 64

struct Mip {
    int w, h, P, sid, red_b, red_p, n_modes, bd;
    const int32_t *top, *left;        // unfiltered rows, index 0 = x 0
    const int32_t* mats;              // (3, 16, 64, 8)
    const int32_t* bdry;              // shared: (2, 8) packed boundaries
};

// The size class of a w x h block (getMipSizeId / getNumModesMip).
static __device__ void mip_size_class(Mip& c, int w, int h) {
    c.w = w;
    c.h = h;
    c.sid = (w == 4 && h == 4) ? 0 : (w == 4 || h == 4 || (w == 8 && h == 8)) ? 1 : 2;
    c.red_b = c.sid == 0 ? 2 : 4;
    c.red_p = c.sid < 2 ? 4 : 8;
    c.n_modes = c.sid == 0 ? 16 : c.sid == 1 ? 8 : 6;
}

// Haar downsampling of n boundary samples to nb: output j, the rounded
// mean of group j of f = n / nb samples (f <= 16: every load issued at
// once, so that a group in device memory costs one round trip).
static __device__ __forceinline__ int mip_down(const int32_t* v, int n, int nb, int j) {
    const int f = n / nb, lf = ilog2(f);
    int s = 0;
#pragma unroll
    for (int i = 0; i < MIP_MAXP / 4; ++i)
        if (i < f) s += v[j * f + i];
    return (s + (f >> 1)) >> lf;
}

// The weight row of reduced sample (r, col) of candidate (t, m): 8
// entries, 32-byte aligned (t = 1 reads the matrix transposed).
static __device__ __forceinline__ const int32_t* mip_row(const Mip& c, int t, int m, int r,
                                                         int col) {
    const int rp = c.red_p;
    const int oi = t ? col * rp + r : r * rp + col;        // transposed read
    return c.mats + ((c.sid * 16 + m) * 64 + oi) * 8;
}

// A reduced sample of a candidate with transpose flag t from its weight row
// ``row``: the 8-term product against the packed boundary ``bdry + 8 * t``
// (the sizeId-2 matrix sits at input columns 1..7).
static __device__ __forceinline__ int mip_reduce(const Mip& c, int t, const int (&row)[8]) {
    const int32_t* bd = c.bdry + 8 * t;
    const int off = bd[0];
    int acc = 0, vsum = 0;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
        int v;
        if (kk == 0) v = c.sid < 2 ? (1 << (c.bd - 1)) - off : 0;
        else v = kk < 2 * c.red_b ? bd[kk] - off : 0;
        acc += row[kk] * v;
        vsum += v;
    }
    const int res = (acc + 32 - 32 * vsum) >> 6;
    return clampi(res + off, 0, (1 << c.bd) - 1);
}

// Reduced sample (r, col) of candidate (t, m).
static __device__ __forceinline__ int mip_reduced(const Mip& c, int t, int m, int r, int col) {
    const int32_t* w = mip_row(c, t, m, r, col);
    int row[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) row[kk] = w[kk];
    return mip_reduce(c, t, row);
}

// Linear upsampling by a factor f = 1 << lf: position p (1..f) between
// ``prev`` and ``red``; factor 1 is the identity.
static __device__ __forceinline__ int mip_up(int prev, int red, int p, int f, int lf) {
    return ((f - p) * prev + p * red + (f >> 1)) >> lf;
}

// The left boundary sample of reduced row r for the horizontal pass.
static __device__ __forceinline__ int mip_left(const Mip& c, int r) {
    return c.left[clampi((r + 1) * (c.h / c.red_p) - 1, 0, c.h - 1)];
}
