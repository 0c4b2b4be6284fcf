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
// The per-sample formulas (``mip_down``, ``mip_reduced``, ``mip_up``,
// ``mip_left``) are the rounding both kernels share: K10b runs them
// through ``mip_candidate`` one candidate a block, K3 through its own
// cluster layout.
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
    int32_t *sred, *sh;               // shared: (8, 8) reduced, (8, MIP_MAXP) rows
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
// mean of group j of f = n / nb samples.
static __device__ __forceinline__ int mip_down(const int32_t* v, int n, int nb, int j) {
    const int f = n / nb, lf = ilog2(f);
    int s = 0;
    for (int i = j * f; i < (j + 1) * f; ++i) s += v[i];
    return (s + (f >> 1)) >> lf;
}

static __device__ void mip_downsample(const int32_t* v, int n, int nb, int* out) {
    for (int j = 0; j < nb; ++j) out[j] = mip_down(v, n, nb, j);
}

// The packed boundaries [top, left] and [left, top] into ``sbdry`` (2, 8);
// called by one thread.
static __device__ void mip_boundaries(const Mip& c, int32_t* sbdry) {
    int rt[4], rl[4];
    mip_downsample(c.top, c.w, c.red_b, rt);
    mip_downsample(c.left, c.h, c.red_b, rl);
    for (int k = 0; k < c.red_b; ++k) {
        sbdry[k] = rt[k];
        sbdry[c.red_b + k] = rl[k];
        sbdry[8 + k] = rl[k];
        sbdry[8 + c.red_b + k] = rt[k];
    }
}

// Reduced sample (r, col) of candidate (t, m): the 8-term product of the
// weight row against the packed boundary ``bdry + 8 * t`` (t = 1 reads the
// matrix transposed; the sizeId-2 matrix sits at input columns 1..7).
static __device__ __forceinline__ int mip_reduced(const Mip& c, int t, int m, int r, int col) {
    const int rp = c.red_p;
    const int32_t* bd = c.bdry + 8 * t;
    const int off = bd[0];
    const int oi = t ? col * rp + r : r * rp + col;        // transposed read
    const int32_t* row = c.mats + ((c.sid * 16 + m) * 64 + oi) * 8;
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

// Linear upsampling by a factor f = 1 << lf: position p (1..f) between
// ``prev`` and ``red``; factor 1 is the identity.
static __device__ __forceinline__ int mip_up(int prev, int red, int p, int f, int lf) {
    return ((f - p) * prev + p * red + (f >> 1)) >> lf;
}

// The left boundary sample of reduced row r for the horizontal pass.
static __device__ __forceinline__ int mip_left(const Mip& c, int r) {
    return c.left[clampi((r + 1) * (c.h / c.red_p) - 1, 0, c.h - 1)];
}

// Candidate k = t * 16 + m's prediction into ``out`` (P-strided, the (h, w)
// region); every thread of the block calls it.
static __device__ void mip_candidate(const Mip& c, int k, int32_t* out) {
    const int t = k >> 4, m = k & 15, rp = c.red_p;
    for (int i = threadIdx.x; i < rp * rp; i += blockDim.x)
        c.sred[(i / rp) * 8 + i % rp] = mip_reduced(c, t, m, i / rp, i % rp);
    __syncthreads();
    const int f_h = c.w / rp, f_v = c.h / rp;
    const int lf_h = ilog2(f_h), lf_v = ilog2(f_v);
    for (int i = threadIdx.x; i < rp * c.w; i += blockDim.x) {
        const int r = i / c.w, x = i % c.w;
        const int jh = x * rp / c.w, ph = x - jh * f_h + 1;
        const int red = c.sred[r * 8 + jh];
        const int prev = jh == 0 ? mip_left(c, r) : c.sred[r * 8 + jh - 1];
        c.sh[r * MIP_MAXP + x] = mip_up(prev, red, ph, f_h, lf_h);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < c.h * c.w; i += blockDim.x) {
        const int y = i / c.w, x = i % c.w;
        const int jv = y * rp / c.h, pv = y - jv * f_v + 1;
        const int red = c.sh[jv * MIP_MAXP + x];
        const int prev = jv == 0 ? c.top[x] : c.sh[(jv - 1) * MIP_MAXP + x];
        out[y * c.P + x] = mip_up(prev, red, pv, f_v, lf_v);
    }
    __syncthreads();
}
