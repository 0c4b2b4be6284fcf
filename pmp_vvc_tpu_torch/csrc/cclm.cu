// K6a: CCLM (LM_CHROMA) against the DM prediction of the wave step's chroma
// CUs.
//
// Replaces pmp_vvc_tpu/ops/cclm_generic.py:cclm_predict_generic (40), with
// the division table of ops/cclm.py (19), the order-grid availability of
// codec/wavefront.py:_avail_from_order (82) and the DM-vs-LM choice of
// _chroma_part (514-541).
//
// One block per chroma CU. Thread 0 reads the left and above availability
// from the chroma tree's coding-order grid; the block then downsamples the
// co-located luma recon (6 taps; the left tap takes the centre column where
// the left neighbour is unavailable) into shared memory and loads the U and
// V originals. Thread 0 picks the 4-point template (luma from the above row,
// 3 taps on a CTU's top row, and the left column; chroma from K1's
// unfiltered reference rows), runs VTM's compare-swap network and the
// 4-bit-significand division for U and V: (a, b, shift) with the clamp of a
// to +-15 where shift < 1, a flat template, and the no-neighbour case. The
// block predicts clip(((a * ds) >> shift) + b) for U and V into shared
// memory, then scores DM and LM by joint U+V SATD with the code K2 and K3
// use (csrc/satd.cuh), on shared tiles over the CU's sides rounded up to 4
// and zero beyond the CU (a chroma side of 2 occurs in both trees). LM wins
// where its SATD is strictly below DM's and the row's CCLM gate (flag bit 0)
// is set. The chosen predictions replace K2's DM predictions in the output,
// zero outside the CU; padding rows give zeros and use_lm 0. Every luma read is clamped to the plane's edges; every right
// shift of a signed product is arithmetic, as in the plain version.
//
// Bound: bytes at most CU sizes. A CU reads a (2h+2) x (2w+3) luma window,
// two chroma originals and two DM predictions and writes two predictions
// and a flag; the downsampling (7 operations a sample), the prediction and
// the four SATDs are a few tens of operations per chroma sample.
#include <cuda_runtime.h>
#include <stdint.h>

#include "satd.cuh"

#define MAXP 32                        // chroma tiles of the 64-pad luma class
#define NT 256

__constant__ int DIV_SIG[16] = {0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0};

static __device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static __device__ __forceinline__ int bitlen(int v) { return v > 0 ? 32 - __clz(v) : 0; }

struct Luma {                          // one frame's luma recon, reads clamped
    const int32_t* p;
    int H, W;
    __device__ int at(int r, int c) const {
        return p[(size_t)clampi(r, 0, H - 1) * W + clampi(c, 0, W - 1)];
    }
};

struct Geo {                           // the CU in chroma samples, luma origin
    int cw, ch, lx, ly;
    bool la, aa;
    // the left tap's column for downsampled column i
    __device__ int lcol(int i) const {
        const int idx = lx + 2 * i;
        return (!la && i == 0) ? idx : idx - 1;
    }
};

// Downsampled luma over rows r0, r0 + 1 at column i: {1 2 1 / 1 2 1} / 8.
static __device__ int six(const Luma& L, const Geo& g, int r0, int i) {
    const int c = g.lx + 2 * i, l = g.lcol(i);
    return (4 + 2 * L.at(r0, c) + L.at(r0, c + 1) + L.at(r0, l) + 2 * L.at(r0 + 1, c) +
            L.at(r0 + 1, c + 1) + L.at(r0 + 1, l)) >> 3;
}

// The above template sample at column i: 3 taps of row ly - 1 on a CTU's
// top row (ly % 128 == 0), else 6 taps of rows ly - 2 and ly - 1.
static __device__ int ds_above(const Luma& L, const Geo& g, int i) {
    if (g.ly % 128 == 0) {
        const int r = max(g.ly - 1, 0), c = g.lx + 2 * i;
        return (2 + 2 * L.at(r, c) + L.at(r, c + 1) + L.at(r, g.lcol(i))) >> 2;
    }
    return six(L, g, max(g.ly - 2, 0), i);
}

// The left template sample at row j: 6 taps at luma columns lx-1..lx-3.
static __device__ int ds_left(const Luma& L, const Geo& g, int j) {
    const int r = g.ly + 2 * j;
    const int c1 = max(g.lx - 1, 0), c2 = max(g.lx - 2, 0), c3 = max(g.lx - 3, 0);
    return (4 + 2 * L.at(r, c2) + L.at(r, c1) + L.at(r, c3) + 2 * L.at(r + 1, c2) +
            L.at(r + 1, c1) + L.at(r + 1, c3)) >> 3;
}

static __device__ __forceinline__ void cswap(int& al, int& ac, int& bl, int& bc) {
    if (al > bl) {
        int t = al; al = bl; bl = t;
        t = ac; ac = bc; bc = t;
    }
}

// (a, b, shift) of the linear model through the four (luma, chroma) pairs.
static __device__ void lm_params(const int* sl, const int* sc, bool none, int bd,
                                 int* out) {
    int n0l = sl[0], n0c = sc[0], n1l = sl[2], n1c = sc[2];
    int x0l = sl[1], x0c = sc[1], x1l = sl[3], x1c = sc[3];
    cswap(n0l, n0c, n1l, n1c);
    cswap(x0l, x0c, x1l, x1c);
    if (n0l > x1l) {                   // the minima and maxima swap places
        int t;
        t = n0l; n0l = x0l; x0l = t;
        t = n1l; n1l = x1l; x1l = t;
        t = n0c; n0c = x0c; x0c = t;
        t = n1c; n1c = x1c; x1c = t;
    }
    if (n1l > x0l) {
        int t;
        t = n1l; n1l = x0l; x0l = t;
        t = n1c; n1c = x0c; x0c = t;
    }
    const int min_l = (n0l + n1l + 1) >> 1, min_c = (n0c + n1c + 1) >> 1;
    const int max_l = (x0l + x1l + 1) >> 1, max_c = (x0c + x1c + 1) >> 1;
    const int diff = max_l - min_l, diff_c = max_c - min_c;
    int a = 0, b, shift = 0;
    if (none) {
        b = 1 << (bd - 1);
    } else if (diff <= 0) {            // flat template
        b = min_c;
    } else {
        int x = bitlen(diff) - 1;
        const int norm = ((diff << 4) >> x) & 15;
        const int v = DIV_SIG[norm] | 8;
        x += norm != 0;
        const int y = bitlen(abs(diff_c));
        a = (diff_c * v + ((1 << y) >> 1)) >> y;
        shift = 3 + x - y;
        if (shift < 1) {
            a = a == 0 ? 0 : (a < 0 ? -15 : 15);
            shift = 1;
        }
        b = min_c - ((a * min_l) >> shift);
    }
    out[0] = a, out[1] = b, out[2] = shift;
}

__global__ void cclm_kernel(const int32_t* __restrict__ refs,
                            const int32_t* __restrict__ ry,
                            const int32_t* __restrict__ ou,
                            const int32_t* __restrict__ ov,
                            const int32_t* __restrict__ og,
                            const int32_t* __restrict__ rows,
                            const int32_t* __restrict__ pred, int B, int P, int bd,
                            int H, int W, int Hc, int Wc, int GH, int GW,
                            int32_t* __restrict__ pred_out, int32_t* __restrict__ use_out) {
    __shared__ int32_t sds[MAXP * MAXP];
    __shared__ int32_t sorg[2][MAXP * MAXP];
    __shared__ int32_t sdm[2][MAXP * MAXP];
    __shared__ int32_t slm[2][MAXP * MAXP];
    __shared__ int red[NT / 32];
    __shared__ int s_la, s_aa, s_use;
    __shared__ int s_par[2][3];
    const int b = blockIdx.x, PP = P * P, L = 2 * P + 3;
    const int32_t* r = rows + 8 * b;
    if (r[6] <= 0) {                   // padding row
        for (int i = threadIdx.x; i < PP; i += blockDim.x)
            pred_out[(size_t)b * PP + i] = pred_out[((size_t)B + b) * PP + i] = 0;
        if (threadIdx.x == 0) use_out[b] = 0;
        return;
    }
    const int fi = r[0], cx = r[1] / 2, cy = r[2] / 2, oi = r[5];
    Geo g;
    g.cw = r[3] / 2, g.ch = r[4] / 2, g.lx = 2 * cx, g.ly = 2 * cy;
    const Luma Lm = {ry + (size_t)fi * H * W, H, W};
    if (threadIdx.x == 0) {            // availability from the chroma order grid
        const int32_t* o = og + (size_t)fi * GH * GW;
        auto avail = [&](bool ok, int px, int py) {
            const int id = o[clampi(py, 0, GH - 1) * GW + clampi(px, 0, GW - 1)];
            return ok && id >= 0 && id < oi;
        };
        s_la = avail(cx > 0, max(cx - 1, 0) * 2 / 4, cy * 2 / 4);
        s_aa = avail(cy > 0, cx * 2 / 4, max(cy - 1, 0) * 2 / 4);
    }
    __syncthreads();
    g.la = s_la, g.aa = s_aa;
    // the tiles over the CU's sides rounded up to 4, zero beyond the CU, so
    // that the SATD of a side of 2 is the plain version's masked one
    const int w4 = max(g.cw, 4), h4 = max(g.ch, 4);
    const int32_t* org[2] = {ou + (size_t)fi * Hc * Wc, ov + (size_t)fi * Hc * Wc};
    const int32_t* dm[2] = {pred + (size_t)b * PP, pred + ((size_t)B + b) * PP};
    for (int e = threadIdx.x; e < h4 * w4; e += blockDim.x) {
        const int j = e / w4, i = e % w4, o = j * P + i;
        const bool in = j < g.ch && i < g.cw;
        sds[o] = in ? six(Lm, g, g.ly + 2 * j, i) : 0;
        for (int pl = 0; pl < 2; ++pl) {
            sorg[pl][o] =
                in ? org[pl][clampi(cy + j, 0, Hc - 1) * Wc + clampi(cx + i, 0, Wc - 1)] : 0;
            sdm[pl][o] = in ? dm[pl][o] : 0;
        }
    }
    if (threadIdx.x == 0) {            // the template and both planes' models
        const int above_is4 = g.la ? 0 : 1, left_is4 = g.aa ? 0 : 1;
        const int cnt_t = g.aa ? min(g.cw, (1 + above_is4) << 1) : 0;
        const int start_t = g.cw >> (2 + above_is4), step_t = max(1, g.cw >> (1 + above_is4));
        const int cnt_l = g.la ? min(g.ch, (1 + left_is4) << 1) : 0;
        const int start_l = g.ch >> (2 + left_is4), step_l = max(1, g.ch >> (1 + left_is4));
        int sl[4], pos[4];
        bool top[4];
        for (int k = 0; k < 4; ++k) {
            top[k] = k < cnt_t;
            pos[k] = top[k] ? clampi(start_t + k * step_t, 0, P - 1)
                            : clampi(start_l + (k - cnt_t) * step_l, 0, P - 1);
            sl[k] = top[k] ? ds_above(Lm, g, pos[k]) : ds_left(Lm, g, pos[k]);
        }
        const bool two = cnt_t + cnt_l == 2, none = !g.la && !g.aa;
        if (two) {                     // [a0, b0] -> [b0, a0, b0, a0]
            const int l0 = sl[0], p0 = pos[0];
            const bool t0 = top[0];
            sl[0] = sl[2] = sl[1], sl[1] = sl[3] = l0;
            pos[0] = pos[2] = pos[1], pos[1] = pos[3] = p0;
            top[0] = top[2] = top[1], top[1] = top[3] = t0;
        }
        for (int pl = 0; pl < 2; ++pl) {
            int sc[4];
            for (int k = 0; k < 4; ++k)
                sc[k] = refs[((size_t)(pl * 4 + (top[k] ? 0 : 1)) * B + b) * L + 1 + pos[k]];
            lm_params(sl, sc, none, bd, s_par[pl]);
        }
    }
    __syncthreads();
    const int pel_max = (1 << bd) - 1;
    for (int e = threadIdx.x; e < h4 * w4; e += blockDim.x) {
        const int j = e / w4, i = e % w4, o = j * P + i;
        const bool in = j < g.ch && i < g.cw;
        for (int pl = 0; pl < 2; ++pl)
            slm[pl][o] = in ? clampi(((s_par[pl][0] * sds[o]) >> s_par[pl][2]) + s_par[pl][1],
                                     0, pel_max)
                            : 0;
    }
    __syncthreads();
    int cost_dm = 0, cost_lm = 0;      // valid in thread 0
    for (int pl = 0; pl < 2; ++pl) {
        cost_dm += satd(w4, h4, P, sorg[pl], sdm[pl], red);
        cost_lm += satd(w4, h4, P, sorg[pl], slm[pl], red);
    }
    if (threadIdx.x == 0) {
        s_use = (r[7] & 1) && cost_lm < cost_dm;
        use_out[b] = s_use;
    }
    __syncthreads();
    for (int pl = 0; pl < 2; ++pl)
        for (int i = threadIdx.x; i < PP; i += blockDim.x) {
            const int y = i / P, x = i % P;
            pred_out[((size_t)pl * B + b) * PP + i] =
                (y < g.ch && x < g.cw) ? (s_use ? slm[pl][i] : dm[pl][i]) : 0;
        }
}

extern "C" int pmp_cclm(const int32_t* refs, const int32_t* ry, const int32_t* ou,
                        const int32_t* ov, const int32_t* og, const int32_t* rows,
                        const int32_t* pred, int B, int P, int bd, int H, int W, int Hc,
                        int Wc, int GH, int GW, int32_t* pred_out, int32_t* use_out,
                        cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > MAXP || P < 2) return (int)cudaErrorInvalidValue;
    cclm_kernel<<<B, NT, 0, stream>>>(refs, ry, ou, ov, og, rows, pred, B, P, bd, H, W, Hc,
                                      Wc, GH, GW, pred_out, use_out);
    return (int)cudaGetLastError();
}
