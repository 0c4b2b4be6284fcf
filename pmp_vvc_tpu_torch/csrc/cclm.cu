// K6a: CCLM (LM_CHROMA) against the DM prediction of the wave step's chroma
// CUs.
//
// Replaces pmp_vvc_tpu/ops/cclm_generic.py:cclm_predict_generic (40), with
// the division table of ops/cclm.py (19), the order-grid availability of
// codec/wavefront.py:_avail_from_order (82) and the DM-vs-LM choice of
// _chroma_part (514-541).
//
// Per chroma CU: the left and above availability from the chroma tree's
// coding-order grid; the 4-point template (luma downsampled from the above
// rows, 3 taps on a CTU's top row, and from the left columns; chroma from
// K1's unfiltered reference rows); VTM's compare-swap network and the
// 4-bit-significand division for U and V: (a, b, shift) with the clamp of a
// to +-15 where shift < 1, a flat template, and the no-neighbour case; the
// prediction clip(((a * ds) >> shift) + b) from the 6-tap downsampled luma
// (the left tap takes the centre column where the left neighbour is
// unavailable). DM and LM are scored by joint U+V SATD over the CU's sides
// rounded up to 4, zero beyond the CU (a chroma side of 2 occurs in both
// trees); LM wins where its SATD is strictly below DM's and the row's CCLM
// gate (flag bit 0) is set. The chosen predictions replace K2's DM
// predictions in the output, zero outside the CU; padding rows give zeros
// and use_lm 0. Every luma read is clamped to the plane's edges; every
// right shift of a signed product is arithmetic, as in the plain version.
//
// Bound: bytes at most CU sizes. A CU reads a (2h+2) x (2w+3) luma window,
// two chroma originals and two DM predictions and writes two predictions
// and a flag; the downsampling (7 operations a sample), the prediction and
// the four SATDs are a few tens of operations per chroma sample. What
// holds a call is its chain of dependent steps, so the design keeps it
// short:
// - Staging: a team of warps takes a CU. Every thread of the team copies in
//   one pass of asynchronous copies (cp.async, so that all of a thread's
//   copies are in flight at once) the luma window (rows ly-2 .. ly+2h-1,
//   columns lx-3 .. lx+2w-1, each read through the plane's clamps), the U
//   and V originals and DM predictions over the rounded tile (zero beyond
//   the CU) and both planes' top and left reference rows into shared
//   memory, while one thread reads the two order-grid cells; then one
//   barrier. Nothing reads device memory again but the outputs' writes.
// - The template on warp 0: lanes 0-3 each downsample one luma sample of
//   the template from the window, lanes 4-11 read the eight chroma samples,
//   and lanes 0 and 1 fit U's and V's models from shuffles. Meanwhile the
//   other warps score DM, which needs no model.
// - The SATDs in registers (csrc/satd.cuh: warp_tile_satd): the four
//   SATDs' tiles (DM U, DM V, LM U, LM V) are cut into segments of one
//   tile's rows, one row a lane, 32 / TS segments a warp call; the calls
//   spread over the team's warps, DM's before the models' barrier and LM's
//   after it, each LM sample formed in registers from the window and the
//   model. Each warp sums its tiles into its own shared slot; after one
//   barrier every thread adds the slots (integers: the order does not
//   matter), decides, and writes its outputs, the LM samples recomputed.
// - Team size: one block per CU above K6A_TEAM_PAD (8 warps at the 16-pad
//   class, 16 at the 32-pad, or K6A_WARPS), with __syncthreads; at pads up to
//   K6A_TEAM_PAD (the RDO's 4- and 8-pad chunks) one warp per CU and
//   K6A_TEAM_CUS CUs a block, with __syncwarp only: the four SATDs of a 4x4
//   CU fill 16 lanes, those of an 8x8 CU 32.
// No cluster and no atomics; each call makes one launch.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "satd.cuh"

#ifndef K6A_TEAM_PAD
#define K6A_TEAM_PAD 8                 // pads up to this: one warp a CU
#endif
#ifndef K6A_WARPS
#define K6A_WARPS 0                    // warps a block above it; 0: 8 at pad 16, 16 at 32
#endif
#define K6A_TEAM_CUS 8                 // CUs (warps) a block of teams

__constant__ int DIV_SIG[16] = {0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0};

static __device__ __forceinline__ int bitlen(int v) { return v > 0 ? 32 - __clz(v) : 0; }

// A CU's staged inputs. win[r * WS + c] is the luma recon at (ly - 2 + r,
// lx - 3 + c), clamped to the plane; org / dm the originals and DM
// predictions over the rounded tile, P-strided, zero beyond the CU; ref the
// unfiltered top and left reference rows from position 1 (the corner is
// position 0 of K1's rows).
template <int P, int NW>
struct Stage {
    static constexpr int WS = 2 * P + 3;
    int win[(2 * P + 2) * WS];
    int org[2][P * P];
    int dm[2][P * P];
    int ref[2][2][P];
    int cost[NW][2];                   // each warp's DM and LM partial SATD
    int par[2][3];                     // (a, b, shift) of U and V
    int la, aa;
};

struct Cu {                            // the CU in chroma samples, its luma origin
    int fi, cx, cy, cw, ch, lx, ly, oi, flag;
};

// Downsampled luma from the window: rows r, r + 1, centre column c, left
// tap column l: {1 2 1 / 1 2 1} / 8.
template <int WS>
static __device__ __forceinline__ int six(const int* win, int r, int c, int l) {
    const int* r0 = win + r * WS;
    const int* r1 = r0 + WS;
    return (4 + 2 * r0[c] + r0[c + 1] + r0[l] + 2 * r1[c] + r1[c + 1] + r1[l]) >> 3;
}

// The CU's downsampled luma at (j, i); the left tap takes the centre column
// at i = 0 where the left neighbour is unavailable.
template <int WS>
static __device__ __forceinline__ int ds_in(const int* win, int j, int i, bool la) {
    const int c = 3 + 2 * i;
    return six<WS>(win, 2 + 2 * j, c, (!la && i == 0) ? c : c - 1);
}

// The above template sample at column i: 3 taps of row ly - 1 on a CTU's
// top row (ly % 128 == 0), else 6 taps of rows ly - 2 and ly - 1. The
// window's clamps stand for the plain version's max(ly - 1, 0).
template <int WS>
static __device__ int ds_above(const int* win, int i, bool la, bool ctu_top) {
    const int c = 3 + 2 * i, l = (!la && i == 0) ? c : c - 1;
    if (ctu_top) {
        const int* r = win + WS;
        return (2 + 2 * r[c] + r[c + 1] + r[l]) >> 2;
    }
    return six<WS>(win, 0, c, l);
}

// The left template sample at row j: 6 taps at luma columns lx-1..lx-3
// (window columns 2, 1, 0; clamped as max(lx - k, 0)).
template <int WS>
static __device__ int ds_left(const int* win, int j) {
    const int* r0 = win + (2 + 2 * j) * WS;
    const int* r1 = r0 + WS;
    return (4 + 2 * r0[1] + r0[2] + r0[0] + 2 * r1[1] + r1[2] + r1[0]) >> 3;
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

// Warp 0's part: the template and both planes' models into s.par. Lanes 0-3
// take the template's luma samples, lanes 4-11 its chroma samples (U, then
// V); every lane must call it.
template <int P, int NW>
static __device__ void fit_models(Stage<P, NW>& s, const Cu& u, int bd) {
    constexpr int WS = Stage<P, NW>::WS;
    const int lane = threadIdx.x & 31;
    const bool la = s.la, aa = s.aa;
    const int above_is4 = la ? 0 : 1, left_is4 = aa ? 0 : 1;
    const int cnt_t = aa ? min(u.cw, (1 + above_is4) << 1) : 0;
    const int start_t = u.cw >> (2 + above_is4), step_t = max(1, u.cw >> (1 + above_is4));
    const int cnt_l = la ? min(u.ch, (1 + left_is4) << 1) : 0;
    const int start_l = u.ch >> (2 + left_is4), step_l = max(1, u.ch >> (1 + left_is4));
    const int count = cnt_t + cnt_l;
    const bool two = count == 2, none = !la && !aa;
    // entry k of the template; the two-sample case takes [b0, a0, b0, a0]
    const int k = two ? ((lane & 1) ^ 1) : (lane & 3);
    const bool top = k < cnt_t;
    const int pos = top ? clampi(start_t + k * step_t, 0, P - 1)
                        : clampi(start_l + (k - cnt_t) * step_l, 0, P - 1);
    int v = 0;
    if (k < count) {
        if (lane < 4)
            v = top ? ds_above<WS>(s.win, pos, la, u.ly % 128 == 0) : ds_left<WS>(s.win, pos);
        else if (lane < 12)
            v = s.ref[(lane - 4) >> 2][top ? 0 : 1][pos];
    }
    int sl[4], sc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        sl[e] = __shfl_sync(0xffffffffu, v, e);
        sc[e] = __shfl_sync(0xffffffffu, v, 4 + 4 * (lane & 1) + e);
    }
    if (lane < 2) lm_params(sl, sc, none, bd, s.par[lane]);
}

// One warp call of the four SATDs' segments: segment q * (32 / TS) + lane /
// TS, row lane % TS of its tile. Segments 0 .. 2n-1 are DM's (U's n tiles,
// then V's), 2n .. 4n-1 LM's; lanes past the last segment pass zeros. Adds
// each tile's SATD once (its row-0 lane) to cdm or clm.
template <int TS, int P, int NW>
static __device__ void satd_call(const Stage<P, NW>& s, const Cu& u, int q, int ntiles,
                                 int nx, int pel_max, int& cdm, int& clm) {
    constexpr int WS = Stage<P, NW>::WS;
    const int lane = threadIdx.x & 31;
    const int seg = q * (32 / TS) + lane / TS, row = lane % TS;
    const bool live = seg < 4 * ntiles, lm = seg >= 2 * ntiles;
    int d[TS];
    if (live) {
        const int rem = lm ? seg - 2 * ntiles : seg, pl = rem >= ntiles;
        const int t = rem - pl * ntiles;
        const int j = (t / nx) * TS + row, c0 = (t % nx) * TS;
        const int* o = s.org[pl] + j * P + c0;
        if (lm) {
            const int a = s.par[pl][0], b = s.par[pl][1], sh = s.par[pl][2];
            const bool la = s.la;
#pragma unroll
            for (int e = 0; e < TS; ++e) {
                const int i = c0 + e;
                const int p = (j < u.ch && i < u.cw)
                    ? clampi(((a * ds_in<WS>(s.win, j, i, la)) >> sh) + b, 0, pel_max) : 0;
                d[e] = o[e] - p;
            }
        } else {
            const int* m = s.dm[pl] + j * P + c0;
#pragma unroll
            for (int e = 0; e < TS; ++e) d[e] = o[e] - m[e];
        }
    } else {
#pragma unroll
        for (int e = 0; e < TS; ++e) d[e] = 0;
    }
    const int v = warp_tile_satd<TS>(d);
    if (live && row == 0) (lm ? clm : cdm) += v;
}

// The four SATDs' calls of warp w of NW, the DM-only ones before the
// models' barrier (from the last warp down, so that warp 0 fits the models
// first) and the rest after it; then the warp's partial sums into its slot.
template <int TS, int P, int NW, bool BLOCK>
static __device__ void score(Stage<P, NW>& s, const Cu& u, int w, int bd) {
    const int w4 = max(u.cw, 4), h4 = max(u.ch, 4);
    const int nx = w4 / TS, ntiles = (h4 / TS) * nx;
    constexpr int SPW = 32 / TS;
    const int ncalls = (4 * ntiles + SPW - 1) / SPW, ndm = 2 * ntiles / SPW;
    const int pel_max = (1 << bd) - 1;
    int cdm = 0, clm = 0;
    if (w == 0) fit_models(s, u, bd);
    for (int q = NW - 1 - w; q < ndm; q += NW)
        satd_call<TS>(s, u, q, ntiles, nx, pel_max, cdm, clm);
    if (BLOCK) __syncthreads(); else __syncwarp();
    for (int q = ndm + w; q < ncalls; q += NW)
        satd_call<TS>(s, u, q, ntiles, nx, pel_max, cdm, clm);
    cdm = __reduce_add_sync(0xffffffffu, cdm);
    clm = __reduce_add_sync(0xffffffffu, clm);
    if ((threadIdx.x & 31) == 0) s.cost[w][0] = cdm, s.cost[w][1] = clm;
}

// One CU on a team of NW warps (BLOCK: the whole block, else one warp);
// t is the thread's index in the team.
template <int P, int NW, bool BLOCK>
static __device__ void cclm_cu(Stage<P, NW>& s, int b, int t,
                               const int32_t* __restrict__ refs,
                               const int32_t* __restrict__ ry,
                               const int32_t* __restrict__ ou,
                               const int32_t* __restrict__ ov,
                               const int32_t* __restrict__ og,
                               const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ pred, int B, int bd, int H, int W,
                               int Hc, int Wc, int GH, int GW, int32_t* __restrict__ pred_out,
                               int32_t* __restrict__ use_out) {
    constexpr int NT = NW * 32, PP = P * P, WS = Stage<P, NW>::WS, L = 2 * P + 3;
    const int32_t* r = rows + 8 * b;
    if (r[6] <= 0) {                   // padding row
        for (int i = t; i < 2 * PP; i += NT)
            pred_out[((size_t)(i / PP) * B + b) * PP + i % PP] = 0;
        if (t == 0) use_out[b] = 0;
        return;
    }
    Cu u;
    u.fi = r[0], u.cx = r[1] / 2, u.cy = r[2] / 2, u.cw = r[3] / 2, u.ch = r[4] / 2;
    u.oi = r[5], u.flag = r[7], u.lx = 2 * u.cx, u.ly = 2 * u.cy;
    const int w4 = max(u.cw, 4), h4 = max(u.ch, 4);

    // one pass of independent loads: asynchronous copies (cp.async), so that
    // a thread's copies are all in flight at once
    const int32_t* Y = ry + (size_t)u.fi * H * W;
    const int ww = 2 * u.cw + 3, wh = 2 * u.ch + 2;
    for (int e = t; e < wh * ww; e += NT) {
        const int r = e / ww, c = e - r * ww;
        __pipeline_memcpy_async(
            &s.win[r * WS + c],
            &Y[(size_t)clampi(u.ly - 2 + r, 0, H - 1) * W + clampi(u.lx - 3 + c, 0, W - 1)], 4);
    }
    for (int e = t; e < 2 * h4 * w4; e += NT) {
        const int pl = e >= h4 * w4, f = e - pl * h4 * w4;
        const int j = f / w4, i = f % w4, o = j * P + i;
        if (j < u.ch && i < u.cw) {
            const int32_t* org = (pl ? ov : ou) + (size_t)u.fi * Hc * Wc;
            __pipeline_memcpy_async(
                &s.org[pl][o],
                &org[clampi(u.cy + j, 0, Hc - 1) * Wc + clampi(u.cx + i, 0, Wc - 1)], 4);
            __pipeline_memcpy_async(&s.dm[pl][o], &pred[((size_t)pl * B + b) * PP + o], 4);
        } else {
            s.org[pl][o] = s.dm[pl][o] = 0;
        }
    }
    for (int e = t; e < 4 * P; e += NT) {   // [plane][top, left][position]
        const int pl = e / (2 * P), side = (e / P) & 1, p = e % P;
        __pipeline_memcpy_async(&s.ref[pl][side][p],
                                &refs[((size_t)(pl * 4 + side) * B + b) * L + 1 + p], 4);
    }
    __pipeline_commit();
    if (t == NT - 1) {                 // availability from the chroma order grid
        const int32_t* o = og + (size_t)u.fi * GH * GW;
        auto avail = [&](bool ok, int px, int py) {
            const int id = o[clampi(py, 0, GH - 1) * GW + clampi(px, 0, GW - 1)];
            return ok && id >= 0 && id < u.oi;
        };
        s.la = avail(u.cx > 0, max(u.cx - 1, 0) * 2 / 4, u.cy * 2 / 4);
        s.aa = avail(u.cy > 0, u.cx * 2 / 4, max(u.cy - 1, 0) * 2 / 4);
    }
    __pipeline_wait_prior(0);
    if (BLOCK) __syncthreads(); else __syncwarp();

    const int w = t >> 5;
    if (min(w4, h4) >= 8) score<8, P, NW, BLOCK>(s, u, w, bd);
    else score<4, P, NW, BLOCK>(s, u, w, bd);
    if (BLOCK) __syncthreads(); else __syncwarp();

    int cost_dm = 0, cost_lm = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) cost_dm += s.cost[k][0], cost_lm += s.cost[k][1];
    const bool use = (u.flag & 1) && cost_lm < cost_dm;
    if (t == 0) use_out[b] = use;
    const int pel_max = (1 << bd) - 1;
    const bool la = s.la;
    for (int i = t; i < PP; i += NT) {
        const int y = i / P, x = i % P;
        const bool in = y < u.ch && x < u.cw;
        const int ds = in && use ? ds_in<WS>(s.win, y, x, la) : 0;
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
            int v = 0;
            if (in)
                v = use ? clampi(((s.par[pl][0] * ds) >> s.par[pl][2]) + s.par[pl][1], 0,
                                 pel_max)
                        : s.dm[pl][i];
            pred_out[((size_t)pl * B + b) * PP + i] = v;
        }
    }
}

// Above K6A_TEAM_PAD: one block of NW warps per CU.
template <int P, int NW>
__global__ void __launch_bounds__(NW * 32)
cclm_block_kernel(const int32_t* __restrict__ refs, const int32_t* __restrict__ ry,
                  const int32_t* __restrict__ ou, const int32_t* __restrict__ ov,
                  const int32_t* __restrict__ og, const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ pred, int B, int bd, int H, int W, int Hc,
                  int Wc, int GH, int GW, int32_t* __restrict__ pred_out,
                  int32_t* __restrict__ use_out) {
    __shared__ Stage<P, NW> s;
    cclm_cu<P, NW, true>(s, blockIdx.x, threadIdx.x, refs, ry, ou, ov, og, rows, pred, B, bd,
                         H, W, Hc, Wc, GH, GW, pred_out, use_out);
}

// At pads up to K6A_TEAM_PAD: one warp per CU, K6A_TEAM_CUS CUs a block.
template <int P>
__global__ void __launch_bounds__(K6A_TEAM_CUS * 32)
cclm_team_kernel(const int32_t* __restrict__ refs, const int32_t* __restrict__ ry,
                 const int32_t* __restrict__ ou, const int32_t* __restrict__ ov,
                 const int32_t* __restrict__ og, const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ pred, int B, int bd, int H, int W, int Hc,
                 int Wc, int GH, int GW, int32_t* __restrict__ pred_out,
                 int32_t* __restrict__ use_out) {
    __shared__ Stage<P, 1> s[K6A_TEAM_CUS];
    const int warp = threadIdx.x >> 5, b = blockIdx.x * K6A_TEAM_CUS + warp;
    if (b >= B) return;
    cclm_cu<P, 1, false>(s[warp], b, threadIdx.x & 31, refs, ry, ou, ov, og, rows, pred, B,
                         bd, H, W, Hc, Wc, GH, GW, pred_out, use_out);
}

template <int P>
static void launch(const int32_t* refs, const int32_t* ry, const int32_t* ou,
                   const int32_t* ov, const int32_t* og, const int32_t* rows,
                   const int32_t* pred, int B, int bd, int H, int W, int Hc, int Wc, int GH,
                   int GW, int32_t* pred_out, int32_t* use_out, cudaStream_t stream) {
    if constexpr (P <= K6A_TEAM_PAD) {
        cclm_team_kernel<P><<<(B + K6A_TEAM_CUS - 1) / K6A_TEAM_CUS, K6A_TEAM_CUS * 32, 0,
                              stream>>>(refs, ry, ou, ov, og, rows, pred, B, bd, H, W, Hc, Wc,
                                        GH, GW, pred_out, use_out);
    } else {
        constexpr int NW = K6A_WARPS ? K6A_WARPS : (P >= 32 ? 16 : 8);
        cclm_block_kernel<P, NW><<<B, NW * 32, 0, stream>>>(
            refs, ry, ou, ov, og, rows, pred, B, bd, H, W, Hc, Wc, GH, GW, pred_out, use_out);
    }
}

extern "C" int pmp_cclm(const int32_t* refs, const int32_t* ry, const int32_t* ou,
                        const int32_t* ov, const int32_t* og, const int32_t* rows,
                        const int32_t* pred, int B, int P, int bd, int H, int W, int Hc,
                        int Wc, int GH, int GW, int32_t* pred_out, int32_t* use_out,
                        cudaStream_t stream) {
    if (B == 0) return 0;
    switch (P) {                       // the chroma pads of the wave path and the RDO
        case 4: launch<4>(refs, ry, ou, ov, og, rows, pred, B, bd, H, W, Hc, Wc, GH, GW,
                          pred_out, use_out, stream); break;
        case 8: launch<8>(refs, ry, ou, ov, og, rows, pred, B, bd, H, W, Hc, Wc, GH, GW,
                          pred_out, use_out, stream); break;
        case 16: launch<16>(refs, ry, ou, ov, og, rows, pred, B, bd, H, W, Hc, Wc, GH, GW,
                            pred_out, use_out, stream); break;
        case 32: launch<32>(refs, ry, ou, ov, og, rows, pred, B, bd, H, W, Hc, Wc, GH, GW,
                            pred_out, use_out, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
