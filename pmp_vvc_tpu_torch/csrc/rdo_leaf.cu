// K9: the device RDO's open-loop leaf costs (K9a, K9b, K9c).
//
// Replaces pmp_vvc_tpu/codec/rdo_device.py:_leaf_cost_fn (77-138) and
// _chroma_leaf_cost_fn (580-648), whose other steps run on the port's K1
// (references from the original planes, every in-frame sample available),
// K5 (the luma round trips, MTS only), K4 (the chroma round trips) and K6a
// (LM against the chosen chroma candidate). ops/rdo_generic.py composes
// them. Padding rows (live == 0) give zeros, mode 0 and cost 0.
//
// K9a rdo_luma_select (rdo_device.py:83-121): RMD over the 35 modes
//   [0, 1] + range(2, 67, 2) by masked Hadamard SATD against the original,
//   the first minimum winning (jnp.argmin), with no +-1 refinement (K2
//   refines, the RDO does not). Writes the mode, its luma prediction, and
//   the DM predictions of U and V with that mode on the unfiltered chroma
//   references (chroma sides of 2 included), zero outside the rect.
//
//   Bound: operations, int32 (chip_smoke.py:rdo_bounds): 35 predictions of
//   every sample and each one's share of a Hadamard SATD, then the winner's
//   luma and chroma predictions; the bytes (references, the original, the
//   three output tiles) are a few per sample. The RDO calls it on chunks of
//   512-16,384 rects, so the card is full without a cluster; what a rect
//   costs is its chain of loads, passes and the argmin. The design:
//
//   - A team per rect: one warp at pads up to K9A_TEAM_PAD (8), K9A_WARPS
//     (4) rects a block, __syncwarp only; above it a block per rect of
//     K9A_WARPS_LARGE (16) warps at the 64-pad class and in proportion to
//     the pad below it (8 at the 32-pad, 4 at the 16-pad class). No
//     cluster and no remote atomic (ROADMAP queue 3).
//   - Every load of a thread (the row's references, U and V's, the
//     original tile (at most 8 samples a thread at once), the 35
//     candidates' luma and chroma table entries) is issued before any is
//     stored; the original goes to shared memory with a padded stride, the
//     mode parameters once per rect (mode_table, DC by warp_dc).
//   - The work is (candidate, tile) items in passes of 32 / TS tiles (TS 8,
//     or 4 when a side is 4), one tile line a lane: a row, or for a
//     horizontal mode a column. An 8x8 rect puts 4 candidates in a pass, a
//     4x4 one 8, a 4x8 one 4 of 2 tiles each; a candidate of more tiles
//     than a pass spans passes. Each lane predicts its line into registers
//     (k9a_line: intra_pred.cuh's predict_line without the branches that
//     the candidates of a pass would take apart), the warp takes the tiles'
//     SATD in registers and shuffles (satd.cuh: warp_tile_satd), aligned
//     shuffles sum a candidate's tiles, and its first lane stores the sum
//     (or adds it, when the candidate spans passes) in the team's shared
//     slots. The block form spreads the passes over its warps.
//   - One warp takes the least (cost << 32) | k over the 35 slots by
//     shuffles: exactly the first minimum.
//   - The team writes the winner's P x P luma tile and the two chroma
//     tiles (half the team each) a line of up to four samples a thread.
//   - No tensor cores: after one Hadamard pass an 8x8 tile's values pass
//     fp16's exact integers (+-2,048), and int8 cannot hold the 11-bit
//     differences. No TMA: a rect reads at most ~18 KB, once.
//   ptxas: 56 registers at the 8- and 16-pad classes, 62 at the 32-pad, 64
//   at the 64-pad, no stack frame, no spills. What is left above the bound
//   is the line predictions' index and PDPC arithmetic, the SATD's shuffles
//   and each rect's fixed chain (PERF.md §6).
// K9b rdo_chroma_select (rdo_device.py:588-617): the dual-tree chroma
//   candidates {planar, DC, HOR, VER} on U and V, scored by joint U+V SATD
//   on tiles over the sides rounded up to 4 (8x8 where both are 8 or more),
//   differences zero beyond the rect; the first minimum wins. Writes both
//   predictions (zero outside the rect) and the winning SATD.
//
//   Bound: operations at every class's chunk (chip_smoke.py:rdo_bounds:
//   four candidate predictions of every tile sample on both planes, their
//   SATDs and the winner's predictions, int32); the bytes (the unfiltered
//   top and left rows of U and V, the originals, both output tiles) come
//   within 1.35x of it at every class. At the 8-pad class a
//   rect is at most 4x4 chroma samples, so what it costs is its share of
//   the launch and its chain of loads, one pass and the argmin. The
//   design, K9a's:
//
//   - A team per rect: one warp at chroma pads up to K9B_TEAM_PAD (8),
//     K9B_WARPS (4) rects a block, __syncwarp only; above it a block per
//     rect of K9B_WARPS_LARGE (8) warps at the 32 chroma pad and in
//     proportion to the pad below it (4 at 16). No cluster, no remote atomic.
//   - Every load of a thread (U's and V's top and left rows, rows 0 and 1
//     of each plane's four in K1's (2, 4, B, 2Pc+3) output: no chroma mode
//     takes the filtered rows; both original tiles by clamped reads inside
//     the rect)
//     is issued before any is stored; the originals go to shared memory with
//     a padded stride, each plane's four mode parameters once per rect
//     (mode_table, DC by warp_dc).
//   - The work is (candidate, plane, tile) items in passes of 32 / TS tiles,
//     one tile line a lane: planar and DC by predict_sample, HOR and VER by
//     k9a_line (a row, or for HOR a column); the warp takes the tiles' SATD
//     with warp_tile_satd. A candidate's U and V tiles are adjacent aligned
//     lane groups, so aligned shuffles sum its joint cost. At the 8-pad
//     class 4 candidates x 2 planes x one 4x4 tile x 4 lines is one pass of
//     32 lanes.
//   - One warp takes the least (cost << 32) | k over the four slots, exactly
//     the first minimum (the costs are non-negative int32); the team writes
//     both winner tiles with k9a_lines, U on half the team, V on the other.
// K9c rdo_leaf_cost (rdo_device.py:122-136, 636-646): each plane's SSE of
//   the round trip's recon against the original, exact in int64 and rounded
//   to float32 once, and the rate proxy of its levels, 8 + nz + sum(2 *
//   bitlen|l| + 1), over the rect (K4 and K5 leave the levels beyond it
//   zero, so this is the plain version's count over the whole tile). Luma
//   tree: sse + lam * (bits + 6); chroma tree: lam * 2; then for U, then V,
//   + dw * sse_c + lam * bits_c, each operation rounded to float32 in the
//   JAX package's order (__fmul_rn / __fadd_rn, never contracted).
//
//   Bound: bytes (chip_smoke.py:rdo_bounds): every QP point's levels and
//   recon, and the originals once. The design:
//
//   - A team per rect, not per (QP point, rect), its originals read once
//     for every QP point, as the bound counts them (the label search calls
//     it with four).
//   - At pads up to K9C_TEAM_PAD (16) a warp per rect, K9C_WARPS (8) rects
//     a block: a lane owns units of four samples of a tile row, the luma
//     tile's (luma tree), then U's and V's. It requests the first QP
//     point's 16-byte level and recon loads of its units with the row
//     (their places depend on the rect's index alone, and these rects fill
//     much of their tiles), keeps its originals inside the rect in
//     registers, and issues each later point's loads inside the rect and its
//     cost parameters before it uses them.
//   - Above it a block per rect of K9C_WARPS_LARGE (8) warps at the 64-pad
//     class, in proportion to the pad below it (4 at 32), at most 64
//     registers a thread so that several blocks share an SM: units number
//     the samples inside the rect, row by row, so that a skinny rect of a
//     large class costs what its samples cost; a thread takes its units two
//     at a time, every load of the pair first, and keeps their originals in
//     its own slots of shared memory for the later QP points.
//   - The sums are integers (SSEs in int64, the three rate proxies packed in
//     one 64-bit word): a warp's by __shfl_xor_sync, four 64-bit words in
//     six exchanges (a reduce-scatter, then a gather); the warp form has no
//     barrier, the block form adds its warps' sums into shared memory, one
//     barrier for up to K9C_QCHUNK (4) QP points. Any order gives the same
//     sums, so the costs equal the plain version's exactly.
// chip_smoke.py computes the bound of each call it times.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_pred.cuh"
#include "satd.cuh"

#define NRMD 35                        // planar, DC, the 33 even angulars
#define NCC 4                          // the chroma tree's candidates
#define FULL 0xffffffffu

__constant__ int CHROMA_CAND[NCC] = {0, 1, 18, 50};

static __device__ __forceinline__ int rmd_mode(int k) { return k < 2 ? k : 2 * (k - 1); }

static __device__ Cu make_cu(int w, int h, int P, int bd, int luma, const int32_t* ref,
                             int L, const int32_t* tabs) {
    Cu c;
    c.w = w; c.h = h; c.lw = ilog2(w); c.lh = ilog2(h);
    c.P = P; c.L = L; c.pel_max = (1 << bd) - 1; c.luma = luma;
    c.tu = ref; c.lu = ref + L; c.tf = ref + 2 * L; c.lf = ref + 3 * L;
    c.tabs = tabs;
    return c;
}

// ---------------------------------------------------------------------------
// K9a
// ---------------------------------------------------------------------------

// The kernel's shape. One value of each ships; chip_smoke.py's K9A_VARIANTS
// builds the others to time them beside it.
#ifndef K9A_TEAM_PAD
#define K9A_TEAM_PAD 8                 // pads up to this: a warp per rect
#endif
#ifndef K9A_WARPS
#define K9A_WARPS 4                    // rects (warps) a block at those pads
#endif
#ifndef K9A_WARPS_LARGE
#define K9A_WARPS_LARGE 16             // warps a block (one rect) at the 64-pad class,
#endif                                 // in proportion to the pad below it

// One rect's shared state: its references (luma; U and V), the original
// with a padded row stride, the 35 candidates' parameters and costs.
template <int P>
struct K9aRect {
    int32_t ref[4 * (2 * P + 3)];
    int32_t cref[2][4 * (P + 3)];
    int32_t org[P * (P + 1)];
    Mode mode[NRMD];                   // luma parameters, DC's value included
    Mode cmode[NRMD];                  // chroma parameters, DC's value not
    int cost[NRMD];
    int best;
};

template <bool WARP>
static __device__ __forceinline__ void team_sync() {
    if (WARP) __syncwarp();
    else __syncthreads();
}

// intra_pred.cuh's predict_line without branches that the lanes of a pass
// take apart (a pass mixes candidates): each reference of the window is
// one load from a selected address, and the PDPC step runs on every sample
// with a weight of 0 where it does not apply ((0 * d + 32) >> 6 is 0).
// Where no active lane needs the side projection or the PDPC step, the
// warp skips it. The TS samples x0 .. x0 + TS - 1 of line y in the mode's
// own space (a row for a vertical mode, a CU column for a horizontal one);
// p.mode >= 2. Equal to predict_line.
template <int TS>
static __device__ __forceinline__ void k9a_line(const Cu& c, const Mode& p, int y, int x0,
                                                int (&out)[TS]) {
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
    const unsigned active = __activemask();
    int v[TS + 3];                         // reference samples x0 + i + dint
    if (__any_sync(active, dint + x0 < 0)) {
#pragma unroll
        for (int i = 0; i < TS + 3; ++i) {
            const int idx = min(P + dint + x0 + i, ltot - 1);
            const int j = P - idx;         // > 0: the negative-angle side projection
            v[i] = idx >= P ? main[idx - P]
                            : side[clampi(min((j * p.inv + 256) >> 9, hp), 0, L - 1)];
        }
    } else {
#pragma unroll
        for (int i = 0; i < TS + 3; ++i) v[i] = main[min(dint + x0 + i, L - 1)];
    }
#pragma unroll
    for (int j = 0; j < TS; ++j) {
        const int acc = f[0] * v[j] + f[1] * v[j + 1] + f[2] * v[j + 2] + f[3] * v[j + 3];
        out[j] = clampi((acc + 32) >> 6, 0, c.pel_max);
    }
    // PDPC: angle 0 adds a weighted (side[1 + y] - main[0]) and clips; the
    // others weigh the projected side sample against the prediction
    const bool a0 = p.angle == 0;
    const int sc = a0 ? (lwp + lhp - 2) >> 2 : p.scale;
    const int lim = !p.pdpc ? 0 : a0 ? min(3 << sc, wp) : min(min(16, P), min(3 << sc, wp));
    if (!__any_sync(active, x0 < lim)) return;
    const int d0 = side[1 + y] - main[0];
#pragma unroll
    for (int j = 0; j < TS; ++j) {
        const int x = x0 + j;
        const int wl = x < lim ? 32 >> min(31, (2 * x) >> sc) : 0;
        const int sv = side[clampi(y + ((256 + (x + 1) * p.inv) >> 9) + 1, 0, L - 1)];
        const int q = out[j] + ((wl * (a0 ? d0 : sv - out[j]) + 32) >> 6);
        out[j] = a0 ? clampi(q, 0, c.pel_max) : q;
    }
}

// The passes first, first + step, ... of the (candidate, tile) items of the
// rect: pass q holds items q * 32/TS .. of 35 * ntiles, item i being tile
// i mod ntiles of candidate i / ntiles, one tile a group of TS lanes and
// one tile line a lane (a row for planar, DC and the vertical modes, a
// column for the horizontal ones: the tile transposed, which leaves its
// SATD as it is). A candidate's tiles are aligned groups of the warp, so
// aligned shuffles sum them; its first lane stores the sum into ``cost``,
// or adds it where the candidate spans passes (``cost`` zeroed then).
template <int TS, int OS>
static __device__ void k9a_passes(const Cu& c, const int32_t* sorg, const Mode* smode,
                                  int* cost, int first, int step) {
    constexpr int PER = 32 / TS, LTS = TS == 8 ? 3 : 2;
    const int lane = threadIdx.x & 31, l = lane % TS, g = lane / TS;
    const int lnx = c.lw - LTS, lnt = lnx + c.lh - LTS, ntiles = 1 << lnt;
    const int seg = min(ntiles, PER) * TS;        // lanes of one candidate in a pass
    const int items = NRMD << lnt, npass = (items + PER - 1) / PER;
    for (int q = first; q < npass; q += step) {
        const int i = q * PER + g, k = i >> lnt, t = i & (ntiles - 1);
        int d[TS];
        if (i < items) {
            const Mode p = smode[k];
            const int ty = (t >> lnx) * TS, tx = (t & ((1 << lnx) - 1)) * TS;
            if (p.mode < 2) {
#pragma unroll
                for (int j = 0; j < TS; ++j)
                    d[j] = sorg[(ty + l) * OS + tx + j] - predict_sample(c, p, ty + l, tx + j);
            } else {                   // a row, or a column of a horizontal mode
                int pred[TS];
                k9a_line<TS>(c, p, p.ver ? ty + l : tx + l, p.ver ? tx : ty, pred);
                const int32_t* o = sorg + (p.ver ? (ty + l) * OS + tx : ty * OS + tx + l);
                const int st = p.ver ? 1 : OS;
#pragma unroll
                for (int j = 0; j < TS; ++j) d[j] = o[j * st] - pred[j];
            }
        } else {
#pragma unroll
            for (int j = 0; j < TS; ++j) d[j] = 0;
        }
        int v = warp_tile_satd<TS>(d);
        for (int o = TS; o < seg; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
        if (i < items && (lane & (seg - 1)) == 0) {
            if (ntiles <= PER) cost[k] = v;
            else atomicAdd(cost + k, v);
        }
    }
}

// The P x P tile of mode p, zero outside the (h, w) rect, N samples of a
// line a thread (threads tid of nthr): along a row, or for a horizontal
// mode along a column (k9a_line), so that neighbouring threads store
// neighbouring samples. K2's write_lines (csrc/intra_rmd.cu) for a team of
// any size.
template <int N, int P>
static __device__ void k9a_lines(const Cu& c, const Mode& p, int32_t* out, int tid, int nthr) {
    const bool hor = p.mode >= 2 && !p.ver;
    const int nl = hor ? c.w : c.h, ns = hor ? c.h : c.w;    // lines, samples a line
    for (int i = tid; i < P * P / N; i += nthr) {
        const int a = hor ? i % P : i / (P / N), s0 = N * (hor ? i / P : i % (P / N));
        int v[N];
#pragma unroll
        for (int j = 0; j < N; ++j) v[j] = 0;
        if (a < nl && s0 < ns) {
            if (p.mode >= 2) {
                k9a_line<N>(c, p, a, s0, v);
            } else {
#pragma unroll
                for (int j = 0; j < N; ++j) v[j] = predict_sample(c, p, a, s0 + j);
            }
#pragma unroll
            for (int j = 0; j < N; ++j) v[j] = s0 + j < ns ? v[j] : 0;    // chroma sides of 2
        }
#pragma unroll
        for (int j = 0; j < N; ++j) out[hor ? (s0 + j) * P + a : a * P + s0 + j] = v[j];
    }
}

// Warps of the block form at pad P: K9A_WARPS_LARGE at the 64-pad class, in
// proportion to the pad below it (4 at the 16-pad class), at least one.
static __host__ __device__ constexpr int k9a_block_warps(int P) {
    return K9A_WARPS_LARGE * P / 64 < 1 ? 1 : K9A_WARPS_LARGE * P / 64;
}

// Samples a thread writes: one round of the team, one to four of them.
static __host__ __device__ constexpr int clamp_n(int v) {
    return v < 1 ? 1 : (v > 4 ? 4 : v);
}

// A team per rect: WARP, a warp (K9A_WARPS rects a block); else the block.
template <int P, bool WARP>
__global__ void __launch_bounds__(32 * (WARP ? K9A_WARPS : k9a_block_warps(P)))
rdo_luma_select_kernel(const int32_t* __restrict__ refs, const int32_t* __restrict__ crefs,
                       const int32_t* __restrict__ org, const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ tabs_l, const int32_t* __restrict__ tabs_c,
                       int B, int bd, int H, int W, int32_t* __restrict__ modes,
                       int32_t* __restrict__ pred, int32_t* __restrict__ cpred) {
    constexpr int NT = WARP ? 32 : 32 * k9a_block_warps(P);  // a team's threads
    constexpr int NTEAM = WARP ? K9A_WARPS : 1;              // teams a block
    constexpr int L = 2 * P + 3, Pc = P / 2, Lc = P + 3, OS = P + 1;
    constexpr int NR = (4 * L + NT - 1) / NT, NCR = (8 * Lc + NT - 1) / NT;
    constexpr int NO = (P * P + NT - 1) / NT;
    constexpr int NOB = NO < 8 ? NO : 8;  // original samples a thread holds at once
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tid = WARP ? lane : threadIdx.x;
    const int b = blockIdx.x * NTEAM + (WARP ? warp : 0);
    if (b >= B) return;                // the warp form's last block: whole warps
    __shared__ K9aRect<P> rect[NTEAM];
    K9aRect<P>& s = rect[WARP ? warp : 0];
    const int32_t* r = rows + 8 * b;
    const int fi = r[0], xs = r[1], ys = r[2], w = r[3], h = r[4], live = r[6];
    int32_t* out = pred + (size_t)b * P * P;
    int32_t* cout_u = cpred + (size_t)b * Pc * Pc;
    int32_t* cout_v = cpred + ((size_t)B + b) * Pc * Pc;
    if (live <= 0) {                   // padding row: team-uniform
        for (int i = tid; i < P * P; i += NT) out[i] = 0;
        for (int i = tid; i < Pc * Pc; i += NT) cout_u[i] = cout_v[i] = 0;
        if (tid == 0) modes[b] = 0;
        return;
    }

    // every load before any store: the references, U's and V's, the
    // original tile (zero beyond the rect; at most NOB samples a thread at
    // once), the 35 candidates' luma and chroma tables
    const int lw = ilog2(w);
    int rv[NR], cv[NCR], ov[NOB];
#pragma unroll
    for (int t = 0; t < NR; ++t) {
        const int e = tid + t * NT, k = e / L;
        rv[t] = e < 4 * L ? refs[((size_t)k * B + b) * L + e - k * L] : 0;
    }
#pragma unroll
    for (int t = 0; t < NCR; ++t) {
        const int e = tid + t * NT, k = e / Lc;
        cv[t] = e < 8 * Lc ? crefs[((size_t)k * B + b) * Lc + e - k * Lc] : 0;
    }
#pragma unroll
    for (int t0 = 0; t0 < NO; t0 += NOB) {
#pragma unroll
        for (int t = 0; t < NOB; ++t) {
            const int e = tid + (t0 + t) * NT, y = e >> lw, x = e & (w - 1);
            ov[t] = e < w * h ? org[((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W +
                                    clampi(xs + x, 0, W - 1)]
                              : 0;
        }
        if (t0 == 0) {
            const Cu c = make_cu(w, h, P, bd, 1, s.ref, L, tabs_l);
            const Cu cc = make_cu(w / 2, h / 2, Pc, bd, 0, s.cref[0], Lc, tabs_c);
            for (int k = tid; k < NRMD; k += NT) {
                s.mode[k] = mode_table(c, rmd_mode(k));
                s.cmode[k] = mode_table(cc, rmd_mode(k));
                s.cost[k] = 0;
            }
#pragma unroll
            for (int t = 0; t < NR; ++t)
                if (tid + t * NT < 4 * L) s.ref[tid + t * NT] = rv[t];
#pragma unroll
            for (int t = 0; t < NCR; ++t) {
                const int e = tid + t * NT;
                if (e < 8 * Lc) s.cref[e >= 4 * Lc][e - (e >= 4 * Lc) * 4 * Lc] = cv[t];
            }
        }
#pragma unroll
        for (int t = 0; t < NOB; ++t) {
            const int e = tid + (t0 + t) * NT;
            if (e < w * h) s.org[(e >> lw) * OS + (e & (w - 1))] = ov[t];
        }
    }
    const Cu c = make_cu(w, h, P, bd, 1, s.ref, L, tabs_l);
    team_sync<WARP>();                 // the references are in: DC sums them
    if (WARP || warp == 0) {
        const int dc = warp_dc(c);
        if (lane == 0) s.mode[1].dc = dc;
    }
    team_sync<WARP>();

    if (min(w, h) >= 8)
        k9a_passes<8, OS>(c, s.org, s.mode, s.cost, WARP ? 0 : warp, NT / 32);
    else
        k9a_passes<4, OS>(c, s.org, s.mode, s.cost, WARP ? 0 : warp, NT / 32);
    team_sync<WARP>();                 // the 35 costs are in

    int kb = 0;
    if (WARP || warp == 0) {           // the first minimum: the least (cost, k) key
        unsigned long long key = ~0ull;
        for (int k = lane; k < NRMD; k += 32) {
            const unsigned long long kk = ((unsigned long long)s.cost[k] << 32) | (unsigned)k;
            key = kk < key ? kk : key;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long kk = __shfl_xor_sync(FULL, key, o);
            key = kk < key ? kk : key;
        }
        kb = (int)(key & 0xffffffffu);
        if (!WARP && lane == 0) s.best = kb;
    }
    if (!WARP) {
        __syncthreads();
        kb = s.best;
    }
    const int m = rmd_mode(kb);
    if (tid == 0) modes[b] = m;
    k9a_lines<clamp_n(P * P / NT), P>(c, s.mode[kb], out, tid, NT);

    // the DM predictions: U on the team's first half, V on its second
    const int half = tid >= NT / 2;
    const Cu cc = make_cu(w / 2, h / 2, Pc, bd, 0, half ? s.cref[1] : s.cref[0], Lc, tabs_c);
    Mode pc = s.cmode[kb];
    if (m == 1) {                      // team-uniform: whole warps sum each plane
        const int dc_u = warp_dc(make_cu(w / 2, h / 2, Pc, bd, 0, s.cref[0], Lc, tabs_c));
        const int dc_v = warp_dc(make_cu(w / 2, h / 2, Pc, bd, 0, s.cref[1], Lc, tabs_c));
        pc.dc = half ? dc_v : dc_u;
    }
    k9a_lines<clamp_n(Pc * Pc / (NT / 2)), Pc>(cc, pc, half ? cout_v : cout_u,
                                              tid - half * (NT / 2), NT / 2);
}

template <int P>
static int launch_luma_select(const int32_t* refs, const int32_t* crefs, const int32_t* org,
                              const int32_t* rows, const int32_t* tabs_l,
                              const int32_t* tabs_c, int B, int bd, int H, int W,
                              int32_t* modes, int32_t* pred, int32_t* cpred,
                              cudaStream_t stream) {
    if constexpr (P <= K9A_TEAM_PAD)
        rdo_luma_select_kernel<P, true><<<(B + K9A_WARPS - 1) / K9A_WARPS, 32 * K9A_WARPS, 0,
                                          stream>>>(refs, crefs, org, rows, tabs_l, tabs_c, B,
                                                    bd, H, W, modes, pred, cpred);
    else
        rdo_luma_select_kernel<P, false><<<B, 32 * k9a_block_warps(P), 0, stream>>>(
            refs, crefs, org, rows, tabs_l, tabs_c, B, bd, H, W, modes, pred, cpred);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9b
// ---------------------------------------------------------------------------

// The kernel's shape, at chroma pads Pc (4, 8, 16, 32). One value of each
// ships; chip_smoke.py's K9B_VARIANTS builds the others to time them.
#ifndef K9B_TEAM_PAD
#define K9B_TEAM_PAD 8                 // chroma pads up to this: a warp per rect
#endif
#ifndef K9B_WARPS
#define K9B_WARPS 4                    // rects (warps) a block at those pads
#endif
#ifndef K9B_WARPS_LARGE
#define K9B_WARPS_LARGE 8              // warps a block (one rect) at the 32 chroma pad,
#endif                                 // in proportion to the pad below it

// One rect's shared state: U's and V's unfiltered reference rows (top,
// left: chroma never takes the filtered ones, whose flag is 0 in every
// chroma table), originals with a padded row stride, the candidates'
// parameters per plane (DC's value included) and their joint costs.
template <int Pc>
struct K9bRect {
    int32_t cref[2][2 * (2 * Pc + 3)];
    int32_t org[2][Pc * (Pc + 1)];
    Mode mode[2][NCC];
    int cost[NCC];
    int best;
};

// The passes first, first + step, ... of the rect's (candidate, plane,
// tile) items over the sides rounded up to 4 (1 << lnx tiles a row, 1 <<
// lnt in all): item i is tile i mod ntiles of plane (i / ntiles) mod 2 of
// candidate i / (2 ntiles); a tile a group of TS lanes, a tile line a lane
// (a row, or for HOR a column: the tile transposed, which leaves its SATD as
// it is). Differences beyond the (h, w) rect are zero (chroma sides of 2).
// A candidate's U and V tiles are adjacent aligned groups, so aligned
// shuffles sum its joint cost; its first lane stores it into ``cost``, or
// adds it where the candidate spans passes (``cost`` zeroed then). ``cref``
// (the top and left rows) and ``sorg`` hold U's then V's (strides CS and
// OSZ), ``smode`` U's four candidates then V's.
template <int TS, int Pc>
static __device__ void k9b_passes(int w, int h, int bd, const int32_t* cref,
                                  const int32_t* sorg, const Mode* smode,
                                  const int32_t* tabs, int* cost, int lnx, int lnt, int first,
                                  int step) {
    constexpr int PER = 32 / TS, Lc = 2 * Pc + 3, CS = 2 * Lc, OS = Pc + 1, OSZ = Pc * OS;
    const int lane = threadIdx.x & 31, l = lane % TS, g = lane / TS;
    const int ntiles = 1 << lnt, items = (2 * NCC) << lnt;   // a multiple of PER
    const int seg = min(2 * ntiles, PER) * TS;   // lanes of one candidate in a pass
    for (int q = first; q < items / PER; q += step) {
        const int i = q * PER + g, k = i >> (lnt + 1), pl = (i >> lnt) & 1;
        const int t = i & (ntiles - 1);
        const Cu c = make_cu(w, h, Pc, bd, 0, cref + pl * CS, Lc, tabs);
        const Mode p = smode[pl * NCC + k];
        const int32_t* o = sorg + pl * OSZ;
        const int ty = (t >> lnx) * TS, tx = (t & ((1 << lnx) - 1)) * TS;
        int d[TS];
        if (p.mode < 2) {              // planar, DC: row ty + l
            const int y = ty + l;
#pragma unroll
            for (int j = 0; j < TS; ++j) {
                const int x = tx + j, v = o[y * OS + x] - predict_sample(c, p, y, x);
                d[j] = y < h && x < w ? v : 0;
            }
        } else {                       // VER: row ty + l; HOR: column tx + l
            int pred[TS];
            k9a_line<TS>(c, p, p.ver ? ty + l : tx + l, p.ver ? tx : ty, pred);
#pragma unroll
            for (int j = 0; j < TS; ++j) {
                const int y = p.ver ? ty + l : ty + j, x = p.ver ? tx + j : tx + l;
                const int v = o[y * OS + x] - pred[j];
                d[j] = y < h && x < w ? v : 0;
            }
        }
        int v = warp_tile_satd<TS>(d);
        for (int off = TS; off < seg; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
        if ((lane & (seg - 1)) == 0) {
            if (2 * ntiles <= PER) cost[k] = v;
            else atomicAdd(cost + k, v);
        }
    }
}

// Warps of the block form at chroma pad Pc: K9B_WARPS_LARGE at 32, in
// proportion to the pad below it, at least one.
static __host__ __device__ constexpr int k9b_block_warps(int Pc) {
    return K9B_WARPS_LARGE * Pc / 32 < 1 ? 1 : K9B_WARPS_LARGE * Pc / 32;
}

// A team per rect: WARP, a warp (K9B_WARPS rects a block); else the block.
template <int Pc, bool WARP>
__global__ void __launch_bounds__(32 * (WARP ? K9B_WARPS : k9b_block_warps(Pc)))
rdo_chroma_select_kernel(const int32_t* __restrict__ crefs, const int32_t* __restrict__ ou,
                         const int32_t* __restrict__ ov, const int32_t* __restrict__ rows,
                         const int32_t* __restrict__ tabs_c, int B, int bd, int Hc, int Wc,
                         int32_t* __restrict__ pred, int32_t* __restrict__ satd_out) {
    constexpr int NT = WARP ? 32 : 32 * k9b_block_warps(Pc);  // a team's threads
    constexpr int NTEAM = WARP ? K9B_WARPS : 1;               // teams a block
    constexpr int Lc = 2 * Pc + 3, OS = Pc + 1, LP = Pc == 4 ? 2 : Pc == 8 ? 3 : Pc == 16 ? 4 : 5;
    constexpr int NCR = (4 * Lc + NT - 1) / NT, NO = (2 * Pc * Pc + NT - 1) / NT;
    constexpr int NOB = NO < 8 ? NO : 8;  // original samples a thread holds at once
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tid = WARP ? lane : threadIdx.x;
    const int b = blockIdx.x * NTEAM + (WARP ? warp : 0);
    if (b >= B) return;                // the warp form's last block: whole warps
    __shared__ K9bRect<Pc> rect[NTEAM];
    K9bRect<Pc>& s = rect[WARP ? warp : 0];
    const int32_t* r = rows + 8 * b;
    const int fi = r[0], xs = r[1] / 2, ys = r[2] / 2, w = r[3] / 2, h = r[4] / 2, live = r[6];
    int32_t* out_u = pred + (size_t)b * Pc * Pc;
    int32_t* out_v = pred + ((size_t)B + b) * Pc * Pc;
    if (live <= 0) {                   // padding row: team-uniform
        for (int i = tid; i < Pc * Pc; i += NT) out_u[i] = out_v[i] = 0;
        if (tid == 0) satd_out[b] = 0;
        return;
    }

    // every load before any store: U's and V's top and left rows (rows 0
    // and 1 of each plane's four in K1's (2, 4, B, Lc) output), then both
    // original tiles (clamped reads inside the rect, at most NOB samples a
    // thread at once), the candidates' tables of both planes
    int cv[NCR], ovv[NOB];
#pragma unroll
    for (int t = 0; t < NCR; ++t) {
        const int e = tid + t * NT, k = e / Lc;    // k = 2 plane + row: K1 row k + 2 (k >> 1)
        cv[t] = e < 4 * Lc ? crefs[((size_t)(k + (k >> 1) * 2) * B + b) * Lc + e - k * Lc] : 0;
    }
#pragma unroll
    for (int t0 = 0; t0 < NO; t0 += NOB) {
#pragma unroll
        for (int t = 0; t < NOB; ++t) {
            const int e = tid + (t0 + t) * NT, pl = e >> (2 * LP);
            const int y = (e >> LP) & (Pc - 1), x = e & (Pc - 1);
            ovv[t] = e < 2 * Pc * Pc && y < h && x < w
                         ? (pl ? ov : ou)[((size_t)fi * Hc + clampi(ys + y, 0, Hc - 1)) * Wc +
                                          clampi(xs + x, 0, Wc - 1)]
                         : 0;
        }
        if (t0 == 0) {
            for (int k = tid; k < 2 * NCC; k += NT) {
                const int pl = k / NCC;
                s.mode[pl][k % NCC] = mode_table(make_cu(w, h, Pc, bd, 0, s.cref[pl], Lc, tabs_c),
                                                 CHROMA_CAND[k % NCC]);
                if (k < NCC) s.cost[k] = 0;
            }
#pragma unroll
            for (int t = 0; t < NCR; ++t) {
                const int e = tid + t * NT;
                if (e < 4 * Lc) (&s.cref[0][0])[e] = cv[t];
            }
        }
#pragma unroll
        for (int t = 0; t < NOB; ++t) {
            const int e = tid + (t0 + t) * NT;
            if (e < 2 * Pc * Pc)
                s.org[e >> (2 * LP)][((e >> LP) & (Pc - 1)) * OS + (e & (Pc - 1))] = ovv[t];
        }
    }
    team_sync<WARP>();                 // the references are in: DC sums them
    if (WARP || warp == 0) {
        const int dc_u = warp_dc(make_cu(w, h, Pc, bd, 0, s.cref[0], Lc, tabs_c));
        const int dc_v = warp_dc(make_cu(w, h, Pc, bd, 0, s.cref[1], Lc, tabs_c));
        if (lane == 0) {
            s.mode[0][1].dc = dc_u;
            s.mode[1][1].dc = dc_v;
        }
    }
    team_sync<WARP>();

    // tiles over the sides rounded up to 4: 8x8 where both are 8 or more
    const int lsw = ilog2(max(w, 4)), lsh = ilog2(max(h, 4));
    const int first = WARP ? 0 : warp, step = NT / 32;
    if (Pc >= 8 && min(lsw, lsh) >= 3) {
        if constexpr (Pc >= 8)
            k9b_passes<8, Pc>(w, h, bd, &s.cref[0][0], &s.org[0][0], &s.mode[0][0], tabs_c,
                              s.cost, lsw - 3, lsw + lsh - 6, first, step);
    } else {
        k9b_passes<4, Pc>(w, h, bd, &s.cref[0][0], &s.org[0][0], &s.mode[0][0], tabs_c, s.cost,
                          lsw - 2, lsw + lsh - 4, first, step);
    }
    team_sync<WARP>();                 // the four joint costs are in

    int kb = 0;
    if (WARP || warp == 0) {           // the first minimum: the least (cost, k) key
        unsigned long long key =
            lane < NCC ? ((unsigned long long)s.cost[lane] << 32) | (unsigned)lane : ~0ull;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long kk = __shfl_xor_sync(FULL, key, o);
            key = kk < key ? kk : key;
        }
        kb = (int)(key & 0xffffffffu);
        if (lane == 0) {
            satd_out[b] = (int)(key >> 32);
            if (!WARP) s.best = kb;
        }
    }
    if (!WARP) {
        __syncthreads();
        kb = s.best;
    }
    // the winner's tiles: U on the team's first half, V on its second
    const int half = tid >= NT / 2;
    k9a_lines<clamp_n(Pc * Pc / (NT / 2)), Pc>(
        make_cu(w, h, Pc, bd, 0, s.cref[half], Lc, tabs_c), s.mode[half][kb],
        half ? out_v : out_u, tid - half * (NT / 2), NT / 2);
}

template <int Pc>
static int launch_chroma_select(const int32_t* crefs, const int32_t* ou, const int32_t* ov,
                                const int32_t* rows, const int32_t* tabs_c, int B, int bd,
                                int Hc, int Wc, int32_t* pred, int32_t* satd,
                                cudaStream_t stream) {
    if constexpr (Pc <= K9B_TEAM_PAD)
        rdo_chroma_select_kernel<Pc, true><<<(B + K9B_WARPS - 1) / K9B_WARPS, 32 * K9B_WARPS,
                                             0, stream>>>(crefs, ou, ov, rows, tabs_c, B, bd,
                                                          Hc, Wc, pred, satd);
    else
        rdo_chroma_select_kernel<Pc, false><<<B, 32 * k9b_block_warps(Pc), 0, stream>>>(
            crefs, ou, ov, rows, tabs_c, B, bd, Hc, Wc, pred, satd);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9c
// ---------------------------------------------------------------------------

// The kernel's shape. One value of each ships; chip_smoke.py's
// K9C_VARIANTS builds the others to time them beside it.
#ifndef K9C_TEAM_PAD
#define K9C_TEAM_PAD 16                // pads up to this: a warp per rect
#endif
#ifndef K9C_WARPS
#define K9C_WARPS 8                    // rects (warps) a block at those pads
#endif
#ifndef K9C_WARPS_LARGE
#define K9C_WARPS_LARGE 8              // warps a block (one rect) at the 64-pad class,
#endif                                 // in proportion to the pad below it

static __host__ __device__ constexpr int k9c_block_warps(int P) {
    return K9C_WARPS_LARGE * P / 64 < 1 ? 1 : K9C_WARPS_LARGE * P / 64;
}

// The sums of one QP point, four 64-bit words: the three planes' SSEs and
// their rate proxies packed 21 bits a plane (a 64x64 tile's proxy is below
// 2^18).
typedef long long K9cSums[4];

// The warp's sums of ``v`` over its lanes in six exchanges: a reduce-scatter
// (the lanes with bit 16 keep words 2 and 3 and send 0 and 1, those with bit
// 8 of the rest one word), then three butterfly steps and a gather, so that
// lane 0 ends with all four. Exact: integers, any order.
static __device__ __forceinline__ void warp_sums(K9cSums& v) {
    const int lane = threadIdx.x & 31;
    const bool u16 = lane & 16, u8 = lane & 8;
    long long k0 = u16 ? v[2] : v[0], k1 = u16 ? v[3] : v[1];
    k0 += __shfl_xor_sync(FULL, u16 ? v[0] : v[2], 16);
    k1 += __shfl_xor_sync(FULL, u16 ? v[1] : v[3], 16);
    long long k = u8 ? k1 : k0;        // word 2 * (lane >> 4 & 1) + (lane >> 3 & 1)
    k += __shfl_xor_sync(FULL, u8 ? k0 : k1, 8);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) k += __shfl_xor_sync(FULL, k, o);
#pragma unroll
    for (int w = 0; w < 4; ++w) v[w] = __shfl_sync(FULL, k, 8 * w);
}

// The JAX package's cost of one QP point from exact sums, each operation
// rounded to float32 in its order (never contracted).
static __device__ float leaf_cost(const K9cSums& v, int luma, float lam, float dw, float lam2) {
    float cost = lam2;                 // the chroma tree's mode bins
    if (luma) {
        const int bits = (int)(v[3] & 0x1fffff) + 8;
        cost = __fadd_rn(__ll2float_rn(v[0]), __fmul_rn(lam, __fadd_rn((float)bits, 6.0f)));
    }
#pragma unroll
    for (int pl = 1; pl < 3; ++pl) {
        const int bits = (int)((v[3] >> (21 * pl)) & 0x1fffff) + 8;
        cost = __fadd_rn(__fadd_rn(cost, __fmul_rn(dw, __ll2float_rn(v[pl]))),
                         __fmul_rn(lam, (float)bits));
    }
    return cost;
}

// One unit's sums into ``v``: the samples of mask ``msk`` (a bit each) of
// four levels, recon and originals of plane ``pl``.
static __device__ __forceinline__ void unit_sums(K9cSums& v, int pl, int msk, const int4& lv,
                                                 const int4& rv, const int4& ov) {
    const int lq[4] = {lv.x, lv.y, lv.z, lv.w}, rq[4] = {rv.x, rv.y, rv.z, rv.w};
    const int og[4] = {ov.x, ov.y, ov.z, ov.w};
    long long sse = 0;
    int bits = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const bool in = msk >> j & 1;
        const long long d = in ? (long long)rq[j] - og[j] : 0;
        sse += d * d;
        const int a = in ? abs(lq[j]) : 0;
        bits += a ? 2 * (32 - __clz(a)) + 2 : 0;   // magnitude + nonzero count
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) v[p] += pl == p ? sse : 0;
    v[3] += (long long)bits << (21 * pl);
}

// The four original samples x0 .. x0 + 3 of row y of a plane (H, W) of
// frame fi at (xs, ys), those of mask ``msk`` only; reads clamped.
static __device__ __forceinline__ int4 org_unit(const int32_t* plane, int fi, int H, int W,
                                                int xs, int ys, int y, int x0, int msk) {
    const int32_t* row = plane + ((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W;
    int o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = msk >> j & 1 ? row[clampi(xs + x0 + j, 0, W - 1)] : 0;
    return make_int4(o[0], o[1], o[2], o[3]);
}

// The warp form: a warp per rect, its tiles in units of four samples of a
// row (an int4 of the P-strided level and recon tiles): the luma tile's
// (luma tree), then U's, then V's; unit u is lane u mod 32's. The first QP
// point's tiles are requested whole with the row (their places depend on
// the rect's index alone; at pads up to 16 the rects fill much of the
// tile), the originals inside the rect once into registers, the later
// points' tiles inside the rect only, each with its cost parameters.
template <int P>
static __device__ void leaf_cost_warp(const int32_t* rows, const int32_t* oy, const int32_t* ou,
                                      const int32_t* ov, const int32_t* lev_l,
                                      const int32_t* rec_l, const int32_t* lev_c,
                                      const int32_t* rec_c, const float* params, int nqp, int B,
                                      int H, int W, int luma, float* cost_out, int b) {
    constexpr int Pc = P / 2, NUL = P * P / 4, NUC = Pc * Pc / 4;
    constexpr int NU = (NUL + 2 * NUC + 31) / 32;            // units a lane
    const int lane = threadIdx.x & 31;
    const int nul = luma ? NUL : 0, nu = nul + 2 * NUC;
    int pl[NU], off[NU], msk[NU];
    int4 lv[NU], rv[NU], org[NU];
    auto load = [&](int t, int q) {
        const size_t o = pl[t] ? off[t] + (size_t)q * 2 * B * Pc * Pc
                               : off[t] + (size_t)q * B * P * P;
        lv[t] = *reinterpret_cast<const int4*>((pl[t] ? lev_c : lev_l) + o);
        rv[t] = *reinterpret_cast<const int4*>((pl[t] ? rec_c : rec_l) + o);
    };
#pragma unroll
    for (int t = 0; t < NU; ++t) {     // plane (3: none), offset in a QP point's tiles
        const int u = lane + 32 * t, c = u >= nul, v = u - nul, p = c ? 1 + (v >= NUC) : 0;
        pl[t] = u < nu ? p : 3;
        off[t] = c ? ((p - 1) * B + b) * Pc * Pc + 4 * (v - (p - 1) * NUC) : b * P * P + 4 * u;
        if (pl[t] < 3) load(t, 0);
    }
    const int32_t* r = rows + 8 * b;
    if (r[6] <= 0) {                   // padding row
        for (int q = lane; q < nqp; q += 32) cost_out[(size_t)q * B + b] = 0.0f;
        return;
    }
    const int fi = r[0], xs = r[1], ys = r[2], w = r[3], h = r[4];
#pragma unroll
    for (int t = 0; t < NU; ++t) {
        const int c = pl[t] > 0, e = (off[t] & (c ? Pc * Pc - 1 : P * P - 1)) >> 2;  // in its tile
        const int y = c ? e / (Pc / 4) : e / (P / 4), x0 = c ? 4 * e % Pc : 4 * e % P;
        const int ww = c ? w / 2 : w, hh = c ? h / 2 : h;
        msk[t] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) msk[t] |= (pl[t] < 3 && y < hh && x0 + j < ww) << j;
        org[t] = org_unit(pl[t] == 0 ? oy : pl[t] == 1 ? ou : ov, fi, c ? H / 2 : H,
                          c ? W / 2 : W, c ? xs / 2 : xs, c ? ys / 2 : ys, y, x0, msk[t]);
    }
    for (int q = 0; q < nqp; ++q) {
        if (q > 0) {
#pragma unroll
            for (int t = 0; t < NU; ++t)       // every load of the QP point first
                if (msk[t]) load(t, q);
        }
        const float lam = params[3 * q], dw = params[3 * q + 1], lam2 = params[3 * q + 2];
        K9cSums v = {0, 0, 0, 0};
#pragma unroll
        for (int t = 0; t < NU; ++t)
            if (msk[t]) unit_sums(v, pl[t], msk[t], lv[t], rv[t], org[t]);
        warp_sums(v);
        if (lane == 0) cost_out[(size_t)q * B + b] = leaf_cost(v, luma, lam, dw, lam2);
    }
}

// QP points a block-form K9c team sums at once (its shared sums).
#define K9C_QCHUNK 4

// The block form: a block of NT threads per rect, its samples inside the
// rect in units of four of a row, numbered rect row by rect row (luma tree:
// the luma rows first), then U's and V's, so that a skinny rect of a large
// class costs what its samples cost. A thread takes units tid, tid + NT,
// ... two at a time (their levels, recon and, at the first QP point, the
// originals, all requested before any is used; the originals then kept in
// the unit's slot of shared memory for the later points) and adds each
// warp's sums of a QP point into shared memory: one barrier for up to
// K9C_QCHUNK QP points.
template <int P, int NT>
static __device__ void leaf_cost_block(const int32_t* rows, const int32_t* oy,
                                       const int32_t* ou, const int32_t* ov,
                                       const int32_t* lev_l, const int32_t* rec_l,
                                       const int32_t* lev_c, const int32_t* rec_c,
                                       const float* params, int nqp, int B, int H, int W,
                                       int luma, float* cost_out, int b) {
    constexpr int Pc = P / 2;
    __shared__ int4 sorg[P * P / 4 + Pc * Pc / 2];
    __shared__ unsigned long long red[K9C_QCHUNK][4];
    const int tid = threadIdx.x, lane = tid & 31;
    const int32_t* r = rows + 8 * b;
    if (r[6] <= 0) {                   // padding row: block-uniform
        for (int q = tid; q < nqp; q += NT) cost_out[(size_t)q * B + b] = 0.0f;
        return;
    }
    const int fi = r[0], xs = r[1], ys = r[2], w = r[3], h = r[4];
    const int lw4 = ilog2(w) - 2, lwc4 = max(ilog2(w) - 3, 0);   // units a row: log2
    const int nul = luma ? h << lw4 : 0, nuc = (h / 2) << lwc4, nu = nul + 2 * nuc;
    for (int q0 = 0; q0 < nqp; q0 += K9C_QCHUNK) {
        const int nq = min(K9C_QCHUNK, nqp - q0), qt = q0 + min(tid, nq - 1);
        const float lam = params[3 * qt], dw = params[3 * qt + 1], lam2 = params[3 * qt + 2];
        if (tid < 4 * K9C_QCHUNK) red[tid / 4][tid % 4] = 0;
        __syncthreads();
        for (int q = q0; q < q0 + nq; ++q) {
            K9cSums v = {0, 0, 0, 0};
            for (int u0 = tid; u0 < nu; u0 += 2 * NT) {
                int pl[2], msk[2], y[2], x0[2];
                int4 lv[2], rv[2], og[2];
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    const int u = u0 + k * NT, c = u >= nul, e = u - nul;
                    const int p = c ? 1 + (e >= nuc) : 0, ec = e - (p - 1) * nuc;
                    pl[k] = p;
                    y[k] = c ? ec >> lwc4 : u >> lw4;
                    x0[k] = 4 * (c ? ec & ((1 << lwc4) - 1) : u & ((1 << lw4) - 1));
                    const int ww = c ? w / 2 : w;
                    msk[k] = u < nu ? (ww - x0[k] >= 4 ? 15 : (1 << (ww - x0[k])) - 1) : 0;
                    if (msk[k]) {
                        const size_t o = c ? (((size_t)q * 2 + p - 1) * B + b) * Pc * Pc +
                                                 y[k] * Pc + x0[k]
                                           : ((size_t)q * B + b) * P * P + y[k] * P + x0[k];
                        lv[k] = *reinterpret_cast<const int4*>((c ? lev_c : lev_l) + o);
                        rv[k] = *reinterpret_cast<const int4*>((c ? rec_c : rec_l) + o);
                        if (q == 0)
                            og[k] = org_unit(p == 0 ? oy : p == 1 ? ou : ov, fi,
                                             c ? H / 2 : H, c ? W / 2 : W, c ? xs / 2 : xs,
                                             c ? ys / 2 : ys, y[k], x0[k], msk[k]);
                    }
                }
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    if (msk[k]) {
                        const int u = u0 + k * NT;
                        if (q == 0) sorg[u] = og[k];
                        else og[k] = sorg[u];
                        unit_sums(v, pl[k], msk[k], lv[k], rv[k], og[k]);
                    }
                }
            }
            warp_sums(v);
            if (lane == 0)
#pragma unroll
                for (int k = 0; k < 4; ++k) atomicAdd(&red[q - q0][k], (unsigned long long)v[k]);
        }
        __syncthreads();
        if (tid < nq) {
            const K9cSums a = {(long long)red[tid][0], (long long)red[tid][1],
                               (long long)red[tid][2], (long long)red[tid][3]};
            cost_out[(size_t)qt * B + b] = leaf_cost(a, luma, lam, dw, lam2);
        }
        if (q0 + K9C_QCHUNK < nqp) __syncthreads();   // the sums read before the next zeroing
    }
}

// A team per rect: WARP, a warp (K9C_WARPS rects a block); else the block,
// at most 64 registers a thread so that several blocks share an SM.
template <int P, bool WARP>
__global__ void __launch_bounds__(32 * (WARP ? K9C_WARPS : k9c_block_warps(P)),
                                  WARP || k9c_block_warps(P) >= 32 ? 1
                                                                   : 32 / k9c_block_warps(P))
rdo_leaf_cost_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ oy,
                     const int32_t* __restrict__ ou, const int32_t* __restrict__ ov,
                     const int32_t* __restrict__ lev_l, const int32_t* __restrict__ rec_l,
                     const int32_t* __restrict__ lev_c, const int32_t* __restrict__ rec_c,
                     const float* __restrict__ params, int nqp, int B, int H, int W, int luma,
                     float* __restrict__ cost_out) {
    if constexpr (WARP) {
        const int b = blockIdx.x * K9C_WARPS + (threadIdx.x >> 5);
        if (b < B)                     // the last block: whole warps
            leaf_cost_warp<P>(rows, oy, ou, ov, lev_l, rec_l, lev_c, rec_c, params, nqp, B, H,
                              W, luma, cost_out, b);
    } else {
        leaf_cost_block<P, 32 * k9c_block_warps(P)>(rows, oy, ou, ov, lev_l, rec_l, lev_c,
                                                    rec_c, params, nqp, B, H, W, luma,
                                                    cost_out, blockIdx.x);
    }
}

template <int P>
static int launch_leaf_cost(const int32_t* rows, const int32_t* oy, const int32_t* ou,
                            const int32_t* ov, const int32_t* lev_l, const int32_t* rec_l,
                            const int32_t* lev_c, const int32_t* rec_c, const float* params,
                            int nqp, int B, int H, int W, int luma, float* cost,
                            cudaStream_t stream) {
    if constexpr (P <= K9C_TEAM_PAD)
        rdo_leaf_cost_kernel<P, true><<<(B + K9C_WARPS - 1) / K9C_WARPS, 32 * K9C_WARPS, 0,
                                        stream>>>(rows, oy, ou, ov, lev_l, rec_l, lev_c, rec_c,
                                                  params, nqp, B, H, W, luma, cost);
    else
        rdo_leaf_cost_kernel<P, false><<<B, 32 * k9c_block_warps(P), 0, stream>>>(
            rows, oy, ou, ov, lev_l, rec_l, lev_c, rec_c, params, nqp, B, H, W, luma, cost);
    return (int)cudaGetLastError();
}

extern "C" int pmp_rdo_luma_select(const int32_t* refs, const int32_t* crefs,
                                   const int32_t* org, const int32_t* rows,
                                   const int32_t* tabs_l, const int32_t* tabs_c, int B, int P,
                                   int bd, int H, int W, int32_t* modes, int32_t* pred,
                                   int32_t* cpred, cudaStream_t stream) {
    if (B == 0) return 0;
    switch (P) {                       // the RDO's pad classes
    case 8: return launch_luma_select<8>(refs, crefs, org, rows, tabs_l, tabs_c, B, bd, H, W,
                                         modes, pred, cpred, stream);
    case 16: return launch_luma_select<16>(refs, crefs, org, rows, tabs_l, tabs_c, B, bd, H,
                                           W, modes, pred, cpred, stream);
    case 32: return launch_luma_select<32>(refs, crefs, org, rows, tabs_l, tabs_c, B, bd, H,
                                           W, modes, pred, cpred, stream);
    case 64: return launch_luma_select<64>(refs, crefs, org, rows, tabs_l, tabs_c, B, bd, H,
                                           W, modes, pred, cpred, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int pmp_rdo_chroma_select(const int32_t* crefs, const int32_t* ou,
                                     const int32_t* ov, const int32_t* rows,
                                     const int32_t* tabs_c, int B, int Pc, int bd, int Hc,
                                     int Wc, int32_t* pred, int32_t* satd, cudaStream_t stream) {
    if (B == 0) return 0;
    switch (Pc) {                      // the RDO's chroma pads
    case 4: return launch_chroma_select<4>(crefs, ou, ov, rows, tabs_c, B, bd, Hc, Wc, pred,
                                           satd, stream);
    case 8: return launch_chroma_select<8>(crefs, ou, ov, rows, tabs_c, B, bd, Hc, Wc, pred,
                                           satd, stream);
    case 16: return launch_chroma_select<16>(crefs, ou, ov, rows, tabs_c, B, bd, Hc, Wc, pred,
                                             satd, stream);
    case 32: return launch_chroma_select<32>(crefs, ou, ov, rows, tabs_c, B, bd, Hc, Wc, pred,
                                             satd, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int pmp_rdo_leaf_cost(const int32_t* rows, const int32_t* oy, const int32_t* ou,
                                 const int32_t* ov, const int32_t* lev_l, const int32_t* rec_l,
                                 const int32_t* lev_c, const int32_t* rec_c,
                                 const float* params, int nqp, int B, int P, int H, int W,
                                 int luma, float* cost, cudaStream_t stream) {
    if (B == 0 || nqp == 0) return 0;
    if ((luma && (!oy || !lev_l || !rec_l)) || (long long)B * P * P >= (1LL << 31))
        return (int)cudaErrorInvalidValue;    // a QP point's tiles indexed in int
    switch (P) {                       // the RDO's pad classes
    case 8: return launch_leaf_cost<8>(rows, oy, ou, ov, lev_l, rec_l, lev_c, rec_c, params,
                                       nqp, B, H, W, luma, cost, stream);
    case 16: return launch_leaf_cost<16>(rows, oy, ou, ov, lev_l, rec_l, lev_c, rec_c, params,
                                         nqp, B, H, W, luma, cost, stream);
    case 32: return launch_leaf_cost<32>(rows, oy, ou, ov, lev_l, rec_l, lev_c, rec_c, params,
                                         nqp, B, H, W, luma, cost, stream);
    case 64: return launch_leaf_cost<64>(rows, oy, ou, ov, lev_l, rec_l, lev_c, rec_c, params,
                                         nqp, B, H, W, luma, cost, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}
