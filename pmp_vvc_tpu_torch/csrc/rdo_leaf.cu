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
//   on tiles over the sides rounded up to 4 and zero beyond the rect (the
//   plain version's masked tiles); the first minimum wins. Writes both
//   predictions and the winning SATD. One block per rect, every (mode,
//   plane, tile) item one thread's work through satd.cuh:tile_satd.
// K9c rdo_leaf_cost (rdo_device.py:122-136, 636-646): one block per
//   (QP, rect). Each plane's SSE of the round trip's recon against the
//   original, exact in int64 and rounded to float32 once, and the rate
//   proxy of its levels, 8 + nz + sum(2 * bitlen|l| + 1). Luma tree:
//   sse + lam * (bits + 6); chroma tree: lam * 2; then for U, then V,
//   + dw * sse_c + lam * bits_c, each operation rounded to float32 in the
//   JAX package's order (__fmul_rn / __fadd_rn, never contracted).
//
// Bound of K9b: operations (4 candidate predictions of every sample and
// their SATDs); of K9c: bytes (each recon and level sample read once, the
// originals once). chip_smoke.py computes the bound of each call it times.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_pred.cuh"
#include "satd.cuh"

#define MAXP 64
#define MAXPC (MAXP / 2)
#define MAXLC (2 * MAXPC + 3)
#define NRMD 35                        // planar, DC, the 33 even angulars
#define NCC 4                          // the chroma tree's candidates

__constant__ int CHROMA_CAND[NCC] = {0, 1, 18, 50};

static __device__ __forceinline__ int rmd_mode(int k) { return k < 2 ? k : 2 * (k - 1); }

// K9b's and K9c's threads per block: enough for the items of the class.
static int threads_for(int P) { return P <= 8 ? 64 : (P <= 16 ? 128 : 256); }

static __device__ Cu make_cu(int w, int h, int P, int bd, int luma, const int32_t* ref,
                             int L, const int32_t* tabs) {
    Cu c;
    c.w = w; c.h = h; c.lw = ilog2(w); c.lh = ilog2(h);
    c.P = P; c.L = L; c.pel_max = (1 << bd) - 1; c.luma = luma;
    c.tu = ref; c.lu = ref + L; c.tf = ref + 2 * L; c.lf = ref + 3 * L;
    c.tabs = tabs;
    return c;
}

// The four reference rows of plane ``pl`` of row ``b`` from K1's (n, 4, B, L)
// output into ``dst`` (4 * L ints).
static __device__ void load_refs(const int32_t* refs, int pl, int b, int B, int L,
                                 int32_t* dst) {
    for (int i = threadIdx.x; i < 4 * L; i += blockDim.x)
        dst[i] = refs[((size_t)(pl * 4 + i / L) * B + b) * L + i % L];
}

// The (h, w) original tile at (xs, ys) of frame ``fi``, P-strided, zero
// beyond the rect; reads clamped to the plane.
static __device__ void load_org(const int32_t* plane, int fi, int H, int W, int xs,
                                int ys, int w, int h, int P, int32_t* dst) {
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
        const int y = i / P, x = i % P;
        dst[i] = (y < h && x < w)
                     ? plane[((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W +
                             clampi(xs + x, 0, W - 1)]
                     : 0;
    }
}

// SATD of tile t (ts x ts, nx tiles a row) of org - prediction of mode p,
// differences zero beyond the (h, w) rect.
static __device__ int mode_tile_satd(const Cu& c, const Mode& p, const int32_t* org,
                                     int t, int ts, int nx) {
    const int r0 = (t / nx) * ts, c0 = (t % nx) * ts;
    int d[64];
    for (int i = 0; i < ts; ++i)
        for (int j = 0; j < ts; ++j) {
            const int y = r0 + i, x = c0 + j;
            d[i * ts + j] =
                (y < c.h && x < c.w) ? org[y * c.P + x] - predict_sample(c, p, y, x) : 0;
        }
    return tile_satd(d, ts);
}

// Prediction of mode p over the P x P tile, zero beyond the rect.
static __device__ void write_pred(const Cu& c, const Mode& p, int32_t* out) {
    for (int i = threadIdx.x; i < c.P * c.P; i += blockDim.x) {
        const int y = i / c.P, x = i % c.P;
        out[i] = (y < c.h && x < c.w) ? predict_sample(c, p, y, x) : 0;
    }
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
#define FULL 0xffffffffu

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
// K9b, K9c
// ---------------------------------------------------------------------------

__global__ void rdo_chroma_select_kernel(const int32_t* __restrict__ crefs,
                                         const int32_t* __restrict__ ou,
                                         const int32_t* __restrict__ ov,
                                         const int32_t* __restrict__ rows,
                                         const int32_t* __restrict__ tabs_c, int B, int Pc,
                                         int bd, int Hc, int Wc, int32_t* __restrict__ pred,
                                         int32_t* __restrict__ satd_out) {
    const int b = blockIdx.x, Lc = 2 * Pc + 3;
    const int32_t* r = rows + 8 * b;
    int32_t* out[2] = {pred + (size_t)b * Pc * Pc, pred + ((size_t)B + b) * Pc * Pc};
    if (r[6] <= 0) {                   // padding row
        for (int i = threadIdx.x; i < Pc * Pc; i += blockDim.x) out[0][i] = out[1][i] = 0;
        if (threadIdx.x == 0) satd_out[b] = 0;
        return;
    }
    __shared__ int32_t scref[2][4 * MAXLC];
    __shared__ int32_t sorg[2][MAXPC * MAXPC];
    __shared__ int scost[NCC];
    __shared__ int s_best;
    const int fi = r[0], xs = r[1] / 2, ys = r[2] / 2, w = r[3] / 2, h = r[4] / 2;
    load_refs(crefs, 0, b, B, Lc, scref[0]);
    load_refs(crefs, 1, b, B, Lc, scref[1]);
    load_org(ou, fi, Hc, Wc, xs, ys, w, h, Pc, sorg[0]);
    load_org(ov, fi, Hc, Wc, xs, ys, w, h, Pc, sorg[1]);
    if (threadIdx.x < NCC) scost[threadIdx.x] = 0;
    __syncthreads();

    // tiles over the sides rounded up to 4: a side of 2 gives zero columns
    // or rows beyond the rect, as the plain version's masked tiles do
    const int sw = max(w, 4), sh = max(h, 4);
    const int ts = min(sw, sh) >= 8 ? 8 : 4, nx = sw / ts, ntiles = (sh / ts) * nx;
    for (int it = threadIdx.x; it < NCC * 2 * ntiles; it += blockDim.x) {
        const int k = it / (2 * ntiles), pl = (it / ntiles) % 2;
        const Cu cc = make_cu(w, h, Pc, bd, 0, scref[pl], Lc, tabs_c);
        atomicAdd(&scost[k], mode_tile_satd(cc, mode_params(cc, CHROMA_CAND[k]), sorg[pl],
                                            it % ntiles, ts, nx));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int best = 0;
        for (int k = 1; k < NCC; ++k)
            if (scost[k] < scost[best]) best = k;
        s_best = best;
        satd_out[b] = scost[best];
    }
    __syncthreads();
    for (int pl = 0; pl < 2; ++pl) {
        const Cu cc = make_cu(w, h, Pc, bd, 0, scref[pl], Lc, tabs_c);
        write_pred(cc, mode_params(cc, CHROMA_CAND[s_best]), out[pl]);
    }
}

static __device__ long long block_sum64(long long v, long long* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    long long s = 0;
    if (threadIdx.x == 0)
        for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
    return s;                          // valid in thread 0
}

// SSE of the P-strided recon tile ``rec`` against the plane's (h, w) rect at
// (xs, ys) and the rate proxy of the level tile ``lev``; valid in thread 0.
static __device__ void plane_sums(const int32_t* rec, const int32_t* lev, const int32_t* plane,
                                  int fi, int H, int W, int xs, int ys, int w, int h, int P,
                                  long long* red64, int* red32, long long* sse_out,
                                  int* bits_out) {
    long long sse = 0;
    int bits = 0;
    for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
        const int y = e / w, x = e % w;
        const long long d =
            (long long)rec[y * P + x] -
            plane[((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W + clampi(xs + x, 0, W - 1)];
        sse += d * d;
        const int a = abs(lev[y * P + x]);
        if (a) bits += 2 * (32 - __clz(a)) + 2;   // magnitude + nonzero count
    }
    *sse_out = block_sum64(sse, red64);
    *bits_out = block_sum(bits, red32) + 8;
}

__global__ void rdo_leaf_cost_kernel(const int32_t* __restrict__ rows,
                                     const int32_t* __restrict__ oy,
                                     const int32_t* __restrict__ ou,
                                     const int32_t* __restrict__ ov,
                                     const int32_t* __restrict__ lev_l,
                                     const int32_t* __restrict__ rec_l,
                                     const int32_t* __restrict__ lev_c,
                                     const int32_t* __restrict__ rec_c,
                                     const float* __restrict__ params, int B, int P, int H,
                                     int W, int luma, float* __restrict__ cost_out) {
    const int b = blockIdx.x, q = blockIdx.y, Pc = P / 2;
    const int32_t* r = rows + 8 * b;
    if (r[6] <= 0) {
        if (threadIdx.x == 0) cost_out[(size_t)q * B + b] = 0.0f;
        return;
    }
    __shared__ long long red64[32];
    __shared__ int red32[32];
    const int fi = r[0], xs = r[1], ys = r[2], w = r[3], h = r[4];
    const float lam = params[3 * q], dw = params[3 * q + 1], lam2 = params[3 * q + 2];
    long long sse;
    int bits;
    float cost = lam2;                 // the chroma tree's mode bins
    if (luma) {
        const size_t tile = ((size_t)q * B + b) * P * P;
        plane_sums(rec_l + tile, lev_l + tile, oy, fi, H, W, xs, ys, w, h, P, red64, red32,
                   &sse, &bits);
        cost = __fadd_rn(__ll2float_rn(sse), __fmul_rn(lam, __fadd_rn((float)bits, 6.0f)));
    }
    for (int pl = 0; pl < 2; ++pl) {
        const size_t tile = (((size_t)q * 2 + pl) * B + b) * Pc * Pc;
        plane_sums(rec_c + tile, lev_c + tile, pl ? ov : ou, fi, H / 2, W / 2, xs / 2, ys / 2,
                   w / 2, h / 2, Pc, red64, red32, &sse, &bits);
        cost = __fadd_rn(__fadd_rn(cost, __fmul_rn(dw, __ll2float_rn(sse))),
                         __fmul_rn(lam, (float)bits));
    }
    if (threadIdx.x == 0) cost_out[(size_t)q * B + b] = cost;
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
    if (Pc > MAXPC || Pc < 4) return (int)cudaErrorInvalidValue;
    rdo_chroma_select_kernel<<<B, threads_for(2 * Pc), 0, stream>>>(
        crefs, ou, ov, rows, tabs_c, B, Pc, bd, Hc, Wc, pred, satd);
    return (int)cudaGetLastError();
}

extern "C" int pmp_rdo_leaf_cost(const int32_t* rows, const int32_t* oy, const int32_t* ou,
                                 const int32_t* ov, const int32_t* lev_l, const int32_t* rec_l,
                                 const int32_t* lev_c, const int32_t* rec_c,
                                 const float* params, int nqp, int B, int P, int H, int W,
                                 int luma, float* cost, cudaStream_t stream) {
    if (B == 0 || nqp == 0) return 0;
    if (P > MAXP || P < 8 || (luma && (!oy || !lev_l || !rec_l)))
        return (int)cudaErrorInvalidValue;
    rdo_leaf_cost_kernel<<<dim3(B, nqp), threads_for(P), 0, stream>>>(
        rows, oy, ou, ov, lev_l, rec_l, lev_c, rec_c, params, B, P, H, W, luma, cost);
    return (int)cudaGetLastError();
}
