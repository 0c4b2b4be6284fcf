// K10a: the intra predictions of N CUs of one size for a list of modes, for
// the sequential FrameEncoder.
//
// Replaces pmp_vvc_tpu/ops/intra.py:predict_block (356) with its helpers
// _predict_planar, _predict_dc, _pdpc_planar_dc and _predict_angular_batch
// (206-353), which codec/encoder.py:_jit_predict (55) jits per (size, modes).
// The reference rows are the unfiltered and filtered top (2W+3 entries) and
// left (2H+3) rows of each CU: index 0 the corner, then the 2W / 2H samples,
// then two replication slots (predict_block's layout, which is also
// csrc/intra_pred.cuh's). The output is (N, M, h, w). Sides 2-64; luma or
// chroma tables (7, 2412) from the wrapper.
//
// Bound: bytes at the encoder's shapes. A 64x64 CU's 67 modes write 1.1 MB
// of int32 predictions at ~12 integer operations per sample (3.3 M
// operations); a call of a smaller CU is its launch and its chain of one
// load round, one barrier, a line's samples and their stores.
//
// Design for the H100:
// - A mode's segments (TS samples of one line) are dealt out in order over
//   a grid of (blocks, N), one a thread and K10A_WARPS warps a block. TS is
//   1 up to K10A_SMALL samples a CU (16x16), else 4: a small call is a
//   chain of dependent steps on one thread a few warps an SM, which four
//   samples lengthen more than one window shortens. A mode with fewer than
//   32 segments (4x4, 2x8, 8x2 and below) takes a warp of its own, its
//   other lanes idle, since modes that share a warp in lane groups take
//   apart at every branch of the prediction; several warps share a mode
//   from 8x8 up (chip_smoke.py's K10A_VARIANTS times the other forms).
// - Each block stages the CU's reference rows once, in one round: thread j
//   loads entry j of every row, padded to 2P + 3 with the row's last entry
//   (what predict_block's clamp to the row's end reads), with scalar loads,
//   since the rows arrive as views at odd offsets of one upload. Chroma
//   reads only the unfiltered rows: its table selects no filtered one.
//   Beside those loads, in the same round, the block copies the ids of its
//   modes and the CU size's entries of all 67 modes' tables into shared
//   memory (a mode's id and then its entries would be two dependent round
//   trips), and every warp sums DC's references straight from device
//   memory (warp_dc). Every load of that round goes to a register first, at
//   an address clamped into its array, and the shared-memory stores follow
//   them all, so that a thread issues all its loads before it waits on any
//   (a load behind a branch or a store waits a round trip more). One
//   barrier covers them all; each thread then builds its mode's parameters
//   from shared memory (mode_entries). A luma call at TS 1, whose lanes hold
//   many lines (a warp's 32 CU columns of a horizontal mode), stages the
//   cubic taps from device memory (CUBIC_TAPS) in the same round, since the
//   constant cache would serve their addresses one at a time.
// - A line is a row for planar, DC and the vertical modes, and a CU column
//   for the horizontal ones, predicted in the mode's own space
//   (intra_pred.cuh: predict_line, one window of TS + 3 references and one
//   set of taps a line; planar and DC through predict_sample), so that
//   neighbouring threads store neighbouring samples: a row segment of 4
//   leaves as one 16-byte store, a column segment as 4-byte stores, each a
//   warp's neighbouring samples.
// Each call makes one launch; the caller stacks U's and V's rows as N = 2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_pred.cuh"

// The kernel's shape. One value of each ships; chip_smoke.py's
// K10A_VARIANTS builds the others to time them beside it.
#ifndef K10A_WARPS
#define K10A_WARPS 4                   // warps per block
#endif
#ifndef K10A_SMALL
#define K10A_SMALL 256                 // samples a CU up to which a thread takes one
#endif
#ifndef K10A_LANE_GROUPS
#define K10A_LANE_GROUPS 0             // 1: modes of fewer than 32 segments share warps
#endif
#define NT (32 * K10A_WARPS)
#define MAXP 64
#define MAXL (2 * MAXP + 3)
#define MAXM (NT / 2 + 1)              // modes a block spans: a mode has >= 2 segments
static_assert(NT >= 128, "a thread an entry of the cubic taps");

__device__ int CUBIC_TAPS[32][4] = CUBIC_TAPS_INIT;   // read only

// log2 of a mode's items: its segments, at least a warp's lanes unless
// modes share warps
static __host__ __device__ __forceinline__ int k10a_lstride(int lseg) {
    return K10A_LANE_GROUPS || lseg > 5 ? lseg : 5;
}

// Segment seg of mode p into the (h, w) tile o: line a, samples s0 ..
// s0 + TS - 1 (row segments in row order; a horizontal mode's column
// segments with neighbouring columns neighbouring).
template <int TS>
static __device__ __forceinline__ void k10a_segment(const Cu& c, const Mode& p, int seg,
                                                    const int (*cf)[4], int32_t* __restrict__ o) {
    constexpr int LTS = TS == 4 ? 2 : TS == 2 ? 1 : 0;
    int v[TS];
    if (p.mode >= 2 && !p.ver) {
        const int a = seg & (c.w - 1), s0 = (seg >> c.lw) << LTS;
        predict_line<TS>(c, p, a, s0, v, cf);
#pragma unroll
        for (int j = 0; j < TS; ++j) o[(s0 + j) * c.w + a] = v[j];
        return;
    }
    const int lseg = c.lw - LTS;
    const int a = seg >> lseg, s0 = (seg & ((1 << lseg) - 1)) << LTS;
    if (p.mode >= 2) {
        predict_line<TS>(c, p, a, s0, v, cf);
    } else {
#pragma unroll
        for (int j = 0; j < TS; ++j) v[j] = predict_sample(c, p, a, s0 + j);
    }
    if constexpr (TS == 4)
        *reinterpret_cast<int4*>(o + a * c.w + s0) = make_int4(v[0], v[1], v[2], v[3]);
    else if constexpr (TS == 2)
        *reinterpret_cast<int2*>(o + a * c.w + s0) = make_int2(v[0], v[1]);
    else
        o[a * c.w + s0] = v[0];
}

template <int TS, bool LUMA>
__global__ void __launch_bounds__(NT)
seq_intra_kernel(const int32_t* __restrict__ tu, const int32_t* __restrict__ lu,
                 const int32_t* __restrict__ tf, const int32_t* __restrict__ lf,
                 const int32_t* __restrict__ modes, const int32_t* __restrict__ tabs, int M,
                 int w, int h, int bd, int32_t* __restrict__ out) {
    constexpr bool STAGE_TAPS = LUMA && TS == 1;
    __shared__ int32_t sref[4][MAXL];
    __shared__ int32_t stab[7][67];    // the CU size's entries of every mode
    __shared__ int32_t smid[MAXM];     // the ids of the block's modes
    __shared__ int staps[32][4];       // the cubic taps (STAGE_TAPS)
    const int n = blockIdx.y, tid = threadIdx.x;
    const int P = max(w, h), L = 2 * P + 3;
    const int lt = 2 * w + 3, ll = 2 * h + 3;
    const int32_t* tn = tu + (size_t)n * lt;
    const int32_t* ln = lu + (size_t)n * ll;
    const int32_t* tfn = LUMA ? tf + (size_t)n * lt : tn;      // chroma: no filtered rows
    const int32_t* lfn = LUMA ? lf + (size_t)n * ll : ln;
    Cu c;
    c.w = w; c.h = h; c.lw = ilog2(w); c.lh = ilog2(h);
    c.P = P; c.L = L; c.pel_max = (1 << bd) - 1; c.luma = LUMA;
    c.tabs = tabs;
    // the block's items and the modes they span
    const int lseg = c.lw + c.lh - (TS == 4 ? 2 : TS == 2 ? 1 : 0);   // log2 of segments a mode
    const int lstr = k10a_lstride(lseg);
    const int first = blockIdx.x * NT;
    const int k0 = first >> lstr, k1 = min(M, ((first + NT - 1) >> lstr) + 1);

    // one round of loads into registers, every address clamped into its
    // array, then the shared-memory stores
    constexpr int RQ = (MAXL + NT - 1) / NT, TQ = (7 * 67 + NT - 1) / NT,
                  MQ = (MAXM + NT - 1) / NT;
    const int32_t* tab = tabs + ((c.lw - 1) * 6 + (c.lh - 1)) * 67;
    int rv[RQ][4], tv[TQ], mv[MQ];
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
        const int jt = min(tid + q * NT, lt - 1), jl = min(tid + q * NT, ll - 1);
        rv[q][0] = tn[jt];
        rv[q][1] = ln[jl];
        rv[q][2] = tfn[jt];
        rv[q][3] = lfn[jl];
    }
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
        const int i = min(tid + q * NT, 7 * 67 - 1), k = i / 67;
        tv[q] = tab[k * NTAB + i - k * 67];
    }
#pragma unroll
    for (int q = 0; q < MQ; ++q) mv[q] = modes[min(k0 + tid + q * NT, M - 1)];
    const int taps = STAGE_TAPS ? CUBIC_TAPS[(tid >> 2) & 31][tid & 3] : 0;
    Cu g = c;                          // DC's sum from the rows in device memory,
    g.tu = tn; g.lu = ln;              // taken by every warp
    const int dc = warp_dc(g);
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
        const int j = tid + q * NT;
        if (j < L) {
            sref[0][j] = rv[q][0];
            sref[1][j] = rv[q][1];
            sref[2][j] = rv[q][2];
            sref[3][j] = rv[q][3];
        }
    }
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
        const int i = tid + q * NT, k = i / 67;
        if (i < 7 * 67) stab[k][i - k * 67] = tv[q];
    }
#pragma unroll
    for (int q = 0; q < MQ; ++q)
        if (k0 + tid + q * NT < k1) smid[tid + q * NT] = mv[q];
    if (STAGE_TAPS && tid < 128) staps[tid >> 2][tid & 3] = taps;
    c.tu = sref[0]; c.lu = sref[1];
    c.tf = LUMA ? sref[2] : sref[0]; c.lf = LUMA ? sref[3] : sref[1];
    __syncthreads();

    const int i = first + tid, seg = i & ((1 << lstr) - 1);
    if (i >= M << lstr || seg >> lseg) return;   // past the modes, or its mode's segments
    const int k = i >> lstr;
    Mode p = mode_entries(&stab[0][0], 67, smid[k - k0]);
    if (p.mode == 1) p.dc = dc;
    k10a_segment<TS>(c, p, seg, STAGE_TAPS ? staps : CHROMA_FILTER,
                     out + ((size_t)n * M + k) * w * h);
}

template <int TS>
static void launch(dim3 grid, cudaStream_t stream, const int32_t* tu, const int32_t* lu,
                   const int32_t* tf, const int32_t* lf, const int32_t* modes,
                   const int32_t* tabs, int M, int w, int h, int luma, int bd, int32_t* out) {
    if (luma)
        seq_intra_kernel<TS, true><<<grid, NT, 0, stream>>>(tu, lu, tf, lf, modes, tabs, M, w, h,
                                                            bd, out);
    else
        seq_intra_kernel<TS, false><<<grid, NT, 0, stream>>>(tu, lu, tf, lf, modes, tabs, M, w,
                                                             h, bd, out);
}

extern "C" int pmp_seq_intra(const int32_t* tu, const int32_t* lu,
                             const int32_t* tf, const int32_t* lf,
                             const int32_t* modes, const int32_t* tabs, int N,
                             int M, int w, int h, int luma, int bd,
                             int32_t* out, cudaStream_t stream) {
    if (N == 0 || M == 0) return 0;
    if (w < 2 || h < 2 || w > MAXP || h > MAXP || (w & (w - 1)) || (h & (h - 1)))
        return (int)cudaErrorInvalidValue;
    const int ts = w * h <= K10A_SMALL ? 1 : min(w, h) == 2 ? 2 : 4;
    const int lseg = __builtin_ctz(w) + __builtin_ctz(h) - __builtin_ctz(ts);
    const long long items = (long long)M << k10a_lstride(lseg);
    dim3 grid((unsigned)((items + NT - 1) / NT), N);
    if (ts == 1) launch<1>(grid, stream, tu, lu, tf, lf, modes, tabs, M, w, h, luma, bd, out);
    else if (ts == 2) launch<2>(grid, stream, tu, lu, tf, lf, modes, tabs, M, w, h, luma, bd, out);
    else launch<4>(grid, stream, tu, lu, tf, lf, modes, tabs, M, w, h, luma, bd, out);
    return (int)cudaGetLastError();
}
