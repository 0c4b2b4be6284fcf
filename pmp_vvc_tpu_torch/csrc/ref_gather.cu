// K1: intra reference gather for one wave step.
//
// Replaces pmp_vvc_tpu/codec/wavefront.py:_refs_generic (97) with
// _avail_from_order (82), _gather_plane (92),
// ops/intra.py:fill_reference_samples (134) and
// ops/intra_generic.py:filter_reference_samples_generic (71).
//
// For a CU at (x, y) of size (w, h) on a P-pad tile it gathers 2P top
// samples (row y-1), 2P left samples (column x-1) and the corner,
// coordinates clamped into the plane. A sample is available iff it lies in
// the picture, within 2w (2h) of the CU, and the coding-order grid
// (4-sample units of the luma plane; chroma coordinates scale by 2) holds an
// id in [0, order id of the CU). Substitution scans bottom-left -> corner
// -> top-right taking the last available sample at or before each
// position, backfilled from the first available one, or 1 << (bd-1) when
// none is; two replication slots follow. The [1 2 1] filter runs over the
// real lengths 2w / 2h with the corner from the unfiltered rows.
//
// Bound: bytes. Each CU reads ~8P samples and 8P grid ids and writes
// 4 x (2P+3) int32; the work is a few integer operations per sample. What
// a call costs is a chain, not work, so the design shortens the chain:
//
// - One warp per (CU, plane), K1_WARPS of them a block, at every pad: no
//   block barrier, and the RDO's 16,384-rect chunks run as as many warps.
// - Lanes 0-7 load the row's eight ints and broadcast them; a padding row
//   is warp-uniform and writes its four zero rows.
// - The S = 4P+1 entries are taken in rounds of 32, entry k * 32 + lane on
//   each lane. Every lane issues all its grid-id and sample loads before it reads any, so the
//   chain is row -> (ids, samples) -> substitution -> writes.
// - The substitution is JAX's cummax form on the warp: each round's
//   availability is one ballot; the last available entry at or before a
//   lane is the highest set bit of the ballot at or below it, else the
//   last one of an earlier round, carried from round to round; the first
//   available entry is the first set bit.
// - The filled row goes to the warp's slice of shared memory; the filter
//   and the four output rows are written lane-strided (coalesced).
// - No cluster, no atomics, no __syncthreads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

#define MAXP 64

#ifndef K1_WARPS
#define K1_WARPS 4              // warps a block, one (CU, plane) each
#endif

#define FULL 0xffffffffu

template <int E>
__global__ void __launch_bounds__(K1_WARPS * 32)
ref_gather_kernel(const int32_t* __restrict__ p0, const int32_t* __restrict__ p1,
                  const int32_t* __restrict__ og, const int32_t* __restrict__ rows,
                  int B, int P, int scale, int bd, int H, int W, int GH, int GW,
                  int nplanes, int32_t* __restrict__ out) {
    __shared__ int32_t fill[K1_WARPS][E * 32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = blockIdx.x * K1_WARPS + warp;
    if (g >= B * nplanes) return;               // warp-uniform
    const int b = g / nplanes, pl = g - b * nplanes;
    const int L = 2 * P + 3, n2 = 2 * P, S = 2 * n2 + 1;
    const size_t qs = (size_t)B * L;            // one output row to the next
    int32_t* o = out + (size_t)pl * 4 * qs + (size_t)b * L;

    const int rv = lane < 8 ? rows[8 * b + lane] : 0;
    const int fi = __shfl_sync(FULL, rv, 0);
    const int xs = __shfl_sync(FULL, rv, 1) / scale, ys = __shfl_sync(FULL, rv, 2) / scale;
    const int ws = __shfl_sync(FULL, rv, 3) / scale, hs = __shfl_sync(FULL, rv, 4) / scale;
    const int oi = __shfl_sync(FULL, rv, 5), live = __shfl_sync(FULL, rv, 6);
    if (live <= 0) {                            // padding row: nothing to gather
        for (int i = lane; i < L; i += 32) o[i] = o[qs + i] = o[2 * qs + i] = o[3 * qs + i] = 0;
        return;
    }
    const int32_t* pf = (pl ? p1 : p0) + (size_t)fi * H * W;
    const int32_t* gf = og + (size_t)fi * GH * GW;

    // every grid id and sample of this lane's entries, loaded in one round;
    // an entry outside the picture or the CU's reach is unavailable and
    // loads nothing
    int id[E], v[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
        const int s = k * 32 + lane;
        int row, col, gx, gy;
        bool ok;
        if (s < n2) {                           // left column, bottom-up
            const int j = n2 - 1 - s;
            ok = (ys + j < H) && (xs > 0) && (j < 2 * hs);
            row = ys + j; col = xs - 1;
            gx = max(xs - 1, 0) * scale / 4; gy = (ys + j) * scale / 4;
        } else if (s == n2) {                   // corner
            ok = (xs > 0) && (ys > 0);
            row = ys - 1; col = xs - 1;
            gx = max(xs - 1, 0) * scale / 4; gy = max(ys - 1, 0) * scale / 4;
        } else {                                // top row, left to right
            const int j = s - n2 - 1;
            ok = (s < S) && (xs + j < W) && (ys > 0) && (j < 2 * ws);
            row = ys - 1; col = xs + j;
            gx = (xs + j) * scale / 4; gy = max(ys - 1, 0) * scale / 4;
        }
        id[k] = ok ? gf[clampi(gy, 0, GH - 1) * GW + clampi(gx, 0, GW - 1)] : -1;
        v[k] = ok ? pf[clampi(row, 0, H - 1) * W + clampi(col, 0, W - 1)] : 0;
    }
    const int none = 1 << (bd - 1);
    int32_t* f = fill[warp];

    // rounds of 32: one ballot a round, the last available entry carried
    unsigned bal[E];
    bool found = false;
    int first_v = 0;                            // the first available sample
#pragma unroll
    for (int k = 0; k < E; ++k) {
        bal[k] = __ballot_sync(FULL, id[k] >= 0 && id[k] < oi);
        if (!found && bal[k]) first_v = __shfl_sync(FULL, v[k], __ffs(bal[k]) - 1);
        found = found || bal[k];
    }
    const unsigned at_or_below = FULL >> (31 - lane);
    int carry = first_v;                        // vals[last] of the earlier rounds
#pragma unroll
    for (int k = 0; k < E; ++k) {
        const unsigned m = bal[k] & at_or_below;
        const int got = __shfl_sync(FULL, v[k], m ? 31 - __clz(m) : lane);
        f[k * 32 + lane] = !found ? none : (m ? got : carry);
        if (bal[k]) carry = __shfl_sync(FULL, v[k], 31 - __clz(bal[k]));
    }
    __syncwarp();

    // unfiltered rows: index 0 = corner, then 2P samples, then two
    // replication slots of the last one
    const int corner_f = (2 * f[n2] + f[n2 + 1] + f[n2 - 1] + 2) >> 2;
    for (int i = lane; i < L; i += 32) {
        const int ti = min(i, n2);
        const int t0 = f[n2 + ti], l0 = f[n2 - ti];
        const int n = min(i + 1, n2);
        int tf = t0, lf = l0;
        if (i < L - 1 && i < 2 * ws)
            tf = i == 0 ? corner_f : (f[n2 + i - 1] + 2 * t0 + f[n2 + n] + 2) >> 2;
        if (i < L - 1 && i < 2 * hs)
            lf = i == 0 ? corner_f : (f[n2 - i + 1] + 2 * l0 + f[n2 - n] + 2) >> 2;
        o[i] = t0;
        o[qs + i] = l0;
        o[2 * qs + i] = tf;
        o[3 * qs + i] = lf;
    }
}

template <int E>
static void launch(dim3 grid, cudaStream_t stream, const int32_t* p0, const int32_t* p1,
                   const int32_t* og, const int32_t* rows, int B, int P, int scale, int bd,
                   int H, int W, int GH, int GW, int nplanes, int32_t* out) {
    ref_gather_kernel<E><<<grid, K1_WARPS * 32, 0, stream>>>(p0, p1, og, rows, B, P, scale, bd,
                                                             H, W, GH, GW, nplanes, out);
}

extern "C" int pmp_ref_gather(const int32_t* p0, const int32_t* p1,
                              const int32_t* og, const int32_t* rows, int B,
                              int P, int scale, int bd, int H, int W, int GH,
                              int GW, int nplanes, int32_t* out,
                              cudaStream_t stream) {
    if (P > MAXP || B <= 0) return B == 0 ? 0 : (int)cudaErrorInvalidValue;
    // entries a lane: S = 4P+1 in rounds of 32 (P = 4, 8, 16, 32, 64 take
    // 1, 2, 3, 5, 9)
    const int S = 4 * P + 1;
    const dim3 grid((B * nplanes + K1_WARPS - 1) / K1_WARPS);
    auto go = S <= 32 ? &launch<1> : S <= 64 ? &launch<2> : S <= 96 ? &launch<3>
            : S <= 160 ? &launch<5> : &launch<9>;
    go(grid, stream, p0, p1, og, rows, B, P, scale, bd, H, W, GH, GW, nplanes, out);
    return (int)cudaGetLastError();
}
