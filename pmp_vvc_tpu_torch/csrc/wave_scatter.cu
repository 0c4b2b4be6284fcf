// K7: masked scatter of one wave step's results into the state planes.
//
// Replaces the scatters of pmp_vvc_tpu/codec/wavefront.py:_make_class_apply
// (438-461) and _chroma_part (634-651), which are
// ``.at[...].set(mode="drop")`` writes into the planes that
// _wave_scan (655-703) carries from step to step: here they are masked
// writes of live rows only.
//
// Each (CU, plane) writes recon (int32) and levels (stored int16) over the
// CU's (h, w) region of the plane, rows and columns inside the plane; with
// up to four code grids (the luma step's mode, MIP, mts_idx and lfnst_idx
// grids, or the chroma step's CCLM / joint Cb-Cr grid), each CU's code
// (uint8) goes over its (h/4, w/4) cells of the 4-sample luma-unit grid (h
// and w in luma units at either scale), cells inside the grid. Padding rows
// (live == 0) write nothing. CUs of one step never overlap, so no order
// between them is needed.
//
// Bound: bytes. Each CU reads w*h recon and levels and writes 6 bytes per
// sample plus its grid cells; there is no arithmetic to speak of. A call's
// time is its chain, so:
//
// - Each (CU, plane) has a team of P*P / K7_BATCH threads (at least a
//   warp; above 256 the team spans blocks on the grid's third axis), so a
//   thread moves at most K7_BATCH samples: a 64x64 CU runs no 16-step loop.
// - A thread loads all its samples (int4 from the tile's P-strided rows
//   where the CU is 4 or more samples wide) before it stores any; the
//   planes are __restrict__.
// - Where a plane offset is 16-byte aligned and the four samples lie in
//   the plane, recon is stored as int4 and levels as four int16 in one
//   store; otherwise (a chroma CU's xs/2 may be 2-aligned only, chroma CUs
//   can be 2 wide, the plane's right edge) one sample at a time.
// - CU sides are powers of two: positions come from shifts by log2(w).
// - The row and the up-to-four codes are loaded once; the same threads
//   write the grid cells. A schedule row is read as two int4, so `rows`
//   must be 16-byte aligned (the wrapper checks it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

#define MAX_GRIDS 4

#ifndef K7_BATCH
#define K7_BATCH 4              // samples a thread moves (a multiple of 4)
#endif

struct Grids {                         // grid k takes code[k][b] over CU b's cells
    uint8_t* grid[MAX_GRIDS];
    const int32_t* code[MAX_GRIDS];
};

static __device__ __forceinline__ int lane4(const int4& a, int e) {
    return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

__global__ void wave_scatter_kernel(const int32_t* __restrict__ rows, int B,
                                    int P, int scale, int H, int W,
                                    int32_t* __restrict__ rp0,
                                    int16_t* __restrict__ lp0,
                                    int32_t* __restrict__ rp1,
                                    int16_t* __restrict__ lp1,
                                    const int32_t* __restrict__ rec,
                                    const int32_t* __restrict__ lev,
                                    Grids grids, int ngrids, int GH, int GW,
                                    bool tiles_vec) {
    const int b = blockIdx.x, pl = blockIdx.y;
    const int T = gridDim.z * blockDim.x;                    // the CU's team
    const int t = blockIdx.z * blockDim.x + threadIdx.x;
    const int4 r0 = reinterpret_cast<const int4*>(rows)[2 * b];
    const int4 r1 = reinterpret_cast<const int4*>(rows)[2 * b + 1];
    if (r1.z <= 0) return;                                   // padding row
    uint8_t code[MAX_GRIDS];
    const bool cells = pl == 0 && ngrids > 0;
#pragma unroll
    for (int k = 0; k < MAX_GRIDS; ++k)
        code[k] = cells && k < ngrids ? (uint8_t)grids.code[k][b] : 0;

    const int fi = r0.x, xs = r0.y / scale, ys = r0.z / scale;
    const int w = r0.w / scale, h = r1.x / scale, lw = ilog2(w);
    int32_t* __restrict__ rp = (pl ? rp1 : rp0) + (size_t)fi * H * W;
    int16_t* __restrict__ lp = (pl ? lp1 : lp0) + (size_t)fi * H * W;
    const size_t tile = ((size_t)pl * B + b) * P * P;
    const int32_t* rt = rec + tile;
    const int32_t* lt = lev + tile;

    if (tiles_vec && w >= 4) {                   // four samples of a row at a time
        constexpr int NV = K7_BATCH / 4;
        const int lv = lw - 2, nv = (h * w) >> 2;
        int4 a[NV], c[NV];
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            const int i = t + k * T;
            if (i < nv) {
                const int y = i >> lv, x = (i & ((1 << lv) - 1)) << 2;
                a[k] = *reinterpret_cast<const int4*>(rt + y * P + x);
                c[k] = *reinterpret_cast<const int4*>(lt + y * P + x);
            }
        }
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            const int i = t + k * T;
            const int y = i >> lv, x = (i & ((1 << lv) - 1)) << 2;
            if (i >= nv || ys + y >= H) continue;
            const size_t o = (size_t)(ys + y) * W + xs + x;
            if (xs + x + 3 < W && ((uintptr_t)(rp + o) & 15) == 0 &&
                ((uintptr_t)(lp + o) & 7) == 0) {
                *reinterpret_cast<int4*>(rp + o) = a[k];
                *reinterpret_cast<short4*>(lp + o) = make_short4(
                    (int16_t)c[k].x, (int16_t)c[k].y, (int16_t)c[k].z, (int16_t)c[k].w);
                continue;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (xs + x + e < W) {
                    rp[o + e] = lane4(a[k], e);
                    lp[o + e] = (int16_t)lane4(c[k], e);
                }
        }
    } else {                                     // sides of 2: one sample at a time
        const int n = h * w;
        int a[K7_BATCH], c[K7_BATCH];
#pragma unroll
        for (int k = 0; k < K7_BATCH; ++k) {
            const int i = t + k * T;
            if (i < n) {
                const int y = i >> lw, x = i & (w - 1);
                a[k] = rt[y * P + x];
                c[k] = lt[y * P + x];
            }
        }
#pragma unroll
        for (int k = 0; k < K7_BATCH; ++k) {
            const int i = t + k * T;
            const int y = i >> lw, x = i & (w - 1);
            if (i >= n || ys + y >= H || xs + x >= W) continue;
            const size_t o = (size_t)(ys + y) * W + xs + x;
            rp[o] = a[k];
            lp[o] = (int16_t)c[k];
        }
    }

    if (cells) {
        const int gw = r0.w >> 2, gh = r1.x >> 2, lg = ilog2(gw);
        const int gx0 = r0.y >> 2, gy0 = r0.z >> 2;
        for (int i = t; i < gh * gw; i += T) {
            const int gy = gy0 + (i >> lg), gx = gx0 + (i & (gw - 1));
            if (gy >= GH || gx >= GW) continue;
            const size_t o = ((size_t)fi * GH + gy) * GW + gx;
#pragma unroll
            for (int k = 0; k < MAX_GRIDS; ++k)
                if (k < ngrids) grids.grid[k][o] = code[k];
        }
    }
}

extern "C" int pmp_wave_scatter(const int32_t* rows, int B, int P, int scale,
                                int nplanes, int H, int W, int32_t* rp0,
                                int16_t* lp0, int32_t* rp1, int16_t* lp1,
                                const int32_t* rec, const int32_t* lev,
                                uint8_t* const* grid, const int32_t* const* code,
                                int ngrids, int GH, int GW, cudaStream_t stream) {
    if (B == 0) return 0;
    if (ngrids < 0 || ngrids > MAX_GRIDS) return (int)cudaErrorInvalidValue;
    Grids g = {};
    for (int k = 0; k < ngrids; ++k) g.grid[k] = grid[k], g.code[k] = code[k];
    // the team: P*P / K7_BATCH threads, at least a warp, blocks of up to 256
    // (a 64x64 CU four of them)
    const int team = (P * P + K7_BATCH - 1) / K7_BATCH;
    const int threads = team <= 32 ? 32 : team >= 256 ? 256 : (team + 31) / 32 * 32;
    const dim3 blocks(B, nplanes, (team + threads - 1) / threads);
    // int4 tile loads need 16-byte rows and bases
    const bool tiles_vec = P % 4 == 0 && ((uintptr_t)rec & 15) == 0 &&
                           ((uintptr_t)lev & 15) == 0;
    wave_scatter_kernel<<<blocks, threads, 0, stream>>>(rows, B, P, scale, H, W, rp0, lp0, rp1,
                                                        lp1, rec, lev, g, ngrids, GH, GW,
                                                        tiles_vec);
    return (int)cudaGetLastError();
}
