// K7: masked scatter of one wave step's results into the state planes.
//
// Replaces the scatters of pmp_vvc_tpu/codec/wavefront.py:_make_class_apply
// (438-461) and _chroma_part (634-651), which are
// ``.at[...].set(mode="drop")`` writes into the planes that
// _wave_scan (655-703) carries from step to step: here they are masked
// writes of live rows only.
//
// One block per (CU, plane): recon (int32) and levels (stored int16) over
// the CU's (h, w) region of the plane, rows and columns inside the plane;
// with up to four code grids (the luma step's mode, MIP, mts_idx and
// lfnst_idx grids, or the chroma step's CCLM / joint Cb-Cr grid), each CU's
// code (uint8) over its (h/4, w/4) cells of the 4-sample luma-unit grid
// (h and w in luma units at either scale), cells inside the grid. Padding
// rows (live == 0) write nothing.
//
// Bound: bytes. Each CU reads w*h recon and levels and writes 6 bytes per
// sample plus its grid cells; there is no arithmetic to speak of.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_GRIDS 4

struct Grids {                         // grid k takes code[k][b] over CU b's cells
    uint8_t* grid[MAX_GRIDS];
    const int32_t* code[MAX_GRIDS];
};

__global__ void wave_scatter_kernel(const int32_t* __restrict__ rows, int B,
                                    int P, int scale, int H, int W,
                                    int32_t* __restrict__ rp0,
                                    int16_t* __restrict__ lp0,
                                    int32_t* __restrict__ rp1,
                                    int16_t* __restrict__ lp1,
                                    const int32_t* __restrict__ rec,
                                    const int32_t* __restrict__ lev,
                                    Grids grids, int ngrids, int GH, int GW) {
    const int b = blockIdx.x, pl = blockIdx.y;
    const int32_t* r = rows + 8 * b;
    if (r[6] <= 0) return;
    const int fi = r[0], xs = r[1] / scale, ys = r[2] / scale;
    const int w = r[3] / scale, h = r[4] / scale;
    int32_t* rp = (pl ? rp1 : rp0) + (size_t)fi * H * W;
    int16_t* lp = (pl ? lp1 : lp0) + (size_t)fi * H * W;
    const size_t tile = ((size_t)pl * B + b) * P * P;
    for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
        const int y = i / w, x = i % w;
        if (ys + y >= H || xs + x >= W) continue;
        const size_t o = (size_t)(ys + y) * W + xs + x;
        rp[o] = rec[tile + y * P + x];
        lp[o] = (int16_t)lev[tile + y * P + x];
    }
    if (ngrids > 0 && pl == 0) {
        const int gw = r[3] / 4, gh = r[4] / 4, gx0 = r[1] / 4, gy0 = r[2] / 4;
        uint8_t v[MAX_GRIDS];
        for (int k = 0; k < ngrids; ++k) v[k] = (uint8_t)grids.code[k][b];
        for (int i = threadIdx.x; i < gh * gw; i += blockDim.x) {
            const int gy = gy0 + i / gw, gx = gx0 + i % gw;
            if (gy >= GH || gx >= GW) continue;
            const size_t o = ((size_t)fi * GH + gy) * GW + gx;
            for (int k = 0; k < ngrids; ++k) grids.grid[k][o] = v[k];
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
    dim3 blocks(B, nplanes);
    wave_scatter_kernel<<<blocks, 256, 0, stream>>>(rows, B, P, scale, H, W, rp0,
                                                    lp0, rp1, lp1, rec, lev, g,
                                                    ngrids, GH, GW);
    return (int)cudaGetLastError();
}
