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
// with up to two code grids (the luma step's mode grid and MIP grid), each
// CU's code (uint8) over its (h/4, w/4) cells of the 4-sample luma-unit
// grid, cells inside the grid. Padding rows (live == 0) write nothing.
//
// Bound: bytes. Each CU reads w*h recon and levels and writes 6 bytes per
// sample plus its grid cells; there is no arithmetic to speak of.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void wave_scatter_kernel(const int32_t* __restrict__ rows, int B,
                                    int P, int scale, int H, int W,
                                    int32_t* __restrict__ rp0,
                                    int16_t* __restrict__ lp0,
                                    int32_t* __restrict__ rp1,
                                    int16_t* __restrict__ lp1,
                                    const int32_t* __restrict__ rec,
                                    const int32_t* __restrict__ lev,
                                    uint8_t* __restrict__ grid0,
                                    const int32_t* __restrict__ code0,
                                    uint8_t* __restrict__ grid1,
                                    const int32_t* __restrict__ code1, int GH,
                                    int GW) {
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
    if (grid0 != nullptr && pl == 0) {
        const int gw = r[3] / 4, gh = r[4] / 4, gx0 = r[1] / 4, gy0 = r[2] / 4;
        const uint8_t v0 = (uint8_t)code0[b];
        const uint8_t v1 = grid1 != nullptr ? (uint8_t)code1[b] : 0;
        for (int i = threadIdx.x; i < gh * gw; i += blockDim.x) {
            const int gy = gy0 + i / gw, gx = gx0 + i % gw;
            if (gy >= GH || gx >= GW) continue;
            const size_t o = ((size_t)fi * GH + gy) * GW + gx;
            grid0[o] = v0;
            if (grid1 != nullptr) grid1[o] = v1;
        }
    }
}

extern "C" int pmp_wave_scatter(const int32_t* rows, int B, int P, int scale,
                                int nplanes, int H, int W, int32_t* rp0,
                                int16_t* lp0, int32_t* rp1, int16_t* lp1,
                                const int32_t* rec, const int32_t* lev,
                                uint8_t* grid0, const int32_t* code0,
                                uint8_t* grid1, const int32_t* code1, int GH,
                                int GW, cudaStream_t stream) {
    if (B == 0) return 0;
    dim3 g(B, nplanes);
    wave_scatter_kernel<<<g, 256, 0, stream>>>(rows, B, P, scale, H, W, rp0,
                                               lp0, rp1, lp1, rec, lev, grid0,
                                               code0, grid1, code1, GH, GW);
    return (int)cudaGetLastError();
}
