// SATD device code shared by K2 (csrc/intra_rmd.cu), K3 (csrc/mip_rmd.cu),
// K6a (csrc/cclm.cu), K9a and K9b (csrc/rdo_leaf.cu) and K10d
// (csrc/seq_satd.cu), so that the angular, MIP, CCLM, RDO and sequential
// costs round the same way. Who uses what: the warp form of square tiles
// ``warp_tile_satd`` K2, K3, K6a, K9a and K9b; the warp form of VTM's tile
// shapes ``warp_tile_had`` K10d.
//
// The port of pmp_vvc_tpu/ops/tq_generic.py:satd_generic (160): 8x8
// Walsh-Hadamard tiles when min(w, h) >= 8, else 4x4, over the CU's (h, w)
// region of two P-strided tiles; each tile's sum of |coefficients| with VTM's
// DC/4 and rounding. All in int32: a 64x64 CU of 10-bit samples stays below
// 2^23, so the JAX package's float32 sums of the same integers are exact.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// The warp form: SATD of up to 32 / TS tiles of TS x TS differences (TS 4
// or 8), held in registers one row per lane: lanes TS*g .. TS*g + TS - 1
// hold the rows of tile g in ``d``. Every lane of the warp must call it.
// The row transform runs in registers, the column transform across the
// tile's lanes with __shfl_xor_sync at distances 1, 2 (and 4); then the sum
// of |coefficients| with VTM's DC/4 and rounding: (s + 2) >> 2 for 8x8,
// (s + 1) >> 1 for 4x4. Returns the tile's SATD in each of its lanes (0 for
// a tile of zero differences).
template <int TS>
static __device__ __forceinline__ int warp_tile_satd(int (&d)[TS]) {
    static_assert(TS == 4 || TS == 8, "SATD tiles are 4x4 or 8x8");
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int len = 1; len < TS; len <<= 1)
#pragma unroll
        for (int j = 0; j < TS; ++j)
            if (!(j & len)) {
                const int a = d[j], b = d[j + len];
                d[j] = a + b;
                d[j + len] = a - b;
            }
#pragma unroll
    for (int len = 1; len < TS; len <<= 1) {
        const bool upper = lane & len;             // row i + len of the pair
#pragma unroll
        for (int j = 0; j < TS; ++j) {
            const int o = __shfl_xor_sync(0xffffffffu, d[j], len);
            d[j] = upper ? o - d[j] : d[j] + o;
        }
    }
    int s = 0;
#pragma unroll
    for (int j = 0; j < TS; ++j) s += abs(d[j]);
#pragma unroll
    for (int len = 1; len < TS; len <<= 1) s += __shfl_xor_sync(0xffffffffu, s, len);
    const int dc = __shfl_sync(0xffffffffu, abs(d[0]), lane & ~(TS - 1));
    const int tv = s - dc + (dc >> 2);
    return TS == 8 ? (tv + 2) >> 2 : (tv + 1) >> 1;
}

// The warp form of VTM's tile shapes (RdCost.cpp xGetHADs; K10d): 32 / TH
// tiles of TH x TW differences (8x16, 16x8, 4x8, 8x4, 8x8, 4x4 or 2x2),
// one tile row a lane: lanes TH*g .. TH*g + TH - 1 hold the rows of tile g
// in ``d``. The row transform (Sylvester order) runs in registers, the
// column transform across the tile's lanes with __shfl_xor_sync; then the
// sum of |coefficients| with |DC| >> 2 for the DC term, normalised in the
// tile's lanes: (s + 2) >> 2 for 8x8, (s + 1) >> 1 for 4x4, s for 2x2, and
// trunc(float32(s) * scale) for the non-square tiles, ``scale`` being
// 2 / sqrt(TH * TW) rounded to float32 (__fmul_rn: one float32 product,
// never contracted). Returns the tile's SATD in each of its lanes. Every
// lane of the warp must call it.
template <int TH, int TW>
static __device__ __forceinline__ int warp_tile_had(int (&d)[TW], float scale) {
    static_assert(TH * TW <= 128 && 32 % TH == 0, "VTM's SATD tiles");
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int len = 1; len < TW; len <<= 1)
#pragma unroll
        for (int j = 0; j < TW; ++j)
            if (!(j & len)) {
                const int a = d[j], b = d[j + len];
                d[j] = a + b;
                d[j + len] = a - b;
            }
#pragma unroll
    for (int len = 1; len < TH; len <<= 1) {
        const bool upper = lane & len;             // row i + len of the pair
#pragma unroll
        for (int j = 0; j < TW; ++j) {
            const int o = __shfl_xor_sync(0xffffffffu, d[j], len);
            d[j] = upper ? o - d[j] : d[j] + o;
        }
    }
    int s = 0;
#pragma unroll
    for (int j = 0; j < TW; ++j) s += abs(d[j]);
#pragma unroll
    for (int len = 1; len < TH; len <<= 1) s += __shfl_xor_sync(0xffffffffu, s, len);
    const int dc = __shfl_sync(0xffffffffu, abs(d[0]), lane & ~(TH - 1));
    const int tv = s - dc + (dc >> 2);
    if constexpr (TH == 8 && TW == 8) return (tv + 2) >> 2;
    else if constexpr (TH == 4 && TW == 4) return (tv + 1) >> 1;
    else if constexpr (TH == 2 && TW == 2) return tv;
    else return (int)truncf(__fmul_rn((float)tv, scale));
}
