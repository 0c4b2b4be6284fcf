// Transform-quantisation device code shared by K4 (csrc/tq.cu), K5
// (csrc/tq_mts.cu) and K10c (csrc/seq_tq.cu), so that every round trip and
// its costs round alike: the quantiser tables and the CU tile's scalar
// quantiser (``Tile``), the round shift and dequantisation of one level,
// and the zero-out rule. K4 and K5 run their stages in csrc/tq_team.cuh,
// K10c in csrc/seq_tq.cu.
//
// Ports of the scalars of pmp_vvc_tpu/ops/tq_generic.py
// forward_transform_generic (96), quantize_generic (135) and
// dequantize_generic (149).
//
// Cores: DCT-2 entries come from the 64-point core by stride (kind 0,
// zero-out beyond 32); DST-7 (kind 2) and DCT-8 (kind 1) from a (2, 4, 32, 32)
// table of the 4..32-point cores, DCT-8 first (zero-out beyond 16).
//
// Float rounding: SSE is summed exactly in int64 and each coefficient
// group's 16 gains in float64, each rounded once to float32; every other
// float operation is written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, which the compiler never contracts into an FMA, so the costs
// round as the plain PyTorch version's separate operations do.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define COEFF_MIN (-32768)
#define COEFF_MAX 32767

__constant__ int QUANT_SCALES[2][6] = {{26214, 23302, 20560, 18396, 16384, 14564},
                                       {18396, 16384, 14564, 13107, 11651, 10280}};
__constant__ int INV_QUANT_SCALES[2][6] = {{40, 45, 51, 57, 64, 72},
                                           {57, 64, 72, 80, 90, 102}};

static __device__ __forceinline__ int rshift(int x, int s) {
    return s > 0 ? (x + (1 << (s - 1))) >> s : x;
}

// Unclipped dequantisation of one (already clipped) level.
static __device__ __forceinline__ int dequant(int lvl, int iscale, int rs) {
    const int v = lvl * iscale;
    return rs > 0 ? (v + (1 << (rs - 1))) >> rs : v * (1 << -rs);
}

// Coefficients kept along a side of n samples (the zero-out rule).
static __device__ __forceinline__ int keep(int kind, int n) {
    return min(n, kind == 0 ? 32 : 16);
}

// The CU tile's geometry and scalar quantiser (TrQuant.cpp:806-893,
// Quant.cpp:954-1031) at internal QP ``qp``.
struct Tile {
    int P, w, h, lw, lh, bd;
    int q_bits, qscale, add, iscale, rs;
    float divisor;                     // 2^(2 tShift - sqrt2), the RD gains'
};

static __device__ Tile make_tile(int P, int w, int h, int qp, int bd) {
    Tile t;
    t.P = P, t.w = w, t.h = h, t.lw = ilog2(w), t.lh = ilog2(h), t.bd = bd;
    const int t_shift = 15 - bd - ((t.lw + t.lh) >> 1), sqrt2 = (t.lw + t.lh) & 1;
    t.q_bits = 14 + qp / 6 + t_shift - sqrt2;
    t.qscale = QUANT_SCALES[sqrt2][qp % 6];
    t.add = 171 << (t.q_bits - 9);
    t.iscale = INV_QUANT_SCALES[sqrt2][qp % 6];
    t.rs = 6 - ((t_shift - sqrt2) + qp / 6);
    t.divisor = ldexpf(1.0f, 2 * t_shift - sqrt2);
    return t;
}
