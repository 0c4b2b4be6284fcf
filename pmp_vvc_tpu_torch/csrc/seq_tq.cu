// K10c: the integer transform-quantisation stages of one TU, for the
// sequential FrameEncoder.
//
// Replaces pmp_vvc_tpu/ops/transforms.py:forward_transform (68) and
// inverse_transform (115), ops/quant.py:quantize (47) and dequantize (62),
// and their fusion codec/encoder.py:_jit_tq (72). One entry point runs the
// stages of a mask in this order: forward transform (1), quantisation (2),
// dequantisation (4), inverse transform (8), each on the previous stage's
// output (the first on the input), and writes every stage's output, so
// that each of the encoder's call sites is one launch: the fused round trip
// returns the coefficients, levels, dequantised coefficients and residual.
//
// Two-dimensional TUs: DCT-2 from the 64-point core by stride (sides
// 2-64), DST-7 / DCT-8 from the 4..32-point cores; the forward transform
// keeps 32 coefficients a side for DCT-2 and 16 for DST-7 / DCT-8 (zero
// beyond), and its stages round-shift by log2(w) + bd - 9 and log2(h) + 6;
// the inverse uses the full matrices, clipped to 16 bits after a shift of
// 7 and after 20 - bd. The 1xN and Nx1 TUs of ISP take transforms.py's
// one-dimensional branch: one stage over the coded side with the shift
// log2(n) + bd - 9 forward and 21 - bd inverse (a left shift where it is
// <= 0). Quantisation follows Quant.cpp with dead zone 171 at the internal
// QP; dequantisation clips the level and the result to 16 bits, with a
// left shift where its shift is <= 0. csrc/tq.cuh holds the tables and the
// rounding (Tile, rshift, dequant), shared with K4 and K5.
//
// All int32, in the plain version's order of terms. For residuals within
// +-2^bd (8 or 10 bits) every partial sum of the forward stages stays below
// 64 * 2^bd * 90 < 2^23 before the first shift and 64 * 46,080 * 90 < 2^28
// before the second; for inverse inputs within 16 bits below 64 * 2^15 *
// 90 < 2^28 in both stages; so no partial sum leaves int32 and any order of
// the terms gives the same sums.
//
// Bound: bytes at the encoder's sizes (one TU in, up to four out;
// chip_smoke.py:seq_bounds), operations only near 64x64. A call is one TU
// (the sequential encoder's N is 1), so what it costs is the launch and
// its chain of dependent steps. The design:
//
//   - A template per (log2 w, log2 h): every product loop is unrolled at
//     compile time, positions are shifts and masks.
//   - A team per TU: one warp up to K10C_WARP_MAX (128) samples, above it
//     a block of one thread per K10C_EPT (2) samples (64-256 threads); every
//     64-sample side takes 128 threads or more, so that a thread holds at
//     most 8 vectors of each core while it loads. (On an H100, a warp up
//     to 256 samples with 4 outputs a thread, the first form, took 2.74 us
//     for a 16x16 round trip against 2.26 us on 4 warps with 2: a thread's
//     chain of multiply-adds, not the barriers, is what a TU pays.)
//   - One load round: each thread issues its vectors of the TU and of the
//     two cores (DCT-2 rows by stride from the 64-point core, or the DST-7
//     / DCT-8 core; one core when both sides share it) before it stores
//     any; the cores go to shared memory as rows and as columns (stride
//     n + 4 from 32 up, so that neighbouring rows fall in other banks).
//     Then one barrier.
//   - Each stage of a transform is a product of shared-memory matrices,
//     K10C_CW (2) neighbouring outputs a thread (int4 loads of the row
//     operand, int2 of the column one; rows of outputs a thread by the
//     team's size), its sums in registers.
//   - The quantiser and the dequantiser run on the registers of the
//     vertical forward stage (or of the input), and every requested
//     stage's output is stored from registers straight to global memory,
//     a vector a thread; only the inverse's input and its middle
//     stage go through shared memory. A fused round trip passes 4 team
//     barriers (__syncwarp for a warp team).
//   - After a forward transform the inverse sums over the kept
//     coefficients only (the rest are zero).
//   - Input and outputs must be 16-byte aligned (the wrapper checks); an
//     unsupported shape or kind returns cudaErrorInvalidValue.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tq.cuh"

#define ST_FWD 1
#define ST_QUANT 2
#define ST_DEQUANT 4
#define ST_INV 8

#ifndef K10C_WARP_MAX
#define K10C_WARP_MAX 128                // samples a TU on one warp, at most
#endif
#ifndef K10C_EPT
#define K10C_EPT 2                       // samples a thread above it
#endif
#ifndef K10C_CW
#define K10C_CW 2                        // neighbouring outputs a thread (2 or 4)
#endif
static_assert(K10C_CW == 2 || K10C_CW == 4, "a thread's outputs are a vector of 2 or 4");

// Round-shift by s, or a left shift by -s where s <= 0 (transforms.py
// _rshift).
static __device__ __forceinline__ int rshift_any(int x, int s) {
    return s > 0 ? (x + (1 << (s - 1))) >> s : (int)((uint32_t)x << -s);
}

// Threads of the team of an h x w TU (see the note above).
static __host__ __device__ constexpr int k10c_threads(int w, int h) {
    const int hw = w * h, side = w > h ? w : h;
    int t = hw <= K10C_WARP_MAX ? 32 : hw / K10C_EPT;
    t = t < 64 && hw > K10C_WARP_MAX ? 64 : t;
    t = t > 256 ? 256 : t;
    return side == 64 && t < 128 ? 128 : t;
}

// Shared-memory row stride of a side of n.
static __host__ __device__ constexpr int k10c_stride(int n) { return n >= 32 ? n + 4 : n; }

// Vectors of N ints (1, 2 or 4) at an N-aligned address.
template <int N>
static __device__ __forceinline__ void ldv(const int32_t* p, int (&v)[N]) {
    if constexpr (N == 4) {
        const int4 q = *reinterpret_cast<const int4*>(p);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else if constexpr (N == 2) {
        const int2 q = *reinterpret_cast<const int2*>(p);
        v[0] = q.x, v[1] = q.y;
    } else {
        v[0] = *p;
    }
}

template <int N>
static __device__ __forceinline__ void stv(int32_t* p, const int (&v)[N]) {
    if constexpr (N == 4) *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
    else if constexpr (N == 2) *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
    else *p = v[0];
}

// The outputs of an R x C matrix over a team of T threads: CW (K10C_CW, or
// C when narrower) neighbouring columns a thread, NCG column groups, G row
// groups, MR rows a thread (rows g, g + G, ...); with GUARD some row groups
// have no row.
template <int R, int C, int T>
struct Lay {
    static constexpr int CW = C < K10C_CW ? C : K10C_CW;
    static constexpr int NCG = C / CW;
    static constexpr int G = T / NCG;
    static constexpr int MR = R > G ? R / G : 1;
    static constexpr bool GUARD = R < G;
};

// acc[m][q] = sum_{k < K} A[r * SA + k] * B[k * SB + c0 + q] for the
// thread's rows r = g + G m and columns c0 + q of ``Lay<R, C, T>``; the
// terms in the order k = 0, 1, ..., as the plain version sums them.
template <int R, int C, int K, int T, int SA, int SB>
static __device__ __forceinline__ void product(const int32_t* A, const int32_t* B, int tid,
                                               int (&acc)[Lay<R, C, T>::MR][Lay<R, C, T>::CW]) {
    using L = Lay<R, C, T>;
    constexpr int KS = K < 4 ? K : 4;
    const int c0 = (tid % L::NCG) * L::CW, g = tid / L::NCG;
#pragma unroll
    for (int m = 0; m < L::MR; ++m)
#pragma unroll
        for (int q = 0; q < L::CW; ++q) acc[m][q] = 0;
    if (L::GUARD && g >= R) return;
#pragma unroll
    for (int k = 0; k < K; k += KS) {
        int b[KS][L::CW];
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldv<L::CW>(B + (k + kk) * SB + c0, b[kk]);
#pragma unroll
        for (int m = 0; m < L::MR; ++m) {
            int a[KS];
            ldv<KS>(A + (g + L::G * m) * SA + k, a);
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
#pragma unroll
                for (int q = 0; q < L::CW; ++q) acc[m][q] += a[kk] * b[kk][q];
        }
    }
}

template <int T>
static __device__ __forceinline__ void team_sync() {
    if constexpr (T == 32) __syncwarp();
    else __syncthreads();
}

// Dead-zone (171) quantisation of one coefficient, and the dequantisation
// of one level, both clipped to 16 bits.
static __device__ __forceinline__ int quant1(int c, const Tile& t) {
    const int mag = (int)((uint32_t)abs(c) * (uint32_t)t.qscale + (uint32_t)t.add) >> t.q_bits;
    return clampi(c < 0 ? -mag : mag, COEFF_MIN, COEFF_MAX);
}

static __device__ __forceinline__ int deq1(int l, const Tile& t) {
    return clampi(dequant(clampi(l, COEFF_MIN, COEFF_MAX), t.iscale, t.rs), COEFF_MIN, COEFF_MAX);
}

// Output ``st`` of TU n: the slot after the stages of the mask before it.
static __device__ __forceinline__ int32_t* slot(int32_t* out, int stages, int st, int N, int n,
                                               int hw) {
    return out + ((size_t)__popc(stages & (st - 1)) * N + n) * hw;
}

// The thread's values of ``Lay<R, C, T>`` (row stride W in the output)
// through the quantiser and the dequantiser of the mask, each requested
// stage's output stored to global memory; ``v`` ends as the inverse's
// input.
template <int R, int C, int T, int W>
static __device__ __forceinline__ void elementwise(int (&v)[Lay<R, C, T>::MR][Lay<R, C, T>::CW],
                                                   bool live, int tid, const Tile& t, int stages,
                                                   int32_t* out, int N, int n, int hw) {
    using L = Lay<R, C, T>;
    const int c0 = (tid % L::NCG) * L::CW, g = tid / L::NCG;
    if (stages & ST_QUANT) {
        int32_t* o = slot(out, stages, ST_QUANT, N, n, hw);
#pragma unroll
        for (int m = 0; m < L::MR; ++m) {
#pragma unroll
            for (int q = 0; q < L::CW; ++q) v[m][q] = quant1(v[m][q], t);
            if (live) stv<L::CW>(o + (g + L::G * m) * W + c0, v[m]);
        }
    }
    if (stages & ST_DEQUANT) {
        int32_t* o = slot(out, stages, ST_DEQUANT, N, n, hw);
#pragma unroll
        for (int m = 0; m < L::MR; ++m) {
#pragma unroll
            for (int q = 0; q < L::CW; ++q) v[m][q] = deq1(v[m][q], t);
            if (live) stv<L::CW>(o + (g + L::G * m) * W + c0, v[m]);
        }
    }
}

// The values of ``Lay<R, C, T>`` into shared memory (row stride S).
template <int R, int C, int T, int S>
static __device__ __forceinline__ void to_shared(const int (&v)[Lay<R, C, T>::MR][Lay<R, C, T>::CW],
                                                 bool live, int tid, int32_t* dst) {
    using L = Lay<R, C, T>;
    const int c0 = (tid % L::NCG) * L::CW, g = tid / L::NCG;
    if (!live) return;
#pragma unroll
    for (int m = 0; m < L::MR; ++m) stv<L::CW>(dst + (g + L::G * m) * S + c0, v[m]);
}

template <int R, int C, int T, int S>
static __device__ __forceinline__ void from_shared(int (&v)[Lay<R, C, T>::MR][Lay<R, C, T>::CW],
                                                   int tid, const int32_t* src) {
    using L = Lay<R, C, T>;
    const int c0 = (tid % L::NCG) * L::CW, g = tid / L::NCG;
#pragma unroll
    for (int m = 0; m < L::MR; ++m)
#pragma unroll
        for (int q = 0; q < L::CW; ++q) v[m][q] = 0;
    if (L::GUARD && g >= R) return;
#pragma unroll
    for (int m = 0; m < L::MR; ++m) ldv<L::CW>(src + (g + L::G * m) * S + c0, v[m]);
}

// A core's address in global memory: row i of the n = 2^LN point core of
// ``kind`` (DCT-2 by stride from the 64-point core).
template <int LN>
static __device__ __forceinline__ const int32_t* core_row(const int32_t* d64, const int32_t* mts,
                                                          int kind, int i) {
    return kind == 0 ? d64 + (i << (6 - LN)) * 64
                     : mts + (((kind - 1) * 4 + LN - 2) * 32 + i) * 32;
}

// The loads of one core, issued (``issue``) before any is stored (``put``):
// vectors of V = min(4, n) entries, NV of them a thread.
template <int LN, int T>
struct CoreLoad {
    static constexpr int n = 1 << LN, V = n < 4 ? n : 4, NV = (n * n / V + T - 1) / T;
    int v[NV][V];

    __device__ __forceinline__ void issue(const int32_t* d64, const int32_t* mts, int kind,
                                          int tid) {
#pragma unroll
        for (int u = 0; u < NV; ++u) {
            const int e = (tid + u * T) * V;
            if (e < n * n) {
                const int32_t* p = core_row<LN>(d64, mts, kind, e >> LN) + (e & (n - 1));
                if constexpr (V == 4) {
                    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
                    v[u][0] = q.x, v[u][1] = q.y, v[u][2] = q.z, v[u][3] = q.w;
                } else {
#pragma unroll
                    for (int q = 0; q < V; ++q) v[u][q] = __ldg(p + q);
                }
            }
        }
    }

    // Rows (M[i][j]) and columns (MT[j][i]), both with stride S.
    template <int S>
    __device__ __forceinline__ void put(int32_t* M, int32_t* MT, int tid) const {
#pragma unroll
        for (int u = 0; u < NV; ++u) {
            const int e = (tid + u * T) * V;
            if (e < n * n) {
                const int i = e >> LN, j = e & (n - 1);
                stv<V>(M + i * S + j, v[u]);
#pragma unroll
                for (int q = 0; q < V; ++q) MT[(j + q) * S + i] = v[u][q];
            }
        }
    }
};

// One TU of h = 2^LH rows and w = 2^LW columns per block; LW or LH 0 is
// ISP's one-dimensional branch. Shared memory: the horizontal core as rows
// and columns, the vertical core likewise (or the same one), and two tiles.
template <int LW, int LH>
__global__ void __launch_bounds__(k10c_threads(1 << LW, 1 << LH))
seq_tq_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ d64,
              const int32_t* __restrict__ mts, int kind_h, int kind_v, int qp, int bd,
              int stages, int32_t* __restrict__ out) {
    constexpr int W = 1 << LW, H = 1 << LH, HW = W * H, T = k10c_threads(W, H);
    constexpr bool ONE_D = LW == 0 || LH == 0;
    constexpr int SW = k10c_stride(W), SH = k10c_stride(H);
    extern __shared__ int4 k10c_smem[];
    int32_t* sm = reinterpret_cast<int32_t*>(k10c_smem);
    const int tid = threadIdx.x, n = blockIdx.x, N = gridDim.x;
    const bool tr = stages & (ST_FWD | ST_INV);
    const Tile t = make_tile(W, W, H, qp, bd);

    if constexpr (ONE_D) {
        // the coded side of n1 samples, one core; the TU is n1 contiguous
        // values whichever way it stands
        constexpr int LN = LW + LH, N1 = 1 << LN, S = k10c_stride(N1);
        constexpr int KN = N1 < 32 ? N1 : 32;
        const int kind = W == 1 ? kind_v : kind_h;
        int32_t* M = sm;                   // core rows
        int32_t* MT = M + N1 * S;          // core columns
        int32_t* X = MT + N1 * S;          // the input, then the inverse's input
        using LX = Lay<1, N1, T>;
        CoreLoad<LN, T> cl;
        int xv[LX::MR][LX::CW];
        const int cx = (tid % LX::NCG) * LX::CW;
        const bool xlive = !(LX::GUARD && tid / LX::NCG >= 1);
        // the inverse over the first NK coefficients of X, clipped, stored
        auto inverse = [&](auto nk) {
            constexpr int NK = decltype(nk)::value;
            int r[LX::MR][LX::CW];
            product<1, N1, NK, T, S, S>(X, M, tid, r);
            const int s2 = (6 + 15 - 1) - bd + 1;
#pragma unroll
            for (int q = 0; q < LX::CW; ++q)
                r[0][q] = clampi(rshift_any(r[0][q], s2), COEFF_MIN, COEFF_MAX);
            if (xlive) stv<LX::CW>(slot(out, stages, ST_INV, N, n, HW) + cx, r[0]);
        };
        if (xlive) ldv<LX::CW>(x + (size_t)n * HW + cx, xv[0]);
        if (tr) cl.issue(d64, mts, kind, tid);
        if (tr) cl.template put<S>(M, MT, tid);
        if (xlive) stv<LX::CW>(X + cx, xv[0]);
        team_sync<T>();
        if (stages & ST_FWD) {
            using L = Lay<1, KN, T>;
            int v[L::MR][L::CW];
            product<1, KN, N1, T, S, S>(X, MT, tid, v);
            const bool live = !(L::GUARD && tid / L::NCG >= 1);
            const int c0 = (tid % L::NCG) * L::CW, kn = keep(kind, N1), s = LN + bd + 6 - 15;
#pragma unroll
            for (int q = 0; q < L::CW; ++q) v[0][q] = c0 + q < kn ? rshift_any(v[0][q], s) : 0;
            if (live) stv<L::CW>(slot(out, stages, ST_FWD, N, n, HW) + c0, v[0]);
            if constexpr (KN < N1) {       // the zeroed-out coefficients
                constexpr int NZ = (N1 - KN) / 4;
                for (int e = tid; e < NZ; e += T) {
                    const int z[4] = {0, 0, 0, 0};
                    for (int st = ST_FWD; st <= ST_DEQUANT; st <<= 1)
                        if (stages & st) stv<4>(slot(out, stages, st, N, n, HW) + KN + 4 * e, z);
                }
            }
            elementwise<1, KN, T, N1>(v, live, tid, t, stages, out, N, n, HW);
            if (stages & ST_INV) {
                team_sync<T>();            // every read of X is done
                to_shared<1, KN, T, S>(v, live, tid, X);
                team_sync<T>();
                inverse(std::integral_constant<int, KN>());
            }
        } else {
            if (stages & (ST_QUANT | ST_DEQUANT)) {
                elementwise<1, N1, T, N1>(xv, xlive, tid, t, stages, out, N, n, HW);
                if (stages & ST_INV) {
                    to_shared<1, N1, T, S>(xv, xlive, tid, X);
                    team_sync<T>();
                }
            }
            if (stages & ST_INV) inverse(std::integral_constant<int, N1>());
        }
    } else {
        constexpr int KW = W < 32 ? W : 32, KH = H < 32 ? H : 32;
        const bool one_core = kind_h == kind_v && W == H;
        int32_t* Mw = sm;                  // horizontal core: rows, columns
        int32_t* MwT = Mw + W * SW;
        int32_t* Mh = one_core ? Mw : MwT + W * SW;
        int32_t* MhT = one_core ? MwT : Mh + H * SH;
        int32_t* X = MwT + W * SW + 2 * H * SH;   // the input, then the inverse's input
        int32_t* Y = X + H * SW;                  // the middle of each transform
        // the load round: the TU's vectors, then both cores', then the stores
        constexpr int NXV = (HW / 4 + T - 1) / T;
        int4 xv[NXV];
#pragma unroll
        for (int u = 0; u < NXV; ++u)
            if (tid + u * T < HW / 4)
                xv[u] = *reinterpret_cast<const int4*>(x + (size_t)n * HW + 4 * (tid + u * T));
        CoreLoad<LW, T> cw;
        CoreLoad<LH, T> ch;
        if (tr) {
            cw.issue(d64, mts, kind_h, tid);
            if (!one_core) ch.issue(d64, mts, kind_v, tid);
        }
#pragma unroll
        for (int u = 0; u < NXV; ++u) {
            const int e = 4 * (tid + u * T);
            if (e < HW) *reinterpret_cast<int4*>(X + (e >> LW) * SW + (e & (W - 1))) = xv[u];
        }
        if (tr) {
            cw.template put<SW>(Mw, MwT, tid);
            if (!one_core) ch.template put<SH>(Mh, MhT, tid);
        }
        team_sync<T>();

        // the inverse: the vertical stage over NK coefficient rows and CI
        // columns (X -> Y), the horizontal over CI (Y -> registers)
        auto inverse = [&](auto nk, auto ci) {
            constexpr int NK = decltype(nk)::value, CI = decltype(ci)::value;
            {
                using L = Lay<H, CI, T>;
                int e[L::MR][L::CW];
                product<H, CI, NK, T, SH, SW>(MhT, X, tid, e);
#pragma unroll
                for (int m = 0; m < L::MR; ++m)
#pragma unroll
                    for (int q = 0; q < L::CW; ++q)
                        e[m][q] = clampi(rshift_any(e[m][q], 7), COEFF_MIN, COEFF_MAX);
                to_shared<H, CI, T, SW>(e, !(L::GUARD && tid / L::NCG >= H), tid, Y);
            }
            team_sync<T>();
            using L = Lay<H, W, T>;
            int r[L::MR][L::CW];
            product<H, W, CI, T, SW, SW>(Y, Mw, tid, r);
            const int c0 = (tid % L::NCG) * L::CW, g = tid / L::NCG, s2 = 6 + 15 - 1 - bd;
            if (L::GUARD && g >= H) return;
            int32_t* o = slot(out, stages, ST_INV, N, n, HW);
#pragma unroll
            for (int m = 0; m < L::MR; ++m) {
#pragma unroll
                for (int q = 0; q < L::CW; ++q)
                    r[m][q] = clampi(rshift_any(r[m][q], s2), COEFF_MIN, COEFF_MAX);
                stv<L::CW>(o + (g + L::G * m) * W + c0, r[m]);
            }
        };

        if (stages & ST_FWD) {
            // horizontal: Y[y][i] = rshift(sum_j X[y][j] Tw[i][j], s1), i < KW
            {
                using L = Lay<H, KW, T>;
                int a[L::MR][L::CW];
                product<H, KW, W, T, SW, SW>(X, MwT, tid, a);
                const int s1 = LW + bd + 6 - 15;
#pragma unroll
                for (int m = 0; m < L::MR; ++m)
#pragma unroll
                    for (int q = 0; q < L::CW; ++q) a[m][q] = rshift(a[m][q], s1);
                to_shared<H, KW, T, SW>(a, !(L::GUARD && tid / L::NCG >= H), tid, Y);
            }
            team_sync<T>();
            // vertical: C[k][i] = rshift(sum_y Th[k][y] Y[y][i], s2), zero
            // beyond the kept (kh, kw)
            using L = Lay<KH, KW, T>;
            int v[L::MR][L::CW];
            product<KH, KW, H, T, SH, SW>(Mh, Y, tid, v);
            const int c0 = (tid % L::NCG) * L::CW, g = tid / L::NCG, s2 = LH + 6;
            const int kw = keep(kind_h, W), kh = keep(kind_v, H);
            const bool live = !(L::GUARD && g >= KH);
            int32_t* o = slot(out, stages, ST_FWD, N, n, HW);
#pragma unroll
            for (int m = 0; m < L::MR; ++m) {
#pragma unroll
                for (int q = 0; q < L::CW; ++q)
                    v[m][q] = g + L::G * m < kh && c0 + q < kw ? rshift(v[m][q], s2) : 0;
                if (live) stv<L::CW>(o + (g + L::G * m) * W + c0, v[m]);
            }
            if constexpr (KW < W || KH < H) {  // the zeroed-out coefficients
#pragma unroll
                for (int u = 0; u < NXV; ++u) {
                    const int e = 4 * (tid + u * T);
                    const int z[4] = {0, 0, 0, 0};
                    if (e < HW && ((e >> LW) >= KH || (e & (W - 1)) >= KW))
                        for (int st = ST_FWD; st <= ST_DEQUANT; st <<= 1)
                            if (stages & st) stv<4>(slot(out, stages, st, N, n, HW) + e, z);
                }
            }
            elementwise<KH, KW, T, W>(v, live, tid, t, stages, out, N, n, HW);
            if (stages & ST_INV) {
                to_shared<KH, KW, T, SW>(v, live, tid, X);   // X was read before the last barrier
                team_sync<T>();
                inverse(std::integral_constant<int, KH>(), std::integral_constant<int, KW>());
            }
        } else {
            if (stages & (ST_QUANT | ST_DEQUANT)) {
                using L = Lay<H, W, T>;
                int v[L::MR][L::CW];
                from_shared<H, W, T, SW>(v, tid, X);
                const bool live = !(L::GUARD && tid / L::NCG >= H);
                elementwise<H, W, T, W>(v, live, tid, t, stages, out, N, n, HW);
                if (stages & ST_INV) {
                    to_shared<H, W, T, SW>(v, live, tid, X);   // each thread its own entries
                    team_sync<T>();
                }
            }
            if (stages & ST_INV)
                inverse(std::integral_constant<int, H>(), std::integral_constant<int, W>());
        }
    }
}

// Dynamic shared memory of a TU's block, in bytes.
static constexpr size_t k10c_smem_bytes(int lw, int lh) {
    const int w = 1 << lw, h = 1 << lh;
    if (lw == 0 || lh == 0) {
        const int n = w * h, s = k10c_stride(n);
        return (size_t)(2 * n * s + s) * sizeof(int32_t);
    }
    const int sw = k10c_stride(w), sh = k10c_stride(h);
    return (size_t)(2 * w * sw + 2 * h * sh + 2 * h * sw) * sizeof(int32_t);
}

template <int LW, int LH>
static int k10c_launch(const int32_t* x, const int32_t* d64, const int32_t* mts, int N,
                       int kind_h, int kind_v, int qp, int bd, int stages, int32_t* out,
                       cudaStream_t stream) {
    constexpr size_t smem = k10c_smem_bytes(LW, LH);
    if constexpr (smem > 48 * 1024) {   // per launch: the attribute is per device
        const cudaError_t e = cudaFuncSetAttribute(
            seq_tq_kernel<LW, LH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    seq_tq_kernel<LW, LH><<<N, k10c_threads(1 << LW, 1 << LH), smem, stream>>>(
        x, d64, mts, kind_h, kind_v, qp, bd, stages, out);
    return (int)cudaGetLastError();
}

typedef int (*K10cLaunch)(const int32_t*, const int32_t*, const int32_t*, int, int, int, int,
                          int, int, int32_t*, cudaStream_t);

#define K10C_ROW(LH) {k10c_launch<0, LH>, k10c_launch<1, LH>, k10c_launch<2, LH>, \
                      k10c_launch<3, LH>, k10c_launch<4, LH>, k10c_launch<5, LH>, \
                      k10c_launch<6, LH>}
static const K10cLaunch K10C_LAUNCH[7][7] = {K10C_ROW(0), K10C_ROW(1), K10C_ROW(2), K10C_ROW(3),
                                             K10C_ROW(4), K10C_ROW(5), K10C_ROW(6)};

// Whether a kind's core covers a coded side of n: DCT-2 any, DST-7 / DCT-8
// 4..32. ISP's uncoded side (of 1) takes any kind, as the wrapper does.
static bool k10c_side(int kind, int n, bool coded) {
    return kind == 0 || !coded || (n >= 4 && n <= 32);
}

extern "C" int pmp_seq_tq(const int32_t* x, const int32_t* d64, const int32_t* mts, int N,
                          int w, int h, int kind_h, int kind_v, int qp, int bd,
                          int stages, int32_t* out, cudaStream_t stream) {
    if (N == 0) return 0;
    if ((stages & 15) == 0 || (stages & ~15) || w < 1 || h < 1 || w > 64 || h > 64 || qp < 0 ||
        (w & (w - 1)) || (h & (h - 1)) || ((uintptr_t)x & 15) || ((uintptr_t)out & 15))
        return (int)cudaErrorInvalidValue;
    // the coded sides: both of a 2-D TU; w of a 1xN row, h of an Nx1 column
    // or a 1x1 TU
    if (kind_h < 0 || kind_h > 2 || kind_v < 0 || kind_v > 2 ||
        !k10c_side(kind_h, w, w > 1) || !k10c_side(kind_v, h, h > 1 || w == 1))
        return (int)cudaErrorInvalidValue;
    return K10C_LAUNCH[31 - __builtin_clz(h)][31 - __builtin_clz(w)](
        x, d64, mts, N, kind_h, kind_v, qp, bd, stages, out, stream);
}
