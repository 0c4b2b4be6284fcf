// K10d: SATD of K candidates against one block with VTM's tile rule, for the
// sequential FrameEncoder.
//
// Replaces pmp_vvc_tpu/ops/distortion.py:satd (86) with _tile_shape (39) and
// _satd_tiles (59) (RdCost.cpp xGetHADs :2828-2951): the block is cut into
// 8x16, 16x8, 4x8, 8x4, 8x8, 4x4 or 2x2 tiles (the first that fits, in
// that order); each tile's 2-D Walsh-Hadamard transform of org - cur, the sum
// of |coefficients| with the DC term replaced by |DC| >> 2, then
// (s + 2) >> 2 for 8x8, (s + 1) >> 1 for 4x4, s for 2x2, and for the
// non-square tiles trunc(float32(s) * float32(2 / sqrt(th * tw))): the JAX
// package multiplies its float32 tile sum by that Python float, which it
// rounds to float32 first, in one float32 product; __fmul_rn on the same
// float32 scale rounds alike and is never contracted. The Hadamard sums are
// integers (exact in float32 while below 2^24, as at these sizes), summed
// here in int32.
//
// Bound: bytes (chip_smoke.py:seq_bounds). A 64x64 block's 67 candidates
// read 1.1 MB of int32 samples at ~20 integer operations per sample; the
// encoder's calls are 2-67 candidates of 4x4 to 64x64, so a call costs its
// launch and its chain: the loads, the butterflies and the sums. The
// design:
//
//   - The warp form of the tiles (csrc/satd.cuh: warp_tile_had): one tile
//     row a lane, its TW values in registers, the row butterflies in
//     registers and the column butterflies across the tile's lanes by
//     shuffles, each tile normalised in its own lanes before any sum
//     across tiles.
//   - Where a candidate's tile rows (w * h / tw) fit a warp, a warp takes
//     32 / rows candidates at once (8 at 4x4, one at 16x16), K10D_WARPS (2)
//     warps a block, and shuffles sum each candidate's tiles. Above that, a
//     block per candidate of up to K10D_WARPS_LARGE (4) warps, each taking
//     passes of 32 tile rows (a 64x64 block is 512), one shared-memory sum.
//     No atomics.
//   - Every load of a lane is issued before any is used: its rows of the
//     candidate and of the original (int4, or int2 for 2x2 tiles), a
//     broadcast original's straight from global memory (L1 and L2 serve
//     the block's repeats; staging it in shared memory once a block, as
//     first written, was slower on an H100 at every block whose candidates
//     fit a warp: the barrier and the second trip cost more than the
//     repeated reads).
//   - The inputs must be 16-byte aligned (the wrapper checks); a tile shape
//     other than VTM's returns cudaErrorInvalidValue.
#include <cuda_runtime.h>
#include <stdint.h>

#include "satd.cuh"

#ifndef K10D_WARPS
#define K10D_WARPS 2                     // warps a block where candidates fit a warp
#endif
#ifndef K10D_WARPS_LARGE
#define K10D_WARPS_LARGE 4               // warps a candidate at most above that
#endif
#ifndef K10D_CPW_MAX
#define K10D_CPW_MAX 32                  // candidates a warp at most
#endif
#define K10D_CHUNKS 4                    // passes of a lane whose loads go out together

// TW neighbouring samples from an aligned address.
template <int TW>
static __device__ __forceinline__ void ld_row(const int32_t* p, int (&v)[TW]) {
    if constexpr (TW == 2) {
        const int2 q = __ldg(reinterpret_cast<const int2*>(p));
        v[0] = q.x, v[1] = q.y;
    } else {
#pragma unroll
        for (int j = 0; j < TW; j += 4) {
            const int4 q = __ldg(reinterpret_cast<const int4*>(p + j));
            v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
        }
    }
}

// The sample offset of tile row ``rr`` of a w-wide block of TH x TW tiles,
// nx tiles a row.
template <int TH, int TW>
static __device__ __forceinline__ int row_offset(int rr, int w, int nx) {
    const int t = rr / TH, ri = rr % TH;
    return ((t / nx) * TH + ri) * w + (t % nx) * TW;
}

// Candidates that fit a warp: ``ls`` = 2^lls lanes a candidate (its
// ``rows`` tile rows, the rest idle), 32 / ls candidates a warp.
template <int TH, int TW>
__global__ void __launch_bounds__(32 * K10D_WARPS)
seq_satd_warps(const int32_t* __restrict__ org, const int32_t* __restrict__ cur, int K,
               int org_step, int w, int h, int rows, int lls, float scale,
               int32_t* __restrict__ out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, hw = w * h;
    const int rr = lane & ((1 << lls) - 1);
    const int k = ((blockIdx.x * K10D_WARPS + warp) << (5 - lls)) + (lane >> lls);
    const bool live = k < K && rr < rows;
    const int off = row_offset<TH, TW>(rr, w, w / TW);
    int c[TW] = {}, o[TW] = {};
    if (live) {
        ld_row<TW>(cur + (size_t)k * hw + off, c);
        ld_row<TW>(org + (size_t)k * org_step + off, o);
    }
    int d[TW];
#pragma unroll
    for (int j = 0; j < TW; ++j) d[j] = o[j] - c[j];
    int v = warp_tile_had<TH, TW>(d, scale);
    for (int len = TH; len < (1 << lls); len <<= 1) v += __shfl_xor_sync(0xffffffffu, v, len);
    if (k < K && rr == 0) out[k] = v;
}

// A candidate of more tile rows than a warp: a block per candidate, its
// warps taking passes of 32 tile rows, K10D_CHUNKS passes' loads at once.
template <int TH, int TW>
__global__ void __launch_bounds__(32 * K10D_WARPS_LARGE)
seq_satd_spans(const int32_t* __restrict__ org, const int32_t* __restrict__ cur, int org_step,
               int w, int h, int rows, float scale, int32_t* __restrict__ out) {
    __shared__ int red[K10D_WARPS_LARGE];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int k = blockIdx.x, nx = w / TW;
    const int32_t* cb = cur + (size_t)k * w * h;
    const int32_t* ob = org + (size_t)k * org_step;
    int acc = 0;
    for (int p0 = warp * 32; p0 < rows; p0 += K10D_CHUNKS * nw * 32) {
        int c[K10D_CHUNKS][TW] = {}, o[K10D_CHUNKS][TW] = {};
#pragma unroll
        for (int u = 0; u < K10D_CHUNKS; ++u) {
            const int rr = p0 + u * nw * 32 + lane;
            if (rr < rows) ld_row<TW>(cb + row_offset<TH, TW>(rr, w, nx), c[u]);
        }
#pragma unroll
        for (int u = 0; u < K10D_CHUNKS; ++u) {
            const int rr = p0 + u * nw * 32 + lane;
            if (rr < rows) ld_row<TW>(ob + row_offset<TH, TW>(rr, w, nx), o[u]);
        }
#pragma unroll
        for (int u = 0; u < K10D_CHUNKS; ++u) {
            if (p0 + u * nw * 32 >= rows) break;        // the same for the whole warp
            int d[TW];
#pragma unroll
            for (int j = 0; j < TW; ++j) d[j] = o[u][j] - c[u][j];
            const int v = warp_tile_had<TH, TW>(d, scale);
            acc += lane % TH == 0 ? v : 0;
        }
    }
#pragma unroll
    for (int len = 16; len > 0; len >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, len);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        int s = 0;
        for (int i = 0; i < nw; ++i) s += red[i];
        out[k] = s;
    }
}

template <int TH, int TW>
static int k10d_launch(const int32_t* org, const int32_t* cur, int K, int org_step, int w,
                       int h, float scale, int32_t* out, cudaStream_t stream) {
    const int rows = w * h / TW;
    int ls = 32 / K10D_CPW_MAX;                    // lanes a candidate where it fits a warp
    while (ls < rows) ls <<= 1;
    if (ls <= 32) {
        const int lls = 31 - __builtin_clz(ls), per_block = K10D_WARPS * (32 >> lls);
        seq_satd_warps<TH, TW><<<(K + per_block - 1) / per_block, 32 * K10D_WARPS, 0, stream>>>(
            org, cur, K, org_step, w, h, rows, lls, scale, out);
    } else {
        int nw = (rows + 31) / 32;
        nw = nw > K10D_WARPS_LARGE ? K10D_WARPS_LARGE : nw;
        seq_satd_spans<TH, TW><<<K, 32 * nw, 0, stream>>>(org, cur, org_step, w, h, rows, scale,
                                                          out);
    }
    return (int)cudaGetLastError();
}

extern "C" int pmp_seq_satd(const int32_t* org, const int32_t* cur, int K,
                            int org_step, int w, int h, int th, int tw,
                            float scale, int32_t* out, cudaStream_t stream) {
    if (K == 0) return 0;
    if (w < 1 || h < 1 || w % tw || h % th || ((uintptr_t)org & 15) || ((uintptr_t)cur & 15) ||
        (org_step % 4))
        return (int)cudaErrorInvalidValue;
    const int shape = th * 100 + tw;
    switch (shape) {
        case 816: return k10d_launch<8, 16>(org, cur, K, org_step, w, h, scale, out, stream);
        case 1608: return k10d_launch<16, 8>(org, cur, K, org_step, w, h, scale, out, stream);
        case 408: return k10d_launch<4, 8>(org, cur, K, org_step, w, h, scale, out, stream);
        case 804: return k10d_launch<8, 4>(org, cur, K, org_step, w, h, scale, out, stream);
        case 808: return k10d_launch<8, 8>(org, cur, K, org_step, w, h, scale, out, stream);
        case 404: return k10d_launch<4, 4>(org, cur, K, org_step, w, h, scale, out, stream);
        case 202: return k10d_launch<2, 2>(org, cur, K, org_step, w, h, scale, out, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
