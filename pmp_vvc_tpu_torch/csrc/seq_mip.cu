// K10b: every MIP candidate of N blocks of one size, for the sequential
// FrameEncoder.
//
// Replaces pmp_vvc_tpu/ops/mip.py:predict_mip_all (75), which
// codec/encoder.py:_jit_mip (64) jits per block size.
//
// The output is (N, 2 * n_modes, h, w): candidate t * n_modes + m is the
// prediction of mode m with transpose flag t, from the block's unfiltered
// top and left references (index 1.. of the 2W+3 / 2H+3 rows, index 0 being
// the corner). The per-sample formulas are csrc/mip.cuh's, shared with K3.
//
// Bound: bytes. A 16x16 block writes 12 candidates of 256 samples (12 KB)
// from ~140 bytes of references, at ~10 integer operations per upsampled
// sample; a call is its launch and its chain of dependent steps.
//
// Design for the H100 (K3's front, csrc/mip_rmd.cu, without its cluster
// and its SATD):
// - A block per candidate, or per few at 4x4 (K10B_SAMPLES output samples
//   a block at most, one candidate at least: 4 candidates a block at 4x4),
//   the shares as even as the count of blocks allows. A call's chain is its
//   passes, and a thread's second item in a pass costs about as much as its
//   first: one item a thread is the shortest chain (chip_smoke.py's
//   K10B_VARIANTS times a block per CU, with a thread's items in turn).
// - One round of loads before the first barrier: the unfiltered top and
//   left rows into shared memory with scalar loads (the rows arrive as
//   views at odd offsets of one upload), the packed boundaries from device
//   memory one thread a sample (mip_down issues a group's loads at once),
//   and each thread's weight rows of the reduced grid, two 16-byte loads a
//   row.
// - Then the block's every reduced grid at once (one thread a reduced
//   sample), every horizontal pass at once into shared memory (one thread a
//   sample), and the vertical pass straight to the output from registers,
//   four samples a thread and one 16-byte store: three barriers a call.
// Each call makes one launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mip.cuh"

// The kernel's shape. One value of each ships; chip_smoke.py's
// K10B_VARIANTS builds the others to time them beside it.
#ifndef K10B_WARPS
#define K10B_WARPS 4                   // warps per block
#endif
#ifndef K10B_SAMPLES
#define K10B_SAMPLES 64                // output samples a block at most (but one candidate)
#endif
#define NT (32 * K10B_WARPS)
#define CLAMP_SIZE(v, lo, hi) ((v) < (lo) ? (lo) : (v) > (hi) ? (hi) : (v))
// A block's candidates: at most max(1, K10B_SAMPLES / (w * h)); their
// reduced samples at most max(K10B_SAMPLES, 64) (a grid has at most w * h
// and at most 64 of them), at most 12 candidates of 8x8; their horizontal
// passes at most max(K10B_SAMPLES, 8 rows of 64), at most 12 of those.
#define MAX_RED CLAMP_SIZE(K10B_SAMPLES, 64, 12 * 64)
#define MAX_HOR CLAMP_SIZE(K10B_SAMPLES, 8 * MIP_MAXP, 12 * 8 * MIP_MAXP)
#define RPT ((MAX_RED + NT - 1) / NT)  // reduced samples a thread
static_assert(NT >= MIP_MAXP, "a thread a reference sample");

__global__ void __launch_bounds__(NT)
seq_mip_kernel(const int32_t* __restrict__ top, const int32_t* __restrict__ left,
               const int32_t* __restrict__ mats, int w, int h, int bd, int cpb,
               int32_t* __restrict__ out) {
    __shared__ __align__(16) int32_t stop[MIP_MAXP];
    __shared__ int32_t sleft[MIP_MAXP];
    __shared__ int32_t sbdry[2 * 8];
    __shared__ int32_t sred[MAX_RED];
    __shared__ __align__(16) int32_t shor[MAX_HOR];
    const int n = blockIdx.y, tid = threadIdx.x;
    Mip c;
    mip_size_class(c, w, h);
    c.P = w; c.bd = bd;
    c.top = stop; c.left = sleft; c.mats = mats; c.bdry = sbdry;
    const int ncand = 2 * c.n_modes;
    const int v0 = blockIdx.x * cpb, nc = min(cpb, ncand - v0);   // this block's candidates
    const int lrp = ilog2(c.red_p), lrr = 2 * lrp, lw = ilog2(w), lh = ilog2(h);
    const int32_t* tn = top + (size_t)n * (2 * w + 3) + 1;
    const int32_t* ln = left + (size_t)n * (2 * h + 3) + 1;

    // one round of loads into registers, every address clamped into its
    // array, so that no load waits behind a branch or a store; each thread
    // takes boundary sample tid % (2 * red_b) (the first 2 * red_b store it)
    const int rt = tn[min(tid, w - 1)], rl = ln[min(tid, h - 1)];
    const int jb = tid % (2 * c.red_b), lft = jb >= c.red_b, j = jb - (lft ? c.red_b : 0);
    const int bv = mip_down(lft ? ln : tn, lft ? h : w, c.red_b, j);
    const int nred = nc << lrr;
    int wt[RPT][8];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
        const int e = min(tid + q * NT, nred - 1), v = v0 + (e >> lrr), t = v >= c.n_modes;
        const int4* row = reinterpret_cast<const int4*>(
            mip_row(c, t, v - t * c.n_modes, (e >> lrp) & (c.red_p - 1), e & (c.red_p - 1)));
        const int4 a = __ldg(row), b = __ldg(row + 1);
        wt[q][0] = a.x; wt[q][1] = a.y; wt[q][2] = a.z; wt[q][3] = a.w;
        wt[q][4] = b.x; wt[q][5] = b.y; wt[q][6] = b.z; wt[q][7] = b.w;
    }
    if (tid < w) stop[tid] = rt;
    if (tid < h) sleft[tid] = rl;
    if (tid < 2 * c.red_b) {           // the packed boundaries
        sbdry[(lft ? c.red_b : 0) + j] = bv;                 // [top, left]
        sbdry[8 + (lft ? 0 : c.red_b) + j] = bv;             // [left, top]
    }
    __syncthreads();                   // the rows and the boundaries are in

#pragma unroll
    for (int q = 0; q < RPT; ++q) {    // every candidate's reduced grid
        const int e = tid + q * NT;
        if (e < nred) sred[e] = mip_reduce(c, v0 + (e >> lrr) >= c.n_modes, wt[q]);
    }
    __syncthreads();

    const int lf_h = lw - lrp, f_h = 1 << lf_h, lrw = lrp + lw;
#pragma unroll 4
    for (int e = tid; e < nc << lrw; e += NT) {              // every horizontal pass
        const int vl = e >> lrw, rr = (e >> lw) & (c.red_p - 1), x = e & (w - 1);
        const int jh = x >> lf_h, ph = (x & (f_h - 1)) + 1;
        const int32_t* red = sred + (vl << lrr) + (rr << lrp);
        const int prev = jh == 0 ? mip_left(c, rr) : red[jh - 1];
        shor[e] = mip_up(prev, red[jh], ph, f_h, lf_h);
    }
    __syncthreads();

    // the vertical pass against the top row, four samples of a row a thread
    const int lf_v = lh - lrp, f_v = 1 << lf_v, lq = lw - 2, lcand = lh + lq;
    int32_t* o = out + ((size_t)n * ncand + v0) * w * h;
#pragma unroll 4
    for (int e = tid; e < nc << lcand; e += NT) {
        const int vl = e >> lcand, y = (e >> lq) & (h - 1), x = (e & ((1 << lq) - 1)) << 2;
        const int jv = y >> lf_v, pv = (y & (f_v - 1)) + 1;
        const int32_t* hp = shor + ((vl << lrp) + jv) * w + x;
        const int4 cur = *reinterpret_cast<const int4*>(hp);
        const int4 prev = *reinterpret_cast<const int4*>(jv == 0 ? stop + x : hp - w);
        *reinterpret_cast<int4*>(o + ((vl << lh) + y) * w + x) =
            make_int4(mip_up(prev.x, cur.x, pv, f_v, lf_v), mip_up(prev.y, cur.y, pv, f_v, lf_v),
                      mip_up(prev.z, cur.z, pv, f_v, lf_v), mip_up(prev.w, cur.w, pv, f_v, lf_v));
    }
}

extern "C" int pmp_seq_mip(const int32_t* top, const int32_t* left,
                           const int32_t* mats, int N, int w, int h, int bd,
                           int32_t* out, cudaStream_t stream) {
    if (N == 0) return 0;
    if (w < 4 || h < 4 || w > MIP_MAXP || h > MIP_MAXP || (w & (w - 1)) || (h & (h - 1)))
        return (int)cudaErrorInvalidValue;
    const int n_modes = (w == 4 && h == 4) ? 16 : (w == 4 || h == 4 || (w == 8 && h == 8)) ? 8 : 6;
    const int ncand = 2 * n_modes;
    const int blocks = (ncand + max(1, K10B_SAMPLES / (w * h)) - 1) / max(1, K10B_SAMPLES / (w * h));
    const int cpb = (ncand + blocks - 1) / blocks;           // the shares as even as they go
    dim3 grid((ncand + cpb - 1) / cpb, N);
    seq_mip_kernel<<<grid, NT, 0, stream>>>(top, left, mats, w, h, bd, cpb, out);
    return (int)cudaGetLastError();
}
