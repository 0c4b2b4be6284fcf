// K2: intra prediction with rough mode decision (luma) or DM (chroma).
//
// Replaces pmp_vvc_tpu/ops/intra_generic.py:predict_generic (142) with
// _planar_dc (90), ops/tq_generic.py:satd_generic (160), and the RMD of
// codec/wavefront.py:_make_class_apply (373-401).
//
// Luma: the 35 RMD candidates (planar, DC, the 33 even angulars) are scored
// by masked Hadamard SATD against the original; the first minimum in
// candidate order wins, then clip(m -+ 1, 2, 66) are scored and compared in
// the order [m, m-1, m+1] with a strict <, and the chosen mode's prediction
// is written, zero outside the CU. Chroma: the DM mode is read from the luma
// mode grid at the CU centre and predicted with the 2-tap filter on the
// unfiltered references. Padding rows give mode 0 and an all-zero tile.
//
// Bound: operations. A 32x32 luma CU costs 37 candidate predictions of 1,024
// samples (~12 integer operations each) and their Hadamard SATDs; the bytes
// (references, the original tile, the prediction written) are small beside
// that. All arithmetic is int32: a 64x64 CU's SATD stays below 2^23.
//
// Design for the H100 (intra_rmd_luma):
// - One thread block cluster of K2_CLUSTER blocks per CU, so that a step's
//   16 CUs of the 32-pad class occupy ~128 SMs instead of 16. Every block
//   loads the CU's references and original into its own shared memory. At
//   64 registers a thread two blocks fit an SM, so that all 16 clusters of
//   a step run at once.
// - The work is (candidate, pass) items, spread over every warp of the
//   cluster: a pass is up to four 8x8 tiles (or eight 4x4) of one candidate,
//   one tile line per lane (a row, or for a horizontal mode a column).
//   Each lane predicts its line straight into registers from one window of
//   references and one set of taps (csrc/intra_pred.cuh: predict_line) and
//   the warp takes the tiles' SATD in registers and shuffles
//   (csrc/satd.cuh: warp_tile_satd); lane 0 adds the item's sum to the
//   candidate's cost slot in the leader block's shared memory over
//   distributed shared memory (atomicAdd; integer sums, so the order does
//   not matter).
// - Each block computes the parameters of all 67 modes once, one thread a
//   mode (mode_table: the 67 threads' table reads coalesce, and overlap the
//   loads of the references and the original; DC's reference sum is a warp
//   reduction, warp_dc), into shared memory, so that no item, refinement or
//   final prediction waits on them. The leader writes the final prediction
//   up to four samples of a line a thread (predict_line).
// - After a cluster barrier every block takes the argmin of the 64-bit keys
//   (cost << 32) | candidate, which is exactly the first minimum; the two
//   refinement candidates are scored the same way, and after one more
//   barrier the leader block compares [m, m-1, m+1] and writes the mode and
//   the prediction.
// - Tensor cores do not serve: after one Hadamard pass an 8x8 tile's values
//   reach +-8,184, past fp16's exact integers, and int8 cannot hold the
//   11-bit differences. The references and the original (at most ~18 KB)
//   are read once per block, so TMA brings nothing either.
// The chroma DM needs no search: intra_dm_kernel, one block per (CU,
// plane), P * P / 256 output samples a thread (one at the 16-pad class, four
// at the 32-pad). Each call makes one launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_pred.cuh"
#include "satd.cuh"

namespace cg = cooperative_groups;

// The luma kernel's shape. One value of each ships; chip_smoke.py's
// K2_VARIANTS builds the others to time them beside it.
#ifndef K2_CLUSTER
#define K2_CLUSTER 8                   // blocks per luma CU: the portable cluster size
#endif
#ifndef K2_WARPS
#define K2_WARPS 16                    // warps per block
#endif
#ifndef K2_BLOCKS_PER_SM
#define K2_BLOCKS_PER_SM 2             // 64 registers a thread: two blocks share an SM
#endif
#define NT (32 * K2_WARPS)
#define NT_DM 256
#define MAXP 64
#define MAXL (2 * MAXP + 3)
#define OSTRIDE (MAXP + 1)             // the original's row stride: no bank conflicts
#define NRMD 35
#define FULL 0xffffffffu

// The CU of row r (luma units) with its plane's reference rows in ``sref``.
static __device__ Cu load_cu(const int32_t* __restrict__ refs, const int32_t* r,
                             const int32_t* __restrict__ tabs, int32_t (*sref)[MAXL],
                             int pl, int b, int B, int P, int luma, int bd) {
    const int scale = luma ? 1 : 2, L = 2 * P + 3;
    Cu c;
    c.w = r[3] / scale; c.h = r[4] / scale;
    c.lw = ilog2(c.w); c.lh = ilog2(c.h);
    c.P = P; c.L = L; c.pel_max = (1 << bd) - 1; c.luma = luma;
    c.tabs = tabs;
    for (int i = threadIdx.x; i < 4 * L; i += blockDim.x) {
        const int k = i / L, j = i % L;
        sref[k][j] = refs[((size_t)(pl * 4 + k) * B + b) * L + j];
    }
    c.tu = sref[0]; c.lu = sref[1]; c.tf = sref[2]; c.lf = sref[3];
    return c;
}

// The P x P prediction tile of mode p, zero outside the CU, N samples of a
// line at a time: along a row, or for a horizontal mode along a column
// (predict_line). Every thread of the block calls it.
template <int N>
static __device__ void write_lines(const Cu& c, const Mode& p, int32_t* out) {
    const bool hor = p.mode >= 2 && !p.ver;
    const int nl = hor ? c.w : c.h, ns = hor ? c.h : c.w;    // lines, samples a line
    for (int i = threadIdx.x; i < c.P * c.P / N; i += blockDim.x) {
        // line a, samples s0 .. s0 + N - 1; neighbouring threads store neighbouring samples
        const int a = hor ? i % c.P : i / (c.P / N), s0 = N * (hor ? i / c.P : i % (c.P / N));
        int v[N];
#pragma unroll
        for (int j = 0; j < N; ++j) v[j] = 0;
        if (a < nl && s0 < ns) {
            if (p.mode >= 2) {
                predict_line<N>(c, p, a, s0, v);
            } else {
#pragma unroll
                for (int j = 0; j < N; ++j) v[j] = predict_sample(c, p, a, s0 + j);
            }
#pragma unroll
            for (int j = 0; j < N; ++j) v[j] = s0 + j < ns ? v[j] : 0;    // chroma sides of 2
        }
#pragma unroll
        for (int j = 0; j < N; ++j) out[hor ? (s0 + j) * c.P + a : a * c.P + s0 + j] = v[j];
    }
}

// write_lines with as many samples a thread as makes one round of the block,
// at most four (eight ran slower at the 64-pad class).
static __device__ void write_pred(const Cu& c, const Mode& p, int32_t* out) {
    const int per = c.P * c.P / blockDim.x;
    if (per >= 4) write_lines<4>(c, p, out);
    else if (per >= 2) write_lines<2>(c, p, out);
    else write_lines<1>(c, p, out);
}

// One pass of a candidate: the SATD of tiles pass * 32/TS .. of the CU
// (org - prediction), summed over the warp; valid in every lane. A lane
// holds one line of its tile: a row for planar, DC and the vertical modes,
// a column (the tile transposed, which leaves its SATD as it is) for the
// horizontal ones, so that an angular line shares its taps and one window
// of references (predict_line).
template <int TS>
static __device__ int pass_satd(const Cu& c, const Mode& p, const int32_t* sorg, int pass) {
    const int lane = threadIdx.x & 31, l = lane % TS;
    const int nx = c.w / TS, t = pass * (32 / TS) + lane / TS;
    int d[TS];
    if (t < nx * (c.h / TS)) {
        const int ty = (t / nx) * TS, tx = (t % nx) * TS;
        if (p.mode < 2) {
#pragma unroll
            for (int j = 0; j < TS; ++j)
                d[j] = sorg[(ty + l) * OSTRIDE + tx + j] - predict_sample(c, p, ty + l, tx + j);
        } else if (p.ver) {
            int pred[TS];
            predict_line<TS>(c, p, ty + l, tx, pred);
#pragma unroll
            for (int j = 0; j < TS; ++j) d[j] = sorg[(ty + l) * OSTRIDE + tx + j] - pred[j];
        } else {
            int pred[TS];
            predict_line<TS>(c, p, tx + l, ty, pred);
#pragma unroll
            for (int j = 0; j < TS; ++j) d[j] = sorg[(ty + j) * OSTRIDE + tx + l] - pred[j];
        }
    } else {
#pragma unroll
        for (int j = 0; j < TS; ++j) d[j] = 0;
    }
    const int v = warp_tile_satd<TS>(d);
    return __reduce_add_sync(FULL, l == 0 ? v : 0);
}

// Score candidates first .. first + n - 1, of modes ``cand`` (parameters in
// ``smode``, by mode): item i of the n * npass (candidate, pass) items goes
// to the cluster's warp i mod (K2_CLUSTER * K2_WARPS); each adds its SATD
// to ``cost`` (the leader block's slots, by candidate).
static __device__ void score(const Cu& c, const int32_t* sorg, const Mode* smode,
                             const int* cand, int first, int n, int* cost, int rank) {
    const int ts = min(c.w, c.h) >= 8 ? 8 : 4;
    const int per = 32 / ts, ntiles = (c.w / ts) * (c.h / ts);
    const int npass = (ntiles + per - 1) / per;
    for (int i = rank * K2_WARPS + (threadIdx.x >> 5); i < n * npass;
         i += K2_CLUSTER * K2_WARPS) {
        const int k = first + i / npass;
        const Mode p = smode[cand[k]];
        const int s = ts == 8 ? pass_satd<8>(c, p, sorg, i % npass)
                              : pass_satd<4>(c, p, sorg, i % npass);
        if ((threadIdx.x & 31) == 0) atomicAdd(cost + k, s);
    }
}

__global__ void __cluster_dims__(K2_CLUSTER, 1, 1) __launch_bounds__(NT, K2_BLOCKS_PER_SM)
intra_rmd_luma(const int32_t* __restrict__ refs, const int32_t* __restrict__ org,
               const int32_t* __restrict__ rows, const int32_t* __restrict__ tabs, int B,
               int P, int bd, int H, int W, int32_t* __restrict__ modes,
               int32_t* __restrict__ pred_out) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / K2_CLUSTER;
    const int32_t* r = rows + 8 * b;
    int32_t* out = pred_out + (size_t)b * P * P;
    if (r[6] <= 0) {                   // padding row: the whole cluster returns
        if (rank == 0) {
            for (int i = threadIdx.x; i < P * P; i += blockDim.x) out[i] = 0;
            if (threadIdx.x == 0) modes[b] = 0;
        }
        return;
    }
    __shared__ int32_t sref[4][MAXL];
    __shared__ int32_t sorg[MAXP * OSTRIDE];
    __shared__ int scost[NRMD + 2];    // the leader's: the 35 RMD costs, then m-1, m+1
    __shared__ int scand[NRMD + 2];    // the candidates' modes, in the same order
    __shared__ Mode smode[67];         // every mode's parameters
    __shared__ int s_best;

    const Cu c = load_cu(refs, r, tabs, sref, 0, b, B, P, 1, bd);
    const int fi = r[0], xs = r[1], ys = r[2];
    for (int i = threadIdx.x; i < c.h * c.w; i += blockDim.x) {
        const int y = i / c.w, x = i % c.w;
        sorg[y * OSTRIDE + x] = org[((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W +
                                    clampi(xs + x, 0, W - 1)];
    }
    for (int k = threadIdx.x; k < NRMD + 2; k += blockDim.x) {
        scost[k] = 0;
        scand[k] = k < 2 ? k : 2 * (k - 1);           // planar, DC, 2, 4, ..., 66
    }
    for (int m = threadIdx.x; m < 67; m += blockDim.x)
        smode[m] = mode_table(c, m);  // the table reads, beside the loads
    __syncthreads();                   // the references are in: DC sums them
    if (threadIdx.x < 32) {
        const int dc = warp_dc(c);
        if (threadIdx.x == 0) smode[1].dc = dc;
    }
    cluster.sync();                    // every block loaded; the leader's slots zeroed
    int* cost = cluster.map_shared_rank(scost, 0);
    score(c, sorg, smode, scand, 0, NRMD, cost, rank);
    cluster.sync();                    // the 35 costs are in
    if (threadIdx.x < 32) {            // the first minimum: the least (cost, index) key
        unsigned long long key = ~0ull;
        for (int k = threadIdx.x; k < NRMD; k += 32) {
            const unsigned long long kk = ((unsigned long long)cost[k] << 32) | (unsigned)k;
            key = kk < key ? kk : key;
        }
        for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long kk = __shfl_xor_sync(FULL, key, o);
            key = kk < key ? kk : key;
        }
        if (threadIdx.x == 0) {
            const int k_a = (int)(key & 0xffffffffu), m = scand[k_a];
            scand[NRMD] = clampi(m - 1, 2, 66);
            scand[NRMD + 1] = clampi(m + 1, 2, 66);
            s_best = k_a;
        }
    }
    __syncthreads();
    const int k_a = s_best, m_a = scand[k_a];
    if (m_a >= 2) score(c, sorg, smode, scand, NRMD, 2, cost, rank); // +-1 refinement
    cluster.sync();                    // the refinement costs are in
    if (rank != 0) return;
    int best = m_a, best_cost = scost[k_a];
    if (m_a >= 2)
        for (int k = NRMD; k < NRMD + 2; ++k)
            if (scost[k] < best_cost) {
                best_cost = scost[k];
                best = scand[k];
            }
    write_pred(c, smode[best], out);
    if (threadIdx.x == 0) modes[b] = best;
}

__global__ void __launch_bounds__(NT_DM)
intra_dm_kernel(const int32_t* __restrict__ refs, const uint8_t* __restrict__ mg,
                const int32_t* __restrict__ rows, const int32_t* __restrict__ tabs, int B,
                int P, int bd, int GH, int GW, int32_t* __restrict__ modes,
                int32_t* __restrict__ pred_out) {
    const int b = blockIdx.x, pl = blockIdx.y;
    const int32_t* r = rows + 8 * b;
    int32_t* out = pred_out + ((size_t)pl * B + b) * P * P;
    if (r[6] <= 0) {                   // padding row
        for (int i = threadIdx.x; i < P * P; i += blockDim.x) out[i] = 0;
        if (threadIdx.x == 0 && pl == 0) modes[b] = 0;
        return;
    }
    __shared__ int32_t sref[4][MAXL];
    const Cu c = load_cu(refs, r, tabs, sref, pl, b, B, P, 0, bd);
    const int gy = clampi((r[2] + r[4] / 2) / 4, 0, GH - 1);
    const int gx = clampi((r[1] + r[3] / 2) / 4, 0, GW - 1);
    const int m = mg[((size_t)r[0] * GH + gy) * GW + gx];
    Mode p = mode_table(c, m);         // broadcast table reads, beside the loads
    __syncthreads();                   // the references are in
    if (p.mode == 1) p.dc = warp_dc(c);
    write_pred(c, p, out);
    if (threadIdx.x == 0 && pl == 0) modes[b] = m;
}

extern "C" int pmp_intra_rmd(const int32_t* refs, const int32_t* org,
                             const uint8_t* mg, const int32_t* rows,
                             const int32_t* tabs, int B, int P, int nplanes,
                             int luma, int bd, int H, int W, int GH, int GW,
                             int32_t* modes, int32_t* pred, cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > MAXP || (luma && nplanes != 1)) return (int)cudaErrorInvalidValue;
    if (luma)
        intra_rmd_luma<<<B * K2_CLUSTER, NT, 0, stream>>>(refs, org, rows, tabs, B, P, bd,
                                                          H, W, modes, pred);
    else
        intra_dm_kernel<<<dim3(B, nplanes), NT_DM, 0, stream>>>(refs, mg, rows, tabs, B, P,
                                                                bd, GH, GW, modes, pred);
    return (int)cudaGetLastError();
}
