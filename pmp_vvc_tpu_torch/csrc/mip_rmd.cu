// K3: the MIP candidates of the wave step's luma CUs against K2's winner.
//
// Replaces pmp_vvc_tpu/ops/mip_generic.py:predict_mip_generic (54), with its
// _mip_table (32) and sid_generic (48) (the per-sample MIP formulas are
// csrc/mip.cuh, shared with K10b), the SATD of its candidates
// (ops/tq_generic.py:satd_generic, 160) and the MIP decision of
// codec/wavefront.py:_make_class_apply (402-425).
//
// The decision: every candidate (t, m) with m < n_modes is scored by SATD
// against the original; the first minimum in t*16+m order wins, and it
// replaces K2's winner only when its SATD is strictly below K2's winner's. A
// MIP CU gets mode 0 (PLANAR) and code 1 + t*16 + m; any other CU keeps K2's
// mode and prediction with code 0. Padding rows give a zero tile, K2's mode
// and code 0.
//
// Bound: operations. A 64x64 CU costs 12 candidates of 4096 upsampled
// samples (about 10 integer operations each) and their Hadamard SATDs; the
// bytes (references, the original tile, K2's prediction in, the prediction
// out) are small beside that. All arithmetic is int32: a 64x64 CU's SATD
// stays below 2^23.
//
// Design for the H100 (the shape of K2's luma kernel, csrc/intra_rmd.cu):
// - One thread block cluster of K3_CLUSTER blocks per CU, so that a step's
//   16 CUs of the 32-pad class occupy 64 SMs instead of 16. At 64
//   registers a thread two blocks fit an SM. Four blocks, not K2's eight: a
//   32x32 CU has 52 items (K2's 148), and a call costs a chain of dependent
//   steps more than its work (chip_smoke.py --k3-times times the shapes
//   side by side).
// - Every block loads the CU's unfiltered top and left references and its
//   original (row stride P + 1: no bank conflicts) into its own shared
//   memory, and computes the packed boundaries, every valid candidate's
//   reduced grid (one thread a reduced sample, all candidates at once) and
//   their horizontal passes (one thread a sample) into shared memory: at
//   most 12 x 8 x 64 samples, 24 KB. So no scoring item waits on another
//   block, and only K2's prediction (slot 0) is read from L2.
// - The work is (slot, pass) items over every warp of the cluster. Slot 0
//   is K2's prediction (read from pred_in), slot 1 + t*n_modes + m the MIP
//   candidate (t, m). A pass is 32 / TS tiles of TS x TS (TS 8, or 4 when a
//   side is 4), one tile row a lane; a CU with fewer tiles than that puts
//   several slots in one pass, each lane knowing its slot. Each lane
//   computes its row's samples in registers by the vertical upsampling of
//   the slot's horizontal pass against the top row, the warp takes the
//   tiles' SATD in registers and shuffles (csrc/satd.cuh: warp_tile_satd),
//   sums each slot's tiles, and one lane a slot adds the sum to the slot's
//   cost in the leader block's shared memory over distributed shared memory
//   (atomicAdd; integer sums, so the order does not matter).
// - After a cluster barrier the leader takes the argmin of the 64-bit keys
//   (cost << 32) | slot: the first minimum among the MIP candidates, and
//   K2's winner on a tie with it, since slot 0 is lowest. That is JAX's
//   argmin and strict comparison in one step, whatever order the remote
//   atomics land in. The leader then writes the winner's prediction (a MIP
//   candidate recomputed from its horizontal pass, or K2's copied), zero
//   outside the CU, and the mode and code.
// - Tensor cores do not serve: the reduced product is at most 8 terms a
//   sample, and after one Hadamard pass an 8x8 tile's values leave fp16's
//   exact integers. The data per CU (references, original, K2's prediction,
//   a few KB) is read once per block, so TMA brings nothing either.
// Each call makes one launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mip.cuh"
#include "satd.cuh"

namespace cg = cooperative_groups;

// The kernel's shape. One value of each ships; chip_smoke.py's K3_VARIANTS
// builds the others to time them beside it.
#ifndef K3_CLUSTER
#define K3_CLUSTER 4                   // blocks per CU
#endif
#ifndef K3_WARPS
#define K3_WARPS 16                    // warps per block
#endif
#ifndef K3_BLOCKS_PER_SM
#define K3_BLOCKS_PER_SM 2             // 64 registers a thread: two blocks share an SM
#endif
#define NT (32 * K3_WARPS)
#define MAXP 64
#define OSTRIDE (MAXP + 1)             // the original's row stride: no bank conflicts
#define NSLOT (1 + 32)                 // K2's winner, then up to 2 x 16 candidates
#define MAX_RED (12 * 64)              // reduced samples: sizeId 2, 12 candidates of 8x8
#define MAX_HOR (12 * 8 * MAXP)        // horizontal passes: sizeId 2, 8 rows of 64
#define FULL 0xffffffffu

// The class of a CU beside its Mip: the candidates' count and the shifts
// that index the tables.
struct K3Cu {
    Mip c;
    int ncand;                         // 2 * n_modes
    int lrp, lw, lf_v;                 // log2 of red_p, w and h / red_p
    const int32_t* shor;               // horizontal passes: (ncand, red_p, w)
};

// Candidate v's (t, m): v = t * n_modes + m.
static __device__ __forceinline__ int cand_k(const Mip& c, int v) {
    return (v / c.n_modes) * 16 + v % c.n_modes;
}

// Sample (y, x) of candidate v: the vertical upsampling of its horizontal
// pass against the top row.
static __device__ __forceinline__ int cand_sample(const K3Cu& u, int v, int y, int x) {
    const int f_v = 1 << u.lf_v, jv = y >> u.lf_v, pv = (y & (f_v - 1)) + 1;
    const int32_t* hp = u.shor + ((v << u.lrp) + jv) * u.c.w;
    const int prev = jv == 0 ? u.c.top[x] : hp[x - u.c.w];
    return mip_up(prev, hp[x], pv, f_v, u.lf_v);
}

// One pass of ``ntiles``-tile slots: lane group g = lane / TS holds tile
// row lane % TS of slot-tile item * (32 / TS) + g. Adds each slot's SATD
// to ``cost`` (one atomicAdd a slot, or a slot's part in this pass).
template <int TS>
static __device__ void pass_satd(const K3Cu& u, const int32_t* sorg, const int32_t* pin,
                                 int item, int nslot, int lnt, int* cost) {
    const Mip& c = u.c;
    const int lane = threadIdx.x & 31, l = lane % TS, per = 32 / TS;
    const int ntiles = 1 << lnt, s = item * per + lane / TS, slot = s >> lnt;
    const bool live = slot < nslot;
    int d[TS];
    if (live) {
        const int t = s & (ntiles - 1), nx = c.w / TS;
        const int y = (t / nx) * TS + l, x0 = (t % nx) * TS;
        if (slot == 0) {
#pragma unroll
            for (int j = 0; j < TS; ++j)
                d[j] = sorg[y * OSTRIDE + x0 + j] - pin[y * c.P + x0 + j];
        } else {
#pragma unroll
            for (int j = 0; j < TS; ++j)
                d[j] = sorg[y * OSTRIDE + x0 + j] - cand_sample(u, slot - 1, y, x0 + j);
        }
    } else {
#pragma unroll
        for (int j = 0; j < TS; ++j) d[j] = 0;
    }
    int v = warp_tile_satd<TS>(d);
    // the tiles of one slot in this pass: aligned groups of min(ntiles, per)
    const int group = TS * min(ntiles, per);
    for (int o = TS; o < group; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
    if (live && (lane & (group - 1)) == 0) atomicAdd(cost + slot, v);
}

__global__ void __cluster_dims__(K3_CLUSTER, 1, 1) __launch_bounds__(NT, K3_BLOCKS_PER_SM)
mip_rmd_kernel(const int32_t* __restrict__ refs, const int32_t* __restrict__ org,
               const int32_t* __restrict__ rows, const int32_t* __restrict__ mats,
               const int32_t* __restrict__ pred_in, const int32_t* __restrict__ best_in, int B,
               int P, int bd, int H, int W, int32_t* __restrict__ best_out,
               int32_t* __restrict__ pred_out, int32_t* __restrict__ code_out) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / K3_CLUSTER, L = 2 * P + 3;
    const int32_t* r = rows + 8 * b;
    const size_t tile = (size_t)b * P * P;
    const int32_t* pin = pred_in + tile;
    int32_t* out = pred_out + tile;
    if (r[6] <= 0) {                   // padding row: the whole cluster returns
        if (rank == 0) {
            for (int i = threadIdx.x; i < P * P; i += blockDim.x) out[i] = 0;
            if (threadIdx.x == 0) {
                best_out[b] = best_in[b];
                code_out[b] = 0;
            }
        }
        return;
    }
    __shared__ int32_t sorg[MAXP * OSTRIDE];
    __shared__ int32_t shor[MAX_HOR];
    __shared__ int32_t sred[MAX_RED];
    __shared__ int32_t stop[MAXP], sleft[MAXP];
    __shared__ int32_t sbdry[2 * 8];
    __shared__ int scost[NSLOT];       // the leader's: K2's winner, then the candidates
    __shared__ int s_slot;

    K3Cu u;
    Mip& c = u.c;
    mip_size_class(c, r[3], r[4]);
    c.P = P; c.bd = bd;
    c.top = stop; c.left = sleft; c.mats = mats; c.bdry = sbdry;
    u.ncand = 2 * c.n_modes;
    u.lrp = ilog2(c.red_p); u.lw = ilog2(c.w); u.lf_v = ilog2(c.h / c.red_p);
    u.shor = shor;
    const int fi = r[0], xs = r[1], ys = r[2];
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        stop[i] = refs[(size_t)b * L + 1 + i];               // refs[0][0][b]
        sleft[i] = refs[((size_t)B + b) * L + 1 + i];        // refs[0][1][b]
    }
    for (int i = threadIdx.x; i < c.h * c.w; i += blockDim.x) {
        const int y = i >> u.lw, x = i & (c.w - 1);
        sorg[y * OSTRIDE + x] = org[((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W +
                                    clampi(xs + x, 0, W - 1)];
    }
    for (int k = threadIdx.x; k < NSLOT; k += blockDim.x) scost[k] = 0;
    __syncthreads();                   // the references are in
    if (threadIdx.x < 2 * c.red_b) {   // the packed boundaries, one thread a sample
        const int j = threadIdx.x % c.red_b, left = threadIdx.x >= c.red_b;
        const int v = left ? mip_down(sleft, c.h, c.red_b, j) : mip_down(stop, c.w, c.red_b, j);
        sbdry[(left ? c.red_b : 0) + j] = v;                 // [top, left]
        sbdry[8 + (left ? 0 : c.red_b) + j] = v;             // [left, top]
    }
    __syncthreads();
    const int lrr = 2 * u.lrp;         // log2 of red_p * red_p
    for (int i = threadIdx.x; i < u.ncand << lrr; i += blockDim.x) {
        const int v = i >> lrr, e = i & ((1 << lrr) - 1), k = cand_k(c, v);
        sred[i] = mip_reduced(c, k >> 4, k & 15, e >> u.lrp, e & (c.red_p - 1));
    }
    __syncthreads();
    const int lrw = u.lrp + u.lw, f_h = c.w >> u.lrp, lf_h = u.lw - u.lrp;
    for (int i = threadIdx.x; i < u.ncand << lrw; i += blockDim.x) {
        const int v = i >> lrw, e = i & ((1 << lrw) - 1), rr = e >> u.lw, x = e & (c.w - 1);
        const int jh = x >> lf_h, ph = (x & (f_h - 1)) + 1;
        const int32_t* red = sred + (v << lrr) + (rr << u.lrp);
        const int prev = jh == 0 ? mip_left(c, rr) : red[jh - 1];
        shor[i] = mip_up(prev, red[jh], ph, f_h, lf_h);
    }
    cluster.sync();                    // every block's tables; the leader's slots zeroed

    int* cost = cluster.map_shared_rank(scost, 0);
    const int ts = min(c.w, c.h) >= 8 ? 8 : 4, lts = ts == 8 ? 3 : 2;
    const int lnt = (u.lw - lts) + (ilog2(c.h) - lts);       // log2 of tiles a slot
    const int nslot = 1 + u.ncand;
    const int nitems = ((nslot << lnt) * ts + 31) / 32;
    for (int i = rank * K3_WARPS + (threadIdx.x >> 5); i < nitems; i += K3_CLUSTER * K3_WARPS) {
        if (ts == 8) pass_satd<8>(u, sorg, pin, i, nslot, lnt, cost);
        else pass_satd<4>(u, sorg, pin, i, nslot, lnt, cost);
    }
    cluster.sync();                    // every slot's cost is in
    if (rank != 0) return;
    if (threadIdx.x < 32) {            // the first minimum: the least (cost, slot) key
        unsigned long long key = ~0ull;
        for (int k = threadIdx.x; k < nslot; k += 32) {
            const unsigned long long kk = ((unsigned long long)scost[k] << 32) | (unsigned)k;
            key = kk < key ? kk : key;
        }
        for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long kk = __shfl_xor_sync(FULL, key, o);
            key = kk < key ? kk : key;
        }
        if (threadIdx.x == 0) s_slot = (int)(key & 0xffffffffu);
    }
    __syncthreads();
    const int slot = s_slot;
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
        const int y = i / P, x = i % P;
        int v = 0;
        if (y < c.h && x < c.w) v = slot > 0 ? cand_sample(u, slot - 1, y, x) : pin[i];
        out[i] = v;
    }
    if (threadIdx.x == 0) {
        best_out[b] = slot > 0 ? 0 : best_in[b];
        code_out[b] = slot > 0 ? 1 + cand_k(c, slot - 1) : 0;
    }
}

extern "C" int pmp_mip_rmd(const int32_t* refs, const int32_t* org,
                           const int32_t* rows, const int32_t* mats,
                           const int32_t* pred_in, const int32_t* best_in,
                           int B, int P, int bd, int H, int W,
                           int32_t* best_out, int32_t* pred_out,
                           int32_t* code_out, cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > MAXP || P < 4) return (int)cudaErrorInvalidValue;
    mip_rmd_kernel<<<B * K3_CLUSTER, NT, 0, stream>>>(refs, org, rows, mats, pred_in, best_in,
                                                      B, P, bd, H, W, best_out, pred_out,
                                                      code_out);
    return (int)cudaGetLastError();
}
