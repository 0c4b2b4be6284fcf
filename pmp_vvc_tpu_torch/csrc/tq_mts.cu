// K5: candidate transform-quantisation of a luma CU (MTS, LFNST, transform
// skip), with sign-data hiding on every candidate but transform skip. Every
// luma step of the wave scan runs it; with the three tools off only DCT-2
// and the zero TU remain, the luma TQ of the configurations without them.
//
// Replaces pmp_vvc_tpu/codec/wavefront.py:_tq_luma_mts (188-319) with
// ops/lfnst_generic.py:fwd_lfnst_generic (120) and inv_lfnst_generic (136),
// and the transform, quantisation, RD zeroing and sign-data hiding it calls
// (the team stages of csrc/tq_team.cuh, which K4 shares, with csrc/tq.cuh's
// rounding).
//
// The candidates, in the order of the JAX package's argmin (c below):
//   0     DCT-2 (mts_idx 0, 1 bin), always legal;
//   1..4  with mts, DST-7/DCT-8 pairs mts_idx 2..5 (2, 3, 4, 4 bins), legal
//         with a level beyond DC and w, h <= 32;
//   5, 6  with lfnst, LFNST 1 and 2 on the DCT-2 coefficients (2 bins):
//         the 8x8 or 4x4 top-left region gathered (plain or transposed by
//         the mode's kernel set), the 16 x 48 int product, (s + 64) >> 7,
//         placed on the 4x4 diagonal scan (8 outputs for 4x4 and 8x8 TUs);
//         quantisation, RD zeroing and sign-data hiding on them; the inverse
//         product clipped to 16 bits and scattered back, then the inverse
//         DCT-2; legal with a level beyond DC, except on MIP CUs below 16x16;
//   7     with ts_max, transform skip (mts_idx 1, 1 bin): the TS quantiser
//         on the residual at qp_ts (dead zone 171, qBits 14 + qp_ts/6), its
//         dequantiser, no RD zeroing, no sign-data hiding; legal with
//         w, h <= ts_max and a nonzero level.
// cost = SSE + lam * (rate proxy + bins) in float32 (luma_cost_of); an
// illegal candidate posts nothing, as +inf would lose. The zero TU
// (SSE0 + 2 lam) wins where its cost is <= the least candidate's.
//
// Bound: operations, int32. Up to seven separable round trips (four integer
// products each) and two 16 x 48 products per CU against the P x P tiles
// read and written once; the float work (RD gains, sign-data hiding's
// errors, the costs) is a small part. chip_smoke.py computes the bound of
// each call it times from the candidates these rows run.
//
// Design for the H100:
// - The call's slots are its candidates: 1 (tools off), 3 (the 64-pad
//   class: DCT-2, LFNST 1, 2), 5 (the RDO's DCT-2 and MTS) or 8 (the 32-pad
//   class with every tool). Each slot runs on a team of its own: above
//   K5_TEAM_PAD a block, the CU's blocks one thread block cluster (its size
//   the slot count, set at launch with cudaLaunchKernelEx, so no block
//   idles); at or below it a warp of one block that holds all the CU's
//   slots (an 8x8 CU of the RDO's 8-pad class has 64 samples, and its
//   chunks have 16,384 CUs). A block-team has K5_WARPS warps at the
//   32-pad class, twice that at the 64-pad, and P * P / 1024 of that at
//   the 16-pad.
// - Each team computes the residual from the original and the prediction,
//   loads its two cores into shared memory once (each as rows and as
//   columns: DCT-2 rows by stride from the 64-point table), and runs its
//   round trip there. The four stages are products of shared-memory
//   matrices: a thread computes K5_STAGE_ROWS x 4 neighbouring outputs
//   from int4 loads (1 x 4 in the teams of the small pads), int32 sums
//   exact in any order, one barrier a stage. Row strides of P + 4 keep the
//   int4 loads free of bank conflicts. The TB's coefficient-group table
//   and LFNST's kernel and gather table are copied into shared memory with
//   the cores, so that no later step waits on device memory.
// - Two instantiations: the clusters' at one block an SM (128 registers),
//   the teams' at K5_TEAM_BLOCKS_PER_SM (80 of 85 registers), both without
//   a stack frame or spills.
// - LFNST slots compute only the 8x8 (4x4 below 8x8 TUs) top-left DCT-2
//   region that the secondary transform reads, and invert the DCT-2 from
//   that region: the rest is zero, so the sums are the same.
// - Quantisation and RD zeroing run one lane a coefficient, 16 lanes a
//   coefficient group, over all of a team's warps: each group's 16 gains
//   are summed in float64 in the order 0..15 from shuffles, as the plain
//   version sums them. Sign-data hiding runs 16 lanes a group too, the 32
//   moves as a lexicographic (error, index) minimum, which is the first
//   minimum of up[0..15], down[0..15] on a strict <. Both write the
//   dequantised coefficient in place of their own.
// - The SSE (int64), the zero TU's SSE0, the rate proxy and the legality
//   count are one team reduction. Each slot's thread 0 stores its key
//   (cost bits << 32) | c (all ones where illegal) into slot s of every
//   block's s_keys (through the cluster's shared memory window), and after
//   one cluster barrier every block takes the least of the keys from its
//   own shared memory: costs are non-negative float32, so the least key is
//   the first minimum in JAX's order. (A 64-bit atomicMin into the leader's
//   shared memory, read back by the other blocks, chose wrong winners on
//   the H100, with CUDA's atomicMin and with atom.shared::cluster alike; a
//   team's local atomicMin and this form were exact.) Where SSE0 + 2 lam
//   > the least cost the winner writes its levels, reconstruction, mts_idx
//   and lfnst_idx from its own shared memory, else slot 0 writes the zero
//   TU. No block touches another's shared memory after that barrier.
// - K5_SERIAL builds one block per CU that runs every slot in turn with
//   the same stages and keeps the best in two more planes: how much of the
//   gain comes from spreading the slots and how much from the stages.
// Each call makes one launch.
#include "tq_team.cuh"

// The kernel's shape. One value of each ships; chip_smoke.py's K5_VARIANTS
// builds the others to time them beside it.
#ifndef K5_WARPS
#define K5_WARPS 8                     // warps a slot at the 32-pad class
#endif
#ifndef K5_BLOCKS_PER_SM
#define K5_BLOCKS_PER_SM 1             // blocks an SM above K5_TEAM_PAD: 128 registers
#endif
#ifndef K5_TEAM_BLOCKS_PER_SM
#define K5_TEAM_BLOCKS_PER_SM 3        // blocks an SM up to K5_TEAM_PAD: 85 registers
#endif
#ifndef K5_TEAM_PAD
#define K5_TEAM_PAD 8                  // pads whose slots share one block, a team each
#endif
#ifndef K5_STAGE_ROWS
#define K5_STAGE_ROWS 2                // output rows a stage thread above K5_TEAM_PAD
#endif
#ifdef K5_SERIAL
#define K5_SERIAL_PLANES 2
#else
#define K5_SERIAL_PLANES 0
#endif
static_assert(K5_TEAM_PAD <= 8, "a team is one warp: 64 samples at most");
#define K5_MAXT (64 * K5_WARPS)        // the largest block: a 64-pad slot
#define K5_TEAM_MAXT 256               // the largest block up to K5_TEAM_PAD: 8 slots

__constant__ int MODE_SHIFT[6] = {0, 6, 10, 12, 14, 15};
// mts_idx 0, 2..5: horizontal and vertical core kinds (0 DCT-2, 1 DCT-8,
// 2 DST-7) and bins; then LFNST 1, 2 and transform skip.
__constant__ int CAND_TR[8] = {0, 2, 3, 4, 5, 0, 0, 1};
__constant__ int CAND_LF[8] = {0, 0, 0, 0, 0, 1, 2, 0};
__constant__ int CAND_KW[8] = {0, 2, 1, 2, 1, 0, 0, 0};
__constant__ int CAND_KH[8] = {0, 2, 2, 1, 1, 0, 0, 0};
__constant__ float CAND_BINS[8] = {1.0f, 2.0f, 3.0f, 4.0f, 4.0f, 2.0f, 2.0f, 1.0f};

// A call's shape: its slots, the warps of a slot's team, the blocks of a
// CU (the cluster) and the teams of a block.
struct K5Shape {
    int nslot, tw, clu, tpb;
};

static __host__ __device__ __forceinline__ K5Shape k5_shape(int P, int mts, int lfnst,
                                                           int ts_max) {
    K5Shape s;
    s.nslot = 1 + 4 * (mts != 0) + 2 * (lfnst != 0) + (ts_max > 0);
    s.tw = P >= 32 ? K5_WARPS * P / 32 : K5_WARPS * P * P / 1024;
    s.tw = s.tw < 1 ? 1 : s.tw;
#ifdef K5_SERIAL
    s.clu = s.tpb = 1;
#else
    const bool team = P <= K5_TEAM_PAD;
    s.tw = team ? 1 : s.tw;
    s.clu = team ? 1 : s.nslot;
    s.tpb = team ? s.nslot : 1;
#endif
    return s;
}

// Shared ints of one team: the residual R, the first stage T1, the
// coefficients C (later the reconstructed residual), the levels L (P rows
// of stride P + 4 each); the cores Cw (kw x w), Ch (kh x h) at stride P + 4
// and their transposes CwT (w x kw), ChT (h x kh) at stride K + 4, K =
// min(P, 32); with K5_SERIAL the best levels and residual; the TB's
// coefficient groups' plane offsets (K x K); with LFNST its 16 x 48 kernel
// and 48-entry gather table.
#define LFNST_INTS (16 * 48 + 48)

static __host__ __device__ __forceinline__ int k5_team_ints(int P, int lfnst) {
    const int S = P + 4, K = P < 32 ? P : 32;
    return (4 + K5_SERIAL_PLANES) * P * S + 2 * K * S + 2 * P * (K + 4) + K * K +
           (lfnst ? LFNST_INTS : 0);
}

// Slot s's candidate (CAND_*) for these tools.
static __device__ __forceinline__ int cand_of(int s, int mts, int lfnst) {
    if (s == 0) return 0;
    s -= 1;
    if (mts) {
        if (s < 4) return 1 + s;
        s -= 4;
    }
    if (lfnst) {
        if (s < 2) return 5 + s;
    }
    return 7;
}

// A candidate's cost SSE + lam * (bits + bins), in float32.
static __device__ __forceinline__ float luma_cost_of(long long sse, int bits, float lam,
                                                     float bins) {
    return __fadd_rn(__ll2float_rn(sse), __fmul_rn(lam, __fadd_rn((float)bits, bins)));
}

// One slot's result in its team's thread 0: the key (~0 where illegal) and
// the zero TU's SSE0.
struct SlotOut {
    unsigned long long key;
    long long sse0;
};

// The round trip of candidate ``c`` on the team's planes; the reconstructed
// residual ends in C, the levels in L. RW: the stages' output rows a thread.
template <int RW>
static __device__ SlotOut run_slot(
    const Team& tm, int c, const Tile& t, int S, int lP, int32_t* R, int32_t* T1, int32_t* C,
    int32_t* L, int32_t* Cw, int32_t* Ch, int32_t* CwT, int32_t* ChT, int ST,
    const int32_t* d64, const int32_t* mts, const int32_t* tab, const int32_t* gat,
    const int32_t* kern_set, int32_t* SD, int32_t* SK, int n16, int qp_ts, int rd_quant,
    int sdh_on, float lam, float lam3, long long* red_a, long long* red_b, int* red_c,
    int* red_d) {
    const int w = t.w, h = t.h, P = t.P, PP = P * P;
    const int lf = CAND_LF[c], kind_w = CAND_KW[c], kind_h = CAND_KH[c];
    const bool is_ts = c == 7;
    const int r = w >= 8 && h >= 8 ? 8 : 4;          // LFNST's region
    const int kw = lf ? r : keep(kind_w, w), kh = lf ? r : keep(kind_h, h);
    const int lw4 = t.lw - 2;
    // levels zeroed over the CU; the cores
    for (int e = tm.tid; e < h << lw4; e += tm.n) {
        const int y = e >> lw4, x = (e & ((1 << lw4) - 1)) << 2;
        *reinterpret_cast<int4*>(L + y * S + x) = make_int4(0, 0, 0, 0);
    }
    if (!is_ts) {
        load_core(tm, d64, mts, kind_w, t.lw, kw, Cw, S, CwT, ST);
        load_core(tm, d64, mts, kind_h, t.lh, kh, Ch, S, ChT, ST);
    }
    // the TB's coefficient groups for sign-data hiding into SD (the first
    // ng of the table: its scan stops at 32 x 32), as plane offsets
    const int ng = (min(w, 32) * min(h, 32)) >> 4;
    if (sdh_on && !is_ts)
        for (int e = tm.tid; e < ng * 16; e += tm.n) {
            const int ix = tab[e];
            SD[e] = ix >= 0 ? (ix >> lP) * S + (ix & (P - 1)) : -1;
        }
    // LFNST's kernel (16 x 48) and gather table into SK, the gather as
    // offsets into the stride-S planes (-1 where unused)
    const int32_t* kern = kern_set + (lf > 0 ? lf - 1 : 0) * 16 * 48;
    int32_t* SG = SK + 16 * 48;
    if (lf) {
        for (int e = tm.tid; e < 16 * 48 / 4; e += tm.n)
            reinterpret_cast<int4*>(SK)[e] = __ldg(reinterpret_cast<const int4*>(kern) + e);
        for (int j = tm.tid; j < 48; j += tm.n) {
            const int g = gat[j];
            SG[j] = g < PP ? (g >> lP) * S + (g & (P - 1)) : -1;
        }
    }
    tsync(tm);
    if (is_ts) {                       // quantiser and dequantiser, sample by sample
        const int q_bits = 14 + qp_ts / 6, scale = QUANT_SCALES[0][qp_ts % 6];
        const int add = 171 << (q_bits - 9);
        const int iscale = INV_QUANT_SCALES[0][qp_ts % 6], rs = 6 - qp_ts / 6;
        for (int e = tm.tid; e < h * w; e += tm.n) {
            const int o = (e >> t.lw) * S + (e & (w - 1));
            const int v = R[o];
            const int mag = min((abs(v) * scale + add) >> q_bits, COEFF_MAX);
            const int lv = v < 0 ? -mag : mag;
            L[o] = lv;
            C[o] = clampi(dequant(clampi(lv, COEFF_MIN, COEFF_MAX), iscale, rs), COEFF_MIN,
                          COEFF_MAX);
        }
        tsync(tm);
    } else {
        const int lkw = ilog2(kw);
        stage<RW>(tm, R, S, CwT, ST, T1, S, h, lkw - 2, w, t.lw + t.bd + 6 - 15, false);
        stage<RW>(tm, Ch, S, T1, S, C, S, kh, lkw - 2, h, t.lh + 6, false);
        int32_t* coef = C;
        int qh = kh, qw = kw;
        if (lf) {                      // secondary transform onto T1's 4x4 diagonal
            for (int e = tm.tid; e < 64; e += tm.n) {
                const int o = e >> 2, q = e & 3;
                int acc = 0;
                if (o < n16)
#pragma unroll 4
                    for (int j = q; j < 48; j += 4) {
                        const int g = SG[j];
                        if (g >= 0) acc += SK[o * 48 + j] * C[g];
                    }
                acc += __shfl_xor_sync(FULL, acc, 1);
                acc += __shfl_xor_sync(FULL, acc, 2);
                const int d = diag4(o);
                if (q == 0) T1[(d >> 2) * S + (d & 3)] = o < n16 ? (acc + 64) >> 7 : 0;
            }
            tsync(tm);
            coef = T1;
            qh = qw = 4;
            for (int e = tm.tid; e < r * r; e += tm.n)   // the primary region, refilled below
                C[(e / r) * S + e % r] = 0;
        }
        const bool rd = rd_quant && min(w, h) >= 4;
        quant_rd(tm, t, S, coef, L, qh, qw, rd, !sdh_on, lam, lam3);
        if (sdh_on) sdh_deq(tm, t, SD, ng, coef, L);
        if (lf) {                      // inverse secondary transform into C's region
            for (int e = tm.tid; e < 192; e += tm.n) {
                const int j = e >> 2, q = e & 3;
                int acc = 0;
                for (int k = q; k < n16; k += 4) {
                    const int d = diag4(k);
                    acc += SK[k * 48 + j] * T1[(d >> 2) * S + (d & 3)];
                }
                acc += __shfl_xor_sync(FULL, acc, 1);
                acc += __shfl_xor_sync(FULL, acc, 2);
                const int g = SG[j];
                if (q == 0 && g >= 0) C[g] = clampi((acc + 64) >> 7, COEFF_MIN, COEFF_MAX);
            }
            tsync(tm);
        }
        stage<RW>(tm, ChT, ST, C, S, T1, S, h, lkw - 2, kh, 7, true);
        stage<RW>(tm, T1, S, Cw, S, C, S, h, t.lw - 2, kw, 6 + 15 - 1 - t.bd, true);
    }
    // SSE, SSE0, the rate proxy and the nonzero levels
    long long sse = 0, sse0 = 0;
    int bits = 0, nz = 0;
    for (int e = tm.tid; e < h * w; e += tm.n) {
        const int o = (e >> t.lw) * S + (e & (w - 1));
        const long long rv = R[o], d = (long long)C[o] - rv;
        sse += d * d;
        sse0 += rv * rv;
        const int a = abs(L[o]);
        if (a) bits += 2 * (32 - __clz(a)) + 2, ++nz;
    }
    for (int o = 16; o > 0; o >>= 1) {
        sse += __shfl_down_sync(FULL, sse, o);
        sse0 += __shfl_down_sync(FULL, sse0, o);
        bits += __shfl_down_sync(FULL, bits, o);
        nz += __shfl_down_sync(FULL, nz, o);
    }
    const int wi = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red_a[wi] = sse, red_b[wi] = sse0, red_c[wi] = bits, red_d[wi] = nz;
    tsync(tm);
    SlotOut out = {~0ull, 0};
    if (tm.tid == 0) {
        sse = sse0 = 0;
        bits = 8;
        nz = 0;
        for (int i = tm.w0; i < tm.w0 + (tm.n >> 5); ++i)
            sse += red_a[i], sse0 += red_b[i], bits += red_c[i], nz += red_d[i];
        const bool legal = c == 0 || (is_ts ? nz > 0 : nz - (L[0] != 0) > 0);
        const float cost = luma_cost_of(sse, bits, lam, CAND_BINS[c]);
        if (legal) out.key = ((unsigned long long)__float_as_uint(cost) << 32) | (unsigned)c;
        out.sse0 = sse0;
    }
    return out;
}

// TEAM: the instantiation for pads up to K5_TEAM_PAD, whose blocks hold
// every slot of a CU: K5_TEAM_BLOCKS_PER_SM blocks an SM, so that enough of
// a 16,384-CU chunk's blocks share one, and 1 x 4 outputs a stage thread;
// the other K5_BLOCKS_PER_SM blocks an SM and K5_STAGE_ROWS x 4.
template <bool TEAM>
__global__ void __launch_bounds__(TEAM ? K5_TEAM_MAXT : K5_MAXT,
                                  TEAM ? K5_TEAM_BLOCKS_PER_SM : K5_BLOCKS_PER_SM)
tq_mts_kernel(
    const int32_t* __restrict__ org_all, const int32_t* __restrict__ pred,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ modes,
    const int32_t* __restrict__ mip_code, const int32_t* __restrict__ d64,
    const int32_t* __restrict__ mts, const int32_t* __restrict__ cgtab,
    const int32_t* __restrict__ lfnst_lut, const int32_t* __restrict__ lfnst_kern,
    const int32_t* __restrict__ lfnst_gather, int B, int P, int qp, int qp_ts, int bd,
    int rd_quant, int H, int W, int sdh_on, int ncg, int use_mts, int use_lfnst,
    int ts_max, float lam, float lam2, float lam3, int32_t* __restrict__ lev_out,
    int32_t* __restrict__ rec_out, int32_t* __restrict__ tr_out,
    int32_t* __restrict__ lf_out) {
    extern __shared__ int4 smem4[];
    __shared__ unsigned long long s_keys[8];
    __shared__ long long red_a[32], red_b[32], s_sse0[8];
    __shared__ int red_c[32], red_d[32];
    const K5Shape sh = k5_shape(P, use_mts, use_lfnst, ts_max);
    const int b = blockIdx.x / sh.clu, rank = blockIdx.x % sh.clu;
    const int nthr = sh.tw * 32, team = threadIdx.x / nthr;
    const Team tm = {(int)threadIdx.x - team * nthr, nthr, team * sh.tw};
    const int slot0 = rank + team;     // one of the two is 0
    const int32_t* r = rows + 8 * b;
    const int PP = P * P, lP = ilog2(P), S = P + 4, K = min(P, 32), ST = K + 4;
    const size_t tile = (size_t)b * PP;
    const int32_t* pr = pred + tile;
    const int pel_max = (1 << bd) - 1;
    if (r[6] <= 0) {                   // padding row: every block returns here
        if (slot0 == 0) {
            for (int i = tm.tid; i < PP; i += tm.n) lev_out[tile + i] = rec_out[tile + i] = 0;
            if (tm.tid == 0) tr_out[b] = lf_out[b] = 0;
        }
        return;
    }
    const bool clustered = sh.clu > 1;
    if (clustered) cluster_arrive();   // waited on before the keys are posted

    int32_t* R = reinterpret_cast<int32_t*>(smem4) + team * k5_team_ints(P, use_lfnst);
    int32_t* T1 = R + P * S;
    int32_t* C = T1 + P * S;
    int32_t* L = C + P * S;
    int32_t* Cw = L + P * S;
    int32_t* Ch = Cw + K * S;
    int32_t* CwT = Ch + K * S;
    int32_t* ChT = CwT + P * ST;
    const int fi = r[0], xs = r[1], ys = r[2];
    const Tile t = make_tile(P, r[3], r[4], qp, bd);
    const int w = t.w, h = t.h, lw4 = t.lw - 2;
    const int32_t* org = org_all + (size_t)fi * H * W;
    for (int e = tm.tid; e < h << lw4; e += tm.n) {     // the residual, four samples a thread
        const int y = e >> lw4, x = (e & ((1 << lw4) - 1)) << 2;
        const int4 p = __ldg(reinterpret_cast<const int4*>(pr + y * P + x));
        const int32_t* orow = org + clampi(ys + y, 0, H - 1) * W;
        *reinterpret_cast<int4*>(R + y * S + x) =
            make_int4(orow[clampi(xs + x, 0, W - 1)] - p.x, orow[clampi(xs + x + 1, 0, W - 1)] - p.y,
                      orow[clampi(xs + x + 2, 0, W - 1)] - p.z,
                      orow[clampi(xs + x + 3, 0, W - 1)] - p.w);
    }

    // LFNST geometry (lfnst_params_generic): the wide-angle-extended mode's
    // kernel set and transpose, the region variant and the output count
    const int sb8 = w >= 8 && h >= 8;
    const int n16 = (w == 4 && h == 4) || (w == 8 && h == 8) ? 8 : 16;
    const int32_t* gat = lfnst_gather;
    const int32_t* kern_set = lfnst_kern;
    bool lfnst_gate = false;
    if (use_lfnst) {
        const int m = modes[b], shift = MODE_SHIFT[abs(t.lw - t.lh)];
        const bool ang = m > 1 && m <= 66;
        const int wam = ang && w > h && m < 2 + shift ? m + 65
                        : ang && h > w && m > 66 - shift ? m - 65 : m;
        const int ext = wam < 0 ? wam + 14 + 67 : wam >= 67 ? wam + 14 : wam;
        const int tp = ext >= 67 + 14 || (ext < 67 && ext > 34);
        gat = lfnst_gather + ((1 - sb8) * 2 + tp) * 48;
        kern_set = lfnst_kern + (size_t)(sb8 * 4 + lfnst_lut[ext]) * 2 * 16 * 48;
        lfnst_gate = mip_code == nullptr || mip_code[b] == 0 || (w >= 16 && h >= 16);
    }
    const int32_t* tab = cgtab + (size_t)(t.lw * 7 + t.lh) * ncg * 16;

    int32_t* SD = ChT + P * ST + K5_SERIAL_PLANES * P * S;
    int32_t* SK = SD + K * K;
#ifdef K5_SERIAL
    const int step = 1;
    int32_t* BL = ChT + P * ST;        // the best levels and residual so far
    int32_t* BX = BL + P * S;
    __shared__ int s_copy;
#else
    const int step = sh.nslot;
#endif
    unsigned long long key = ~0ull;
    for (int s = slot0; s < sh.nslot; s += step) {
        const int c = cand_of(s, use_mts, use_lfnst);
        const bool is_mts = c >= 1 && c <= 4;
        if ((is_mts && (w > 32 || h > 32)) || (CAND_LF[c] && !lfnst_gate) ||
            (c == 7 && (w > ts_max || h > ts_max)))
            continue;                  // illegal whatever its levels: not run
        const SlotOut o = run_slot<TEAM ? 1 : K5_STAGE_ROWS>(tm, c, t, S, lP, R, T1, C, L, Cw, Ch, CwT, ChT, ST, d64,
                                   mts, tab, gat, kern_set, SD, SK, n16, qp_ts, rd_quant,
                                   sdh_on, lam, lam3, red_a, red_b, red_c, red_d);
#ifdef K5_SERIAL
        if (tm.tid == 0) {
            s_copy = o.key < key;
            key = s_copy ? o.key : key;
            if (c == 0) s_sse0[team] = o.sse0;
        }
        tsync(tm);
        if (s_copy)
            for (int e = tm.tid; e < h * w; e += tm.n) {
                const int i = (e >> t.lw) * S + (e & (w - 1));
                BL[i] = L[i];
                BX[i] = C[i];
            }
        tsync(tm);
#else
        if (tm.tid == 0) {
            key = o.key;
            s_sse0[team] = o.sse0;
        }
#endif
    }
#ifdef K5_SERIAL
    const int32_t* OL = BL;
    const int32_t* OX = BX;
#else
    const int32_t* OL = L;
    const int32_t* OX = C;
#endif
    // every slot's key into every block's s_keys, then the least of them
#ifdef K5_SERIAL
    const int nkeys = 1;
#else
    const int nkeys = sh.nslot;
#endif
    if (clustered) cluster_wait();     // every block of the cluster runs
    if (tm.tid == 0) {
        if (clustered)
            for (int q = 0; q < sh.clu; ++q) cluster_store(cluster_addr(&s_keys[slot0], q), key);
        else
            s_keys[slot0] = key;
    }
    if (clustered) {
        cluster_arrive();
        cluster_wait();
    } else {
        __syncthreads();
    }
    unsigned long long best = ~0ull;
    for (int q = 0; q < nkeys; ++q) best = s_keys[q] < best ? s_keys[q] : best;
    const int win = (int)(best & 0xffu);
    const bool coded = __fadd_rn(__ll2float_rn(s_sse0[team]), lam2) >
                       __uint_as_float((unsigned)(best >> 32));
#ifdef K5_SERIAL
    const bool writer = true;
#else
    const bool writer = coded ? win == cand_of(slot0, use_mts, use_lfnst) : slot0 == 0;
#endif
    if (writer) {
        const int lq = lP - 2;
        for (int e = tm.tid; e < PP >> 2; e += tm.n) {
            const int y = e >> lq, x = (e & ((1 << lq) - 1)) << 2;
            const int4 p = __ldg(reinterpret_cast<const int4*>(pr + y * P + x));
            const int pv[4] = {p.x, p.y, p.z, p.w};
            int lv[4], rc[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const bool in = y < h && x + u < w;
                const int o = y * S + x + u;
                lv[u] = in && coded ? OL[o] : 0;
                rc[u] = in ? clampi(pv[u] + (coded ? OX[o] : 0), 0, pel_max) : 0;
            }
            *reinterpret_cast<int4*>(lev_out + tile + y * P + x) =
                make_int4(lv[0], lv[1], lv[2], lv[3]);
            *reinterpret_cast<int4*>(rec_out + tile + y * P + x) =
                make_int4(rc[0], rc[1], rc[2], rc[3]);
        }
        if (tm.tid == 0) {
            tr_out[b] = coded ? CAND_TR[win] : 0;
            lf_out[b] = coded ? CAND_LF[win] : 0;
        }
    }
}

extern "C" int pmp_tq_mts(const int32_t* org, const int32_t* pred, const int32_t* rows,
                          const int32_t* modes, const int32_t* mip_code,
                          const int32_t* d64, const int32_t* mts, const int32_t* cgtab,
                          const int32_t* lfnst_lut, const int32_t* lfnst_kern,
                          const int32_t* lfnst_gather, int B, int P, int qp, int qp_ts,
                          int bd, int rd_quant, int H, int W, int sdh, int ncg,
                          int use_mts, int use_lfnst, int ts_max, float lam, float lam2,
                          float lam3, int32_t* lev, int32_t* rec, int32_t* tr,
                          int32_t* lf, cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > 64 || P < 8 || ((use_mts || ts_max) && P > 32)) return (int)cudaErrorInvalidValue;
    const K5Shape sh = k5_shape(P, use_mts, use_lfnst, ts_max);
    const int smem = sh.tpb * k5_team_ints(P, use_lfnst) * (int)sizeof(int32_t);
#ifdef K5_SERIAL
    const bool team = false;
#else
    const bool team = P <= K5_TEAM_PAD;
#endif
    auto kernel = team ? tq_mts_kernel<true> : tq_mts_kernel<false>;
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    if (sh.clu == 1) {                 // one block a CU: no cluster
        kernel<<<B, sh.tpb * sh.tw * 32, smem, stream>>>(
            org, pred, rows, modes, mip_code, d64, mts, cgtab, lfnst_lut, lfnst_kern,
            lfnst_gather, B, P, qp, qp_ts, bd, rd_quant, H, W, sdh, ncg, use_mts, use_lfnst,
            ts_max, lam, lam2, lam3, lev, rec, tr, lf);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * sh.clu);
    cfg.blockDim = dim3(sh.tpb * sh.tw * 32);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = sh.clu;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kernel, org, pred, rows, modes, mip_code, d64, mts, cgtab, lfnst_lut,
        lfnst_kern, lfnst_gather, B, P, qp, qp_ts, bd, rd_quant, H, W, sdh, ncg, use_mts,
        use_lfnst, ts_max, lam, lam2, lam3, lev, rec, tr, lf);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
