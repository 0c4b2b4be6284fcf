// K4: the chroma transform-quantisation of the wave step, with sign-data
// hiding, the single-tree LFNST region, the joint Cb-Cr trial (K6c) and the
// LMCS chroma residual scale (K6b). Luma runs K5 (csrc/tq_mts.cu).
//
// Replaces pmp_vvc_tpu/ops/tq_generic.py forward_transform_generic (96),
// inverse_transform_generic (113), quantize_generic (135),
// dequantize_generic (149) and rd_cleanup_generic (198),
// ops/sdh_generic.py:apply_sdh_generic (66), codec/wavefront.py:_bits_proxy
// (68), and the coded-vs-zero TU decision of _tq_generic (134-179), with
// the joint trial and the scale of _chroma_part (558-633).
//
// One round trip (each plane's, and the joint TU's), on a P x P tile:
//   resid = org - pred over the CU; DCT-2 in two int32 stages with the
//   per-CU round shifts (matrices: the 64-point core by stride, zero-out
//   beyond 32); dead-zone (171) quantisation; RDOQ-lite zeroing of 4x4
//   coefficient groups (skipped when min(w, h) < 4); with ``lfnst_active``
//   (single tree), a CU whose luma chose LFNST keeps its levels inside the
//   LFNST-signallable region (wavefront.py:543-557: diagonal scan positions
//   < 8 of 4x4 and 8x8 TBs, < 16 of the others, no constraint where a side
//   is below 4); with sdh, sign-data hiding on the groups of the grouped
//   diagonal scan; dequantisation; the inverse with a clip to [COEFF_MIN,
//   COEFF_MAX] after each stage; the rate proxy 8 + nz + sum(2 * bitlen|l|
//   + 1); then the coded TU against the zero TU, dw * SSE + lam * bits
//   against dw * SSE0 + 2 lam (the zero TU wins ties), and rec = clip(pred
//   + rr).
//
// With ``jccr`` (K6c, mask 3, Cr = -Cb), the joint residual round((res_u -
// res_v) / 2), half to even, in integers, takes a third round trip at qp_j
// as U's residual with the same LFNST region and sign-data hiding; Cr is
// clip(pred_v - rr_j) from the unclipped reconstructed residual after that
// TU's coded-vs-zero decision. The separate and joint costs are dw * (SSE_U
// + SSE_V) + lam * bits over the reconstructions, each SSE exact in int64
// and rounded once, bits the coded TUs' rate proxies (1 for an uncoded TU)
// + 1, or the joint TU's + 3, in float32 in the JAX package's operation
// order. Joint wins where its TU is coded and its cost is strictly lower:
// both planes then take its levels and reconstructions, and use_joint is 1.
//
// With ``crs_on`` (K6b), the CU's scale: the 64x64 VPDU's left column and
// above row of mapped luma recon ``ry``, 64 samples each read clamped to
// the frame, where the chroma coding-order grid ``og`` says the side's
// first sample precedes the CU; their average (s + (32 << max(n - 1, 0)))
// >> (5 + n), or 1 << (bd - 1) with no side; the scale lut[average], or
// 1 << 11 for CUs of 4 or fewer chroma samples. Every round trip (U, V and
// the joint TU) then codes sgn * min(((|r| << 11) + c / 2) / c, 2^bd - 1)
// and scales its reconstructed residual back, sgn * ((|rr| * c + 2^10) >>
// 11) after a clip to [-2^bd, 2^bd - 1], clipped to 16 bits; both costs
// measure the unscaled residual. ``crs_out`` (may be null) receives the
// scales.
//
// Bound: bytes at the wave step's shapes (the full P x P tiles of
// prediction, levels and recon); the four integer products (about 4 * w *
// h * min(w, 32) multiply-adds a round trip) come close for the largest
// CUs. chip_smoke.py computes the bound of each call it times, by bytes and
// by operations.
//
// Design for the H100:
// - A unit is a CU with the trial (three round trips: U, V, joint; the
//   joint residual comes from the two original residuals, so the three are
//   independent until the final cost comparison), else one (CU, plane)
//   (the RDO's calls and the configurations without the trial). Each round
//   trip runs on a team of its own, on planes of its own in shared memory:
//   above K4_TEAM_PAD a team is a block of K4_WARPS * P / 32 warps (at most
//   K4_WARPS), the trial's three blocks one thread block cluster (set at
//   launch with cudaLaunchKernelEx); at or below it one warp, K4_TEAM_WARPS
//   teams a block (a 4-pad chunk of the RDO has 16,384 CUs, 32,768 teams).
// - A team computes its residual (the joint one from both originals and
//   predictions) and loads the DCT-2 rows of its two cores into shared
//   memory once, as rows and as columns, by stride from the 64-point table
//   (a side of 2 as a 4-point core padded with zeros, so that every stage
//   runs on whole int4 columns); the four stages are csrc/tq_team.cuh's
//   ``stage`` products, one barrier each. Quantisation and RD zeroing are
//   ``quant_rd`` (a lane a coefficient, each group's 16 gains summed in
//   float64 in the order 0..15), the region one pass after it, sign-data
//   hiding ``sdh_deq`` (16 lanes a group, the least (error, index) move).
// - SSE (int64, exact), SSE0, the rate proxy and, with the trial, the SSEs
//   of the reconstructions against the originals are one team reduction,
//   after which every thread of the team holds the coded-vs-zero decision.
// - Each team of the trial posts its SSEs, bits and decision into the
//   unit's post slots, in every block of the cluster (stores into each
//   block's shared memory, no atomics: a remote 64-bit atomicMin chose wrong
//   winners on this card); after one barrier every team computes the same
//   joint decision from its own copy. Exactly one team writes each output
//   tile: the joint team both planes where joint wins, else U and V their
//   own; U writes crs_out and the joint team use_joint.
// - The CRS scale is derived by every warp that needs it (128 loads, one
//   warp reduction), so no team waits on another for it.
// - K4_ONE_BLOCK builds the trial's three teams as warp groups of one block
//   under named barriers in place of a cluster; K4_SERIAL one team a unit
//   that runs its round trips in turn: both for timing beside the shipped
//   form. Each call makes one launch.
#include "tq_team.cuh"

#define CRS_UNIT (1 << 11)             // CSCALE_FP_PREC: the identity scale
#define VPDU 64

// The kernel's shape. One value of each ships; chip_smoke.py's K4_VARIANTS
// builds the others to time them beside it.
#ifndef K4_WARPS
#define K4_WARPS 8                     // warps a team at the 32-pad class
#endif
#ifndef K4_TEAM_PAD
#define K4_TEAM_PAD 8                  // pads whose teams are single warps
#endif
#define K4_TEAM_WARPS 8                // warps a block up to K4_TEAM_PAD
#ifndef K4_TEAM_BLOCKS_PER_SM
#define K4_TEAM_BLOCKS_PER_SM 2        // blocks an SM up to K4_TEAM_PAD: at most 128 registers
#endif
#ifndef K4_STAGE_ROWS
#define K4_STAGE_ROWS 1                // output rows a stage thread above K4_TEAM_PAD
#endif
static_assert(K4_TEAM_PAD <= 8, "a team is one warp: 64 samples at most");
#ifdef K4_ONE_BLOCK
#define K4_MAXT (96 * K4_WARPS)        // three teams
#else
#define K4_MAXT (32 * K4_WARPS)        // one team: up to 255 registers
#endif
static_assert(K4_MAXT <= 1024, "a block holds at most 1024 threads");
#define K4_TEAM_MAXT (32 * K4_TEAM_WARPS)
#define POST 4                         // u64 a posted round trip: SSE(s), bits, coded
#define RED 6                          // int64 partial sums a warp

// A call's shape: the round trips of a unit, the warps of a team, the
// blocks of a unit (the cluster), the units of a block and the teams of a
// unit (1 where one team runs the unit's round trips in turn).
struct K4Shape {
    int nslot, tw, clu, upb, tpu;
};

static __host__ __device__ __forceinline__ K4Shape k4_shape(int P, int jccr) {
    K4Shape s;
    s.nslot = jccr ? 3 : 1;
    const bool team = P <= K4_TEAM_PAD;
    const int tw = K4_WARPS * P / 32;   // in proportion to the pad, at most K4_WARPS
    s.tw = team ? 1 : (tw < 1 ? 1 : tw > K4_WARPS ? K4_WARPS : tw);
#ifdef K4_SERIAL
    s.tpu = 1;
    s.clu = 1;
    s.upb = team ? K4_TEAM_WARPS : 1;
#else
    s.tpu = s.nslot;
#ifdef K4_ONE_BLOCK
    const bool cluster = !team && jccr && P > 32;   // three 64-pad teams exceed a block
#else
    const bool cluster = !team && jccr;
#endif
    s.clu = cluster ? s.nslot : 1;
    s.upb = team ? K4_TEAM_WARPS / s.nslot : 1;
#endif
    return s;
}

// Shared ints of one round trip's planes: the residual R, the first stage
// T1, the coefficients C (the scaled residual before them, the
// reconstructed residual after the inverse), the levels L (P rows of
// stride P + 4 each); the cores Cw (kw x w), Ch (kh x h) at stride P + 4
// and their transposes CwT (w x kw), ChT (h x kh) at stride K + 4, K =
// max(min(P, 32), 4); the TB's coefficient groups' plane offsets.
static __host__ __device__ __forceinline__ int k4_slot_ints(int P) {
    const int S = P + 4, K = P < 32 ? P : 32;
    return 4 * P * S + 2 * K * S + 2 * P * (K + 4) + (K * K > 32 ? K * K : 32);
}

// Bytes of a block's dynamic shared memory: with the trial, each unit's
// posts; each warp's partial sums; each round trip's planes.
static __host__ __device__ __forceinline__ int k4_smem(const K4Shape& s, int P) {
    const int spb = s.clu > 1 ? 1 : s.upb * s.nslot;
    const int warps = (s.clu > 1 ? 1 : s.upb * s.tpu) * s.tw;
    return (s.nslot == 3 ? s.upb * 3 * POST * 8 : 0) + warps * RED * 8 +
           spb * k4_slot_ints(P) * 4;
}

// LMCS chroma residual scaling of one residual sample before the forward
// transform, and of one reconstructed residual sample after the inverse.
static __device__ __forceinline__ int crs_fwd(int r, int c, int bd) {
    const int m = min(((abs(r) << 11) + (c >> 1)) / c, (1 << bd) - 1);
    return r < 0 ? -m : m;
}

static __device__ __forceinline__ int crs_inv(int r, int c, int bd) {
    const int rs = clampi(r, -(1 << bd), (1 << bd) - 1);
    const int m = (abs(rs) * c + (1 << 10)) >> 11;
    return clampi(rs < 0 ? -m : m, COEFF_MIN, COEFF_MAX);
}

// The CU's CRS scale (row ``r`` in luma units), in every lane of the
// calling warp, which must be whole.
static __device__ int crs_scale(const int32_t* ry, const int32_t* og, const int32_t* lut,
                                const int32_t* r, int HL, int WL, int bd) {
    const int fi = r[0], vx = r[1] / VPDU * VPDU, vy = r[2] / VPDU * VPDU, oi = r[5];
    const int GH = HL / 4, GW = WL / 4;
    const int32_t* g = og + (size_t)fi * GH * GW;
    const int32_t* p = ry + (size_t)fi * HL * WL;
    // a side counts where the leaf covering its first sample precedes the CU
    const int id_l = g[clampi(vy / 4, 0, GH - 1) * GW + clampi(max(vx - 4, 0) / 4, 0, GW - 1)];
    const int id_a = g[clampi(max(vy - 4, 0) / 4, 0, GH - 1) * GW + clampi(vx / 4, 0, GW - 1)];
    const bool left = vx > 0 && id_l >= 0 && id_l < oi;
    const bool above = vy > 0 && id_a >= 0 && id_a < oi;
    // both sides read while the grid is read (the reads are clamped to the
    // frame), then the ones that count summed
    const int lane = threadIdx.x & 31;
    int sl = 0, sa = 0;
    for (int i = lane; i < VPDU; i += 32) {
        sl += p[min(vy + i, HL - 1) * WL + max(vx - 1, 0)];
        sa += p[max(vy - 1, 0) * WL + min(vx + i, WL - 1)];
    }
    int s = (left ? sl : 0) + (above ? sa : 0);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    const int n = left + above;
    const int avg = n == 0 ? 1 << (bd - 1) : (s + (32 << max(n - 1, 0))) >> (5 + n);
    return (r[3] / 2) * (r[4] / 2) > 4 ? lut[clampi(avg, 0, (1 << bd) - 1)] : CRS_UNIT;
}

// The (h, w) side n's core (n = 2^ln, kn = min(n, 32) rows) into M (rows
// kn, stride S) and MT (columns kn, stride ST); a side of 2 as a 4 x 4
// matrix whose entries beyond the 2-point core are zero.
static __device__ void load_dct2(const Team& tm, const int32_t* d64, int ln, int32_t* M, int S,
                                 int32_t* MT, int ST) {
    if (ln >= 2) {
        load_core(tm, d64, nullptr, 0, ln, min(1 << ln, 32), M, S, MT, ST);
        return;
    }
    for (int e = tm.tid; e < 16; e += tm.n) {
        const int i = e >> 2, j = e & 3;
        const int v = i < 2 && j < 2 ? d64[(i << 5) * 64 + j] : 0;
        M[i * S + j] = v;
        MT[j * ST + i] = v;
    }
}

// One round trip's planes in shared memory.
struct Planes {
    int32_t *R, *T1, *C, *L, *Cw, *Ch, *CwT, *ChT, *SD;
};

static __device__ __forceinline__ Planes planes_at(int32_t* base, int P) {
    const int S = P + 4, K = P < 32 ? P : 32;
    Planes q;
    q.R = base;
    q.T1 = q.R + P * S;
    q.C = q.T1 + P * S;
    q.L = q.C + P * S;
    q.Cw = q.L + P * S;
    q.Ch = q.Cw + K * S;
    q.CwT = q.Ch + K * S;
    q.ChT = q.CwT + P * (K + 4);
    q.SD = q.ChT + P * (K + 4);
    return q;
}

// What a round trip leaves in every thread of its team: the coded-vs-zero
// decision, the rate proxy, and with the trial the SSEs of its
// reconstructions against the originals (U, V: coded and uncoded; the
// joint TU: U and V, coded).
struct Trip {
    int coded, bits;
    long long e0, e1;
};

// The CU's geometry and the call's constants of a round trip.
struct Cu {
    int P, S, w, h, xs, ys, H, W, crs, bd;
    bool region, sdh, rd, trial;
    float lam, lam2, lam3, dw;
};

// One round trip of ``kind`` (0 U, 1 V, 2 the joint TU) on the team's planes
// ``q``: the levels end in L, the reconstructed residual (scaled back) in C.
// ``ou``, ``ov``: frame fi of the original planes; ``pu``, ``pv``: the CU's
// prediction tiles.
template <int RW>
static __device__ Trip round_trip(const Team& tm, const Cu& cu, const Tile& t, int kind,
                                  const Planes& q, const int32_t* ou, const int32_t* ov,
                                  const int32_t* pu, const int32_t* pv, const int32_t* d64,
                                  const int32_t* tab, long long* red) {
    const int P = cu.P, S = cu.S, w = cu.w, h = cu.h, ST = (P < 32 ? P : 32) + 4;
    const int w4 = max(w, 4), h4 = max(h, 4), kw = min(w, 32), kh = min(h, 32);
    const int kw4 = max(kw, 4), kh4 = max(kh, 4), lq = ilog2(w4) - 2;
    const int32_t* pa = kind == 1 ? pv : pu;
    const int32_t* oa = kind == 1 ? ov : ou;
    int32_t* X = cu.crs ? q.C : q.R;   // the transform's input
    // the residual over (h, w4), zero beyond w; with CRS also scaled into C
    for (int e = tm.tid; e < h << lq; e += tm.n) {
        const int y = e >> lq, x = (e & ((1 << lq) - 1)) << 2;
        const int4 p4 = __ldg(reinterpret_cast<const int4*>(pa + y * P + x));
        const int pp[4] = {p4.x, p4.y, p4.z, p4.w};
        const int32_t* orow = oa + clampi(cu.ys + y, 0, cu.H - 1) * cu.W;
        int v[4];
        if (kind == 2) {
            const int4 q4 = __ldg(reinterpret_cast<const int4*>(pv + y * P + x));
            const int qv[4] = {q4.x, q4.y, q4.z, q4.w};
            const int32_t* vrow = ov + clampi(cu.ys + y, 0, cu.H - 1) * cu.W;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int c = clampi(cu.xs + x + u, 0, cu.W - 1);
                const int d = (orow[c] - pp[u]) - (vrow[c] - qv[u]);
                int j = d >> 1;
                if ((d & 1) && (j & 1)) ++j;
                v[u] = x + u < w ? j : 0;
            }
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
                v[u] = x + u < w ? orow[clampi(cu.xs + x + u, 0, cu.W - 1)] - pp[u] : 0;
        }
        *reinterpret_cast<int4*>(q.R + y * S + x) = make_int4(v[0], v[1], v[2], v[3]);
        if (cu.crs)
            *reinterpret_cast<int4*>(q.C + y * S + x) =
                make_int4(crs_fwd(v[0], cu.crs, cu.bd), crs_fwd(v[1], cu.crs, cu.bd),
                          crs_fwd(v[2], cu.crs, cu.bd), crs_fwd(v[3], cu.crs, cu.bd));
    }
    if (w > 32 || h > 32)              // levels beyond the zero-out limit
        for (int e = tm.tid; e < h << lq; e += tm.n) {
            const int y = e >> lq, x = (e & ((1 << lq) - 1)) << 2;
            *reinterpret_cast<int4*>(q.L + y * S + x) = make_int4(0, 0, 0, 0);
        }
    load_dct2(tm, d64, t.lw, q.Cw, S, q.CwT, ST);
    const int32_t* Ch = q.Cw;
    const int32_t* ChT = q.CwT;
    if (h != w) {
        load_dct2(tm, d64, t.lh, q.Ch, S, q.ChT, ST);
        Ch = q.Ch;
        ChT = q.ChT;
    }
    // the TB's coefficient groups as plane offsets (2x2 groups below 16
    // coefficients)
    const int ng = kw * kh >= 16 ? (kw * kh) >> 4 : (kw * kh) >> 2;
    if (cu.sdh)
        for (int e = tm.tid; e < ng * 16; e += tm.n) {
            const int ix = tab[e];
            q.SD[e] = ix >= 0 ? (ix / P) * S + (ix & (P - 1)) : -1;
        }
    tsync(tm);
    const int lkw = ilog2(kw4) - 2;
    stage<RW>(tm, X, S, q.CwT, ST, q.T1, S, h, lkw, w4, t.lw + t.bd + 6 - 15, false);
    stage<RW>(tm, Ch, S, q.T1, S, q.C, S, kh4, lkw, h4, t.lh + 6, false);
    quant_rd(tm, t, S, q.C, q.L, kh4, kw4, cu.rd && min(w, h) >= 4, !cu.sdh, cu.lam, cu.lam3);
    if (cu.region) {                   // w, h >= 4: the top-left group's first n_allow positions
        const int n_allow = (w == 4 && h == 4) || (w == 8 && h == 8) ? 8 : 16;
        for (int e = tm.tid; e < kh * kw; e += tm.n) {
            const int y = e / kw, x = e & (kw - 1);
            // the diagonal scan position of (y, x) in the 4x4 group
            const int k = (int)((0xfda6eb73c8419520ull >> (4 * ((y & 3) * 4 + (x & 3)))) & 15);
            if (y >= 4 || x >= 4 || k >= n_allow) {
                q.L[y * S + x] = 0;
                if (!cu.sdh) q.C[y * S + x] = 0;
            }
        }
        tsync(tm);
    }
    if (cu.sdh) sdh_deq(tm, t, q.SD, ng, q.C, q.L);
    stage<RW>(tm, ChT, ST, q.C, S, q.T1, S, h, lkw, kh4, 7, true);
    stage<RW>(tm, q.T1, S, q.Cw, S, q.C, S, h, lq, kw4, 6 + 15 - 1 - t.bd, true);
    // the sums over the CU, the reconstructed residual scaled back in place
    long long sse = 0, sse0 = 0, e0 = 0, e1 = 0;
    int bits = 0;
    const int pel_max = (1 << cu.bd) - 1;
    for (int e = tm.tid; e < h * w; e += tm.n) {
        const int y = e >> t.lw, x = e & (w - 1), o = y * S + x;
        const int res = q.R[o];
        int rr = q.C[o];
        if (cu.crs) {
            rr = crs_inv(rr, cu.crs, cu.bd);
            q.C[o] = rr;
        }
        const long long d = (long long)rr - res;
        sse += d * d;
        sse0 += (long long)res * res;
        const int a = abs(q.L[o]);
        if (a) bits += 2 * (32 - __clz(a)) + 2;   // magnitude + nonzero count
        if (cu.trial) {
            const int i = y * P + x;
            if (kind == 2) {
                const int c = clampi(cu.ys + y, 0, cu.H - 1) * cu.W + clampi(cu.xs + x, 0, cu.W - 1);
                const long long du = clampi(pu[i] + rr, 0, pel_max) - ou[c];
                const long long dv = clampi(pv[i] - rr, 0, pel_max) - ov[c];
                e0 += du * du;
                e1 += dv * dv;
            } else {
                const int p = pa[i], org = res + p;
                const long long dc = clampi(p + rr, 0, pel_max) - org;
                const long long dz = clampi(p, 0, pel_max) - org;
                e0 += dc * dc;
                e1 += dz * dz;
            }
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        sse += __shfl_xor_sync(FULL, sse, o);
        sse0 += __shfl_xor_sync(FULL, sse0, o);
        e0 += __shfl_xor_sync(FULL, e0, o);
        e1 += __shfl_xor_sync(FULL, e1, o);
        bits += __shfl_xor_sync(FULL, bits, o);
    }
    if (tm.n > 32) {                   // the team's warps' sums, in every thread
        long long* mine = red + (threadIdx.x >> 5) * RED;
        if ((tm.tid & 31) == 0)
            mine[0] = sse, mine[1] = sse0, mine[2] = e0, mine[3] = e1, mine[4] = bits;
        tsync(tm);
        sse = sse0 = e0 = e1 = bits = 0;
        for (int i = tm.w0; i < tm.w0 + (tm.n >> 5); ++i) {
            const long long* p = red + i * RED;
            sse += p[0], sse0 += p[1], e0 += p[2], e1 += p[3], bits += (int)p[4];
        }
    } else {
        __syncwarp();                  // C, scaled back, is read by other lanes next
    }
    Trip out;
    out.bits = bits + 8;
    const float cost_code =
        __fadd_rn(__fmul_rn(cu.dw, __ll2float_rn(sse)), __fmul_rn(cu.lam, (float)out.bits));
    out.coded = __fadd_rn(__fmul_rn(cu.dw, __ll2float_rn(sse0)), cu.lam2) > cost_code;
    out.e0 = e0;
    out.e1 = e1;
    return out;
}

// A P x P output tile of levels and recon: inside the (h, w) CU the levels
// L and clip(pred + sg * rr), rr = C, where ``coded`` (else no level and
// clip(pred)); zero outside it (h = w = 0: a zero tile).
static __device__ void write_tile(const Team& tm, int P, int S, int w, int h, bool coded,
                                  const int32_t* L, const int32_t* C, const int32_t* pr,
                                  int sg, int pel_max, int32_t* lev, int32_t* rec) {
    const int lq = ilog2(P) - 2;
    for (int e = tm.tid; e < (P * P) >> 2; e += tm.n) {
        const int y = e >> lq, x = (e & ((1 << lq) - 1)) << 2;
        const int4 p = __ldg(reinterpret_cast<const int4*>(pr + y * P + x));
        const int pv[4] = {p.x, p.y, p.z, p.w};
        int lv[4], rc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const bool in = y < h && x + u < w;
            const int o = y * S + x + u;
            lv[u] = in && coded ? L[o] : 0;
            rc[u] = in ? clampi(pv[u] + (coded ? sg * C[o] : 0), 0, pel_max) : 0;
        }
        *reinterpret_cast<int4*>(lev + y * P + x) = make_int4(lv[0], lv[1], lv[2], lv[3]);
        *reinterpret_cast<int4*>(rec + y * P + x) = make_int4(rc[0], rc[1], rc[2], rc[3]);
    }
}

// TEAM: the instantiation for pads up to K4_TEAM_PAD, whose teams are warps
// (K4_TEAM_BLOCKS_PER_SM blocks an SM, 1 x 4 outputs a stage thread); the
// other one block an SM and K4_STAGE_ROWS x 4.
template <bool TEAM>
__global__ void __launch_bounds__(TEAM ? K4_TEAM_MAXT : K4_MAXT,
                                  TEAM ? K4_TEAM_BLOCKS_PER_SM : 1)
tq_kernel(const int32_t* __restrict__ o0, const int32_t* __restrict__ o1,
          const int32_t* __restrict__ pred, const int32_t* __restrict__ rows,
          const int32_t* __restrict__ d64, const int32_t* __restrict__ cgtab,
          const int32_t* __restrict__ lfnst_active, const int32_t* __restrict__ ry,
          const int32_t* __restrict__ og, const int32_t* __restrict__ lut, int nplanes, int B,
          int P, int scale, int qp, int bd, int rd_quant, int H, int W, int sdh_on, int ncg,
          int jccr, int qp_j, int crs_on, float lam, float lam2, float lam3, float dw,
          int32_t* __restrict__ lev_out, int32_t* __restrict__ rec_out,
          int32_t* __restrict__ joint_out, int32_t* __restrict__ crs_out) {
    extern __shared__ int4 smem4[];
    const K4Shape sh = k4_shape(P, jccr);
    const bool clustered = sh.clu > 1;
    const int nthr = sh.tw * 32, team = threadIdx.x / nthr;
    const int tpb = clustered ? 1 : sh.upb * sh.tpu;
    const Team tm = {(int)threadIdx.x - team * nthr, nthr, team * sh.tw,
                     sh.tw > 1 && tpb > 1 ? 1 + team : 0};
    const int ub = team / sh.tpu;      // the block's unit
    const int u = clustered ? blockIdx.x / sh.clu : blockIdx.x * sh.upb + ub;
    const int slot0 = clustered ? blockIdx.x % sh.clu : team % sh.tpu;
    const int step = sh.tpu == 1 ? 1 : sh.nslot;   // one team: every round trip in turn
    if (u >= (jccr ? B : B * nplanes)) return;
    const int b = jccr ? u : u / nplanes, upl = jccr ? 0 : u % nplanes;
    const int PP = P * P, pel_max = (1 << bd) - 1;
    const int32_t* r = rows + 8 * b;
    // the output tile of a plane
    auto lev_t = [&](int pl) { return lev_out + ((size_t)pl * B + b) * PP; };
    auto rec_t = [&](int pl) { return rec_out + ((size_t)pl * B + b) * PP; };
    const int32_t* pu = pred + ((size_t)(jccr ? 0 : upl) * B + b) * PP;
    const int32_t* pv = jccr ? pred + ((size_t)B + b) * PP : pu;
    if (r[6] <= 0) {                   // padding row: every block of the unit returns here
        for (int s = slot0; s < sh.nslot; s += step) {
            const int pl = jccr ? s : upl;
            if (pl < nplanes)
                write_tile(tm, P, 0, 0, 0, false, nullptr, nullptr, pl == 1 && jccr ? pv : pu,
                           1, pel_max, lev_t(pl), rec_t(pl));
            if (tm.tid == 0 && s == 0 && pl == 0) {
                if (jccr) joint_out[b] = 0;
                if (crs_out) crs_out[b] = CRS_UNIT;
            }
        }
        return;
    }
    if (clustered) cluster_arrive();   // waited on before the posts

    unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
    unsigned long long* post = reinterpret_cast<unsigned long long*>(base) + ub * 3 * POST;
    base += jccr ? sh.upb * 3 * POST * 8 : 0;
    long long* red = reinterpret_cast<long long*>(base);
    base += tpb * sh.tw * RED * 8;
    int32_t* planes0 = reinterpret_cast<int32_t*>(base) +
                       (clustered ? 0 : ub * sh.nslot) * k4_slot_ints(P);

    Cu cu;
    cu.P = P, cu.S = P + 4, cu.w = r[3] / scale, cu.h = r[4] / scale;
    cu.xs = r[1] / scale, cu.ys = r[2] / scale, cu.H = H, cu.W = W, cu.bd = bd;
    cu.crs = crs_on ? crs_scale(ry, og, lut, r, H * scale, W * scale, bd) : 0;
    cu.region = lfnst_active != nullptr && lfnst_active[b] && cu.w >= 4 && cu.h >= 4;
    cu.sdh = sdh_on, cu.rd = rd_quant, cu.trial = jccr;
    cu.lam = lam, cu.lam2 = lam2, cu.lam3 = lam3, cu.dw = dw;
    const int fi = r[0];
    const int32_t* ou = (jccr || upl == 0 ? o0 : o1) + (size_t)fi * H * W;
    const int32_t* ov = jccr ? o1 + (size_t)fi * H * W : ou;
    const Tile tc = make_tile(P, cu.w, cu.h, qp, bd);
    const int32_t* tab = cgtab + (size_t)(tc.lw * 7 + tc.lh) * ncg * 16;
    if (tm.tid == 0 && crs_out && slot0 == 0 && upl == 0) crs_out[b] = cu.crs;

    Trip trip = {};
    for (int s = slot0; s < sh.nslot; s += step) {
        const Planes q = planes_at(planes0 + (clustered ? 0 : s) * k4_slot_ints(P), P);
        const Tile t = s == 2 ? make_tile(P, cu.w, cu.h, qp_j, bd) : tc;
        trip = round_trip<TEAM ? 1 : K4_STAGE_ROWS>(tm, cu, t, jccr ? s : upl, q, ou, ov, pu,
                                                     pv, d64, tab, red);
        if (!jccr) {                   // the one writer of this plane
            write_tile(tm, P, cu.S, cu.w, cu.h, trip.coded, q.L, q.C, pu, 1, pel_max,
                       lev_t(upl), rec_t(upl));
            continue;
        }
        // the post: U and V their reconstruction's SSE, the joint TU its
        // two; the bits of a coded TU with a level (0: none); the decision
        if (tm.tid == 0) {
            const unsigned long long v[POST] = {
                (unsigned long long)(s == 2 || trip.coded ? trip.e0 : trip.e1),
                (unsigned long long)(s == 2 ? trip.e1 : 0),
                (unsigned long long)(trip.coded && trip.bits > 8 ? trip.bits : 0),
                (unsigned long long)trip.coded};
            if (clustered) {
                cluster_wait();        // every block of the cluster runs
                for (int k = 0; k < POST; ++k)
                    for (int rank = 0; rank < sh.clu; ++rank)
                        cluster_store(cluster_addr(&post[s * POST + k], rank), v[k]);
            } else {
                for (int k = 0; k < POST; ++k) post[s * POST + k] = v[k];
            }
        }
    }
    if (!jccr) return;
    // every round trip posted: one barrier over the unit's teams
    if (clustered) {
        if (tm.tid != 0) cluster_wait();
        cluster_arrive();
        cluster_wait();
    } else if (sh.upb == 1) {
        __syncthreads();
    } else if (sh.tpu == 1) {
        __syncwarp();
    } else {
        named_sync(1 + ub, sh.tpu * nthr);
    }
    const float bits_s = __fadd_rn(__fadd_rn(post[2] ? (float)post[2] : 1.0f,
                                             post[POST + 2] ? (float)post[POST + 2] : 1.0f),
                                   1.0f);
    const float cost_s = __fadd_rn(
        __fmul_rn(dw, __fadd_rn(__ll2float_rn((long long)post[0]),
                                __ll2float_rn((long long)post[POST]))),
        __fmul_rn(lam, bits_s));
    const float cost_j = __fadd_rn(
        __fmul_rn(dw, __fadd_rn(__ll2float_rn((long long)post[2 * POST]),
                                __ll2float_rn((long long)post[2 * POST + 1]))),
        __fmul_rn(lam, __fadd_rn((float)post[2 * POST + 2], 3.0f)));
    const bool use = post[2 * POST + 2] > 8 && cost_j < cost_s;
    // exactly one writer a tile: the joint team both planes where joint
    // wins, else U and V their own
    for (int s = slot0; s < sh.nslot; s += step) {
        const Planes q = planes_at(planes0 + (clustered ? 0 : s) * k4_slot_ints(P), P);
        if (s == 2) {
            if (tm.tid == 0) joint_out[b] = use;
            if (!use) continue;
            write_tile(tm, P, cu.S, cu.w, cu.h, true, q.L, q.C, pu, 1, pel_max, lev_t(0),
                       rec_t(0));
            write_tile(tm, P, cu.S, cu.w, cu.h, true, q.L, q.C, pv, -1, pel_max, lev_t(1),
                       rec_t(1));
        } else if (!use) {
            write_tile(tm, P, cu.S, cu.w, cu.h, post[s * POST + 3] != 0, q.L, q.C,
                       s == 0 ? pu : pv, 1, pel_max, lev_t(s), rec_t(s));
        }
    }
}

extern "C" int pmp_tq(const int32_t* o0, const int32_t* o1, const int32_t* pred,
                      const int32_t* rows, const int32_t* d64,
                      const int32_t* cgtab, const int32_t* lfnst_active,
                      const int32_t* ry, const int32_t* og, const int32_t* lut,
                      int nplanes, int B, int P,
                      int scale, int qp, int bd, int rd_quant,
                      int H, int W, int sdh, int ncg, int jccr, int qp_j, int crs_on,
                      float lam, float lam2, float lam3, float dw, int32_t* lev, int32_t* rec,
                      int32_t* joint, int32_t* crs_out, cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > 64 || P < 4 || (jccr && nplanes != 2) || (!jccr && (nplanes < 1 || nplanes > 2)) ||
        (crs_on && (!ry || !og || !lut)) || (crs_out && !crs_on))
        return (int)cudaErrorInvalidValue;
    const K4Shape sh = k4_shape(P, jccr);
    const int smem = k4_smem(sh, P);
    const int units = jccr ? B : B * nplanes;
    const int threads = (sh.clu > 1 ? 1 : sh.upb * sh.tpu) * sh.tw * 32;
    auto kernel = P <= K4_TEAM_PAD ? tq_kernel<true> : tq_kernel<false>;
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sh.clu > 1 ? units * sh.clu : (units + sh.upb - 1) / sh.upb);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = sh.clu;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = sh.clu > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kernel, o0, o1, pred, rows, d64, cgtab, lfnst_active, ry, og, lut, nplanes, B, P,
        scale, qp, bd, rd_quant, H, W, sdh, ncg, jccr, qp_j, crs_on, lam, lam2, lam3, dw, lev,
        rec, joint, crs_out);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
