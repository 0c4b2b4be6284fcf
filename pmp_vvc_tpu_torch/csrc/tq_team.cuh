// The team form of a transform-quantisation round trip, shared by K4
// (csrc/tq.cu, chroma) and K5 (csrc/tq_mts.cu, luma): a team is a warp, a
// block, or a group of a block's warps under a named barrier, and works on
// planes in shared memory (row stride P + 4, so that int4 loads at
// neighbouring rows fall in different banks). The rounding is csrc/tq.cuh's:
// its Tile, quantiser tables and dequant.
//
// What is here: the team and its barrier; the cluster helpers (barriers
// without .aligned, the mapped address of a variable in another block's
// shared memory and a 64-bit store there); the four transform stages as one
// product ``stage`` of shared-memory matrices (RW x 4 outputs a thread from
// int4 loads, one barrier); the cores loaded into shared memory by rows and
// by columns (``load_core``); the dead-zone quantiser with the RDOQ-lite
// zeroing, one lane a coefficient and 16 lanes a coefficient group
// (``quant_rd``); sign-data hiding, 16 lanes a group (``sdh_deq``).
// Every function is called by all threads of the team and ends with the
// team's barrier where another thread reads its result.
#pragma once
#include "tq.cuh"

#define FULL 0xffffffffu

// The 4x4 diagonal scan (ops/lfnst.py:_DIAG4) as y * 4 + x, a nibble a
// position, so that lanes at different positions read no table.
static __device__ __forceinline__ int diag4(int k) {
    return (int)((0xfbe7ad369c258140ull >> (4 * k)) & 15);
}

// A team's threads: ``tid`` of ``n`` (the whole block, one warp, or ``n``
// threads of a block under named barrier ``bar`` > 0), first warp ``w0`` of
// the block.
struct Team {
    int tid, n, w0, bar;
};

// bar.sync id, n among the threads of a named barrier (the form without
// .aligned: a warp may reach it diverged).
static __device__ __forceinline__ void named_sync(int id, int n) {
    asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

static __device__ __forceinline__ void tsync(const Team& tm) {
    if (tm.n == 32) __syncwarp();
    else if (tm.bar > 0) named_sync(tm.bar, tm.n);
    else __syncthreads();
}

// The cluster barriers are the forms without .aligned: a warp may reach
// them diverged (after the one thread that posts the key).
static __device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

static __device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The address of ``p`` in the shared memory of the cluster's block
// ``rank``, and a 64-bit store there.
static __device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
    return r;
}

static __device__ __forceinline__ void cluster_store(uint32_t addr, unsigned long long v) {
    asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(addr), "l"(v) : "memory");
}

static __device__ __forceinline__ int4 ld4(const int32_t* p) {
    return *reinterpret_cast<const int4*>(p);
}

static __device__ __forceinline__ int stage_out(int acc, int shift, bool clip) {
    const int v = rshift(acc, shift);
    return clip ? clampi(v, COEFF_MIN, COEFF_MAX) : v;
}

// out[a][b] = rshift(sum_k A[a][k] B[k][b], shift), clipped to 16 bits with
// ``clip``, for a < M, b < 4 << lnq, k < K (M a multiple of RW, K of 4):
// RW x 4 neighbouring outputs a thread from int4 loads.
// Ends with the team's barrier.
template <int RW>
static __device__ void stage(const Team& tm, const int32_t* A, int sa, const int32_t* B,
                             int sb, int32_t* out, int so, int M, int lnq, int K, int shift,
                             bool clip) {
    const int tasks = (M / RW) << lnq, qm = (1 << lnq) - 1;
    for (int t = tm.tid; t < tasks; t += tm.n) {
        const int a = (t >> lnq) * RW, b = (t & qm) << 2;
        const int32_t* bc = B + b;
        int acc[RW][4] = {};
#pragma unroll 2
        for (int k = 0; k < K; k += 4) {
            const int4 b0 = ld4(bc + k * sb), b1 = ld4(bc + (k + 1) * sb);
            const int4 b2 = ld4(bc + (k + 2) * sb), b3 = ld4(bc + (k + 3) * sb);
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                const int4 av = ld4(A + (a + r) * sa + k);
                acc[r][0] += av.x * b0.x + av.y * b1.x + av.z * b2.x + av.w * b3.x;
                acc[r][1] += av.x * b0.y + av.y * b1.y + av.z * b2.y + av.w * b3.y;
                acc[r][2] += av.x * b0.z + av.y * b1.z + av.z * b2.z + av.w * b3.z;
                acc[r][3] += av.x * b0.w + av.y * b1.w + av.z * b2.w + av.w * b3.w;
            }
        }
#pragma unroll
        for (int r = 0; r < RW; ++r)
            *reinterpret_cast<int4*>(out + (a + r) * so + b) =
                make_int4(stage_out(acc[r][0], shift, clip), stage_out(acc[r][1], shift, clip),
                          stage_out(acc[r][2], shift, clip), stage_out(acc[r][3], shift, clip));
    }
    tsync(tm);
}

// Rows i < kn of the n = 2^ln point core of ``kind`` into M (kn x n,
// stride S) and MT (n x kn, stride ST); n >= 4.
static __device__ void load_core(const Team& tm, const int32_t* d64, const int32_t* mts,
                                 int kind, int ln, int kn, int32_t* M, int S, int32_t* MT,
                                 int ST) {
    const int lq = ln - 2, total = kn << lq;
    for (int e = tm.tid; e < total; e += tm.n) {
        const int i = e >> lq, j = (e & ((1 << lq) - 1)) << 2;
        const int32_t* src = kind == 0 ? d64 + (i << (6 - ln)) * 64 + j
                                       : mts + (((kind - 1) * 4 + ln - 2) * 32 + i) * 32 + j;
        const int4 v = __ldg(reinterpret_cast<const int4*>(src));
        *reinterpret_cast<int4*>(M + i * S + j) = v;
        MT[j * ST + i] = v.x;
        MT[(j + 1) * ST + i] = v.y;
        MT[(j + 2) * ST + i] = v.z;
        MT[(j + 3) * ST + i] = v.w;
    }
}

// Dead-zone (171) quantisation of the (qh, qw) region of ``coef`` into
// ``lev`` (qh, qw multiples of 4), one lane a coefficient and 16 lanes a 4x4
// group; with ``rd`` the RDOQ-lite zeroing of each group (its gains summed
// in float64 in the order 0..15, as the plain version sums them); with
// ``deq`` the clipped dequantised level in place of the coefficient. Ends
// with the team's barrier.
static __device__ void quant_rd(const Team& tm, const Tile& t, int S, int32_t* coef,
                                int32_t* lev, int qh, int qw, bool rd, bool deq, float lam,
                                float lam3) {
    const int lgx = ilog2(qw) - 2, n = ((qh >> 2) << lgx) * 16, lane = tm.tid & 31;
    const int gb = lane & 16;
    for (int base = tm.tid - lane; base < n; base += tm.n) {
        const int e = base + lane, g = e >> 4, i = e & 15;
        const bool act = e < n;
        const int o = ((g >> lgx) * 4 + (i >> 2)) * S + (g & ((1 << lgx) - 1)) * 4 + (i & 3);
        int lv = 0;
        float gain = 0.0f;
        int c = 0;
        if (act) {
            c = coef[o];
            const int mag = (int)((uint32_t)abs(c) * (uint32_t)t.qscale + (uint32_t)t.add) >>
                            t.q_bits;
            lv = clampi(c < 0 ? -mag : mag, COEFF_MIN, COEFF_MAX);
            if (rd) {
                const float fc = (float)c;
                const float er = __fsub_rn(fc, (float)dequant(lv, t.iscale, t.rs));
                gain = __fdiv_rn(__fsub_rn(__fmul_rn(fc, fc), __fmul_rn(er, er)), t.divisor);
            }
        }
        if (rd) {                      // warp-uniform
            double gsum = 0.0;
#pragma unroll
            for (int k = 0; k < 16; ++k) gsum += (double)__shfl_sync(FULL, gain, gb + k);
            const int nz = __popc((__ballot_sync(FULL, lv != 0) >> gb) & 0xffffu);
            const float thr = __fmul_rn(lam, __fadd_rn(__fmul_rn(3.0f, (float)nz), 1.5f));
            if (__double2float_rn(gsum) < thr) lv = 0;
            if (abs(lv) == 1 && gain < lam3) lv = 0;
        }
        if (act) {
            lev[o] = lv;
            if (deq) coef[o] = clampi(dequant(lv, t.iscale, t.rs), COEFF_MIN, COEFF_MAX);
        }
    }
    tsync(tm);
}

// Sign-data hiding over the TB's ``ng`` coefficient groups (``tab``: their
// 16 plane offsets each in scan order, -1 where absent), 16 lanes a group:
// where the first and last nonzero slots are >= 4 apart and the parity of
// the absolute sum disagrees with the first level's sign, the level move of
// least added dequantisation error (deq(l') - c)^2 - (deq(l) - c)^2 in
// float32 is applied, +1 in magnitude on a nonzero level or -1 on one of
// magnitude >= 2, the first minimum of up[0..15], down[0..15] taken as the
// least (error, index). Every lane then writes its coefficient's clipped
// dequantised level in place. Ends with the team's barrier.
static __device__ void sdh_deq(const Team& tm, const Tile& t, const int32_t* tab, int ng,
                               int32_t* coef, int32_t* lev) {
    const int n = ng * 16, lane = tm.tid & 31, gb = lane & 16, k = lane & 15;
    for (int base = tm.tid - lane; base < n; base += tm.n) {
        const int e = base + lane;
        const int o = e < n ? tab[e] : -1;
        int l = o >= 0 ? lev[o] : 0;
        const unsigned m = (__ballot_sync(FULL, l != 0) >> gb) & 0xffffu;
        int sum = abs(l);
        for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
        const int first = m ? __ffs(m) - 1 : 0, last = m ? 31 - __clz(m) : 0;
        const int lfirst = __shfl_sync(FULL, l, gb + first);
        const bool go = m && last - first >= 4 && (sum & 1) != (lfirst < 0 ? 1 : 0);
        float be = INFINITY;
        int bi = k;
        if (go && l != 0) {
            const int sg = l > 0 ? 1 : -1;
            const float cf = (float)coef[o];
            const float d0 = __fsub_rn((float)dequant(l, t.iscale, t.rs), cf);
            const float e0 = __fmul_rn(d0, d0);
            const float du = __fsub_rn((float)dequant(l + sg, t.iscale, t.rs), cf);
            be = __fsub_rn(__fmul_rn(du, du), e0);
            if (abs(l) >= 2) {
                const float dd = __fsub_rn((float)dequant(l - sg, t.iscale, t.rs), cf);
                const float ed = __fsub_rn(__fmul_rn(dd, dd), e0);
                if (ed < be) be = ed, bi = k + 16;
            }
        }
        for (int off = 8; off > 0; off >>= 1) {   // the least (error, index)
            const float oe = __shfl_xor_sync(FULL, be, off);
            const int oi = __shfl_xor_sync(FULL, bi, off);
            if (oe < be || (oe == be && oi < bi)) be = oe, bi = oi;
        }
        if (go && (bi & 15) == k) l += (bi < 16) == (l > 0) ? 1 : -1;
        if (o >= 0) {
            lev[o] = l;
            coef[o] = clampi(dequant(l, t.iscale, t.rs), COEFF_MIN, COEFF_MAX);
        }
    }
    tsync(tm);
}
