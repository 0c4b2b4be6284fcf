// K9: the device RDO's open-loop leaf costs (K9a, K9b, K9c).
//
// Replaces pmp_vvc_tpu/codec/rdo_device.py:_leaf_cost_fn (77-138) and
// _chroma_leaf_cost_fn (580-648), whose other steps run on the port's K1
// (references from the original planes, every in-frame sample available),
// K5 (the luma round trips, MTS only), K4 (the chroma round trips) and K6a
// (LM against the chosen chroma candidate). ops/rdo_generic.py composes
// them; every kernel here is one block per rect, the rect's samples in
// shared memory.
//
// K9a rdo_luma_select (rdo_device.py:83-121): RMD over the 35 modes
//   [0, 1] + range(2, 67, 2) by masked Hadamard SATD (csrc/satd.cuh) against
//   the original; every (mode, SATD tile) pair is one thread's work, the
//   tile's prediction computed in registers (csrc/intra_pred.cuh) and its
//   SATD added to the mode's integer sum; the first minimum wins, with no
//   +-1 refinement (K2 refines, the RDO does not). Writes the mode, its luma
//   prediction, and the DM predictions of U and V with that mode on the
//   unfiltered chroma references (chroma sides of 2 included).
// K9b rdo_chroma_select (rdo_device.py:588-617): the dual-tree chroma
//   candidates {planar, DC, HOR, VER} on U and V, scored by joint U+V SATD
//   on tiles over the sides rounded up to 4 and zero beyond the rect (the
//   plain version's masked tiles); the first minimum wins. Writes both
//   predictions and the winning SATD.
// K9c rdo_leaf_cost (rdo_device.py:122-136, 636-646): one block per
//   (QP, rect). Each plane's SSE of the round trip's recon against the
//   original, exact in int64 and rounded to float32 once, and the rate
//   proxy of its levels, 8 + nz + sum(2 * bitlen|l| + 1). Luma tree:
//   sse + lam * (bits + 6); chroma tree: lam * 2; then for U, then V,
//   + dw * sse_c + lam * bits_c, each operation rounded to float32 in the
//   JAX package's order (__fmul_rn / __fadd_rn, never contracted).
//
// Padding rows (live == 0) give zeros, mode 0 and cost 0.
//
// Bound: K9a and K9b by operations (35 or 4 candidate predictions of every
// sample, each sample's share of a Hadamard SATD) against a few bytes per
// sample; K9c by bytes (each recon and level sample read once, the
// originals once). chip_smoke.py computes the bound of each call it times.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_pred.cuh"
#include "satd.cuh"

#define MAXP 64
#define MAXL (2 * MAXP + 3)
#define MAXPC (MAXP / 2)
#define MAXLC (2 * MAXPC + 3)
#define NRMD 35                        // planar, DC, the 33 even angulars
#define NCC 4                          // the chroma tree's candidates

__constant__ int CHROMA_CAND[NCC] = {0, 1, 18, 50};

static __device__ __forceinline__ int rmd_mode(int k) { return k < 2 ? k : 2 * (k - 1); }

// Threads per block: enough for the (candidate, tile) pairs of the class.
static int threads_for(int P) { return P <= 8 ? 64 : (P <= 16 ? 128 : 256); }

static __device__ Cu make_cu(int w, int h, int P, int bd, int luma, const int32_t* ref,
                             int L, const int32_t* tabs) {
    Cu c;
    c.w = w; c.h = h; c.lw = ilog2(w); c.lh = ilog2(h);
    c.P = P; c.L = L; c.pel_max = (1 << bd) - 1; c.luma = luma;
    c.tu = ref; c.lu = ref + L; c.tf = ref + 2 * L; c.lf = ref + 3 * L;
    c.tabs = tabs;
    return c;
}

// The four reference rows of plane ``pl`` of row ``b`` from K1's (n, 4, B, L)
// output into ``dst`` (4 * L ints).
static __device__ void load_refs(const int32_t* refs, int pl, int b, int B, int L,
                                 int32_t* dst) {
    for (int i = threadIdx.x; i < 4 * L; i += blockDim.x)
        dst[i] = refs[((size_t)(pl * 4 + i / L) * B + b) * L + i % L];
}

// The (h, w) original tile at (xs, ys) of frame ``fi``, P-strided, zero
// beyond the rect; reads clamped to the plane.
static __device__ void load_org(const int32_t* plane, int fi, int H, int W, int xs,
                                int ys, int w, int h, int P, int32_t* dst) {
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
        const int y = i / P, x = i % P;
        dst[i] = (y < h && x < w)
                     ? plane[((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W +
                             clampi(xs + x, 0, W - 1)]
                     : 0;
    }
}

// SATD of tile t (ts x ts, nx tiles a row) of org - prediction of mode p,
// differences zero beyond the (h, w) rect.
static __device__ int mode_tile_satd(const Cu& c, const Mode& p, const int32_t* org,
                                     int t, int ts, int nx) {
    const int r0 = (t / nx) * ts, c0 = (t % nx) * ts;
    int d[64];
    for (int i = 0; i < ts; ++i)
        for (int j = 0; j < ts; ++j) {
            const int y = r0 + i, x = c0 + j;
            d[i * ts + j] =
                (y < c.h && x < c.w) ? org[y * c.P + x] - predict_sample(c, p, y, x) : 0;
        }
    return tile_satd(d, ts);
}

// Prediction of mode p over the P x P tile, zero beyond the rect.
static __device__ void write_pred(const Cu& c, const Mode& p, int32_t* out) {
    for (int i = threadIdx.x; i < c.P * c.P; i += blockDim.x) {
        const int y = i / c.P, x = i % c.P;
        out[i] = (y < c.h && x < c.w) ? predict_sample(c, p, y, x) : 0;
    }
}

__global__ void rdo_luma_select_kernel(const int32_t* __restrict__ refs,
                                       const int32_t* __restrict__ crefs,
                                       const int32_t* __restrict__ org,
                                       const int32_t* __restrict__ rows,
                                       const int32_t* __restrict__ tabs_l,
                                       const int32_t* __restrict__ tabs_c, int B, int P,
                                       int bd, int H, int W, int32_t* __restrict__ modes,
                                       int32_t* __restrict__ pred,
                                       int32_t* __restrict__ cpred) {
    const int b = blockIdx.x, L = 2 * P + 3, Pc = P / 2, Lc = 2 * Pc + 3;
    const int32_t* r = rows + 8 * b;
    int32_t* out = pred + (size_t)b * P * P;
    int32_t* cout[2] = {cpred + (size_t)b * Pc * Pc, cpred + ((size_t)B + b) * Pc * Pc};
    if (r[6] <= 0) {                   // padding row
        for (int i = threadIdx.x; i < P * P; i += blockDim.x) out[i] = 0;
        for (int i = threadIdx.x; i < Pc * Pc; i += blockDim.x) cout[0][i] = cout[1][i] = 0;
        if (threadIdx.x == 0) modes[b] = 0;
        return;
    }
    __shared__ int32_t sref[4 * MAXL];
    __shared__ int32_t scref[2][4 * MAXLC];
    __shared__ int32_t sorg[MAXP * MAXP];
    __shared__ int scost[NRMD];
    __shared__ int s_best;
    const int fi = r[0], xs = r[1], ys = r[2], w = r[3], h = r[4];
    load_refs(refs, 0, b, B, L, sref);
    load_refs(crefs, 0, b, B, Lc, scref[0]);
    load_refs(crefs, 1, b, B, Lc, scref[1]);
    load_org(org, fi, H, W, xs, ys, w, h, P, sorg);
    for (int k = threadIdx.x; k < NRMD; k += blockDim.x) scost[k] = 0;
    __syncthreads();

    const Cu c = make_cu(w, h, P, bd, 1, sref, L, tabs_l);
    const int ts = min(w, h) >= 8 ? 8 : 4, nx = w / ts, ntiles = (h / ts) * nx;
    for (int it = threadIdx.x; it < NRMD * ntiles; it += blockDim.x) {
        const int k = it / ntiles;
        atomicAdd(&scost[k], mode_tile_satd(c, mode_params(c, rmd_mode(k)), sorg,
                                            it % ntiles, ts, nx));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int best = 0;
        for (int k = 1; k < NRMD; ++k)
            if (scost[k] < scost[best]) best = k;
        s_best = rmd_mode(best);
        modes[b] = s_best;
    }
    __syncthreads();
    const int m = s_best;
    write_pred(c, mode_params(c, m), out);
    for (int pl = 0; pl < 2; ++pl) {
        const Cu cc = make_cu(w / 2, h / 2, Pc, bd, 0, scref[pl], Lc, tabs_c);
        write_pred(cc, mode_params(cc, m), cout[pl]);
    }
}

__global__ void rdo_chroma_select_kernel(const int32_t* __restrict__ crefs,
                                         const int32_t* __restrict__ ou,
                                         const int32_t* __restrict__ ov,
                                         const int32_t* __restrict__ rows,
                                         const int32_t* __restrict__ tabs_c, int B, int Pc,
                                         int bd, int Hc, int Wc, int32_t* __restrict__ pred,
                                         int32_t* __restrict__ satd_out) {
    const int b = blockIdx.x, Lc = 2 * Pc + 3;
    const int32_t* r = rows + 8 * b;
    int32_t* out[2] = {pred + (size_t)b * Pc * Pc, pred + ((size_t)B + b) * Pc * Pc};
    if (r[6] <= 0) {                   // padding row
        for (int i = threadIdx.x; i < Pc * Pc; i += blockDim.x) out[0][i] = out[1][i] = 0;
        if (threadIdx.x == 0) satd_out[b] = 0;
        return;
    }
    __shared__ int32_t scref[2][4 * MAXLC];
    __shared__ int32_t sorg[2][MAXPC * MAXPC];
    __shared__ int scost[NCC];
    __shared__ int s_best;
    const int fi = r[0], xs = r[1] / 2, ys = r[2] / 2, w = r[3] / 2, h = r[4] / 2;
    load_refs(crefs, 0, b, B, Lc, scref[0]);
    load_refs(crefs, 1, b, B, Lc, scref[1]);
    load_org(ou, fi, Hc, Wc, xs, ys, w, h, Pc, sorg[0]);
    load_org(ov, fi, Hc, Wc, xs, ys, w, h, Pc, sorg[1]);
    if (threadIdx.x < NCC) scost[threadIdx.x] = 0;
    __syncthreads();

    // tiles over the sides rounded up to 4: a side of 2 gives zero columns
    // or rows beyond the rect, as the plain version's masked tiles do
    const int sw = max(w, 4), sh = max(h, 4);
    const int ts = min(sw, sh) >= 8 ? 8 : 4, nx = sw / ts, ntiles = (sh / ts) * nx;
    for (int it = threadIdx.x; it < NCC * 2 * ntiles; it += blockDim.x) {
        const int k = it / (2 * ntiles), pl = (it / ntiles) % 2;
        const Cu cc = make_cu(w, h, Pc, bd, 0, scref[pl], Lc, tabs_c);
        atomicAdd(&scost[k], mode_tile_satd(cc, mode_params(cc, CHROMA_CAND[k]), sorg[pl],
                                            it % ntiles, ts, nx));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int best = 0;
        for (int k = 1; k < NCC; ++k)
            if (scost[k] < scost[best]) best = k;
        s_best = best;
        satd_out[b] = scost[best];
    }
    __syncthreads();
    for (int pl = 0; pl < 2; ++pl) {
        const Cu cc = make_cu(w, h, Pc, bd, 0, scref[pl], Lc, tabs_c);
        write_pred(cc, mode_params(cc, CHROMA_CAND[s_best]), out[pl]);
    }
}

static __device__ long long block_sum64(long long v, long long* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    long long s = 0;
    if (threadIdx.x == 0)
        for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
    return s;                          // valid in thread 0
}

// SSE of the P-strided recon tile ``rec`` against the plane's (h, w) rect at
// (xs, ys) and the rate proxy of the level tile ``lev``; valid in thread 0.
static __device__ void plane_sums(const int32_t* rec, const int32_t* lev, const int32_t* plane,
                                  int fi, int H, int W, int xs, int ys, int w, int h, int P,
                                  long long* red64, int* red32, long long* sse_out,
                                  int* bits_out) {
    long long sse = 0;
    int bits = 0;
    for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
        const int y = e / w, x = e % w;
        const long long d =
            (long long)rec[y * P + x] -
            plane[((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W + clampi(xs + x, 0, W - 1)];
        sse += d * d;
        const int a = abs(lev[y * P + x]);
        if (a) bits += 2 * (32 - __clz(a)) + 2;   // magnitude + nonzero count
    }
    *sse_out = block_sum64(sse, red64);
    *bits_out = block_sum(bits, red32) + 8;
}

__global__ void rdo_leaf_cost_kernel(const int32_t* __restrict__ rows,
                                     const int32_t* __restrict__ oy,
                                     const int32_t* __restrict__ ou,
                                     const int32_t* __restrict__ ov,
                                     const int32_t* __restrict__ lev_l,
                                     const int32_t* __restrict__ rec_l,
                                     const int32_t* __restrict__ lev_c,
                                     const int32_t* __restrict__ rec_c,
                                     const float* __restrict__ params, int B, int P, int H,
                                     int W, int luma, float* __restrict__ cost_out) {
    const int b = blockIdx.x, q = blockIdx.y, Pc = P / 2;
    const int32_t* r = rows + 8 * b;
    if (r[6] <= 0) {
        if (threadIdx.x == 0) cost_out[(size_t)q * B + b] = 0.0f;
        return;
    }
    __shared__ long long red64[32];
    __shared__ int red32[32];
    const int fi = r[0], xs = r[1], ys = r[2], w = r[3], h = r[4];
    const float lam = params[3 * q], dw = params[3 * q + 1], lam2 = params[3 * q + 2];
    long long sse;
    int bits;
    float cost = lam2;                 // the chroma tree's mode bins
    if (luma) {
        const size_t tile = ((size_t)q * B + b) * P * P;
        plane_sums(rec_l + tile, lev_l + tile, oy, fi, H, W, xs, ys, w, h, P, red64, red32,
                   &sse, &bits);
        cost = __fadd_rn(__ll2float_rn(sse), __fmul_rn(lam, __fadd_rn((float)bits, 6.0f)));
    }
    for (int pl = 0; pl < 2; ++pl) {
        const size_t tile = (((size_t)q * 2 + pl) * B + b) * Pc * Pc;
        plane_sums(rec_c + tile, lev_c + tile, pl ? ov : ou, fi, H / 2, W / 2, xs / 2, ys / 2,
                   w / 2, h / 2, Pc, red64, red32, &sse, &bits);
        cost = __fadd_rn(__fadd_rn(cost, __fmul_rn(dw, __ll2float_rn(sse))),
                         __fmul_rn(lam, (float)bits));
    }
    if (threadIdx.x == 0) cost_out[(size_t)q * B + b] = cost;
}

extern "C" int pmp_rdo_luma_select(const int32_t* refs, const int32_t* crefs,
                                   const int32_t* org, const int32_t* rows,
                                   const int32_t* tabs_l, const int32_t* tabs_c, int B, int P,
                                   int bd, int H, int W, int32_t* modes, int32_t* pred,
                                   int32_t* cpred, cudaStream_t stream) {
    if (B == 0) return 0;
    if (P > MAXP || P < 8) return (int)cudaErrorInvalidValue;
    rdo_luma_select_kernel<<<B, threads_for(P), 0, stream>>>(
        refs, crefs, org, rows, tabs_l, tabs_c, B, P, bd, H, W, modes, pred, cpred);
    return (int)cudaGetLastError();
}

extern "C" int pmp_rdo_chroma_select(const int32_t* crefs, const int32_t* ou,
                                     const int32_t* ov, const int32_t* rows,
                                     const int32_t* tabs_c, int B, int Pc, int bd, int Hc,
                                     int Wc, int32_t* pred, int32_t* satd, cudaStream_t stream) {
    if (B == 0) return 0;
    if (Pc > MAXPC || Pc < 4) return (int)cudaErrorInvalidValue;
    rdo_chroma_select_kernel<<<B, threads_for(2 * Pc), 0, stream>>>(
        crefs, ou, ov, rows, tabs_c, B, Pc, bd, Hc, Wc, pred, satd);
    return (int)cudaGetLastError();
}

extern "C" int pmp_rdo_leaf_cost(const int32_t* rows, const int32_t* oy, const int32_t* ou,
                                 const int32_t* ov, const int32_t* lev_l, const int32_t* rec_l,
                                 const int32_t* lev_c, const int32_t* rec_c,
                                 const float* params, int nqp, int B, int P, int H, int W,
                                 int luma, float* cost, cudaStream_t stream) {
    if (B == 0 || nqp == 0) return 0;
    if (P > MAXP || P < 8 || (luma && (!oy || !lev_l || !rec_l)))
        return (int)cudaErrorInvalidValue;
    rdo_leaf_cost_kernel<<<dim3(B, nqp), threads_for(P), 0, stream>>>(
        rows, oy, ou, ov, lev_l, rec_l, lev_c, rec_c, params, B, P, H, W, luma, cost);
    return (int)cudaGetLastError();
}
