// K3: the MIP candidates of the wave step's luma CUs against K2's winner.
//
// Replaces pmp_vvc_tpu/ops/mip_generic.py:predict_mip_generic (54), with its
// _mip_table (32) and sid_generic (48), the SATD of its candidates
// (ops/tq_generic.py:satd_generic, 160) and the MIP decision of
// codec/wavefront.py:_make_class_apply (402-425).
//
// One block per CU, the candidates in turn. The block derives the size class
// (sid, the boundary size red_b, the reduced size red_p, n_modes), Haar-
// downsamples the unfiltered top and left references, then for each of the
// 2 x 16 candidates (t, m) with m < n_modes: the reduced prediction from the
// (3, 16, 64, 8) weight table (a product of at most 8 terms per reduced
// sample, the sizeId-2 matrix at input columns 1..7), the horizontal linear
// upsampling against the left boundary and the vertical one against the top
// row into shared memory, and the SATD against the original with the code K2
// uses (csrc/satd.cuh). The first minimum wins (strict <, in t*16+m order);
// the MIP winner replaces K2's prediction only when its SATD is strictly
// below K2's winner's, which the block scores from K2's prediction with the
// same code. A MIP CU gets mode 0 (PLANAR) and code 1 + t*16 + m; any other
// CU keeps K2's mode and prediction with code 0. Nothing but the final
// prediction and the two small outputs goes to device memory.
//
// Bound: operations. A 64x64 CU costs 12 candidates of 4096 upsampled
// samples (about 10 integer operations each) and their Hadamard SATDs; the
// bytes (references, the original tile, K2's prediction in, the prediction
// out) are small beside that.
#include <cuda_runtime.h>
#include <stdint.h>

#include "satd.cuh"

#define MAXP 64
#define NT 256
#define NCAND 32                      // 2 transposes x 16 modes
#define NO_COST 0x40000000            // above every real SATD

static __device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static __device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

struct Mip {
    int w, h, P, sid, red_b, red_p, n_modes, bd;
    const int32_t *top, *left;        // shared: unfiltered rows, index 0 = x 0
    const int32_t* mats;              // (3, 16, 64, 8)
    const int32_t* bdry;              // shared: (2, 8) packed boundaries
    int32_t *sred, *sh;               // shared: (8, 8) reduced, (8, MAXP) rows
};

// Candidate k's prediction into ``out`` (P-strided, the (h, w) region).
static __device__ void mip_candidate(const Mip& c, int k, int32_t* out) {
    const int t = k >> 4, m = k & 15, rp = c.red_p;
    const int32_t* bd = c.bdry + 8 * t;
    const int off = bd[0];
    const int maxv = (1 << c.bd) - 1;
    for (int i = threadIdx.x; i < rp * rp; i += blockDim.x) {
        const int r = i / rp, col = i % rp;
        const int oi = t ? col * rp + r : r * rp + col;    // transposed read
        const int32_t* row = c.mats + ((c.sid * 16 + m) * 64 + oi) * 8;
        int acc = 0, vsum = 0;
        for (int kk = 0; kk < 8; ++kk) {
            int v;
            if (kk == 0) v = c.sid < 2 ? (1 << (c.bd - 1)) - off : 0;
            else v = kk < 2 * c.red_b ? bd[kk] - off : 0;
            acc += row[kk] * v;
            vsum += v;
        }
        const int res = (acc + 32 - 32 * vsum) >> 6;
        c.sred[r * 8 + col] = clampi(res + off, 0, maxv);
    }
    __syncthreads();
    const int f_h = c.w / rp, f_v = c.h / rp;
    const int lf_h = ilog2(f_h), lf_v = ilog2(f_v);
    for (int i = threadIdx.x; i < rp * c.w; i += blockDim.x) {
        const int r = i / c.w, x = i % c.w;
        const int jh = x * rp / c.w, ph = x - jh * f_h + 1;
        const int red = c.sred[r * 8 + jh];
        const int prev = jh == 0 ? c.left[clampi((r + 1) * f_v - 1, 0, c.P - 1)]
                                 : c.sred[r * 8 + jh - 1];
        c.sh[r * MAXP + x] = ((f_h - ph) * prev + ph * red + (f_h >> 1)) >> lf_h;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < c.h * c.w; i += blockDim.x) {
        const int y = i / c.w, x = i % c.w;
        const int jv = y * rp / c.h, pv = y - jv * f_v + 1;
        const int red = c.sh[jv * MAXP + x];
        const int prev = jv == 0 ? c.top[x] : c.sh[(jv - 1) * MAXP + x];
        out[y * c.P + x] = ((f_v - pv) * prev + pv * red + (f_v >> 1)) >> lf_v;
    }
    __syncthreads();
}

// Haar downsampling of n boundary samples to nb: groups of f = n / nb.
static __device__ void downsample(const int32_t* v, int n, int nb, int* out) {
    const int f = n / nb, lf = ilog2(f);
    for (int j = 0; j < nb; ++j) {
        int s = 0;
        for (int i = j * f; i < (j + 1) * f; ++i) s += v[i];
        out[j] = (s + (f >> 1)) >> lf;
    }
}

__global__ void mip_rmd_kernel(const int32_t* __restrict__ refs,
                               const int32_t* __restrict__ org,
                               const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ mats,
                               const int32_t* __restrict__ pred_in,
                               const int32_t* __restrict__ best_in, int B,
                               int P, int bd, int H, int W,
                               int32_t* __restrict__ best_out,
                               int32_t* __restrict__ pred_out,
                               int32_t* __restrict__ code_out) {
    const int b = blockIdx.x, L = 2 * P + 3;
    const int32_t* r = rows + 8 * b;
    const size_t tile = (size_t)b * P * P;
    const int32_t* pin = pred_in + tile;
    int32_t* out = pred_out + tile;
    if (r[6] <= 0) {                   // padding row
        for (int i = threadIdx.x; i < P * P; i += blockDim.x) out[i] = 0;
        if (threadIdx.x == 0) {
            best_out[b] = best_in[b];
            code_out[b] = 0;
        }
        return;
    }
    __shared__ int32_t sorg[MAXP * MAXP];
    __shared__ int32_t spred[MAXP * MAXP];
    __shared__ int32_t sh[8 * MAXP];
    __shared__ int32_t sred[64];
    __shared__ int32_t stop[MAXP], sleft[MAXP];
    __shared__ int32_t sbdry[2 * 8];
    __shared__ int red[NT / 32];
    __shared__ int s_k;

    const int fi = r[0], xs = r[1], ys = r[2];
    Mip c;
    c.w = r[3]; c.h = r[4]; c.P = P; c.bd = bd;
    c.sid = (c.w == 4 && c.h == 4) ? 0 : (c.w == 4 || c.h == 4 || (c.w == 8 && c.h == 8)) ? 1 : 2;
    c.red_b = c.sid == 0 ? 2 : 4;
    c.red_p = c.sid < 2 ? 4 : 8;
    c.n_modes = c.sid == 0 ? 16 : c.sid == 1 ? 8 : 6;
    c.top = stop; c.left = sleft; c.mats = mats; c.bdry = sbdry;
    c.sred = sred; c.sh = sh;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        stop[i] = refs[(size_t)b * L + 1 + i];               // refs[0][0][b]
        sleft[i] = refs[((size_t)B + b) * L + 1 + i];        // refs[0][1][b]
    }
    for (int i = threadIdx.x; i < c.h * c.w; i += blockDim.x) {
        const int y = i / c.w, x = i % c.w;
        sorg[y * P + x] = org[((size_t)fi * H + clampi(ys + y, 0, H - 1)) * W +
                              clampi(xs + x, 0, W - 1)];
    }
    __syncthreads();
    if (threadIdx.x == 0) {            // boundaries: [top, left] and [left, top]
        int rt[4], rl[4];
        downsample(stop, c.w, c.red_b, rt);
        downsample(sleft, c.h, c.red_b, rl);
        for (int k = 0; k < c.red_b; ++k) {
            sbdry[k] = rt[k];
            sbdry[c.red_b + k] = rl[k];
            sbdry[8 + k] = rl[k];
            sbdry[8 + c.red_b + k] = rt[k];
        }
    }
    __syncthreads();

    const int cost_ang = satd(c.w, c.h, P, sorg, pin, red);   // thread 0
    int best_cost = NO_COST, best_k = 0;
    for (int k = 0; k < NCAND; ++k) {
        if ((k & 15) >= c.n_modes) continue;                  // uniform
        mip_candidate(c, k, spred);
        const int cost = satd(c.w, c.h, P, sorg, spred, red);
        if (threadIdx.x == 0 && cost < best_cost) {
            best_cost = cost;
            best_k = k;
        }
    }
    if (threadIdx.x == 0) s_k = best_cost < cost_ang ? best_k : -1;
    __syncthreads();
    const int k = s_k;
    if (k >= 0) mip_candidate(c, k, spred);
    const int32_t* src = k >= 0 ? spred : pin;
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
        const int y = i / P, x = i % P;
        out[i] = (y < c.h && x < c.w) ? src[i] : 0;
    }
    if (threadIdx.x == 0) {
        best_out[b] = k >= 0 ? 0 : best_in[b];
        code_out[b] = k >= 0 ? 1 + k : 0;
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
    mip_rmd_kernel<<<B, NT, 0, stream>>>(refs, org, rows, mats, pred_in, best_in,
                                         B, P, bd, H, W, best_out, pred_out,
                                         code_out);
    return (int)cudaGetLastError();
}
