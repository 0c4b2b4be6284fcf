// K1: intra reference gather for one wave step.
//
// Replaces pmp_vvc_tpu/codec/wavefront.py:_refs_generic (97) with
// _avail_from_order (82), _gather_plane (92),
// ops/intra.py:fill_reference_samples (134) and
// ops/intra_generic.py:filter_reference_samples_generic (71).
//
// One block per (CU, plane). For a CU at (x, y) of size (w, h) on a P-pad
// tile it gathers 2P top samples (row y-1), 2P left samples (column x-1)
// and the corner, coordinates clamped into the plane. A sample is
// available iff it lies in the picture, within 2w (2h) of the CU, and the
// coding-order grid (4-sample units of the luma plane; chroma coordinates
// scale by 2) holds an id in [0, order id of the CU). Substitution scans
// bottom-left -> corner -> top-right taking the last available sample at or
// before each position, backfilled from the first available one, or
// 1 << (bd-1) when none is; two replication slots follow. The [1 2 1]
// filter runs over the real lengths 2w / 2h with the corner from the
// unfiltered rows.
//
// Bound: bytes. Each CU reads ~8P samples and 8P grid ids and writes
// 4 x (2P+3) int32; the work is a few integer operations per sample. The
// substitution is a sequential scan of 4P+1 entries done by one thread:
// simple and right, and short next to K2's work on the same CU.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAXP 64
#define MAXS (4 * MAXP + 1)

static __device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void ref_gather_kernel(const int32_t* __restrict__ p0,
                                  const int32_t* __restrict__ p1,
                                  const int32_t* __restrict__ og,
                                  const int32_t* __restrict__ rows,
                                  int B, int P, int scale, int bd, int H,
                                  int W, int GH, int GW,
                                  int32_t* __restrict__ out) {
    const int b = blockIdx.x, pl = blockIdx.y;
    const int L = 2 * P + 3, n2 = 2 * P, S = 2 * n2 + 1;
    const int32_t* r = rows + 8 * b;
    int32_t* tu = out + ((size_t)(pl * 4 + 0) * B + b) * L;
    int32_t* lu = out + ((size_t)(pl * 4 + 1) * B + b) * L;
    int32_t* tf = out + ((size_t)(pl * 4 + 2) * B + b) * L;
    int32_t* lf = out + ((size_t)(pl * 4 + 3) * B + b) * L;
    if (r[6] <= 0) {            // padding row: nothing to gather
        for (int i = threadIdx.x; i < L; i += blockDim.x)
            tu[i] = lu[i] = tf[i] = lf[i] = 0;
        return;
    }
    const int fi = r[0], xs = r[1] / scale, ys = r[2] / scale;
    const int ws = r[3] / scale, hs = r[4] / scale, oi = r[5];
    const int32_t* pf = (pl ? p1 : p0) + (size_t)fi * H * W;
    const int32_t* gf = og + (size_t)fi * GH * GW;

    __shared__ int32_t vals[MAXS];
    __shared__ int32_t filled[MAXS];
    __shared__ unsigned char avail[MAXS];

    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        int row, col, gx, gy;
        bool ok;
        if (s < n2) {                       // left column, bottom-up
            const int j = n2 - 1 - s;
            ok = (ys + j < H) && (xs > 0) && (j < 2 * hs);
            row = ys + j; col = xs - 1;
            gx = max(xs - 1, 0) * scale / 4; gy = (ys + j) * scale / 4;
        } else if (s == n2) {               // corner
            ok = (xs > 0) && (ys > 0);
            row = ys - 1; col = xs - 1;
            gx = max(xs - 1, 0) * scale / 4; gy = max(ys - 1, 0) * scale / 4;
        } else {                            // top row, left to right
            const int j = s - n2 - 1;
            ok = (xs + j < W) && (ys > 0) && (j < 2 * ws);
            row = ys - 1; col = xs + j;
            gx = (xs + j) * scale / 4; gy = max(ys - 1, 0) * scale / 4;
        }
        const int id = gf[clampi(gy, 0, GH - 1) * GW + clampi(gx, 0, GW - 1)];
        avail[s] = ok && id >= 0 && id < oi;
        vals[s] = pf[clampi(row, 0, H - 1) * W + clampi(col, 0, W - 1)];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int first = -1;
        for (int s = 0; s < S && first < 0; ++s)
            if (avail[s]) first = s;
        int last = -1;
        for (int s = 0; s < S; ++s) {
            if (avail[s]) last = s;
            filled[s] = first < 0 ? (1 << (bd - 1))
                                  : vals[last >= 0 ? last : first];
        }
    }
    __syncthreads();
    // unfiltered rows: index 0 = corner, then 2P samples, then two
    // replication slots of the last one
    const int corner_f = (filled[n2] + filled[n2 + 1] + filled[n2] +
                          filled[n2 - 1] + 2) >> 2;
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const int ti = min(i, n2);
        const int t0 = filled[n2 + ti], l0 = filled[n2 - ti];
        tu[i] = t0;
        lu[i] = l0;
        if (i == L - 1) {
            tf[i] = t0;
            lf[i] = l0;
            continue;
        }
        const int tm = filled[n2 + min(max(i - 1, 0), n2)];
        const int tp = filled[n2 + min(i + 1, n2)];
        const int lm = filled[n2 - min(max(i - 1, 0), n2)];
        const int lp = filled[n2 - min(i + 1, n2)];
        tf[i] = i >= 2 * ws ? t0 : (i == 0 ? corner_f : (tm + 2 * t0 + tp + 2) >> 2);
        lf[i] = i >= 2 * hs ? l0 : (i == 0 ? corner_f : (lm + 2 * l0 + lp + 2) >> 2);
    }
}

extern "C" int pmp_ref_gather(const int32_t* p0, const int32_t* p1,
                              const int32_t* og, const int32_t* rows, int B,
                              int P, int scale, int bd, int H, int W, int GH,
                              int GW, int nplanes, int32_t* out,
                              cudaStream_t stream) {
    if (P > MAXP || B <= 0) return B == 0 ? 0 : (int)cudaErrorInvalidValue;
    dim3 grid(B, nplanes);
    ref_gather_kernel<<<grid, 256, 0, stream>>>(p0, p1, og, rows, B, P, scale,
                                                bd, H, W, GH, GW, out);
    return (int)cudaGetLastError();
}
