// K12b: the recon halo bands of one spatial-stripe step, packed into one
// send buffer and unpacked from one receive buffer.
//
// Replaces the exchange of pmp_vvc_tpu/parallel/spatial.py:
// spatial_wave_planes (exchange, 153-167): after every wave step each
// device sends its stripe's last hl owned recon columns to its right
// neighbour (whose left halo they become) and its first hr owned columns to
// its left neighbour (whose right halo they become), for the luma plane and
// at half width for both chroma planes, and writes what it receives into
// its halos where it has that neighbour. XLA fuses the slices and selects
// around two ppermutes; here the six bands of a step cross in one buffer,
// so a step costs one pack, one exchange and one unpack.
//
// A stripe plane is (1, H/s, (hl + strd + hr)/s) int32 with s = 1 (luma)
// or 2 (chroma): [left halo hl | owned strd | right halo hr]. The buffer
// holds, in order, band A of y, u, v (the last hl/s owned columns: sent
// right, received from the left into the left halo) and band B of y, u, v
// (the first hr/s owned columns: sent left, received from the right into
// the right halo), each row-major.
//
// One thread per band sample. Bound: bytes, each sample read once and
// written once (the sends of both bands; on unpack only the bands of the
// neighbours that exist); there is no arithmetic beyond the indexing.
#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256

struct Planes {
    int32_t* p[3];
};

// The plane, row, sent (owned) column, halo column and band (1: A) of
// buffer element i; false past the buffer's end.
__device__ __forceinline__ bool band_at(int i, int H, int hl, int hr, int strd,
                                        int* pl, int* row, int* src, int* dst,
                                        int* band_a, int* width) {
    for (int k = 0; k < 6; ++k) {
        const int p = k % 3, s = p ? 2 : 1, a = k < 3;
        const int bw = (a ? hl : hr) / s, n = (H / s) * bw;
        if (i < n) {
            const int r = i / bw, c = i % bw, hlp = hl / s, sp = strd / s;
            *pl = p;
            *row = r;
            *src = a ? sp + c : hlp + c;
            *dst = a ? c : hlp + sp + c;
            *band_a = a;
            *width = (hl + strd + hr) / s;
            return true;
        }
        i -= n;
    }
    return false;
}

__global__ void halo_pack_kernel(Planes planes, int H, int hl, int hr, int strd,
                                 int n, int32_t* __restrict__ out) {
    const int i = blockIdx.x * NT + threadIdx.x;
    if (i >= n) return;
    int pl, row, src, dst, a, w;
    if (!band_at(i, H, hl, hr, strd, &pl, &row, &src, &dst, &a, &w)) return;
    out[i] = planes.p[pl][(size_t)row * w + src];
}

__global__ void halo_unpack_kernel(const int32_t* __restrict__ buf, Planes planes,
                                   int H, int hl, int hr, int strd, int n,
                                   int has_left, int has_right) {
    const int i = blockIdx.x * NT + threadIdx.x;
    if (i >= n) return;
    int pl, row, src, dst, a, w;
    if (!band_at(i, H, hl, hr, strd, &pl, &row, &src, &dst, &a, &w)) return;
    if (a ? has_left : has_right) planes.p[pl][(size_t)row * w + dst] = buf[i];
}

static int band_size(int H, int hl, int hr) {
    return H * (hl + hr) + 2 * (H / 2) * ((hl + hr) / 2);
}

static bool bad_shape(int H, int hl, int hr, int strd) {
    return H <= 0 || H % 2 || hl <= 0 || hl % 2 || hr <= 0 || hr % 2 || strd % 2 ||
           strd < hl || strd < hr;
}

extern "C" int pmp_halo_pack(const int32_t* ry, const int32_t* ru, const int32_t* rv,
                             int H, int hl, int hr, int strd, int32_t* out,
                             cudaStream_t stream) {
    if (bad_shape(H, hl, hr, strd)) return (int)cudaErrorInvalidValue;
    Planes pl = {{const_cast<int32_t*>(ry), const_cast<int32_t*>(ru),
                  const_cast<int32_t*>(rv)}};
    const int n = band_size(H, hl, hr);
    halo_pack_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(pl, H, hl, hr, strd, n, out);
    return (int)cudaGetLastError();
}

extern "C" int pmp_halo_unpack(const int32_t* buf, int32_t* ry, int32_t* ru,
                               int32_t* rv, int H, int hl, int hr, int strd,
                               int has_left, int has_right, cudaStream_t stream) {
    if (bad_shape(H, hl, hr, strd)) return (int)cudaErrorInvalidValue;
    Planes pl = {{ry, ru, rv}};
    const int n = band_size(H, hl, hr);
    halo_unpack_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(buf, pl, H, hl, hr, strd,
                                                             n, has_left, has_right);
    return (int)cudaGetLastError();
}
