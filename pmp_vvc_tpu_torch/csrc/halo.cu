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
// Bound: bytes, each band sample read once and written once (on unpack
// only the bands of the neighbours that exist); there is no arithmetic
// beyond the indexing. Design: the work item is a (band, plane, row, quad)
// of 4 samples. The host lays the call's bands out in a table passed by
// value, which stays in the constant bank (each band's plane, pitch,
// columns, buffer offset, items and first block), so a block finds its
// (band, plane) by comparing its index with five block offsets, and an item
// its row and quad by shifts where every band's width in quads is a power
// of two (8 / 4 and 128 / 64 columns on the path: an instantiation of its
// own), else by one division. On the path (stripes of 128 columns) every
// band row starts 16-byte aligned and holds whole quads, so a quad moves as
// one 16-byte load and one 16-byte store; where the call is not so aligned
// (strd % 8, a halo width % 8, or a pointer % 16), the scalar instantiation
// moves one sample an item. A thread issues every load of its K12B_QPT
// items before any store. The unpack's table holds only the bands it
// receives; with no neighbour it launches nothing.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K12B_QPT          // items a thread
#define K12B_QPT 1
#endif
#ifndef K12B_THREADS      // threads a block
#define K12B_THREADS 256
#endif

namespace {

constexpr int kQPT = K12B_QPT;
constexpr int kThreads = K12B_THREADS;
constexpr int kBands = 6;
static_assert(kQPT >= 1 && kQPT <= 8, "K12B_QPT is 1 to 8");
static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 1024,
              "K12B_THREADS is a multiple of 32 up to 1024");

struct Band {           // one (band, plane) of a call
  int32_t* plane;       // the stripe plane
  int pitch;            // its row, in samples
  int col;              // the band's first column in the plane: sent (pack) or halo (unpack)
  int buf_off;          // its first sample in the buffer
  int items;            // rows x items a row
  int row_items;        // items a row
  int shift;            // log2(row_items) where it is a power of two
  int block0;           // its first block; INT_MAX past the call's bands
};

struct Bands {
  Band b[kBands];
};

template <int V> struct Item;
template <> struct Item<1> { using T = int32_t; };
template <> struct Item<4> { using T = int4; };

// PACK: plane -> buffer, else buffer -> plane. V samples an item (4: one
// 16-byte access). POW2: every band's items a row are a power of two (row
// and item by shifts), else by a division. The table stays in the constant
// bank (__grid_constant__): a block reads its band's fields by its index.
template <bool PACK, int V, bool POW2>
__global__ void __launch_bounds__(kThreads)
halo_kernel(const __grid_constant__ Bands bands, int32_t* __restrict__ buf) {
  using T = typename Item<V>::T;
  int k = 0;
#pragma unroll
  for (int j = 1; j < kBands; ++j) k += (int)blockIdx.x >= bands.b[j].block0;
  const Band& bd = bands.b[k];
  const int first = ((int)blockIdx.x - bd.block0) * (kThreads * kQPT) + threadIdx.x;
  T* src[kQPT];
  T* dst[kQPT];
  T v[kQPT];
#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    const int it = first + j * kThreads;
    if (it < bd.items) {
      const int row = POW2 ? it >> bd.shift : it / bd.row_items;
      const int q = POW2 ? it & (bd.row_items - 1) : it - row * bd.row_items;
      T* in_plane = reinterpret_cast<T*>(bd.plane + (size_t)row * bd.pitch + bd.col) + q;
      T* in_buf = reinterpret_cast<T*>(buf + bd.buf_off) + it;
      src[j] = PACK ? in_plane : in_buf;
      dst[j] = PACK ? in_buf : in_plane;
      v[j] = *src[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kQPT; ++j)
    if (first + j * kThreads < bd.items) *dst[j] = v[j];
}

bool bad_shape(int H, int hl, int hr, int strd) {
  return H <= 0 || H % 2 || hl <= 0 || hl % 2 || hr <= 0 || hr % 2 || strd % 2 ||
         strd < hl || strd < hr;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The table of one call and its grid: band A (k < 3) where `send_a`, band
// B where `send_b`, with columns for a pack or an unpack; v samples an item.
// `pow2`: whether every band's items a row are a power of two.
int layout(int32_t* const planes[3], int H, int hl, int hr, int strd, bool pack, bool send_a,
           bool send_b, int v, Bands* out, bool* pow2) {
  int blocks = 0, off = 0, used = 0;
  *pow2 = true;
  for (int k = 0; k < kBands; ++k) {
    const int p = k % 3, s = p ? 2 : 1;
    const bool a = k < 3;
    const int bw = (a ? hl : hr) / s, rows = H / s, hlp = hl / s, sp = strd / s;
    if (a ? send_a : send_b) {
      Band& b = out->b[used++];
      b.plane = planes[p];
      b.pitch = (hl + strd + hr) / s;
      b.col = pack ? (a ? sp : hlp) : (a ? 0 : hlp + sp);
      b.buf_off = off;
      b.row_items = bw / v;
      b.items = rows * b.row_items;
      b.shift = __builtin_ctz(b.row_items);
      *pow2 = *pow2 && (b.row_items & (b.row_items - 1)) == 0;
      b.block0 = blocks;
      blocks += (b.items + kThreads * kQPT - 1) / (kThreads * kQPT);
    }
    off += rows * bw;
  }
  for (int k = used; k < kBands; ++k) {
    out->b[k] = out->b[0];
    out->b[k].block0 = INT_MAX;
  }
  return blocks;
}

int launch(int32_t* const planes[3], int32_t* buf, int H, int hl, int hr, int strd, bool pack,
           bool send_a, bool send_b, cudaStream_t stream) {
  const bool vec = hl % 8 == 0 && hr % 8 == 0 && strd % 8 == 0 && aligned16(buf) &&
                   aligned16(planes[0]) && aligned16(planes[1]) && aligned16(planes[2]);
  Bands bands;
  bool pow2;
  const int blocks = layout(planes, H, hl, hr, strd, pack, send_a, send_b, vec ? 4 : 1, &bands,
                            &pow2);
  if (blocks == 0) return (int)cudaSuccess;
  auto kernel =
      pack ? (vec ? (pow2 ? halo_kernel<true, 4, true> : halo_kernel<true, 4, false>)
                  : (pow2 ? halo_kernel<true, 1, true> : halo_kernel<true, 1, false>))
           : (vec ? (pow2 ? halo_kernel<false, 4, true> : halo_kernel<false, 4, false>)
                  : (pow2 ? halo_kernel<false, 1, true> : halo_kernel<false, 1, false>));
  kernel<<<blocks, kThreads, 0, stream>>>(bands, buf);
  return (int)cudaGetLastError();
}

}  // namespace

// Planes ry (1, H, hl + strd + hr), ru and rv (1, H/2, (hl + strd + hr)/2)
// and the buffer (H (hl + hr) + 2 (H/2) ((hl + hr)/2) samples), int32,
// contiguous; H, hl, hr and strd even, strd >= hl, hr. One launch on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pmp_halo_pack(const int32_t* ry, const int32_t* ru, const int32_t* rv,
                             int H, int hl, int hr, int strd, int32_t* out,
                             cudaStream_t stream) {
  if (bad_shape(H, hl, hr, strd)) return (int)cudaErrorInvalidValue;
  int32_t* const planes[3] = {const_cast<int32_t*>(ry), const_cast<int32_t*>(ru),
                              const_cast<int32_t*>(rv)};
  return launch(planes, out, H, hl, hr, strd, true, true, true, stream);
}

// The same shapes; band A into the left halos where has_left, band B into
// the right halos where has_right. One launch on `stream` over the bands
// received, none where neither is; returns cudaGetLastError() (0 on
// success).
extern "C" int pmp_halo_unpack(const int32_t* buf, int32_t* ry, int32_t* ru,
                               int32_t* rv, int H, int hl, int hr, int strd,
                               int has_left, int has_right, cudaStream_t stream) {
  if (bad_shape(H, hl, hr, strd)) return (int)cudaErrorInvalidValue;
  int32_t* const planes[3] = {ry, ru, rv};
  return launch(planes, const_cast<int32_t*>(buf), H, hl, hr, strd, false, has_left != 0,
                has_right != 0, stream);
}
