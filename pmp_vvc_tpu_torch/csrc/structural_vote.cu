// K8: structural vote on the Down-Up-CNN's QT-depth maps, for Hopper (sm_90a).
//
// Replaces pmp_vvc_tpu/pmp/structural.py:structural_vote, the jitted program
// that follows the Q-net in pmp_vvc_tpu/pmp/predict.py. For each CTU it takes
// the raw 8x8 QT-depth map, 2x2 max-pools it to 4x4, rounds half to even
// (rintf, as jnp.round and torch.round do; not roundf), clamps to [0,3],
// repairs the 4x4 map by majority vote so that it describes a legal quadtree,
// and writes the 2x nearest upsample back as 8x8.
//
// Bound: memory. A CTU reads 256 B, writes 256 B and does under 200 scalar
// operations. At the prediction path's batch (512 CTUs, 0.26 MB in and out)
// the launch and one dependent round of loads and stores bound the kernel
// long before the bytes do.
//
// Design: a half-warp per CTU (K8_LANES 16), two CTUs a warp, grid-strided
// over the warp's CTU pairs with no shared memory. Lane f of a CTU loads the
// map's float4 f (row f/2, columns 4(f%2)..+3), so a warp reads two whole
// maps in one coalesced round. Rounding and clamping are monotone, so each
// lane rounds the maxima of its two column pairs first and packs them into
// one int; one __shfl_xor_sync(.., 2) brings the other row of the 2x2
// windows, and lane f then holds pooled row f/4, columns 2(f%2) and
// 2(f%2)+1 as integers (lanes f and f^2 alike). num0 is one ballot: the lane
// of each pair that loaded the even row tests the first column, the other
// lane the second, so the half-warp's 16 bits are the 16 cells. A
// quadrant's cells are on lanes f and f^4: one __shfl_xor_sync(.., 4) of the
// packed (sum, count of 1s) gives qsum and n1. Each lane stores its float4
// (p0, p0, p1, p1). An odd N leaves the last warp's second half empty: it
// runs on the last map's address, so that every lane takes part in the
// full-mask shuffles and the ballot, and stores nothing.
// Build parameters, one shipped value each: K8_LANES 8 gives each CTU 8
// lanes that load both rows of their windows (no xor-2 shuffle, two ballots,
// two stores a lane); K8_THREADS is the block size. The grid covers the
// CTU pairs, up to the threads the card holds at once.
// Inputs are finite (the Q-net's output); NaN is outside the contract.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K8_LANES
#define K8_LANES 16
#endif
#ifndef K8_THREADS
#define K8_THREADS 256
#endif
static_assert(K8_LANES == 16 || K8_LANES == 8, "K8_LANES is 16 or 8");
static_assert(K8_THREADS % 32 == 0 && K8_THREADS <= 1024, "K8_THREADS is whole warps");

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAPS_PER_WARP = 32 / K8_LANES;

// clamp(rint(x), 0, 3) as an int
__device__ __forceinline__ int level(float x) {
  return (int)fminf(fmaxf(rintf(x), 0.f), 3.f);
}

// The vote on a lane's two pooled cells (p0, p1) of its CTU, whose map has
// num0 zeros; the quadrant's other row is on lane ^ `other_row`. Every lane
// of the warp calls it (the shuffle).
__device__ __forceinline__ void vote(int& p0, int& p1, int num0, int other_row) {
  // case A: zeros promoted to 1, then each quadrant whose sum lies in
  // [5, 10] harmonised (fewer than three 1s: the 1s become 2; else all 1)
  const int a0 = p0 ? p0 : 1, a1 = p1 ? p1 : 1;
  const int mine = ((a0 + a1) << 4) | ((a0 == 1) + (a1 == 1));
  const int quad = mine + __shfl_xor_sync(FULL, mine, other_row);
  const int qsum = quad >> 4, n1 = quad & 15;
  if (num0 <= 12) {
    const bool mixed = qsum >= 5 && qsum <= 10;
    p0 = !mixed ? a0 : n1 >= 3 ? 1 : (a0 == 1 ? 2 : a0);
    p1 = !mixed ? a1 : n1 >= 3 ? 1 : (a1 == 1 ? 2 : a1);
  } else if (num0 < 16) {
    // case B: mostly zeros -> all zeros; num0 == 16 is already all zeros
    p0 = p1 = 0;
  }
}

__device__ __forceinline__ float4 upsampled(int p0, int p1) {
  return make_float4((float)p0, (float)p0, (float)p1, (float)p1);
}

__global__ void __launch_bounds__(K8_THREADS)
structural_vote_kernel(const float4* __restrict__ in, float4* __restrict__ out, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int slot = lane / K8_LANES;        // the warp's CTU this lane serves
  const int f = lane % K8_LANES;
  const unsigned mask = (K8_LANES == 16 ? 0xffffu : 0xffu) << (slot * K8_LANES);
  const int64_t groups = (n + MAPS_PER_WARP - 1) / MAPS_PER_WARP;
  const int64_t warps = (int64_t)gridDim.x * (K8_THREADS / 32);
  for (int64_t g = (int64_t)blockIdx.x * (K8_THREADS / 32) + (threadIdx.x >> 5); g < groups;
       g += warps) {
    const int64_t c = g * MAPS_PER_WARP + slot;
    const bool live = c < n;
    const float4* src = in + (live ? c : n - 1) * 16;
    float4* dst = out + c * 16;
#if K8_LANES == 16
    // row 2r + a, column quad b, for f = 4r + 2a + b
    const float4 v = src[f];
    const int row = level(fmaxf(v.x, v.y)) | (level(fmaxf(v.z, v.w)) << 2);
    const int other = __shfl_xor_sync(FULL, row, 2);
    int p0 = max(row & 3, other & 3), p1 = max(row >> 2, other >> 2);
    const bool odd_row = f & 2;
    const int num0 = __popc(__ballot_sync(FULL, (odd_row ? p1 : p0) == 0) & mask);
    vote(p0, p1, num0, 4);
    if (live) dst[f] = upsampled(p0, p1);
#else
    // pooled row r, column quad b, for f = 2r + b: float4s 4r + b and 4r + 2 + b
    const int r = f >> 1, b = f & 1;
    const float4 v0 = src[4 * r + b], v1 = src[4 * r + 2 + b];
    int p0 = level(fmaxf(fmaxf(v0.x, v0.y), fmaxf(v1.x, v1.y)));
    int p1 = level(fmaxf(fmaxf(v0.z, v0.w), fmaxf(v1.z, v1.w)));
    const int num0 = __popc(__ballot_sync(FULL, p0 == 0) & mask) +
                     __popc(__ballot_sync(FULL, p1 == 0) & mask);
    vote(p0, p1, num0, 2);
    if (live) dst[4 * r + b] = dst[4 * r + 2 + b] = upsampled(p0, p1);
#endif
  }
}

}  // namespace

// in, out: n contiguous 8x8 float32 maps, 16-byte aligned. Launches on
// `stream` and returns the CUDA error (0 on success).
extern "C" int pmp_structural_vote(const float* in, float* out, int64_t n,
                                   void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t groups = (n + MAPS_PER_WARP - 1) / MAPS_PER_WARP;
  const int64_t wanted = (groups * 32 + K8_THREADS - 1) / K8_THREADS;
  const int64_t resident = (int64_t)sms * (2048 / K8_THREADS);
  const int64_t blocks = wanted < resident ? wanted : resident;
  structural_vote_kernel<<<(unsigned)blocks, K8_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out), n);
  return (int)cudaGetLastError();
}
