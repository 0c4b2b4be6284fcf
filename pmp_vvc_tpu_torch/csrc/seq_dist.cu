// K10e: SAD or SSE of K blocks against their originals, summed over the
// last two axes, for Hopper (sm_90a).
//
// Replaces pmp_vvc_tpu/ops/distortion.py:sad (99) and sse (105): the sum of
// |org - cur| or (org - cur)^2 over each block's samples. The JAX package
// sums in int32 (x64 off), where the sum wraps; the kernel accumulates in
// uint32_t, whose sums wrap the same way (signed overflow is undefined in
// C++), and returns the bits as int32. The difference and the square wrap
// alike, and |INT_MIN| stays INT_MIN, as in XLA. Sums modulo 2^32 are exact
// in any order, so a block is summed as one flat run of n = h*w samples,
// split over lanes in whatever order loads best.
//
// Bound: bytes. Three integer operations per sample against eight bytes
// read; a call of a few small blocks is bound by its launch and one round
// of loads.
//
// Design: a warp per block of up to K10E_WARP_UNITS units (64 int4s,
// 16x16), K10E_WARPS such warps a thread block, each lane loading one or
// two units in a single round; above that a thread block per block of
// samples, its warps the least power of two, up to 32, that covers the
// block at K10E_LPL units a lane (1): 8 warps at 32x32, 32 at 64x64.
// Units are int4s where n is a multiple of 4 (every side 2..64 gives one)
// and both base pointers lie on the 16-byte grain, else samples: the scalar
// instantiation of the same kernels. Each lane makes
// exactly the loads it needs (LOADS, an instantiation of 1 or 2, with no
// bounds tests where the lanes cover the block exactly), unit i of L lanes
// being lane i % L's, and issues all of its loads of both inputs before it
// uses any: the time of a small call is the launch, one load round trip
// and the lane's instruction chain, so the chain carries no slot it does
// not load, and a large block is spread over more lanes rather than more
// loads a lane. The original is read through the read-only path: a
// broadcast original (org_step 0) is served to every block from L1 / L2,
// not staged. Each warp's sum is one __reduce_add_sync, which adds
// unsigned values modulo 2^32 as the int32 contract wraps; a thread
// block's warps meet in shared memory, and its first warp adds their sums
// with one more __reduce_add_sync. Build parameters, one shipped value
// each: K10E_WARPS, K10E_WARP_UNITS, K10E_LPL.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K10E_WARPS
#define K10E_WARPS 4
#endif
#ifndef K10E_WARP_UNITS
#define K10E_WARP_UNITS 64
#endif
#ifndef K10E_LPL
#define K10E_LPL 1
#endif
static_assert(K10E_WARP_UNITS == 32 || K10E_WARP_UNITS == 64, "a warp's lanes load 1 or 2 units");
static_assert(K10E_LPL == 1 || K10E_LPL == 2, "K10E_LPL is 1 or 2");
static_assert(K10E_WARPS >= 1 && K10E_WARPS <= 32, "K10E_WARPS is 1..32 warps");

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TEAM_MAX = 32;    // a thread block's most warps

template <bool SQUARE>
__device__ __forceinline__ uint32_t term(int32_t o, int32_t c) {
    const uint32_t d = (uint32_t)o - (uint32_t)c;
    return SQUARE ? d * d : ((int32_t)d < 0 ? 0u - d : d);
}

template <bool SQUARE>
__device__ __forceinline__ uint32_t terms(int4 o, int4 c) {
    return (term<SQUARE>(o.x, c.x) + term<SQUARE>(o.y, c.y)) +
           (term<SQUARE>(o.z, c.z) + term<SQUARE>(o.w, c.w));
}

template <bool SQUARE>
__device__ __forceinline__ uint32_t terms(int32_t o, int32_t c) {
    return term<SQUARE>(o, c);
}

__device__ __forceinline__ void zero(int4& v) { v = make_int4(0, 0, 0, 0); }
__device__ __forceinline__ void zero(int32_t& v) { v = 0; }

// One round of a lane: units base + j * lanes for j < LOADS (tested
// against `units` unless EXACT), every load issued before any is used.
template <typename U, int LOADS, bool EXACT, bool SQUARE>
__device__ __forceinline__ uint32_t round_sum(const U* o, const U* c, int base, int lanes,
                                              int units) {
    U ov[LOADS], cv[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        const int i = base + j * lanes;
        if (EXACT || i < units) {
            ov[j] = __ldg(o + i);
            cv[j] = __ldg(c + i);
        } else {
            zero(ov[j]);
            zero(cv[j]);
        }
    }
    uint32_t acc = terms<SQUARE>(ov[0], cv[0]);
#pragma unroll
    for (int j = 1; j < LOADS; ++j) acc += terms<SQUARE>(ov[j], cv[j]);
    return acc;
}

// U: int4 or int32_t; `units` of U a block of samples (at most 32 * LOADS),
// the original's stride `org_units` (0: one original for every block); a
// warp per block of samples.
template <typename U, int LOADS, bool EXACT, bool SQUARE>
__global__ void __launch_bounds__(32 * K10E_WARPS)
warp_dist_kernel(const U* __restrict__ org, const U* __restrict__ cur, int K, int units,
                 int org_units, int32_t* __restrict__ out) {
    const int k = blockIdx.x * K10E_WARPS + (threadIdx.x >> 5);
    if (k >= K) return;    // a whole warp
    const int lane = threadIdx.x & 31;
    const uint32_t acc = __reduce_add_sync(
        FULL, round_sum<U, LOADS, EXACT, SQUARE>(org + (size_t)k * org_units,
                                                 cur + (size_t)k * units, lane, 32, units));
    if (lane == 0) out[k] = (int32_t)acc;
}

// The same with a thread block per block of samples, in rounds of
// blockDim.x * LOADS units.
template <typename U, int LOADS, bool EXACT, bool SQUARE>
__global__ void __launch_bounds__(32 * TEAM_MAX)
team_dist_kernel(const U* __restrict__ org, const U* __restrict__ cur, int units,
                 int org_units, int32_t* __restrict__ out) {
    const int k = blockIdx.x, t = threadIdx.x, lanes = blockDim.x;
    const U* o = org + (size_t)k * org_units;
    const U* c = cur + (size_t)k * units;
    uint32_t acc = 0;
    for (int base = t; base < units; base += lanes * LOADS)
        acc += round_sum<U, LOADS, EXACT, SQUARE>(o, c, base, lanes, units);
    acc = __reduce_add_sync(FULL, acc);
    __shared__ uint32_t sums[32];
    const int warp = t >> 5, lane = t & 31;
    if (lane == 0) sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        const uint32_t total = __reduce_add_sync(FULL, lane < (lanes >> 5) ? sums[lane] : 0u);
        if (lane == 0) out[k] = (int32_t)total;
    }
}

// team: 0 for a warp per block of samples, else the warps of its thread block
template <typename U, int LOADS, bool EXACT, bool SQUARE>
void launch(const U* org, const U* cur, int K, int units, int org_units, int team,
            int32_t* out, cudaStream_t stream) {
    if (team == 0)
        warp_dist_kernel<U, LOADS, EXACT, SQUARE>
            <<<(K + K10E_WARPS - 1) / K10E_WARPS, 32 * K10E_WARPS, 0, stream>>>(
                org, cur, K, units, org_units, out);
    else
        team_dist_kernel<U, LOADS, EXACT, SQUARE><<<K, 32 * team, 0, stream>>>(
            org, cur, units, org_units, out);
}

// The form for `units` units a block: a warp up to K10E_WARP_UNITS, else a
// thread block of the least power of two of warps up to TEAM_MAX covering
// them at K10E_LPL a lane; the loads a lane then makes a round (1
// or 2), and whether the lanes' rounds cover the units exactly.
template <typename U, bool SQUARE>
void dispatch(const U* org, const U* cur, int K, int units, int org_units, int32_t* out,
              cudaStream_t stream) {
    int team = 0;
    if (units > K10E_WARP_UNITS)
        for (team = 1; team < TEAM_MAX && units > 32 * team * K10E_LPL;) team *= 2;
    const int lanes = 32 * (team ? team : 1);
    const int loads = units > lanes ? 2 : 1;
    const bool exact = units > 0 && units % (lanes * loads) == 0;
    if (loads == 1 && exact)
        launch<U, 1, true, SQUARE>(org, cur, K, units, org_units, team, out, stream);
    else if (loads == 1)
        launch<U, 1, false, SQUARE>(org, cur, K, units, org_units, team, out, stream);
    else if (exact)
        launch<U, 2, true, SQUARE>(org, cur, K, units, org_units, team, out, stream);
    else
        launch<U, 2, false, SQUARE>(org, cur, K, units, org_units, team, out, stream);
}

template <typename U>
int run(const int32_t* org, const int32_t* cur, int K, int units, int org_units, int square,
        int32_t* out, cudaStream_t stream) {
    const U* o = reinterpret_cast<const U*>(org);
    const U* c = reinterpret_cast<const U*>(cur);
    if (square)
        dispatch<U, true>(o, c, K, units, org_units, out, stream);
    else
        dispatch<U, false>(o, c, K, units, org_units, out, stream);
    return (int)cudaGetLastError();
}

}  // namespace

// org: one n-sample block (org_step 0) or K of them (org_step n); cur: K
// blocks of n samples; out: K int32 sums. The int4 instantiation where n
// and org_step are multiples of 4 and both pointers lie on the 16-byte grain.
extern "C" int pmp_seq_dist(const int32_t* org, const int32_t* cur, int K, int n,
                            int org_step, int square, int32_t* out, cudaStream_t stream) {
    if (K == 0) return 0;
    if (n < 0 || org_step < 0) return (int)cudaErrorInvalidValue;
    if (n % 4 == 0 && org_step % 4 == 0 && ((uintptr_t)org | (uintptr_t)cur) % 16 == 0)
        return run<int4>(org, cur, K, n / 4, org_step / 4, square, out, stream);
    return run<int32_t>(org, cur, K, n, org_step, square, out, stream);
}
