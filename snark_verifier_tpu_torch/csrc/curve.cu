// K2: batched complete G1 addition (RCB15 algorithm 7).
// K3: batched complete G1 doubling (RCB15 algorithm 9).
// K5: batched complete G1 addition with a select, out = m ? p + q : p.
//
// Replace snark_verifier_tpu/ops/curve_pallas.py _add_kernel and _dbl_kernel
// (reached through g1_add_pallas / g1_add_t and g1_double_pallas /
// g1_double_t; msm_pallas.py builds the MSM tables with them).  The TPU
// kernels fuse the 12 (add) or 8 (double) Montgomery multiplies on (16, 512)
// VMEM blocks.
//
// K5 replaces curve_pallas.py _add_select_kernel (g1_add_select_pallas and
// the transposed g1_add_select_t): the step of the large MSM's bucket tree,
// of its flush and of g1_tree_sum.  It runs the K2 body and selects on a
// one-byte mask, so the select costs no extra pass over the points.
//
// Bound on the H100: latency (the widest launches stay above it, below).
// A point add is 12 CIOS multiplies (~3,200 32-bit multiplies) against 576
// bytes of input and 384 of output, far from the card's bandwidth; its
// bound by operations is 6.2 us at 32,768 adds.  With one thread per add
// (the schedule before this one, since deleted)
// a launch took about one thread's chain of 12 dependent fmul (7.1 us of
// products alone) plus ~25 dependent modular adds: 16-17 us per launch at
// the decide's 8192 adds and fewer, which fill 64 blocks of 128 threads,
// under half the 132 SMs, and 33-36 us at 32,768 (about 8 warps per SM at
// 110 registers: too few to hide the chain).  So here a group of 8 lanes
// owns one add (4 per warp; bn254.cuh g1_add_group):
//   - the group loads p and q once, lane k the 16-byte limb pair k of each
//     coordinate (neighbouring lanes on neighbouring addresses), into 18
//     slots of shared memory per group; no device load sits on the chain
//     after that;
//   - the 12 products run as two levels of six independent products on
//     lanes 0-5, with fmul_eo (two carry chains), exchanged through the
//     slots under __syncwarp: the chain is 2 product latencies plus the
//     adds between them;
//   - the 18 modular adds between the levels are split over the lanes (lane
//     r computes the second level's operand r, the six chains as six steps
//     in lockstep): 58 registers; running all 18 on every lane took 80 and
//     was 3-16 % slower from 1024 adds up, so it was dropped;
//   - lane k stores limb pair k of each output coordinate; K5's mask is
//     read by one lane and shuffled to the group, and a masked-off group
//     stores p's words from the slots.
// On an H100 SXM (700 W, chip_smoke.py) a launch takes 4.1-4.3 us at 32 to
// 1024 adds, 7.4 us at 8192 and 21 us at 32,768, against 11.6-16.8 and 34 us
// with one thread; 64-thread blocks (8 adds) were the fastest or within
// 1.1 % at every width.  The widest launches stay at ~3.4x their bound:
// every warp there runs its products on 6 of each 8 lanes, and whether
// the multiply rate or the adds' instructions hold it is not measured.
// Every point's coordinates are read through two element strides, its
// outer and inner batch index (i / inner, i % inner; the inner index is the
// last batch dim, the outer one the leading dims folded): the bucket tree's
// even/odd slices, g1_tree_sum's slices and broadcast operands (stride 0)
// reach the kernel without a copy.  The output equals the one-thread
// kernels' limb for limb: the same operations on the same operands, and
// fmul_eo gives fmul's integer.
//
// K3 (the doubling, RCB15 alg. 9: 8 products, ~14 modular adds) is bound
// the same way: by operations 4.1 us at the verify's 32,760 doublings, far
// from the bandwidth bound, and with one thread per doubling (76 registers,
// 8 fmul and the limbs' device loads on the thread's chain, ~7.8 warps per
// SM at 32,760) a launch took 19-25 us.  So one doubling runs on a group of
// DBL_GROUP = 4 lanes (bn254.cuh g1_double_group), K2's schedule: the group
// loads the point once into 15 slots of shared memory with 16-byte loads,
// lane k the limb pairs k and k + 4; the 8 products run as two levels of
// four independent fmul_eo products, one a lane, exchanged through the
// slots under __syncwarp; the adds between the levels are split over the 4
// lanes by role (z3 = 8 a, t2 = 9 c, y3 = a + t2, e = a - 3 t2), the
// longest chain 8 operations; lane k stores its limb pairs.  Four lanes
// keep every lane multiplying.  On an H100 SXM (700 W, chip_smoke.py) a
// launch takes 10.0 us at 32,760 doublings against 24.8 on one thread (a
// group of 8, lanes 4-7 repeating 0-3, took 15.6), 3.7 us at 288 and fewer
// (8.9-11.8 on one thread); one doubling's chain is 1.6 us against 6.0.
// The output equals the one-thread kernel's limb for limb.
#include "bn254.cuh"

namespace {

constexpr int ADD_GROUP = 8;        // lanes per point add (K2, K5)
constexpr int ADD_BLOCK_MAX = 256;  // the largest block the wrapper launches
constexpr int DBL_BLOCK_MAX = 256;  // the largest K3 block

// K2/K5's inputs: coordinate c of point i (x1, y1, z1, x2, y2, z2) starts
// at c[c] + (i / inner) * s0[c] + (i % inner) * s1[c] (int64 elements, 16
// limbs contiguous and 16-byte aligned); K5's mask byte of point i at
// mask + (i / inner) * m0 + (i % inner) * m1.  ops/curve_cuda.py
// point_offsets is the same map.
struct AddOperands {
  const int64_t* c[6];
  int64_t s0[6], s1[6];
  const uint8_t* mask;
  int64_t m0, m1;
  int64_t n, inner;
};

__device__ __forceinline__ void store_word(int64_t* dst, int64_t i, int k, uint32_t w) {
  longlong2 v;
  v.x = static_cast<long long>(w & 0xFFFFu);
  v.y = static_cast<long long>(w >> 16);
  reinterpret_cast<longlong2*>(dst + 16 * i)[k] = v;
}

// Point i = (block * blockDim + thread) / ADD_GROUP, lane k = thread %
// ADD_GROUP; a group past the end loads the last point and stores nothing,
// so every lane of every warp reaches the __syncwarp()s.
template <bool kSelect>
__device__ __forceinline__ void add_lanes(const AddOperands& a, int64_t* ox, int64_t* oy, int64_t* oz,
                                          const svtpu::Field& f) {
  extern __shared__ uint4 add_slots[];
  const int t = threadIdx.x, k = t & (ADD_GROUP - 1);
  svtpu::Fe* s = reinterpret_cast<svtpu::Fe*>(add_slots) + (t / ADD_GROUP) * svtpu::ADD_SLOTS;
  uint32_t* words = reinterpret_cast<uint32_t*>(s);
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + t) / ADD_GROUP;
  const bool live = i < a.n;
  const int64_t li = live ? i : a.n - 1;
  const int64_t o = li / a.inner, r = li - o * a.inner;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const longlong2 v = reinterpret_cast<const longlong2*>(a.c[c] + o * a.s0[c] + r * a.s1[c])[k];
    words[c * svtpu::NW + k] = static_cast<uint32_t>(v.x) | (static_cast<uint32_t>(v.y) << 16);
  }
  unsigned take = 1;
  if (kSelect) {
    const unsigned m = k == 0 ? static_cast<unsigned>(a.mask[o * a.m0 + r * a.m1]) : 0u;
    take = __shfl_sync(0xffffffffu, m, 0, ADD_GROUP);
  }
  __syncwarp();
  const svtpu::G1 sum = svtpu::g1_add_group<ADD_GROUP>(s, k, 0xffffffffu, f);
  if (!live) return;
  uint32_t x = svtpu::fe_word(sum.x, k), y = svtpu::fe_word(sum.y, k), z = svtpu::fe_word(sum.z, k);
  if (kSelect && !take) {  // p, still in slots 0-2
    x = words[k];
    y = words[svtpu::NW + k];
    z = words[2 * svtpu::NW + k];
  }
  store_word(ox, i, k, x);
  store_word(oy, i, k, y);
  store_word(oz, i, k, z);
}

__global__ void __launch_bounds__(ADD_BLOCK_MAX)
    g1_add_kernel(const __grid_constant__ AddOperands a, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                  int64_t* __restrict__ oz, svtpu::Field f) {
  add_lanes<false>(a, ox, oy, oz, f);
}

__global__ void __launch_bounds__(ADD_BLOCK_MAX)
    g1_add_select_kernel(const __grid_constant__ AddOperands a, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                         int64_t* __restrict__ oz, svtpu::Field f) {
  add_lanes<true>(a, ox, oy, oz, f);
}

// K3 on groups of 4 lanes: point i = (block * blockDim + thread) / 4, lane
// k = thread % 4 loads and stores limb pairs k and k + 4 of each coordinate
// (contiguous inputs); a group past the end loads the last point and stores
// nothing, so every lane of every warp reaches the __syncwarp()s.
__global__ void __launch_bounds__(DBL_BLOCK_MAX)
    g1_double_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y, const int64_t* __restrict__ z,
                     int64_t* __restrict__ ox, int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t n,
                     svtpu::Field f) {
  extern __shared__ uint4 dbl_slots[];
  constexpr int G = svtpu::DBL_GROUP;
  const int t = threadIdx.x, k = t & (G - 1);
  svtpu::Fe* s = reinterpret_cast<svtpu::Fe*>(dbl_slots) + (t / G) * svtpu::DBL_SLOTS;
  uint32_t* words = reinterpret_cast<uint32_t*>(s);
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + t) / G;
  const bool live = i < n;
  const int64_t li = live ? i : n - 1;
  const int64_t* const src[3] = {x, y, z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int h = 0; h < svtpu::NW / G; ++h) {
      const int j = k + h * G;
      const longlong2 v = reinterpret_cast<const longlong2*>(src[c] + 16 * li)[j];
      words[c * svtpu::NW + j] = static_cast<uint32_t>(v.x) | (static_cast<uint32_t>(v.y) << 16);
    }
  }
  __syncwarp();
  const svtpu::G1 r = svtpu::g1_double_group(s, k, 0xffffffffu, f);
  if (!live) return;
#pragma unroll
  for (int h = 0; h < svtpu::NW / G; ++h) {
    const int j = k + h * G;
    store_word(ox, i, j, svtpu::fe_word(r.x, j));
    store_word(oy, i, j, svtpu::fe_word(r.y, j));
    store_word(oz, i, j, svtpu::fe_word(r.z, j));
  }
}

}  // namespace

// K2 (mask null) or K5 on groups of 8 lanes.  coords: the 6 coordinate
// pointers x1, y1, z1, x2, y2, z2; strides: (s0, s1) of each, 12 int64;
// mask_strides: (m0, m1); inner: the inner index's extent (>= 1); block: a
// multiple of 32 up to 256 threads (block / 8 points per block).
extern "C" int svtpu_g1_add_lanes(const void* const* coords, const int64_t* strides, const void* mask,
                                  const int64_t* mask_strides, void* ox, void* oy, void* oz, int64_t n,
                                  int64_t inner, const void* field_words, int block, void* stream) {
  if (n <= 0) return 0;
  if (block <= 0 || block % 32 != 0 || block > ADD_BLOCK_MAX || inner <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  AddOperands a;
  for (int c = 0; c < 6; ++c) {
    a.c[c] = static_cast<const int64_t*>(coords[c]);
    a.s0[c] = strides[2 * c];
    a.s1[c] = strides[2 * c + 1];
  }
  a.mask = static_cast<const uint8_t*>(mask);
  a.m0 = mask ? mask_strides[0] : 0;
  a.m1 = mask ? mask_strides[1] : 0;
  a.n = n;
  a.inner = inner;
  const int grid = svtpu::grid_for(n * ADD_GROUP, block);
  const size_t smem = static_cast<size_t>(block / ADD_GROUP) * svtpu::ADD_SLOTS * sizeof(svtpu::Fe);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* x = static_cast<int64_t*>(ox);
  int64_t* y = static_cast<int64_t*>(oy);
  int64_t* z = static_cast<int64_t*>(oz);
  if (mask) {
    g1_add_select_kernel<<<grid, block, smem, s>>>(a, x, y, z, f);
  } else {
    g1_add_kernel<<<grid, block, smem, s>>>(a, x, y, z, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 on groups of 4 lanes, `block` threads per block (a multiple of 32 up to
// 256), on contiguous (n, 16) coordinates.
extern "C" int svtpu_g1_double(const void* x, const void* y, const void* z, void* ox, void* oy,
                               void* oz, int64_t n, const void* field_words, int block, void* stream) {
  if (n <= 0) return 0;
  if (block <= 0 || block % 32 != 0 || block > DBL_BLOCK_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  const size_t smem = static_cast<size_t>(block / svtpu::DBL_GROUP) * svtpu::DBL_SLOTS * sizeof(svtpu::Fe);
  g1_double_kernel<<<svtpu::grid_for(n * svtpu::DBL_GROUP, block), block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(y), static_cast<const int64_t*>(z),
      static_cast<int64_t*>(ox), static_cast<int64_t*>(oy), static_cast<int64_t*>(oz), n, f);
  return static_cast<int>(cudaGetLastError());
}
