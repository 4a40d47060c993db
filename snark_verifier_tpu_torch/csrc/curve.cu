// K2: batched complete G1 addition (RCB15 algorithm 7).
// K3: batched complete G1 doubling (RCB15 algorithm 9).
// K5: batched complete G1 addition with a select, out = m ? p + q : p.
//
// Replace snark_verifier_tpu/ops/curve_pallas.py _add_kernel and _dbl_kernel
// (reached through g1_add_pallas / g1_add_t and g1_double_pallas /
// g1_double_t; msm_pallas.py builds the MSM tables with them).  The TPU
// kernels fuse the 12 (add) or 6 (double) Montgomery multiplies on (16, 512)
// VMEM blocks; here one thread owns one point and keeps all of its
// intermediates in registers.
//
// K5 replaces curve_pallas.py _add_select_kernel (g1_add_select_pallas and
// the transposed g1_add_select_t): the step of the large MSM's bucket tree,
// of its flush and of g1_tree_sum.  It runs the K2 body and selects on a
// one-byte mask, so the select costs no extra pass over the points.
//
// Bound on the H100: ALU and latency.  A point add is ~12 CIOS multiplies
// (~1,600 multiply-adds) against 576 bytes of input and 384 of output, so
// the card is far from its bandwidth; at the table build's 32,760 points the
// launch fills the card only a few warps deep.  The design spends nothing
// on memory (no shared memory, 16-byte loads) and leaves latency hiding to
// the number of points in flight.
#include "bn254.cuh"

namespace {

__device__ __forceinline__ svtpu::G1 load_point(const int64_t* x, const int64_t* y,
                                                const int64_t* z, int64_t i) {
  svtpu::G1 p;
  p.x = svtpu::load_fe(x + 16 * i);
  p.y = svtpu::load_fe(y + 16 * i);
  p.z = svtpu::load_fe(z + 16 * i);
  return p;
}

__device__ __forceinline__ void store_point(int64_t* x, int64_t* y, int64_t* z, int64_t i,
                                            const svtpu::G1& p) {
  svtpu::store_fe(x + 16 * i, p.x);
  svtpu::store_fe(y + 16 * i, p.y);
  svtpu::store_fe(z + 16 * i, p.z);
}

__global__ void g1_add_kernel(const int64_t* __restrict__ x1, const int64_t* __restrict__ y1,
                              const int64_t* __restrict__ z1, const int64_t* __restrict__ x2,
                              const int64_t* __restrict__ y2, const int64_t* __restrict__ z2,
                              int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                              int64_t* __restrict__ oz, int64_t n, svtpu::Field f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const svtpu::G1 p = load_point(x1, y1, z1, i);
  const svtpu::G1 q = load_point(x2, y2, z2, i);
  store_point(ox, oy, oz, i, svtpu::g1_add(p, q, f));
}

__global__ void g1_double_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                                 const int64_t* __restrict__ z, int64_t* __restrict__ ox,
                                 int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t n,
                                 svtpu::Field f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point(ox, oy, oz, i, svtpu::g1_double(load_point(x, y, z, i), f));
}

__global__ void g1_add_select_kernel(const int64_t* __restrict__ x1,
                                     const int64_t* __restrict__ y1,
                                     const int64_t* __restrict__ z1,
                                     const int64_t* __restrict__ x2,
                                     const int64_t* __restrict__ y2,
                                     const int64_t* __restrict__ z2,
                                     const uint8_t* __restrict__ mask, int64_t* __restrict__ ox,
                                     int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                                     int64_t n, svtpu::Field f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const svtpu::G1 p = load_point(x1, y1, z1, i);
  const svtpu::G1 q = load_point(x2, y2, z2, i);
  const svtpu::G1 s = svtpu::g1_add(p, q, f);
  store_point(ox, oy, oz, i, mask[i] ? s : p);
}

}  // namespace

extern "C" int svtpu_g1_add(const void* x1, const void* y1, const void* z1, const void* x2,
                            const void* y2, const void* z2, void* ox, void* oy, void* oz,
                            int64_t n, const void* field_words, int block, void* stream) {
  if (n <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  g1_add_kernel<<<svtpu::grid_for(n, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x1), static_cast<const int64_t*>(y1),
      static_cast<const int64_t*>(z1), static_cast<const int64_t*>(x2),
      static_cast<const int64_t*>(y2), static_cast<const int64_t*>(z2),
      static_cast<int64_t*>(ox), static_cast<int64_t*>(oy), static_cast<int64_t*>(oz), n, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_g1_double(const void* x, const void* y, const void* z, void* ox, void* oy,
                               void* oz, int64_t n, const void* field_words, int block,
                               void* stream) {
  if (n <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  g1_double_kernel<<<svtpu::grid_for(n, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(y),
      static_cast<const int64_t*>(z), static_cast<int64_t*>(ox), static_cast<int64_t*>(oy),
      static_cast<int64_t*>(oz), n, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_g1_add_select(const void* x1, const void* y1, const void* z1, const void* x2,
                                   const void* y2, const void* z2, const void* mask, void* ox,
                                   void* oy, void* oz, int64_t n, const void* field_words,
                                   int block, void* stream) {
  if (n <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  g1_add_select_kernel<<<svtpu::grid_for(n, block), block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x1), static_cast<const int64_t*>(y1),
      static_cast<const int64_t*>(z1), static_cast<const int64_t*>(x2),
      static_cast<const int64_t*>(y2), static_cast<const int64_t*>(z2),
      static_cast<const uint8_t*>(mask), static_cast<int64_t*>(ox), static_cast<int64_t*>(oy),
      static_cast<int64_t*>(oz), n, f);
  return static_cast<int>(cudaGetLastError());
}
