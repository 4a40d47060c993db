// K7: batched Fq12 multiplication, one product per thread.
//
// Replaces snark_verifier_tpu/ops/tower_pallas.py _f12_mul_kernel
// (fq12_mul_flat_pallas), the product of every Miller-loop step and every
// step of the final exponentiation.  It replays _f12_mul_core: Karatsuba at
// Fq2 (3 products), Fq6 (6 Fq2 products) and Fq12 (3 Fq6 products), 54
// Montgomery products in all, with xi = 9 + u applied as 9t = 8t + t (the
// add chain of mul_b3).  Every add and sub leaves its value reduced below p,
// so for reduced operands each output limb equals the JAX package's.
//
// Bound on the H100: latency.  The decide multiplies at batch 2 (Miller
// loop) and 1 (final exponentiation), so a launch is one or two threads and
// its time is one thread's chain of 54 products and ~100 adds.  The operands
// alone are 2 x 12 x 8 words; ptxas spills part of the working set to local
// memory (see the build log).  The Fq2 product is a non-inlined function, so
// the kernel's code stays small and compiles quickly; the 18 calls cost a
// little latency.
//
// Layout: flat (12, n, 16) int64, component (l, j, c) at index l*6 + j*2 + c
// (tower.fq12_to_flat), element e of component i at (i * n + e) * 16.
#include "bn254.cuh"

namespace {

using svtpu::Fe;
using svtpu::Field;

struct Fq2 {
  Fe c0, c1;
};

struct Fq6 {
  Fq2 a[3];
};

__device__ __forceinline__ Fq2 f2add(const Fq2& x, const Fq2& y, const Field& f) {
  return {svtpu::fadd(x.c0, y.c0, f), svtpu::fadd(x.c1, y.c1, f)};
}

__device__ __forceinline__ Fq2 f2sub(const Fq2& x, const Fq2& y, const Field& f) {
  return {svtpu::fsub(x.c0, y.c0, f), svtpu::fsub(x.c1, y.c1, f)};
}

// (x0 y0 - x1 y1, (x0 + x1)(y0 + y1) - (x0 y0 + x1 y1))
__device__ __noinline__ Fq2 f2mul(const Fq2& x, const Fq2& y, const Field& f) {
  const Fe t0 = svtpu::fmul(x.c0, y.c0, f);
  const Fe t1 = svtpu::fmul(x.c1, y.c1, f);
  const Fe t2 = svtpu::fmul(svtpu::fadd(x.c0, x.c1, f), svtpu::fadd(y.c0, y.c1, f), f);
  return {svtpu::fsub(t0, t1, f), svtpu::fsub(t2, svtpu::fadd(t0, t1, f), f)};
}

// x * (9 + u) = (9 x0 - x1, 9 x1 + x0)
__device__ __forceinline__ Fq2 f2xi(const Fq2& x, const Field& f) {
  return {svtpu::fsub(svtpu::mul_b3(x.c0, f), x.c1, f), svtpu::fadd(svtpu::mul_b3(x.c1, f), x.c0, f)};
}

__device__ __forceinline__ Fq6 f6add(const Fq6& x, const Fq6& y, const Field& f) {
  return {{f2add(x.a[0], y.a[0], f), f2add(x.a[1], y.a[1], f), f2add(x.a[2], y.a[2], f)}};
}

__device__ __forceinline__ Fq6 f6sub(const Fq6& x, const Fq6& y, const Field& f) {
  return {{f2sub(x.a[0], y.a[0], f), f2sub(x.a[1], y.a[1], f), f2sub(x.a[2], y.a[2], f)}};
}

// Karatsuba over Fq2 with v^3 = xi, as tower.fq6_mul
__device__ Fq6 f6mul(const Fq6& x, const Fq6& y, const Field& f) {
  const Fq2 t0 = f2mul(x.a[0], y.a[0], f);
  const Fq2 t1 = f2mul(x.a[1], y.a[1], f);
  const Fq2 t2 = f2mul(x.a[2], y.a[2], f);
  const Fq2 m12 = f2mul(f2add(x.a[1], x.a[2], f), f2add(y.a[1], y.a[2], f), f);
  const Fq2 m01 = f2mul(f2add(x.a[0], x.a[1], f), f2add(y.a[0], y.a[1], f), f);
  const Fq2 m02 = f2mul(f2add(x.a[0], x.a[2], f), f2add(y.a[0], y.a[2], f), f);
  Fq6 r;
  r.a[0] = f2add(t0, f2xi(f2sub(m12, f2add(t1, t2, f), f), f), f);
  r.a[1] = f2add(f2sub(m01, f2add(t0, t1, f), f), f2xi(t2, f), f);
  r.a[2] = f2add(f2sub(m02, f2add(t0, t2, f), f), t1, f);
  return r;
}

__device__ __forceinline__ Fq6 load_fq6(const int64_t* src, int l, int64_t n, int64_t e) {
  Fq6 r;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.a[j].c0 = svtpu::load_fe(src + ((l * 6 + j * 2) * n + e) * 16);
    r.a[j].c1 = svtpu::load_fe(src + ((l * 6 + j * 2 + 1) * n + e) * 16);
  }
  return r;
}

__device__ __forceinline__ void store_fq6(int64_t* dst, int l, int64_t n, int64_t e, const Fq6& v) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    svtpu::store_fe(dst + ((l * 6 + j * 2) * n + e) * 16, v.a[j].c0);
    svtpu::store_fe(dst + ((l * 6 + j * 2 + 1) * n + e) * 16, v.a[j].c1);
  }
}

__global__ void fq12_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                                int64_t* __restrict__ out, int64_t n, Field f) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const Fq6 a0 = load_fq6(a, 0, n, e), a1 = load_fq6(a, 1, n, e);
  const Fq6 b0 = load_fq6(b, 0, n, e), b1 = load_fq6(b, 1, n, e);
  const Fq6 t0 = f6mul(a0, b0, f);
  const Fq6 t1 = f6mul(a1, b1, f);
  const Fq6 t2 = f6mul(f6add(a0, a1, f), f6add(b0, b1, f), f);
  // c0 = t0 + v t1 with v (x0, x1, x2) = (xi x2, x0, x1); c1 = t2 - (t0 + t1)
  const Fq6 vt1 = {{f2xi(t1.a[2], f), t1.a[0], t1.a[1]}};
  store_fq6(out, 0, n, e, f6add(t0, vt1, f));
  store_fq6(out, 1, n, e, f6sub(t2, f6add(t0, t1, f), f));
}

}  // namespace

extern "C" int svtpu_fq12_mul(const void* a, const void* b, void* out, int64_t n,
                              const void* field_words, int block, void* stream) {
  if (n <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  fq12_mul_kernel<<<svtpu::grid_for(n, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b), static_cast<int64_t*>(out),
      n, f);
  return static_cast<int>(cudaGetLastError());
}
