// K1: batched Montgomery multiply, a * b * 2^-256 mod p, for Fq or Fr.
//
// Replaces snark_verifier_tpu/ops/field_pallas.py _mont_mul_kernel
// (mont_mul_pallas, helpers tmul/tadd/tsub).  The TPU kernel computes the
// product on transposed (16, lanes) limb slabs with schoolbook columns and a
// Kogge-Stone carry pass; here one thread owns one element and runs CIOS on
// 8 x 32-bit words in registers (bn254.cuh).
//
// Bound on the H100: at the verifier's widths (B = 1820 elements) a launch
// is ~1820 threads, so it is launch-latency bound, not bandwidth or ALU
// bound: 256 bytes in and 128 out per element, ~130 multiply-adds.  The
// design keeps each element in registers and reads it with 16-byte vector
// loads; batching more work per launch (fusing whole field expressions) is
// the lever left for later.
#include "bn254.cuh"

namespace {

__global__ void mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                                int64_t* __restrict__ out, int64_t n, svtpu::Field f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const svtpu::Fe x = svtpu::load_fe(a + 16 * i);
  const svtpu::Fe y = svtpu::load_fe(b + 16 * i);
  svtpu::store_fe(out + 16 * i, svtpu::fmul(x, y, f));
}

}  // namespace

extern "C" int svtpu_mont_mul(const void* a, const void* b, void* out, int64_t n,
                              const void* field_words, int block, void* stream) {
  if (n <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  mont_mul_kernel<<<svtpu::grid_for(n, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b), static_cast<int64_t*>(out),
      n, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* svtpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
