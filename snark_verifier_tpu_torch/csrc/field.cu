// K1: batched Montgomery multiply, a * b * 2^-256 mod p, for Fq or Fr, and
// mont_pow, a whole fixed-exponent chain a^e in one launch.
//
// Replaces snark_verifier_tpu/ops/field_pallas.py _mont_mul_kernel
// (mont_mul_pallas, helpers tmul/tadd/tsub).  The TPU kernel computes the
// product on transposed (16, lanes) limb slabs with schoolbook columns and a
// Kogge-Stone carry pass; here one thread owns one element and runs CIOS on
// 8 x 32-bit words in registers (bn254.cuh).
//
// mont_mul: at the verifier's widths (B = 1820 elements) a launch is ~1820
// threads, so it is launch-latency bound, not bandwidth or ALU bound: 256
// bytes in and 128 out per element, ~130 multiply-adds.  The design keeps
// each element in registers and reads it with 16-byte vector loads, in
// 32-thread blocks (field_cuda.K1_BLOCK), so a wide batch spreads over more
// SMs: the fastest of a sweep of 32/64/128 at 1, 64 and 1820 elements on the
// H100.
//
// mont_pow: the TPU runs _mont_mul_kernel inside the lax.scan of
// snark_verifier_tpu/ops/field.py:375 pow_const (Fermat inversions, square
// roots, x^n), one program for the whole chain.  Launched eagerly, each
// product of the chain is one K1 launch: 329 launches for p - 2.  Here one
// thread runs the whole chain for its element: the 16-entry table a^0..a^15
// (14 products), then the 4-bit windows most significant first, 4 squarings
// and one product by the window's entry each, the entry for a zero digit
// (Montgomery one) included, so the limbs equal the plain version's even for
// an input above p.  The table lives in shared memory, one 512-byte slot per
// thread laid out [entry][word][thread] (conflict-free), not in registers
// (16 x 8 words would take 128).  Bound: 2 x N x 32 bytes; 329 x 264 32-bit
// multiplies per element for p - 2; the critical path is the chain itself,
// 329 dependent product latencies, so the kernel is latency bound, and
// 32-thread blocks spread a batch over many SMs (57 at N = 1820).  The
// product is fmul_eo (two carry chains, bn254.cuh) or fmul, chosen by the
// launch, for measuring one against the other.  An exponent above 2^256
// runs as a few launches over 64-window pieces of the same chain, most
// significant first: each later launch starts from the one before's
// accumulator (acc_in) and runs all 64 of its windows, leading zero digits
// included, so the products are the plain chain's one for one.
#include "bn254.cuh"

namespace {

constexpr int POW_BLOCK = 32;  // threads per mont_pow block (one warp)
constexpr int POW_TABLE = 16;  // 4-bit windows

struct Exponent {
  uint32_t w[svtpu::NW];  // little-endian words
  int bits;               // bit length (0 for the exponent 0)
};

__global__ void mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                                int64_t* __restrict__ out, int64_t n, svtpu::Field f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const svtpu::Fe x = svtpu::load_fe(a + 16 * i);
  const svtpu::Fe y = svtpu::load_fe(b + 16 * i);
  svtpu::store_fe(out + 16 * i, svtpu::fmul(x, y, f));
}

template <bool kEvenOdd>
__device__ __forceinline__ svtpu::Fe pow_mul(const svtpu::Fe& a, const svtpu::Fe& b, const svtpu::Field& f) {
  return kEvenOdd ? svtpu::fmul_eo(a, b, f) : svtpu::fmul(a, b, f);
}

template <bool kEvenOdd>
__global__ void __launch_bounds__(POW_BLOCK) mont_pow_kernel(const int64_t* __restrict__ a,
                                                             const int64_t* __restrict__ acc_in,
                                                             int64_t* __restrict__ out, int64_t n,
                                                             svtpu::Field f, Exponent e) {
  __shared__ uint32_t table[POW_TABLE][svtpu::NW][POW_BLOCK];
  const int t = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * POW_BLOCK + t;
  if (i >= n) return;
  auto put = [&](int k, const svtpu::Fe& v) {
#pragma unroll
    for (int j = 0; j < svtpu::NW; ++j) table[k][j][t] = v.w[j];
  };
  auto get = [&](uint32_t k) {
    svtpu::Fe v;
#pragma unroll
    for (int j = 0; j < svtpu::NW; ++j) v.w[j] = table[k][j][t];
    return v;
  };
  auto digit = [&](int w) { return (e.w[w >> 3] >> (4 * (w & 7))) & 15u; };

  const int nwin = (e.bits + 3) / 4;
  if (nwin == 0) {
    svtpu::store_fe(out + 16 * i, svtpu::mont_one(f));
    return;
  }
  const svtpu::Fe x = svtpu::load_fe(a + 16 * i);
  put(0, svtpu::mont_one(f));
  put(1, x);
  svtpu::Fe acc = x;
  for (int k = 2; k < POW_TABLE; ++k) {
    acc = pow_mul<kEvenOdd>(acc, x, f);
    put(k, acc);
  }
  int w = nwin - 1;
  if (acc_in != nullptr) {
    acc = svtpu::load_fe(acc_in + 16 * i);  // a later piece: every window of it
  } else {
    acc = get(digit(w--));
  }
  for (; w >= 0; --w) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = pow_mul<kEvenOdd>(acc, acc, f);
    acc = pow_mul<kEvenOdd>(acc, get(digit(w)), f);
  }
  svtpu::store_fe(out + 16 * i, acc);
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

// exponent_words: 8 little-endian u32 words; bits: the exponent's bit length
// (at most 256); acc_in: null for the chain's first piece, else the
// accumulator of the piece before (then bits is 256: all 64 windows);
// even_odd: 1 for fmul_eo, 0 for fmul.
extern "C" int svtpu_mont_pow(const void* a, const void* acc_in, void* out, int64_t n,
                              const void* field_words, const void* exponent_words, int bits,
                              int even_odd, void* stream) {
  if (n <= 0) return 0;
  if (bits < 0 || bits > 32 * svtpu::NW) return static_cast<int>(cudaErrorInvalidValue);
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  Exponent e;
  for (int j = 0; j < svtpu::NW; ++j) e.w[j] = static_cast<const uint32_t*>(exponent_words)[j];
  e.bits = bits;
  const int grid = svtpu::grid_for(n, POW_BLOCK);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* src = static_cast<const int64_t*>(a);
  const int64_t* prev = static_cast<const int64_t*>(acc_in);
  int64_t* dst = static_cast<int64_t*>(out);
  if (even_odd) {
    mont_pow_kernel<true><<<grid, POW_BLOCK, 0, s>>>(src, prev, dst, n, f, e);
  } else {
    mont_pow_kernel<false><<<grid, POW_BLOCK, 0, s>>>(src, prev, dst, n, f, e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* svtpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
