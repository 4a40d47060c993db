// K12: the modular limb ops of the verify, one launch a call: field add,
// sub and neg, the u256 reduction into [0, p) and the modulus check x < p.
//
// Replaces no TPU kernel: the JAX package runs these ops as XLA
// (snark_verifier_tpu/ops/field.py:269 add, :275 sub, :283 neg, with
// _cond_sub_mod :250; ops/encode.py:38 reduce_u256, :59 is_lt_modulus), and
// XLA fuses each into the program around it.  The port ran them as eager
// PyTorch (ops/field.py add_plain ... lt_modulus_plain): every call resolves
// its carries with a carry-lookahead over the limbs, 17 (lt_modulus) to 90
// (reduce_u256) small tensor ops a call, each a host dispatch and a 2-3 us
// elementwise kernel.  A k=8 Keccak verify makes 100 such calls, a Poseidon
// verify 111 and the k=20 outer snark with its per-proof decide 311, the
// same at any batch: 71 %, 78 % and 85 % of the host ops each dispatches
// besides its kernels.  Every cell of the benchmark was host-bound, the card
// idle four-fifths of a batch, most of it while the host was inside the
// verify.  Here a call is one launch.
//
// Each op is the plain version's, for every 256-bit input (limbs below 2^16,
// values >= p included), so the limbs equal the plain version's bit for bit:
//   add(a, b):      s = a + b mod 2^256 with carry c; s - p mod 2^256 if c or
//                   s >= p, else s;
//   sub(a, b):      d = a - b mod 2^256; d + p mod 2^256 if a < b, else d;
//   neg(a):         sub(0, a);
//   reduce_u256(x): five rounds of "x - p if x >= p";
//   lt_modulus(x):  x < p, as one byte (a bool tensor).
//
// Bound on the H100: at the verify's widths (at most 1820 elements a call)
// the launch, about 2 us of device time for a few hundred integer ops a
// thread; beyond that the bytes, 2 x 128 in and 128 out an element at
// 3.35 TB/s (0.21 us at 1820 elements).  What the kernel takes away is host
// dispatch, so the design keeps it small:
//   - one thread an element, its 8 x 32-bit words in registers, read with
//     16-byte loads (two limbs each) as K1 reads them;
//   - each operand has a row stride in int64 elements (16 for a contiguous
//     row set, 0 for one row broadcast over the batch, the stride of a
//     strided view otherwise), so the wrapper copies no broadcast constant
//     and no sliced operand;
//   - the carry chains are portable C++ (uint64_t sums, no inline PTX): at
//     this size they cost nothing on the card, and the body compiles for the
//     host, where a CPU test holds it against the plain version;
//   - 32-thread blocks, as K1's sweep chose, so 1820 elements spread over 57
//     SMs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 8;            // 32-bit words an element
constexpr int K12_BLOCK = 32;    // threads (elements) a block
constexpr int REDUCE_ROUNDS = 5; // 2^256 / p < 6 for both BN254 moduli

struct Words {
  uint32_t w[NW];
};

// 16 little-endian 16-bit limbs (int64, 16-byte aligned) -> 8 words.
__device__ __forceinline__ Words load_words(const int64_t* src) {
  const longlong2* s = reinterpret_cast<const longlong2*>(src);
  Words r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const longlong2 v = s[k];
    r.w[k] = static_cast<uint32_t>(v.x) | (static_cast<uint32_t>(v.y) << 16);
  }
  return r;
}

__device__ __forceinline__ void store_words(int64_t* dst, const Words& a) {
  longlong2* d = reinterpret_cast<longlong2*>(dst);
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    longlong2 v;
    v.x = static_cast<long long>(a.w[k] & 0xFFFFu);
    v.y = static_cast<long long>(a.w[k] >> 16);
    d[k] = v;
  }
}

// s = a + b mod 2^256; returns the carry out (0 or 1).
__device__ __forceinline__ uint32_t add_words(const Words& a, const Words& b, Words& s) {
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    carry += static_cast<uint64_t>(a.w[k]) + b.w[k];
    s.w[k] = static_cast<uint32_t>(carry);
    carry >>= 32;
  }
  return static_cast<uint32_t>(carry);
}

// d = a - b mod 2^256; returns the borrow out (1 when a < b).
__device__ __forceinline__ uint32_t sub_words(const Words& a, const Words& b, Words& d) {
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint64_t t = static_cast<uint64_t>(a.w[k]) - b.w[k] - borrow;
    d.w[k] = static_cast<uint32_t>(t);
    borrow = t >> 63;  // the difference wrapped below zero
  }
  return static_cast<uint32_t>(borrow);
}

__device__ __forceinline__ void select_words(bool take, const Words& x, Words& into) {
#pragma unroll
  for (int k = 0; k < NW; ++k) into.w[k] = take ? x.w[k] : into.w[k];
}

// (a - b) mod p as the plain sub: add p back when a < b.
__device__ __forceinline__ Words sub_mod(const Words& a, const Words& b, const Words& p) {
  Words d, corrected;
  const uint32_t borrow = sub_words(a, b, d);
  add_words(d, p, corrected);
  select_words(borrow != 0, corrected, d);
  return d;
}

__device__ __forceinline__ int64_t element() { return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; }

// Operands: element i of an operand with row stride s is the 16 limbs at
// base + s * i; out is contiguous, 16 limbs an element (one byte for
// lt_modulus); p is the modulus.
__global__ void __launch_bounds__(K12_BLOCK) field_add_kernel(const int64_t* __restrict__ a, int64_t sa,
                                                              const int64_t* __restrict__ b, int64_t sb,
                                                              int64_t* __restrict__ out, int64_t n, Words p) {
  const int64_t i = element();
  if (i >= n) return;
  Words s, d;
  const uint32_t carry = add_words(load_words(a + sa * i), load_words(b + sb * i), s);
  const uint32_t borrow = sub_words(s, p, d);
  select_words(carry != 0 || borrow == 0, d, s);
  store_words(out + 16 * i, s);
}

__global__ void __launch_bounds__(K12_BLOCK) field_sub_kernel(const int64_t* __restrict__ a, int64_t sa,
                                                              const int64_t* __restrict__ b, int64_t sb,
                                                              int64_t* __restrict__ out, int64_t n, Words p) {
  const int64_t i = element();
  if (i >= n) return;
  store_words(out + 16 * i, sub_mod(load_words(a + sa * i), load_words(b + sb * i), p));
}

__global__ void __launch_bounds__(K12_BLOCK) field_neg_kernel(const int64_t* __restrict__ a, int64_t sa,
                                                              int64_t* __restrict__ out, int64_t n, Words p) {
  const int64_t i = element();
  if (i >= n) return;
  const Words zero = {};
  store_words(out + 16 * i, sub_mod(zero, load_words(a + sa * i), p));
}

__global__ void __launch_bounds__(K12_BLOCK) reduce_u256_kernel(const int64_t* __restrict__ a, int64_t sa,
                                                                int64_t* __restrict__ out, int64_t n, Words p) {
  const int64_t i = element();
  if (i >= n) return;
  Words x = load_words(a + sa * i);
#pragma unroll
  for (int round = 0; round < REDUCE_ROUNDS; ++round) {
    Words d;
    const uint32_t borrow = sub_words(x, p, d);
    select_words(borrow == 0, d, x);
  }
  store_words(out + 16 * i, x);
}

__global__ void __launch_bounds__(K12_BLOCK) lt_modulus_kernel(const int64_t* __restrict__ a, int64_t sa,
                                                               uint8_t* __restrict__ out, int64_t n, Words p) {
  const int64_t i = element();
  if (i >= n) return;
  Words d;
  out[i] = static_cast<uint8_t>(sub_words(load_words(a + sa * i), p, d));
}

Words modulus_from_host(const void* field_words) {
  Words p;
  for (int k = 0; k < NW; ++k) p.w[k] = static_cast<const uint32_t*>(field_words)[k];
  return p;
}

int grid_for(int64_t n) { return static_cast<int>((n + K12_BLOCK - 1) / K12_BLOCK); }

}  // namespace

// Every entry: operands as (pointer, row stride in int64 elements), out
// contiguous, n elements, field_words the FieldSpec's kernel words (p as 8
// u32 words, then n0), the stream last.
extern "C" int svtpu_field_add(const void* a, int64_t sa, const void* b, int64_t sb, void* out, int64_t n,
                               const void* field_words, void* stream) {
  if (n <= 0) return 0;
  field_add_kernel<<<grid_for(n), K12_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), sa, static_cast<const int64_t*>(b), sb, static_cast<int64_t*>(out), n,
      modulus_from_host(field_words));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_field_sub(const void* a, int64_t sa, const void* b, int64_t sb, void* out, int64_t n,
                               const void* field_words, void* stream) {
  if (n <= 0) return 0;
  field_sub_kernel<<<grid_for(n), K12_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), sa, static_cast<const int64_t*>(b), sb, static_cast<int64_t*>(out), n,
      modulus_from_host(field_words));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_field_neg(const void* a, int64_t sa, void* out, int64_t n, const void* field_words,
                               void* stream) {
  if (n <= 0) return 0;
  field_neg_kernel<<<grid_for(n), K12_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), sa, static_cast<int64_t*>(out), n, modulus_from_host(field_words));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_reduce_u256(const void* a, int64_t sa, void* out, int64_t n, const void* field_words,
                                 void* stream) {
  if (n <= 0) return 0;
  reduce_u256_kernel<<<grid_for(n), K12_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), sa, static_cast<int64_t*>(out), n, modulus_from_host(field_words));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_lt_modulus(const void* a, int64_t sa, void* out, int64_t n, const void* field_words,
                                void* stream) {
  if (n <= 0) return 0;
  lt_modulus_kernel<<<grid_for(n), K12_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), sa, static_cast<uint8_t*>(out), n, modulus_from_host(field_words));
  return static_cast<int>(cudaGetLastError());
}
