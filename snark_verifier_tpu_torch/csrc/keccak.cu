// K11: the whole Keccak-256 sponge of every row in one launch.
//
// Replaces no TPU kernel: the JAX package runs snark_verifier_tpu/ops/
// keccak.py as XLA (no Pallas kernel).  The port ran it as eager PyTorch
// (ops/keccak.py keccak256_plain): about 35 tensor ops a round, five of them
// index gathers over (rows, 25) int64 lanes.  The 7 hashes of a Keccak-
// transcript verify (13 keccak-f[1600] permutations) were 26,753 host aten
// ops, 59 % of a verify batch's 44,959, and the gathers its second-largest
// device op: the plain version set the verify's pace.  Here one launch hashes
// every row of a call: the legacy 0x01 ... 0x80 padding (L = 0 and L % 136 ==
// 0 included), each 136-byte block's absorb as 17 little-endian lanes and its
// keccak-f[1600], then the squeeze of the first 4 lanes.
//
// The rounds are ops/keccak.py keccak_f's, step for step: theta (column
// parities c, d[x] = c[x - 1] ^ rotl(c[x + 1], 1) into every lane of column
// x), rho and pi together (lane i of the result is lane PI_SRC[i] rotated by
// its RHO offset), chi, iota.  They are bit operations on 64-bit lanes, so
// the digests equal the plain version's, the JAX package's and util/
// keccak.py's bit for bit.
//
// Bound on the H100: the bytes, 8 per input byte (an int64 a byte) and 256 per
// output row, at 3.35 TB/s, and the 64-bit logic ops, about 310 32-bit
// integer ops a round.  At the verify's largest hash (1820 rows of 448 bytes,
// 4 blocks) that is 7.0 MB, 2.1 us, and 54 M ops, 3.2 us at 132 SMs x 64
// lanes x 1.98 GHz.  Neither binds: one row's chain does (its reads, then 24
// dependent rounds a block), and the launch itself.  What the kernel takes
// away is host dispatch, so the design keeps that chain short and the code
// small rather than filling the card:
//   - one thread a row, the 25 lanes in registers; inside a round the rho
//     offsets and the pi order are compile-time constants (a rotation is two
//     funnel shifts by an immediate) and the 5 columns and the 25 lanes are
//     independent, so each step has 5 to 25 ops to issue at once;
//   - the round loop is not unrolled (the round constant comes from constant
//     memory): with the 24 rounds unrolled the verify's hashes took 23 %
//     longer, likely because 24 copies of a round overflow the instruction
//     cache;
//   - a block's 136 bytes are read into 17 lanes before any is absorbed, and
//     the next block's while this one is permuted, so the reads overlap each
//     other and the rounds;
//   - 32-thread blocks, so 1820 rows spread over 57 SMs, a warp on each.
// On an H100 SXM (700 W) the verify's 7 hashes at 1820 rows take 0.134 ms of
// device time (0.232 ms with the rounds unrolled and each lane absorbed as it
// was read; 0.300-0.333 ms with a warp's rows staged through shared memory by
// coalesced reads), the 448-byte one 0.038 ms, one row's chain 0.030 ms.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RATE = 136;  // bytes a block (Keccak-256)
constexpr int RATE_LANES = RATE / 8;
constexpr int KECCAK_BLOCK = 32;  // threads (rows) a block

// iota's constants, one a round (util/keccak.py _ROUND_CONSTANTS)
__constant__ uint64_t ROUND_CONSTANTS[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) { return r == 0 ? x : (x << r) | (x >> (64 - r)); }

// keccak-f[1600] on the 25 lanes of one row (lane x + 5 y), in registers.
__device__ __forceinline__ void keccak_f(uint64_t (&a)[25]) {
  // rho offsets, by lane x + 5 y (util/keccak.py _RHO)
  constexpr int RHO[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
  // pi: lane i of the result is lane PI_SRC[i] of the theta step's output (ops/keccak.py _PI_SRC)
  constexpr int PI_SRC[25] = {0, 6, 12, 18, 24, 3, 9, 10, 16, 22, 1, 7, 13, 19, 20, 4, 5, 11, 17, 23, 2, 8, 14, 15, 21};
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
    }
#pragma unroll
    for (int i = 0; i < 25; ++i) b[i] = rotl64(a[PI_SRC[i]], RHO[PI_SRC[i]]);
#pragma unroll
    for (int i = 0; i < 25; ++i) {
      const int row = i - i % 5;
      a[i] = b[i] ^ (~b[row + (i + 1) % 5] & b[row + (i + 2) % 5]);
    }
    a[0] ^= ROUND_CONSTANTS[round];
  }
}

// The 17 little-endian lanes of the padded message's block at byte `base`:
// the message's bytes below `length`, then the padding (0x01 at `length`,
// 0x80 at `last`, both in one byte when they meet), zeros between.
__device__ __forceinline__ void read_block(const int64_t* __restrict__ msg, int64_t base, int64_t length, int64_t last,
                                           uint64_t (&lanes)[RATE_LANES]) {
#pragma unroll
  for (int i = 0; i < RATE_LANES; ++i) {
    uint64_t lane = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t pos = base + 8 * i + j;
      uint64_t byte = pos < length ? static_cast<uint64_t>(msg[pos]) : 0;
      if (pos == length) byte ^= 0x01;
      if (pos == last) byte ^= 0x80;
      lane |= byte << (8 * j);
    }
    lanes[i] = lane;
  }
}

// Keccak-256 of one row per thread.  data: (rows, length) int64 byte values
// (0..255), contiguous; out: (rows, 32) int64 digest bytes.
__global__ void __launch_bounds__(KECCAK_BLOCK) keccak256_kernel(const int64_t* __restrict__ data, int64_t length,
                                                                int64_t* __restrict__ out, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int64_t* msg = data + row * length;
  const int64_t last = (length / RATE + 1) * RATE - 1;  // the padding adds 1 to RATE bytes; 0x80 closes it
  uint64_t a[25], block[RATE_LANES];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
  read_block(msg, 0, length, last, block);
#pragma unroll 1
  for (int64_t base = 0; base <= last; base += RATE) {
#pragma unroll
    for (int i = 0; i < RATE_LANES; ++i) a[i] ^= block[i];
    if (base + RATE <= last) read_block(msg, base + RATE, length, last, block);  // in flight during the rounds
    keccak_f(a);
  }
  int64_t* digest = out + 32 * row;
#pragma unroll
  for (int k = 0; k < 32; ++k) digest[k] = static_cast<int64_t>((a[k / 8] >> (8 * (k % 8))) & 0xFF);
}

}  // namespace

// Keccak-256 (legacy 0x01 padding) of every row: data (rows, length) int64
// byte values, contiguous; out (rows, 32) int64 digest bytes.
extern "C" int svtpu_keccak256(const void* data, int64_t length, void* out, int64_t rows, void* stream) {
  if (rows <= 0) return 0;
  if (length < 0 || (length > 0 && data == nullptr) || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>((rows + KECCAK_BLOCK - 1) / KECCAK_BLOCK);
  keccak256_kernel<<<grid, KECCAK_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(data), length, static_cast<int64_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
