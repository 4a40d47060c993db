// K10: the whole Poseidon permutation (sparse form) in one launch.
//
// Replaces no TPU kernel: the JAX package runs snark_verifier_tpu/ops/
// poseidon.py permutation as XLA (a lax.scan over the rounds, no Pallas
// kernel).  The port ran it as eager PyTorch, each Montgomery product one K1
// launch and each modular add tens of plain-torch ops: ~330 K1 launches and
// ~42k host ops per permutation, which set the pace of the Poseidon-
// transcript verify (14 permutations a batch).  Here one launch runs the
// absorb and every round for every row of the batch.
//
// The schedule is ops/poseidon.py permutation_plain's, operation for
// operation (util/poseidon_opt.py's sparse form, T = 5, R_F = 8, R_P = 60):
//   - absorb: word j += round-0 constant j, words 1..n += the n inputs, word
//     n + 1 += 1 (absorb_with_pre_constants);
//   - R_F / 2 - 1 full rounds with the dense MDS, then one with the
//     pre-sparse MDS;
//   - R_P partial rounds: s0 = sbox(word 0) + c, word 0 = row . (s0, words
//     1..), word j += col_j s0;
//   - R_F / 2 full rounds with the dense MDS, the last with a zero row of
//     constants.
// A full round is x^5 of every word, plus its constant, then the matrix,
// each row a left fold of its products; the same modular adds in the same
// order, and fmul_eo gives the plain Montgomery product's integer, so the
// limbs equal the plain version's for any input below 2^256.
//
// Bound on the H100: one row's chain of dependent products.  A permutation
// is 1040 Montgomery products per row (8 full rounds of 40, 60 partial
// rounds of 12) against 160 + 32 n bytes in and 160 out: at the verify's
// 1820 rows the multiply bound is ~0.03 ms and the bytes' under 0.001 ms.
// Its critical path is 4 dependent products a round (the S-box's 3, then
// the matrix) over 68 rounds: 272 x 0.43 us (fmul_eo inside mont_pow) =
// 0.118 ms.  With one thread a row (the first schedule, since deleted) the
// thread issued all 1040 products one after another: 0.488 ms a launch at
// 1820 rows, its one row's chain 0.479 ms.  So a row runs on a group of 8
// lanes, lane j owning word j of the state in registers (lanes 5-7 repeat
// word 0 and store nothing):
//   - a full round: each lane its own S-box and constant, then its matrix
//     row over the 5 S-box outputs, shuffled from the group's lanes in word
//     order: 3 + 5 products a lane;
//   - a partial round: word 0 shuffled to every lane, its S-box on every
//     lane, then lane j's product of the row's entry j and, on lanes 1-4,
//     the column's product by s0, side by side; every lane left-folds the
//     row's 5 products from the shuffles, so word 0 is on every lane for
//     the next round: 3 + 2 products a lane, 4 on the chain;
//   - 128-thread blocks (16 rows), so 1820 rows are 114 blocks, one warp
//     for each of an SM's 4 schedulers.
// On an H100 SXM (700 W) a launch takes 0.179 ms at 1820 rows and one row's
// chain 0.174 ms, 1.5x the critical path; the shuffles and modular adds
// between the products are the rest.
//
// The constants (695 field elements at T = 5, ~22 KB as words) come as one
// flat table of int64 limbs in the order the rounds read them (ops/
// poseidon.py flat_table): the round-0 and start rows, the dense MDS, the
// pre-sparse MDS, 2 T elements per partial round (its constant, its row,
// its column), the end rows.  Each block stages it into shared memory once;
// the lanes of a warp read at most 5 distinct constants at a step, each a
// broadcast to its lanes.  The code stays small: one site for the S-box and
// one for each round kind's products, with the matrix row in a loop.
#include "bn254.cuh"

namespace {

using svtpu::Fe;
using svtpu::Field;

// Offsets into the flat table, in field elements (ops/poseidon.py flat_table
// lays it out; tests/test_torch_poseidon.py k10_model reads it the same way).
struct Offsets {
  int mds, pre, partial, end, size;
};

__host__ __device__ inline Offsets table_offsets(int t, int r_f, int r_p) {
  Offsets o;
  o.mds = (r_f / 2 + 1) * t;  // after the round-0 row and the r_f / 2 start rows
  o.pre = o.mds + t * t;
  o.partial = o.pre + t * t;
  o.end = o.partial + 2 * t * r_p;
  o.size = o.end + (r_f / 2) * t;
  return o;
}

__device__ __forceinline__ Fe sbox(const Fe& x, const Field& f) {
  const Fe x2 = svtpu::fmul_eo(x, x, f);
  const Fe x4 = svtpu::fmul_eo(x2, x2, f);
  return svtpu::fmul_eo(x4, x, f);
}

constexpr int PERM_GROUP = 8;    // lanes per row: lane j < T owns state word j
constexpr int PERM_BLOCK = 128;  // threads per block: 16 rows, a warp for each of an SM's 4 schedulers

// Word `src` of the calling lane's group, as a value (every lane of the warp
// takes part).
__device__ __forceinline__ Fe shfl_fe(const Fe& v, int src) {
  Fe r;
#pragma unroll
  for (int k = 0; k < svtpu::NW; ++k) r.w[k] = __shfl_sync(0xffffffffu, v.w[k], src, PERM_GROUP);
  return r;
}

// The permutation of one row on a group of PERM_GROUP lanes: lane j < T
// holds word j (lanes T.. hold word 0 again and store nothing).  A full
// round is each lane's own S-box, then its own matrix row over the group's
// S-box outputs, shuffled in word order; a partial round is the S-box of
// word 0 on every lane, then on lane j the row's product j and the column's
// product, the row's products left-folded from the shuffles on every lane.
// state: (rows, T, 16) limbs; inputs: (rows, n_inputs, 16) limbs (null when
// n_inputs is 0); table: (table_offsets(T, r_f, r_p).size, 16) limbs; out:
// (rows, T, 16).
template <int T>
__global__ void __launch_bounds__(PERM_BLOCK) poseidon_perm_kernel(
    const int64_t* __restrict__ state, const int64_t* __restrict__ inputs, int n_inputs,
    const int64_t* __restrict__ table, int64_t* __restrict__ out, int64_t rows, int r_f, int r_p, Field f) {
  extern __shared__ uint4 perm_smem[];
  Fe* tab = reinterpret_cast<Fe*>(perm_smem);
  const Offsets o = table_offsets(T, r_f, r_p);
  for (int k = threadIdx.x; k < o.size; k += blockDim.x) svtpu::sts_fe(tab + k, svtpu::load_fe(table + 16 * k));
  __syncthreads();
  const int lane = threadIdx.x % PERM_GROUP;
  const int j = lane < T ? lane : 0;
  const int64_t group = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / PERM_GROUP;
  const int64_t row = group < rows ? group : rows - 1;  // a group past the end works on the last row, stores nothing

  Fe w = svtpu::fadd(svtpu::load_fe(state + 16 * (row * T + j)), svtpu::lds_fe(tab + j), f);
  if (j >= 1 && j <= n_inputs) w = svtpu::fadd(w, svtpu::load_fe(inputs + 16 * (row * n_inputs + j - 1)), f);
  if (j == n_inputs + 1) w = svtpu::fadd(w, svtpu::mont_one(f), f);
  const int half = r_f / 2;
#pragma unroll 1
  for (int r = 0; r < r_f + r_p; ++r) {
    const bool full = r < half || r >= half + r_p;  // the same on every lane
    // table indices: the full round's constant row, the partial round's 2 T entries
    const int c = r < half ? (r + 1) * T : o.end + (r - half - r_p) * T;
    const int q = o.partial + 2 * T * (r - half);
    const Fe x0 = shfl_fe(w, 0);
    const Fe s = svtpu::fadd(sbox(svtpu::fe_sel(full, w, x0), f), svtpu::lds_fe(tab + (full ? c + j : q)), f);
    if (full) {
      const Fe* row_j = tab + (r == half - 1 ? o.pre : o.mds) + j * T;
      Fe acc = svtpu::fmul_eo(shfl_fe(s, 0), svtpu::lds_fe(row_j), f);
#pragma unroll 1
      for (int k = 1; k < T; ++k) acc = svtpu::fadd(acc, svtpu::fmul_eo(shfl_fe(s, k), svtpu::lds_fe(row_j + k), f), f);
      w = acc;
    } else {
      // s is s0 on every lane; row . (s0, w_1..) and col_{j-1} s0 + w_j
      const Fe prod = svtpu::fmul_eo(svtpu::fe_sel(j == 0, s, w), svtpu::lds_fe(tab + q + 1 + j), f);
      const Fe next = svtpu::fadd(svtpu::fmul_eo(svtpu::lds_fe(tab + q + T + j), s, f), w, f);
      Fe w0 = shfl_fe(prod, 0);
#pragma unroll
      for (int k = 1; k < T; ++k) w0 = svtpu::fadd(w0, shfl_fe(prod, k), f);
      w = svtpu::fe_sel(j == 0, w0, next);
    }
  }
  if (group < rows && lane < T) svtpu::store_fe(out + 16 * (row * T + lane), w);
}

}  // namespace

// One permutation of every row: state (rows, t, 16) and inputs (rows,
// n_inputs, 16) int64 limbs, Montgomery form; table of table_rows field
// elements (ops/poseidon.py flat_table); out (rows, t, 16).  t must be 5
// (the kernel's one instance), 0 <= n_inputs < t, r_f even.
extern "C" int svtpu_poseidon_perm(const void* state, const void* inputs, int n_inputs, const void* table,
                                   int64_t table_rows, void* out, int64_t rows, int t, int r_f, int r_p,
                                   const void* field_words, void* stream) {
  if (rows <= 0) return 0;
  if (t != 5 || n_inputs < 0 || n_inputs >= t || (n_inputs > 0 && inputs == nullptr) || r_f < 2 || r_f % 2 != 0 ||
      r_p < 0 || table_offsets(t, r_f, r_p).size != table_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(table_rows) * sizeof(Fe);
  if (smem > 48 * 1024) {  // above the default, dynamic shared memory must be asked for
    const cudaError_t err = cudaFuncSetAttribute(poseidon_perm_kernel<5>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  poseidon_perm_kernel<5><<<svtpu::grid_for(rows * PERM_GROUP, PERM_BLOCK), PERM_BLOCK, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(state), static_cast<const int64_t*>(inputs), n_inputs,
      static_cast<const int64_t*>(table), static_cast<int64_t*>(out), rows, r_f, r_p, f);
  return static_cast<int>(cudaGetLastError());
}
