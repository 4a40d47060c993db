// K4: batched small MSM, window sums in parallel, then Horner, in one launch.
// K6: Horner window combine of a large MSM, one accumulator per MSM.
// K8, K9: the two-kernel form of K4, one launch of each per window.
//
// K4 replaces snark_verifier_tpu/ops/msm_pallas.py:139 _scan_kernel_body
// (_scan_call, :209, driven by msm_batched_fused).  The TPU kernel scans
// (window, point) in order because the TPU's grid runs in order; kept on
// the H100 with one thread per proof, that order gives work to only 15 of
// the 132 SMs at B = 1820 proofs, and each thread runs 64 * (n + 4) point
// operations in one chain.  The 64 window sums of a proof do not depend on each other;
// only the Horner step over them is serial.  So here:
//
//   phase 1: one block holds `ppb` proofs, one after another, and 64 threads,
//            one per window.  The proof's table is staged in shared memory as
//            packed 32-bit words, TILE points at a time (9 x 3 x TILE x 32 B),
//            and thread w computes W_w = sum_i T_i[|d_iw|] (y negated where
//            d_iw < 0), the first point's selection starting the sum: K8's
//            arithmetic, for all windows at once.
//   phase 2: thread j of the block runs proof j's Horner step over its
//            window sums: acc = 16 acc + W_w, most significant window first,
//            from the identity (4 doublings, one complete add): K9's
//            arithmetic.
//
// The output therefore equals msm_windowed's (K8/K9) limb for limb.  Bound
// on the H100: phase 1 is throughput (1820 x 64 x 17 complete adds fill the
// card), phase 2 latency (a chain of 320 point operations per proof, every
// proof of the batch at once when the grid's blocks are all resident).
// Spreading each point operation of phase 2 over 8 threads (two rounds of
// independent Montgomery products) did not shorten it on the H100: one
// thread already overlaps the independent products of a point operation.
// `ppb` (1-8) is the launch parameter: more proofs per block make fewer,
// larger blocks, but sum their window sums one proof after another.  All of
// a block's Horner threads sit in its first warp, and a third block on an SM
// slows every chain, so the wrapper takes the fewest proofs per block that
// keep the grid at 2 blocks per SM (7 at B = 1820: 260 blocks; 1 up to B =
// 264), the best of a sweep over B = 8-1820 at every batch.
//
// K6 replaces snark_verifier_tpu/ops/curve_pallas.py _horner_w_kernel
// (horner_combine_pallas, driven by msm._horner_combine): acc = sum_w
// 2^(w * window) T_w over the per-window totals T_w.  The TPU kernel runs a
// sequential window grid with the accumulator in VMEM.  Here one warp owns
// one MSM (the leading batch axis: the decide's two MSMs are one launch of
// two warps).  It starts from the identity and runs `window` doublings and
// one complete add per window, most significant first, the operations and
// operands of the JAX package's CPU reference scan, so the output triple
// matches it limb for limb.
//
// Bound on the H100: latency.  One MSM is a chain of nwin * (window + 1)
// point operations (32 * 9 at window 8) that nothing can run in parallel,
// and it is alone on the card.  So the design shortens the chain:
//   (a) the warp first stages the nwin totals in shared memory with
//       coalesced loads (nwin x 3 x 32 bytes), so no device-memory load
//       sits on the chain;
//   (b) the independent Montgomery products of each point operation run on
//       separate lanes, and every lane keeps the whole accumulator and runs
//       the adds: a doubling (alg. 9) is two levels of four products,
//       {y y, y z, z z, x y} and {t2 z3, t1 z3, t0 y3, t0 x y}, an addition
//       (alg. 7) two levels of six; the products go through shared memory
//       with __syncwarp between levels (the pattern of K7's warp product);
//   (c) the product is fmul_eo (bn254.cuh: two carry chains per row), so
//       the chain is 576 product latencies at window 8, against 8-12
//       products per point operation on one thread before.
// On an H100 SXM (700 W, chip_smoke.py) a launch took 0.406 ms at nwin 32,
// window 8, batch 1 or 2 alike, against 2.16 ms with one thread per MSM
// and 0.556 with (a) + (b) and fmul; those two schedules are gone.

// K8 replaces snark_verifier_tpu/ops/msm_pallas.py _window_kernel_body
// (_window_call) and K9 replaces _horner_kernel_body (_horner_call): the
// JAX package's small MSM with its one-kernel scan switched off.  Per window,
// most significant first, K8 computes contrib = sum_i T_i[|d_i|] (y negated
// where d_i < 0), the first point's selection starting the sum (no add to the
// identity), and K9 computes acc = 16 * acc + contrib (4 doublings, one
// complete add; acc starts at the identity, so the first window runs through
// K9 too).  Same operations in the same order as the TPU kernels, so the
// triples match them limb for limb.
//
// Bound on the H100: latency.  K8 is a chain of n - 1 dependent complete
// adds per proof (35 at the outer snark's n = 36, where B = 8 proofs gave a
// launch 8 threads with one thread per proof), K9 a chain of 5 point
// operations, and an MSM is 64 launches of each.  With one thread per proof
// (K8's first schedule) each step loaded T_i[|d_i|] (384 bytes,
// uncoalesced), negated its y and then ran 12 fmul on the thread: ~4.8 us
// a step.  So K8 runs one proof on a group of 8 lanes: the accumulator
// stays in the group's shared-memory slots and each step is one g1_add_group (bn254.cuh; K2's two levels of six
// fmul_eo products on lanes), in the plain version's order, acc = sel_0,
// then acc + sel_1, ... (no tree: the order keeps K8, and K4 beside it,
// limb-equal to msm_window_plain).  The gather and the negation are off the
// accumulator's chain: before step i's add the group starts the loads of
// step i + 1's entry (lane k its 16-byte limb pair of each coordinate, 128
// contiguous bytes a group) and of digit i + 2, and only after the add
// negates that entry's y where d < 0 (word-parallel: each word's borrow
// from the group's ballots, no carry chain) and writes it to the q slots.
// On an H100 SXM (700 W, chip_smoke.py) a launch takes 0.069 ms at B = 8,
// n = 36 (1.97 us a step) against 0.306 on one thread, and 0.035 against
// 0.174 ms at B = 1820, n = 18.
//
// K9 is 5 point operations in one chain per proof; on one thread (12 or 8
// fmul each, the operands loaded from device memory) a launch took 0.043
// ms at B = 8, the chain alone.  So K9 runs one proof on a group of 8
// lanes too, K8's group and block: the group loads acc into shared memory
// (lane k its 16-byte limb pair of each coordinate) and contrib into
// registers, runs 4 g1_double_group (bn254.cuh: two levels of four fmul_eo
// products on 4 lanes) and one g1_add_group.  g1_double_group takes exactly
// 4 lanes, so each half of the group doubles the same point in a slot set
// of its own (no slot has two writers); after each doubling lanes 0-2 of
// each half write the result's x, y, z back to its p slots.  Contrib reaches
// the add's q slots only after the fourth doubling, whose level-1 products
// sit in slots 3-6 of half 0's set, the add's slots.  On an H100 SXM (700
// W, chip_smoke.py) a launch takes 0.0093 ms at B = 8 and 0.0097 at B =
// 1820, against 0.0429 and 0.0490 on one thread; one proof's chain is
// 0.0075 ms against 0.0411.
//
// Layouts: table (9, 3, n, B, 16) int64 (entry k, coordinate, point, proof,
// limb); digits (B, n, nwin) int64 signed windows in [-8, 8], least
// significant first; outputs three (B, 16) coordinate tensors.
#include "bn254.cuh"

namespace {

constexpr int NWIN_MAX = 64;  // threads per K4 block: one per window
constexpr int NTAB = 9;       // table entries |d| = 0..8
constexpr int TILE = 24;      // most points of a proof's table staged at once
constexpr int PPB_MAX = 8;    // proofs per block: their window sums fill 48 KB of shared memory

// dynamic shared memory of one K4 block: the staged table tile of `tile`
// points, then the window sums of its ppb proofs
inline size_t msm_scan_smem(int tile, int ppb) {
  return sizeof(svtpu::Fe) * (static_cast<size_t>(tile) * NTAB * 3 + static_cast<size_t>(ppb) * NWIN_MAX * 3);
}

// two blocks per SM hold the wrapper's grid (260 blocks of 7 proofs at B = 1820)
__global__ void __launch_bounds__(NWIN_MAX, 2)
msm_scan_kernel(const int64_t* __restrict__ table, const int64_t* __restrict__ digits,
                int64_t* __restrict__ ox, int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                int64_t batch, int npoints, int nwin, int ppb, int tile, svtpu::Field f) {
  extern __shared__ svtpu::Fe smem[];
  svtpu::Fe* tab = smem;  // (tile, NTAB, 3): point, entry, coordinate
  svtpu::G1* sums = reinterpret_cast<svtpu::G1*>(smem + tile * NTAB * 3);  // (ppb, NWIN_MAX)
  const int w = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * ppb;
  const int64_t coord_stride = static_cast<int64_t>(npoints) * batch * 16;  // next coordinate
  const int64_t entry_stride = 3 * coord_stride;                           // next table entry

  // phase 1: the window sums of each proof of the block
  for (int j = 0; j < ppb && first + j < batch; ++j) {
    const int64_t b = first + j;
    const int64_t* dig = digits + b * npoints * nwin + w;
    svtpu::G1 acc;
    for (int i0 = 0; i0 < npoints; i0 += tile) {
      const int pts = min(tile, npoints - i0);
      __syncthreads();  // the previous tile is read
      for (int t = w; t < pts * NTAB * 3; t += NWIN_MAX) {
        const int i = t / (NTAB * 3), k = (t / 3) % NTAB, c = t % 3;
        tab[t] = svtpu::load_fe(table + k * entry_stride + c * coord_stride +
                                (static_cast<int64_t>(i0 + i) * batch + b) * 16);
      }
      __syncthreads();
      if (w < nwin) {
        for (int i = 0; i < pts; ++i) {
          const int64_t d = dig[static_cast<int64_t>(i0 + i) * nwin];
          const svtpu::Fe* e = tab + (i * NTAB + (d < 0 ? -d : d)) * 3;
          svtpu::G1 pt;
          pt.x = e[0];
          pt.y = d < 0 ? svtpu::fsub(svtpu::fzero(), e[1], f) : e[1];
          pt.z = e[2];
          acc = i0 + i == 0 ? pt : svtpu::g1_add(acc, pt, f);
        }
      }
    }
    if (w < nwin) sums[j * NWIN_MAX + w] = acc;
  }
  __syncthreads();

  // phase 2: Horner over the window sums, one thread per proof
  const int64_t b = first + w;
  if (w >= ppb || b >= batch) return;
  svtpu::G1 acc = svtpu::g1_identity(f);
  for (int v = nwin - 1; v >= 0; --v) {
    for (int k = 0; k < 4; ++k) acc = svtpu::g1_double(acc, f);
    acc = svtpu::g1_add(acc, sums[w * NWIN_MAX + v], f);
  }
  svtpu::store_fe(ox + 16 * b, acc.x);
  svtpu::store_fe(oy + 16 * b, acc.y);
  svtpu::store_fe(oz + 16 * b, acc.z);
}

constexpr int HORNER_WARP = 32;  // one warp per MSM

// v[lane] for lanes 0..n-1 (lanes beyond n take v[n - 1]), as selects: no
// lane diverges.
template <int N>
__device__ __forceinline__ svtpu::Fe pick(int lane, const svtpu::Fe (&v)[N]) {
  svtpu::Fe r = v[N - 1];
#pragma unroll
  for (int k = N - 2; k >= 0; --k) {
#pragma unroll
    for (int j = 0; j < svtpu::NW; ++j) r.w[j] = lane == k ? v[k].w[j] : r.w[j];
  }
  return r;
}

// One level of N independent products, product k on lane k; every lane
// returns all N results (through xs, N entries of shared memory).
template <int N>
__device__ __forceinline__ void warp_level(svtpu::Fe (&r)[N], const svtpu::Fe (&x)[N], const svtpu::Fe (&y)[N],
                                           svtpu::Fe* xs, int lane, const svtpu::Field& f) {
  const svtpu::Fe prod = svtpu::fmul_eo(pick(lane, x), pick(lane, y), f);
  if (lane < N) xs[lane] = prod;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = xs[k];
  __syncwarp();
}

// RCB15 alg. 9 (svtpu::g1_double), its 8 products in two levels of 4.
__device__ __forceinline__ svtpu::G1 warp_double(const svtpu::G1& p, svtpu::Fe* xs, int lane,
                                                 const svtpu::Field& f) {
  using svtpu::fadd;
  using svtpu::fsub;
  svtpu::Fe r[4];
  warp_level<4>(r, {p.y, p.y, p.z, p.x}, {p.y, p.z, p.z, p.y}, xs, lane, f);
  const svtpu::Fe t0 = r[0], t1 = r[1], xy = r[3];
  svtpu::Fe z3 = fadd(t0, t0, f);
  z3 = fadd(z3, z3, f);
  z3 = fadd(z3, z3, f);
  const svtpu::Fe t2 = svtpu::mul_b3(r[2], f);
  const svtpu::Fe y3 = fadd(t0, t2, f);
  const svtpu::Fe t1b = fadd(t2, t2, f);
  const svtpu::Fe t0b = fsub(t0, fadd(t1b, t2, f), f);
  warp_level<4>(r, {t2, t1, t0b, t0b}, {z3, z3, y3, xy}, xs, lane, f);
  svtpu::G1 out;
  out.x = fadd(r[3], r[3], f);
  out.y = fadd(r[2], r[0], f);
  out.z = r[1];
  return out;
}

// RCB15 alg. 7 (svtpu::g1_add), its 12 products in two levels of 6.
__device__ __forceinline__ svtpu::G1 warp_add(const svtpu::G1& p, const svtpu::G1& q, svtpu::Fe* xs, int lane,
                                              const svtpu::Field& f) {
  using svtpu::fadd;
  using svtpu::fsub;
  svtpu::Fe r[6];
  warp_level<6>(r, {p.x, p.y, p.z, fadd(p.x, p.y, f), fadd(p.y, p.z, f), fadd(p.x, p.z, f)},
                          {q.x, q.y, q.z, fadd(q.x, q.y, f), fadd(q.y, q.z, f), fadd(q.x, q.z, f)}, xs, lane, f);
  svtpu::Fe t0 = r[0], t1 = r[1], t2 = r[2];
  const svtpu::Fe t3 = fsub(r[3], fadd(t0, t1, f), f);
  const svtpu::Fe t4 = fsub(r[4], fadd(t1, t2, f), f);
  svtpu::Fe y3 = fsub(r[5], fadd(t0, t2, f), f);
  const svtpu::Fe x3 = fadd(t0, t0, f);
  t0 = fadd(x3, t0, f);
  t2 = svtpu::mul_b3(t2, f);
  const svtpu::Fe z3 = fadd(t1, t2, f);
  t1 = fsub(t1, t2, f);
  y3 = svtpu::mul_b3(y3, f);
  warp_level<6>(r, {t3, t4, t1, y3, z3, t0}, {t1, y3, z3, t0, t4, t3}, xs, lane, f);
  svtpu::G1 out;
  out.x = fsub(r[0], r[1], f);
  out.y = fadd(r[2], r[3], f);
  out.z = fadd(r[4], r[5], f);
  return out;
}

// totals: three (batch, nwin, 16) coordinate tensors, window 0 least
// significant; outputs three (batch, 16) tensors.  One warp per MSM
// (block), dynamic shared memory nwin * 3 * 32 bytes of staged totals plus
// 6 exchange slots.
__global__ void __launch_bounds__(HORNER_WARP) horner_combine_kernel(
    const int64_t* __restrict__ tx, const int64_t* __restrict__ ty, const int64_t* __restrict__ tz,
    int64_t* __restrict__ ox, int64_t* __restrict__ oy, int64_t* __restrict__ oz, int nwin, int window,
    svtpu::Field f) {
  extern __shared__ svtpu::Fe horner_smem[];
  svtpu::Fe* tot = horner_smem;             // (nwin, 3): the staged totals
  svtpu::Fe* xs = horner_smem + 3 * nwin;  // the products of one level
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  // (a) stage: word q of the totals is word q % 8 of coordinate (q / 8) % 3
  // of window q / 24; 8 consecutive lanes read one coordinate's 128 bytes
  for (int q = lane; q < 24 * nwin; q += HORNER_WARP) {
    const int v = q / 24, c = (q / 8) % 3, k = q % 8;
    const int64_t* src = c == 0 ? tx : (c == 1 ? ty : tz);
    const longlong2 two = reinterpret_cast<const longlong2*>(src + (b * nwin + v) * 16)[k];
    tot[3 * v + c].w[k] = static_cast<uint32_t>(two.x) | (static_cast<uint32_t>(two.y) << 16);
  }
  __syncwarp();
  svtpu::G1 acc = svtpu::g1_identity(f);
  for (int w = nwin - 1; w >= 0; --w) {
    for (int k = 0; k < window; ++k) acc = warp_double(acc, xs, lane, f);
    svtpu::G1 t;
    t.x = tot[3 * w];
    t.y = tot[3 * w + 1];
    t.z = tot[3 * w + 2];
    acc = warp_add(acc, t, xs, lane, f);
  }
  if (lane == 0) {
    svtpu::store_fe(ox + 16 * b, acc.x);
    svtpu::store_fe(oy + 16 * b, acc.y);
    svtpu::store_fe(oz + 16 * b, acc.z);
  }
}

constexpr int WINDOW_GROUP = 8;       // K8's lanes per proof: one g1_add_group
constexpr int WINDOW_BLOCK_MAX = 256;  // the largest K8 block
constexpr unsigned FULL_WARP = 0xffffffffu;

// Word k of T_i[|d|] of proof b, for lane k of the proof's group: coordinate
// c of entry |d| at table + ((|d| * 3 + c) * n + i) * B * 16 + b * 16 (the
// (9, 3, n, B, 16) layout), limb pair k; 16 bytes a lane, 128 contiguous
// bytes a group.  ops/msm_cuda.py window_entry_offset is the same map.
__device__ __forceinline__ void load_entry(const int64_t* table, int64_t d, int i, int64_t b, int npoints,
                                           int64_t batch, int k, uint32_t (&w)[3]) {
  const int64_t coord_stride = static_cast<int64_t>(npoints) * batch * 16;
  const int64_t* e = table + (d < 0 ? -d : d) * 3 * coord_stride + (static_cast<int64_t>(i) * batch + b) * 16;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const longlong2 v = reinterpret_cast<const longlong2*>(e + c * coord_stride)[k];
    w[c] = static_cast<uint32_t>(v.x) | (static_cast<uint32_t>(v.y) << 16);
  }
}

// Word k of fsub(0, y) on the group of 8 lanes at warp lane `base`, lane k
// holding word k of y and pk word k of p: (p - y) mod 2^256, each word's
// borrow in resolved from the group's ballots of p_j < y_j (generate) and
// p_j == y_j (propagate) as the carries of one integer add, or 0 where y ==
// 0.  Every lane of the warp must call it.
__device__ __forceinline__ uint32_t neg_word(uint32_t y, uint32_t pk, int k, int base) {
  const unsigned gen = (__ballot_sync(FULL_WARP, pk < y) >> base) & 0xffu;
  const unsigned prop = (__ballot_sync(FULL_WARP, pk == y) >> base) & 0xffu;
  const unsigned nonzero = (__ballot_sync(FULL_WARP, y != 0u) >> base) & 0xffu;
  const unsigned any = gen | prop;
  const uint32_t borrow = (((any + gen) ^ any ^ gen) >> k) & 1u;
  return nonzero ? pk - y - borrow : 0u;
}

// Limb pair k of row b of a (B, 16) coordinate tensor as one 32-bit word.
__device__ __forceinline__ uint32_t load_word(const int64_t* src, int64_t b, int k) {
  const longlong2 v = reinterpret_cast<const longlong2*>(src + 16 * b)[k];
  return static_cast<uint32_t>(v.x) | (static_cast<uint32_t>(v.y) << 16);
}

__device__ __forceinline__ void store_word(int64_t* dst, int64_t b, int k, uint32_t w) {
  reinterpret_cast<longlong2*>(dst + 16 * b)[k] =
      make_longlong2(static_cast<long long>(w & 0xFFFFu), static_cast<long long>(w >> 16));
}

__device__ __forceinline__ void put_words(uint32_t* words, int k, const uint32_t (&w)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) words[c * svtpu::NW + k] = w[c];
}

// digits: (B, n) int64 signed digits of one window; outputs three (B, 16).
// Proof b = (block * blockDim + thread) / 8, lane k = thread % 8; a group
// past the end runs the last proof and stores nothing, so every lane of
// every warp reaches the ballots and __syncwarp()s.  Slots 0-2 of the
// group hold the accumulator, 3-5 the next selection.
__global__ void __launch_bounds__(WINDOW_BLOCK_MAX)
    msm_window_kernel(const int64_t* __restrict__ table, const int64_t* __restrict__ digits, int64_t* __restrict__ ox,
                      int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t batch, int npoints,
                      svtpu::Field f) {
  extern __shared__ uint4 window_slots[];
  const int t = threadIdx.x, k = t & (WINDOW_GROUP - 1), base = (t & 31) & ~(WINDOW_GROUP - 1);
  svtpu::Fe* s = reinterpret_cast<svtpu::Fe*>(window_slots) + (t / WINDOW_GROUP) * svtpu::ADD_SLOTS;
  uint32_t* words = reinterpret_cast<uint32_t*>(s);
  const int64_t g = (static_cast<int64_t>(blockIdx.x) * blockDim.x + t) / WINDOW_GROUP;
  const bool live = g < batch;
  const int64_t b = live ? g : batch - 1;
  const int64_t* dig = digits + b * npoints;
  uint32_t pk = f.p[0];
#pragma unroll
  for (int j = 1; j < svtpu::NW; ++j) pk = k == j ? f.p[j] : pk;

  // the first selection starts the sum (slots 0-2), the second waits in 3-5
  uint32_t w[3];
  int64_t d = dig[0];
  load_entry(table, d, 0, b, npoints, batch, k, w);
  const uint32_t y0 = neg_word(w[1], pk, k, base);
  w[1] = d < 0 ? y0 : w[1];
  put_words(words, k, w);
  int64_t d_next = npoints > 2 ? dig[2] : 0;
  if (npoints > 1) {
    d = dig[1];
    load_entry(table, d, 1, b, npoints, batch, k, w);
    const uint32_t y1 = neg_word(w[1], pk, k, base);
    w[1] = d < 0 ? y1 : w[1];
    put_words(words + 3 * svtpu::NW, k, w);
  }
  __syncwarp();
  for (int i = 1; i < npoints; ++i) {
    // step i + 1's digit and entry are loaded before step i's add and used
    // after it: their latency hides behind the add's arithmetic
    const bool more = i + 1 < npoints;  // the same on every lane of the launch
    d = d_next;
    if (more) {
      load_entry(table, d, i + 1, b, npoints, batch, k, w);
      d_next = i + 2 < npoints ? dig[i + 2] : 0;
    }
    const svtpu::G1 acc = svtpu::g1_add_group<WINDOW_GROUP>(s, k, FULL_WARP, f);
    // slots 0-5 were last read before the add's first __syncwarp
    words[k] = svtpu::fe_word(acc.x, k);
    words[svtpu::NW + k] = svtpu::fe_word(acc.y, k);
    words[2 * svtpu::NW + k] = svtpu::fe_word(acc.z, k);
    if (more) {
      const uint32_t y = neg_word(w[1], pk, k, base);
      w[1] = d < 0 ? y : w[1];
      put_words(words + 3 * svtpu::NW, k, w);
    }
    __syncwarp();  // the slots are written, and every lane read the add's products
  }
  if (!live) return;
  store_word(ox, b, k, words[k]);
  store_word(oy, b, k, words[svtpu::NW + k]);
  store_word(oz, b, k, words[2 * svtpu::NW + k]);
}

// K9's slots per group: the add's (the first DBL_SLOTS of them half 0's
// doubling set), then half 1's doubling set.
constexpr int HORNER_SLOTS = svtpu::ADD_SLOTS + svtpu::DBL_SLOTS;

// acc, contrib: three (B, 16) each; outputs three (B, 16).  Proof b =
// (block * blockDim + thread) / 8, lane k = thread % 8, half k / 4 and role
// k % 4 in it; a group past the end runs the last proof and stores nothing,
// so every lane of every warp reaches the __syncwarp()s.
__global__ void __launch_bounds__(WINDOW_BLOCK_MAX)
    msm_horner_kernel(const int64_t* __restrict__ ax, const int64_t* __restrict__ ay, const int64_t* __restrict__ az,
                      const int64_t* __restrict__ cx, const int64_t* __restrict__ cy, const int64_t* __restrict__ cz,
                      int64_t* __restrict__ ox, int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t batch,
                      svtpu::Field f) {
  extern __shared__ uint4 horner_slots[];
  const int t = threadIdx.x, k = t & (WINDOW_GROUP - 1), role = k & (svtpu::DBL_GROUP - 1);
  svtpu::Fe* s = reinterpret_cast<svtpu::Fe*>(horner_slots) + (t / WINDOW_GROUP) * HORNER_SLOTS;
  svtpu::Fe* d = s + (k / svtpu::DBL_GROUP) * svtpu::ADD_SLOTS;  // this half's doubling set
  uint32_t* words = reinterpret_cast<uint32_t*>(s);
  const int64_t g = (static_cast<int64_t>(blockIdx.x) * blockDim.x + t) / WINDOW_GROUP;
  const bool live = g < batch;
  const int64_t b = live ? g : batch - 1;
  const int64_t* const acc_in[3] = {ax, ay, az};
  const int64_t* const contrib_in[3] = {cx, cy, cz};
  uint32_t q[3];  // word k of contrib's coordinates, off the chain until the add
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint32_t w = load_word(acc_in[c], b, k);
    q[c] = load_word(contrib_in[c], b, k);
    words[c * svtpu::NW + k] = w;                      // half 0's p slots
    words[(svtpu::ADD_SLOTS + c) * svtpu::NW + k] = w;  // half 1's
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const svtpu::G1 r = svtpu::g1_double_group(d, role, FULL_WARP, f);
    // the p slots were last read before the doubling's first __syncwarp,
    // slots 3-6 (the add's q slots) before its last
    if (role < 3) svtpu::sts_fe(d + role, svtpu::fe_sel(role == 0, r.x, svtpu::fe_sel(role == 1, r.y, r.z)));
    if (i == 3) put_words(words + 3 * svtpu::NW, k, q);
    __syncwarp();
  }
  const svtpu::G1 acc = svtpu::g1_add_group<WINDOW_GROUP>(s, k, FULL_WARP, f);
  if (!live) return;
  store_word(ox, b, k, svtpu::fe_word(acc.x, k));
  store_word(oy, b, k, svtpu::fe_word(acc.y, k));
  store_word(oz, b, k, svtpu::fe_word(acc.z, k));
}

}  // namespace

extern "C" int svtpu_msm_scan(const void* table, const void* digits, void* ox, void* oy,
                              void* oz, int64_t batch, int npoints, int nwin, int ppb,
                              const void* field_words, void* stream) {
  if (batch <= 0) return 0;
  if (npoints < 1 || nwin < 1 || nwin > NWIN_MAX || ppb < 1 || ppb > PPB_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = npoints < TILE ? npoints : TILE;
  const size_t smem = msm_scan_smem(tile, ppb);
  if (smem > 48 * 1024) {  // above the default, dynamic shared memory must be asked for
    const cudaError_t err = cudaFuncSetAttribute(
        msm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  msm_scan_kernel<<<svtpu::grid_for(batch, ppb), NWIN_MAX, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<const int64_t*>(digits),
      static_cast<int64_t*>(ox), static_cast<int64_t*>(oy), static_cast<int64_t*>(oz), batch,
      npoints, nwin, ppb, tile, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_horner_combine(const void* tx, const void* ty, const void* tz, void* ox,
                                    void* oy, void* oz, int64_t batch, int nwin, int window,
                                    const void* field_words, void* stream) {
  if (batch <= 0) return 0;
  if (nwin < 1 || nwin > 256) return static_cast<int>(cudaErrorInvalidValue);
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  const size_t smem = (3 * static_cast<size_t>(nwin) + 6) * sizeof(svtpu::Fe);  // at most 24.8 KB
  horner_combine_kernel<<<static_cast<unsigned>(batch), HORNER_WARP, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(tx), static_cast<const int64_t*>(ty), static_cast<const int64_t*>(tz),
      static_cast<int64_t*>(ox), static_cast<int64_t*>(oy), static_cast<int64_t*>(oz), nwin, window, f);
  return static_cast<int>(cudaGetLastError());
}

// K8 on groups of 8 lanes, `block` threads per block (a multiple of 32 up to
// 256, block / 8 proofs).
extern "C" int svtpu_msm_window(const void* table, const void* digits, void* ox, void* oy, void* oz,
                                int64_t batch, int npoints, const void* field_words, int block,
                                void* stream) {
  if (batch <= 0) return 0;
  if (npoints < 1 || block <= 0 || block % 32 != 0 || block > WINDOW_BLOCK_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* tab = static_cast<const int64_t*>(table);
  const int64_t* dig = static_cast<const int64_t*>(digits);
  int64_t* x = static_cast<int64_t*>(ox);
  int64_t* y = static_cast<int64_t*>(oy);
  int64_t* z = static_cast<int64_t*>(oz);
  const size_t smem = static_cast<size_t>(block / WINDOW_GROUP) * svtpu::ADD_SLOTS * sizeof(svtpu::Fe);
  msm_window_kernel<<<svtpu::grid_for(batch * WINDOW_GROUP, block), block, smem, s>>>(tab, dig, x, y, z, batch,
                                                                                      npoints, f);
  return static_cast<int>(cudaGetLastError());
}

// K9 on groups of 8 lanes, `block` threads per block (a multiple of 32 up to
// 256, block / 8 proofs).
extern "C" int svtpu_msm_horner(const void* ax, const void* ay, const void* az, const void* cx,
                                const void* cy, const void* cz, void* ox, void* oy, void* oz,
                                int64_t batch, const void* field_words, int block, void* stream) {
  if (batch <= 0) return 0;
  if (block <= 0 || block % 32 != 0 || block > WINDOW_BLOCK_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  const size_t smem = static_cast<size_t>(block / WINDOW_GROUP) * HORNER_SLOTS * sizeof(svtpu::Fe);
  msm_horner_kernel<<<svtpu::grid_for(batch * WINDOW_GROUP, block), block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ax), static_cast<const int64_t*>(ay), static_cast<const int64_t*>(az),
      static_cast<const int64_t*>(cx), static_cast<const int64_t*>(cy), static_cast<const int64_t*>(cz),
      static_cast<int64_t*>(ox), static_cast<int64_t*>(oy), static_cast<int64_t*>(oz), batch, f);
  return static_cast<int>(cudaGetLastError());
}
