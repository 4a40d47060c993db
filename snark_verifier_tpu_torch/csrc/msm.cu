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
// sequential window grid with the accumulator in VMEM; here one thread walks
// the windows most significant first and keeps the accumulator in registers.
// It starts from the identity and runs `window` doublings and one complete
// add per window, the operations of the JAX package's CPU reference scan, so
// the output triple matches it limb for limb.  The leading batch axis (one
// thread per MSM) serves batched MSMs; the decide has two MSMs.
//
// Bound on the H100: latency.  One MSM is a serial chain of nwin * (window +
// 1) point operations (32 * 9 at window 8) on one thread; nothing in the
// chain can run in parallel, so its time is the chain's latency.
//
// K8 replaces snark_verifier_tpu/ops/msm_pallas.py _window_kernel_body
// (_window_call) and K9 replaces _horner_kernel_body (_horner_call): the
// JAX package's small MSM with its one-kernel scan switched off.  Per window,
// most significant first, K8 computes contrib = sum_i T_i[|d_i|] (y negated
// where d_i < 0), the first point's selection starting the sum (no add to the
// identity), and K9 computes acc = 16 * acc + contrib (4 doublings, one
// complete add; acc starts at the identity, so the first window runs through
// K9 too).  One thread per proof, as K4.  Same operations in the same order
// as the TPU kernels, so the triples match them limb for limb.
//
// Bound on the H100: latency and launches.  K8 is a chain of n - 1 complete
// adds per thread (17 at n = 18), K9 a chain of 5 point operations; at B =
// 1820 a launch holds 57 warps, and an MSM is 64 launches of each, so the
// launch floor (about 2 us) sets K9's time and the dispatch of 128 launches
// per MSM adds to K8's.
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

// totals: three (batch, nwin, 16) coordinate tensors, window 0 least
// significant; outputs three (batch, 16) tensors.
__global__ void horner_combine_kernel(const int64_t* __restrict__ tx,
                                      const int64_t* __restrict__ ty,
                                      const int64_t* __restrict__ tz, int64_t* __restrict__ ox,
                                      int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                                      int64_t batch, int nwin, int window, svtpu::Field f) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  svtpu::G1 acc = svtpu::g1_identity(f);
  for (int w = nwin - 1; w >= 0; --w) {
    for (int k = 0; k < window; ++k) acc = svtpu::g1_double(acc, f);
    const int64_t off = (b * nwin + w) * 16;
    svtpu::G1 t;
    t.x = svtpu::load_fe(tx + off);
    t.y = svtpu::load_fe(ty + off);
    t.z = svtpu::load_fe(tz + off);
    acc = svtpu::g1_add(acc, t, f);
  }
  svtpu::store_fe(ox + 16 * b, acc.x);
  svtpu::store_fe(oy + 16 * b, acc.y);
  svtpu::store_fe(oz + 16 * b, acc.z);
}

__device__ __forceinline__ svtpu::G1 load_g1(const int64_t* x, const int64_t* y,
                                              const int64_t* z, int64_t off) {
  svtpu::G1 p;
  p.x = svtpu::load_fe(x + off);
  p.y = svtpu::load_fe(y + off);
  p.z = svtpu::load_fe(z + off);
  return p;
}

__device__ __forceinline__ void store_g1(int64_t* x, int64_t* y, int64_t* z, int64_t off,
                                         const svtpu::G1& p) {
  svtpu::store_fe(x + off, p.x);
  svtpu::store_fe(y + off, p.y);
  svtpu::store_fe(z + off, p.z);
}

// digits: (B, n) int64 signed digits of one window; outputs three (B, 16).
__global__ void msm_window_kernel(const int64_t* __restrict__ table,
                                  const int64_t* __restrict__ digits, int64_t* __restrict__ ox,
                                  int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                                  int64_t batch, int npoints, svtpu::Field f) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int64_t coord_stride = static_cast<int64_t>(npoints) * batch * 16;
  const int64_t entry_stride = 3 * coord_stride;
  const int64_t* dig = digits + b * npoints;

  svtpu::G1 acc;
  for (int i = 0; i < npoints; ++i) {
    const int64_t d = dig[i];
    const int64_t k = d < 0 ? -d : d;
    const int64_t* e = table + k * entry_stride + (static_cast<int64_t>(i) * batch + b) * 16;
    svtpu::G1 pt = load_g1(e, e + coord_stride, e + 2 * coord_stride, 0);
    if (d < 0) pt.y = svtpu::fsub(svtpu::fzero(), pt.y, f);
    acc = i == 0 ? pt : svtpu::g1_add(acc, pt, f);
  }
  store_g1(ox, oy, oz, 16 * b, acc);
}

// acc, contrib: three (B, 16) each; outputs three (B, 16).
__global__ void msm_horner_kernel(const int64_t* __restrict__ ax, const int64_t* __restrict__ ay,
                                  const int64_t* __restrict__ az, const int64_t* __restrict__ cx,
                                  const int64_t* __restrict__ cy, const int64_t* __restrict__ cz,
                                  int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                                  int64_t* __restrict__ oz, int64_t batch, svtpu::Field f) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  svtpu::G1 acc = load_g1(ax, ay, az, 16 * b);
  for (int k = 0; k < 4; ++k) acc = svtpu::g1_double(acc, f);
  acc = svtpu::g1_add(acc, load_g1(cx, cy, cz, 16 * b), f);
  store_g1(ox, oy, oz, 16 * b, acc);
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
                                    const void* field_words, int block, void* stream) {
  if (batch <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  horner_combine_kernel<<<svtpu::grid_for(batch, block), block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(tx), static_cast<const int64_t*>(ty),
      static_cast<const int64_t*>(tz), static_cast<int64_t*>(ox), static_cast<int64_t*>(oy),
      static_cast<int64_t*>(oz), batch, nwin, window, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_msm_window(const void* table, const void* digits, void* ox, void* oy, void* oz,
                                int64_t batch, int npoints, const void* field_words, int block,
                                void* stream) {
  if (batch <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  msm_window_kernel<<<svtpu::grid_for(batch, block), block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<const int64_t*>(digits),
      static_cast<int64_t*>(ox), static_cast<int64_t*>(oy), static_cast<int64_t*>(oz), batch,
      npoints, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_msm_horner(const void* ax, const void* ay, const void* az, const void* cx,
                                const void* cy, const void* cz, void* ox, void* oy, void* oz,
                                int64_t batch, const void* field_words, int block, void* stream) {
  if (batch <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  msm_horner_kernel<<<svtpu::grid_for(batch, block), block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ax), static_cast<const int64_t*>(ay),
      static_cast<const int64_t*>(az), static_cast<const int64_t*>(cx),
      static_cast<const int64_t*>(cy), static_cast<const int64_t*>(cz),
      static_cast<int64_t*>(ox), static_cast<int64_t*>(oy), static_cast<int64_t*>(oz), batch, f);
  return static_cast<int>(cudaGetLastError());
}
