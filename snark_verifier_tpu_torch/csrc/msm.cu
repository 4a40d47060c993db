// K4: batched small MSM by point scan, one accumulator per proof.
// K6: Horner window combine of a large MSM, one accumulator per MSM.
// K8, K9: the two-kernel form of K4, one launch of each per window.
//
// Replaces snark_verifier_tpu/ops/msm_pallas.py _scan_kernel_body (_scan_call,
// driven by msm_batched_fused).  The TPU kernel runs a sequential grid
// (b_block, window, point) with the accumulator block resident in VMEM; on
// Hopper the grid's sequential axes become loops inside one thread, and the
// batch axis becomes the thread index: thread b owns proof b's accumulator in
// registers for the whole MSM.
//
// Per window, most significant first: 4 doublings (skipped for the first
// window), then for each of the n points select T[|d|] from the 9-entry table
// T_k = k * P_i, negate y when d < 0, and add with the complete formula.  The
// very first step assigns instead of adding.  Same operations in the same
// order as the TPU kernel, so the output triple matches it limb for limb for
// the same tables.
//
// Bound on the H100: latency.  At B = 1820 proofs the launch is 1820 threads,
// about 57 warps on a 132-SM card, and each thread runs a serial chain of
// 64 * (n + 4) point operations.  The block size is a launch parameter
// (chip_smoke.py sweeps it); splitting one proof's scan over several threads
// (by points or windows) is the next step.
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

__global__ void msm_scan_kernel(const int64_t* __restrict__ table,
                                const int64_t* __restrict__ digits, int64_t* __restrict__ ox,
                                int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                                int64_t batch, int npoints, int nwin, svtpu::Field f) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int64_t coord_stride = static_cast<int64_t>(npoints) * batch * 16;  // next coordinate
  const int64_t entry_stride = 3 * coord_stride;                           // next table entry
  const int64_t* dig = digits + b * npoints * nwin;

  svtpu::G1 acc;
  bool first = true;
  for (int w = nwin - 1; w >= 0; --w) {
    if (!first) {
      for (int k = 0; k < 4; ++k) acc = svtpu::g1_double(acc, f);
    }
    for (int i = 0; i < npoints; ++i) {
      const int64_t d = dig[i * nwin + w];
      const int64_t k = d < 0 ? -d : d;
      const int64_t* e = table + k * entry_stride + (static_cast<int64_t>(i) * batch + b) * 16;
      svtpu::G1 pt;
      pt.x = svtpu::load_fe(e);
      pt.y = svtpu::load_fe(e + coord_stride);
      pt.z = svtpu::load_fe(e + 2 * coord_stride);
      if (d < 0) pt.y = svtpu::fsub(svtpu::fzero(), pt.y, f);
      if (first) {
        acc = pt;
        first = false;
      } else {
        acc = svtpu::g1_add(acc, pt, f);
      }
    }
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
                              void* oz, int64_t batch, int npoints, int nwin,
                              const void* field_words, int block, void* stream) {
  if (batch <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  msm_scan_kernel<<<svtpu::grid_for(batch, block), block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<const int64_t*>(digits),
      static_cast<int64_t*>(ox), static_cast<int64_t*>(oy), static_cast<int64_t*>(oz), batch,
      npoints, nwin, f);
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
