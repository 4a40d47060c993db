// K7: the pairing's Fq12 products, as three kernels on one warp-wide product.
//
// Replaces snark_verifier_tpu/ops/tower_pallas.py:97 _f12_mul_kernel
// (fq12_mul_flat_pallas, :106/:129), the product of every Miller-loop step
// and every step of the final exponentiation, which the JAX package calls
// once per step from pairing._mul_flat.
//
//   fq12_mul_kernel     one flat product per warp (tower_cuda.fq12_mul_flat);
//   miller_loop_kernel  all steps of both Miller loops of a KZG check, one
//                       warp per lane of the doubled batch (pairing.py
//                       miller_loop_pair);
//   final_exp_kernel    _combine, the Fq12 inverse, the easy part and the
//                       Scott hard-part chain, one warp per batch element
//                       (pairing.py final_exponentiation).
//
// Bound on the H100: latency.  The decide checks one pair of points (batch 1,
// doubled to 2 in the Miller loop), so the card holds one or two warps and a
// check is a chain of 440 Fq12 products.  One thread per product runs 54
// Montgomery products in a row per product and spills at 255 registers, and
// one launch per product puts 440 launches, with the line evaluation between
// them, on the host.  Here a product is spread over a warp: the 54 Montgomery
// products of the Karatsuba tree (3 Fq6 x 6 Fq2 x 3 Fq) go two to a lane,
// and the pre-additions and the recombination run in rounds of independent
// adds, one value per lane, with operands in shared memory; a product costs
// about two `fmul` latencies and a few `fadd` latencies.  The whole Miller
// loop (line products lam * (-px) for all steps first, in parallel) and the
// whole final exponentiation run in one launch each, with f in shared
// memory.
//
// Every value is kept reduced below p, and a product or an inverse of reduced
// values has one reduced result, so each output limb equals the JAX
// package's, the plain versions' and the oracle's however the product is
// split.  The inverse is conj(f) * (f conj(f))^-1 with the Fq6 norm inverted
// through one Fermat chain a^(p-2) on one lane (0 maps to 0, as F.inv).
//
// Layout: flat (12, n, 16) int64, component (l, j, c) at index l*6 + j*2 + c
// (tower.fq12_to_flat), element e of component i at (i * n + e) * 16.
#include "bn254.cuh"

namespace {

using svtpu::Fe;
using svtpu::Field;

constexpr int NC = 12;     // Fq components of an Fq12
constexpr int NPROD = 54;  // Montgomery products of one Fq12 product
constexpr int WARP = 32;
constexpr int MUL_WARPS = 4;   // warps (products) per block of fq12_mul_kernel
constexpr int MAX_STEPS = 96;  // Miller-loop steps the kernel holds (BN254: 88)

struct Fq2 {
  Fe c0, c1;
};

__device__ __forceinline__ Fe fneg(const Fe& a, const Field& f) {
  return svtpu::fsub(svtpu::fzero(), a, f);
}

// component c of x * (9 + u) = (9 x0 - x1, 9 x1 + x0)
__device__ __forceinline__ Fe xi_comp(const Fe& x0, const Fe& x1, int c, const Field& f) {
  return c == 0 ? svtpu::fsub(svtpu::mul_b3(x0, f), x1, f) : svtpu::fadd(svtpu::mul_b3(x1, f), x0, f);
}

// (x0 y0 - x1 y1, (x0 + x1)(y0 + y1) - (x0 y0 + x1 y1))
__device__ __noinline__ Fq2 f2mul(const Fq2& x, const Fq2& y, const Field& f) {
  const Fe t0 = svtpu::fmul(x.c0, y.c0, f);
  const Fe t1 = svtpu::fmul(x.c1, y.c1, f);
  const Fe t2 = svtpu::fmul(svtpu::fadd(x.c0, x.c1, f), svtpu::fadd(y.c0, y.c1, f), f);
  return {svtpu::fsub(t0, t1, f), svtpu::fsub(t2, svtpu::fadd(t0, t1, f), f)};
}

__device__ __forceinline__ Fq2 f2add(const Fq2& x, const Fq2& y, const Field& f) {
  return {svtpu::fadd(x.c0, y.c0, f), svtpu::fadd(x.c1, y.c1, f)};
}

__device__ __forceinline__ Fq2 f2sub(const Fq2& x, const Fq2& y, const Field& f) {
  return {svtpu::fsub(x.c0, y.c0, f), svtpu::fsub(x.c1, y.c1, f)};
}

__device__ __forceinline__ Fq2 f2xi(const Fq2& x, const Field& f) {
  return {xi_comp(x.c0, x.c1, 0, f), xi_comp(x.c0, x.c1, 1, f)};
}

// ---- the warp-wide Fq12 product ---------------------------------------------

// Shared scratch of one warp's product.  Karatsuba operand (i, j, k) at
// (i * 6 + j) * 3 + k: i the Fq12 level (a0, a1, a0 + a1), j the Fq6 level
// (x0, x1, x2, x1 + x2, x0 + x1, x0 + x2), k the Fq2 level (c0, c1, c0 + c1).
struct MulScratch {
  Fe a[NPROD], b[NPROD];  // operands
  Fe r[NPROD];            // their products
  Fe q[36];               // Fq2 products (i, j, c) at (i * 6 + j) * 2 + c
  Fe d[18];               // Fq6 partial sums (i, m, c) at (i * 3 + m) * 2 + c
  Fe u[18];               // Fq6 products (i, m, c) at (i * 3 + m) * 2 + c
  Fe v[2];                // xi * u[1][2]
};

// out = x * y on the 32 lanes of a warp; x, y, out are 12 Fe in shared
// memory (out may be x or y).  The caller has synchronised the warp after
// writing x and y; out is visible to the warp on return.
__device__ __noinline__ void warp_mul(Fe* out, const Fe* x, const Fe* y, MulScratch& s, int lane, const Field& f) {
  // Fq12 level: a0, a1 copied, a0 + a1 added (18 entries per operand)
  for (int t = lane; t < 36; t += WARP) {
    const Fe* src = t < 18 ? x : y;
    Fe* dst = t < 18 ? s.a : s.b;
    const int e = t % 18, i = e / 6, j = (e % 6) / 2, k = e % 2;
    const int m = j * 2 + k;
    dst[(i * 6 + j) * 3 + k] = i < 2 ? src[i * 6 + m] : svtpu::fadd(src[m], src[6 + m], f);
  }
  __syncwarp();
  // Fq6 level: x1 + x2, x0 + x1, x0 + x2
  for (int t = lane; t < 36; t += WARP) {
    Fe* dst = t < 18 ? s.a : s.b;
    const int e = t % 18, i = e / 6, jj = 3 + (e % 6) / 2, k = e % 2;
    const int p0 = jj == 3 ? 1 : 0, p1 = jj == 4 ? 1 : 2;
    dst[(i * 6 + jj) * 3 + k] = svtpu::fadd(dst[(i * 6 + p0) * 3 + k], dst[(i * 6 + p1) * 3 + k], f);
  }
  __syncwarp();
  // Fq2 level: c0 + c1
  for (int t = lane; t < 36; t += WARP) {
    Fe* dst = t < 18 ? s.a : s.b;
    const int q = t % 18;
    dst[q * 3 + 2] = svtpu::fadd(dst[q * 3], dst[q * 3 + 1], f);
  }
  __syncwarp();
  // the 54 Montgomery products, two per lane on lanes 0-21 (written side by
  // side so that the two chains overlap); lanes 22-31 repeat their first
  {
    const int t2 = lane + WARP < NPROD ? lane + WARP : lane;
    const Fe r0 = svtpu::fmul(s.a[lane], s.b[lane], f);
    const Fe r1 = svtpu::fmul(s.a[t2], s.b[t2], f);
    s.r[lane] = r0;
    if (t2 != lane) s.r[t2] = r1;
  }
  __syncwarp();
  // Fq2 products: (t0 - t1, t2 - (t0 + t1)), one per lane on lanes 0-17
  if (lane < 18) {
    const Fe r0 = s.r[lane * 3], r1 = s.r[lane * 3 + 1];
    s.q[lane * 2] = svtpu::fsub(r0, r1, f);
    s.q[lane * 2 + 1] = svtpu::fsub(s.r[lane * 3 + 2], svtpu::fadd(r0, r1, f), f);
  }
  __syncwarp();
  // Fq6 products, with t_j = q[i][j], m12 = q[i][3], m01 = q[i][4], m02 = q[i][5]:
  // d0 = m12 - (t1 + t2), d1 = m01 - (t0 + t1), d2 = m02 - (t0 + t2)
  if (lane < 18) {
    const int i = lane / 6, m = (lane % 6) / 2, c = lane % 2;
    const Fe* q = s.q + i * 12;
    const int p0 = m == 0 ? 1 : 0, p1 = m == 1 ? 1 : 2;
    s.d[lane] = svtpu::fsub(q[(3 + m) * 2 + c], svtpu::fadd(q[p0 * 2 + c], q[p1 * 2 + c], f), f);
  }
  __syncwarp();
  // u0 = t0 + xi d0, u1 = d1 + xi t2, u2 = d2 + t1; and, on lanes 18-19,
  // v = xi * (d2 + t1) of i = 1, the value u[1][2] takes
  if (lane >= 18 && lane < 20) {
    const Fe w0 = svtpu::fadd(s.d[10], s.q[14], f), w1 = svtpu::fadd(s.d[11], s.q[15], f);
    s.v[lane - 18] = xi_comp(w0, w1, lane - 18, f);
  } else if (lane < 18) {
    const int i = lane / 6, m = (lane % 6) / 2, c = lane % 2;
    const Fe* q = s.q + i * 12;
    const Fe* d = s.d + i * 6;
    Fe r;
    if (m == 0) r = svtpu::fadd(q[c], xi_comp(d[0], d[1], c, f), f);
    else if (m == 1) r = svtpu::fadd(d[2 + c], xi_comp(q[4], q[5], c, f), f);
    else r = svtpu::fadd(d[4 + c], q[2 + c], f);
    s.u[lane] = r;
  }
  __syncwarp();
  // c0 = u0 + v u1 with v (x0, x1, x2) = (xi x2, x0, x1); c1 = u2 - (u0 + u1)
  if (lane < NC) {
    const int l = lane / 6, j = (lane % 6) / 2, c = lane % 2;
    const Fe* u0 = s.u;
    const Fe* u1 = s.u + 6;
    const Fe* u2 = s.u + 12;
    const int o = j * 2 + c;
    Fe r;
    if (l == 1) r = svtpu::fsub(u2[o], svtpu::fadd(u0[o], u1[o], f), f);
    else if (j == 0) r = svtpu::fadd(u0[c], s.v[c], f);
    else r = svtpu::fadd(u0[o], u1[o - 2], f);
    out[lane] = r;
  }
  __syncwarp();
}

__device__ __forceinline__ void load_fq12(Fe* dst, const int64_t* src, int64_t n, int64_t e, int lane) {
  if (lane < NC) dst[lane] = svtpu::load_fe(src + (lane * n + e) * 16);
}

__device__ __forceinline__ void store_fq12(int64_t* dst, const Fe* src, int64_t n, int64_t e, int lane) {
  if (lane < NC) svtpu::store_fe(dst + (lane * n + e) * 16, src[lane]);
}

__global__ void __launch_bounds__(MUL_WARPS * WARP)
fq12_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int64_t* __restrict__ out, int64_t n, Field f) {
  __shared__ Fe xs[MUL_WARPS][NC], ys[MUL_WARPS][NC];
  __shared__ MulScratch scratch[MUL_WARPS];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * MUL_WARPS + warp;
  if (e >= n) return;  // a whole warp leaves; no block-wide barrier follows
  load_fq12(xs[warp], a, n, e, lane);
  load_fq12(ys[warp], b, n, e, lane);
  __syncwarp();
  warp_mul(xs[warp], xs[warp], ys[warp], scratch[warp], lane, f);
  store_fq12(out, xs[warp], n, e, lane);
}

// ---- the Miller loop -------------------------------------------------------

// Lane e of the doubled batch (one block of one warp each) evaluates key
// (e >= half)'s lines at (px[e], py[e]).  Tape: lam and c3 (steps, 2 keys,
// 2 Fq2 components, 16), is_dbl (steps).  Per step: f = f^2 if the step
// doubles, then f = f * line with line = ((py, 0, 0), (lam * -px, c3, 0)).
__global__ void __launch_bounds__(WARP)
miller_loop_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                   const int64_t* __restrict__ lam, const int64_t* __restrict__ c3,
                   const int64_t* __restrict__ is_dbl, int64_t* __restrict__ out, int64_t n2,
                   int64_t half, int steps, Field f) {
  __shared__ Fe fv[NC], line[NC], lam_px[2 * MAX_STEPS];
  __shared__ MulScratch scratch;
  const int64_t e = blockIdx.x;
  const int lane = threadIdx.x;
  const int key = e >= half ? 1 : 0;
  const Fe neg_px = fneg(svtpu::load_fe(px + e * 16), f);
  for (int t = lane; t < 2 * steps; t += WARP) {  // every step's lam * (-px), in parallel
    lam_px[t] = svtpu::fmul(svtpu::load_fe(lam + (((t >> 1) * 2 + key) * 2 + (t & 1)) * 16), neg_px, f);
  }
  if (lane < NC) {
    fv[lane] = lane == 0 ? svtpu::mont_one(f) : svtpu::fzero();
    line[lane] = lane == 0 ? svtpu::load_fe(py + e * 16) : svtpu::fzero();
  }
  __syncwarp();
  for (int st = 0; st < steps; ++st) {
    if (is_dbl[st]) warp_mul(fv, fv, fv, scratch, lane, f);
    if (lane < 4) {
      line[6 + lane] = lane < 2 ? lam_px[2 * st + lane]
                                : svtpu::load_fe(c3 + ((st * 2 + key) * 2 + lane - 2) * 16);
    }
    __syncwarp();
    warp_mul(fv, fv, line, scratch, lane, f);
  }
  store_fq12(out, fv, n2, e, lane);
}

// ---- the final exponentiation ----------------------------------------------

// a^(p-2) (0 -> 0) on one thread: 4-bit windows, most significant first,
// with the 16 powers of a in shared memory.
__device__ Fe fermat_inv(const Fe& a, Fe* table, const Field& f) {
  uint32_t e[svtpu::NW];
#pragma unroll
  for (int j = 0; j < svtpu::NW; ++j) e[j] = f.p[j];
  e[0] -= 2;  // p is odd and its low word is above 2: no borrow
  table[0] = svtpu::mont_one(f);
  table[1] = a;
  for (int k = 2; k < 16; ++k) table[k] = svtpu::fmul(table[k - 1], a, f);
  Fe acc = table[0];
  for (int w = 8 * svtpu::NW - 1; w >= 0; --w) {
    for (int k = 0; k < 4; ++k) acc = svtpu::fmul(acc, acc, f);
    const uint32_t d = (e[w / 8] >> (4 * (w % 8))) & 15u;
    if (d) acc = svtpu::fmul(acc, table[d], f);
  }
  return acc;
}

struct FinalExpShared {
  Fe slot[14][NC];
  Fe frob[2][6][2];  // Frobenius coefficients (power, Fq2 slot, component)
  Fe c6[3][2];       // the Fq6 inverse's cofactors, then the result
  Fe ninv[2];        // the Fq2 inverse of the Fq6 norm
  Fe powers[16];     // Fermat table
  MulScratch scratch;
};

__global__ void __launch_bounds__(WARP)
final_exp_kernel(const int64_t* __restrict__ f1, const int64_t* __restrict__ f2,
                 const uint8_t* __restrict__ lhs_inf, const uint8_t* __restrict__ rhs_inf,
                 const int64_t* __restrict__ frob, int64_t* __restrict__ out, int64_t n,
                 uint64_t bn_x, Field f) {
  __shared__ FinalExpShared sh;
  const int64_t e = blockIdx.x;
  const int lane = threadIdx.x;
  enum { F, Y0, TMP, FU, FU2, FU3, Y1, Y2, Y3, Y4, Y5, Y6, T0, T1 };
  Fe(*s)[NC] = sh.slot;

  auto mul = [&](int dst, int x, int y) { warp_mul(s[dst], s[x], s[y], sh.scratch, lane, f); };
  auto conj = [&](int dst, int x) {  // (a0, -a1)
    if (lane < NC) s[dst][lane] = lane < 6 ? s[x][lane] : fneg(s[x][lane], f);
    __syncwarp();
  };
  auto frob_map = [&](int dst, int x, int power) {  // each Fq2 slot (conjugated if odd) times its coefficient
    if (lane < 6) {
      Fq2 a = {s[x][2 * lane], s[x][2 * lane + 1]};
      if (power & 1) a.c1 = fneg(a.c1, f);
      const Fq2 r = f2mul(a, {sh.frob[power - 1][lane][0], sh.frob[power - 1][lane][1]}, f);
      s[dst][2 * lane] = r.c0;
      s[dst][2 * lane + 1] = r.c1;
    }
    __syncwarp();
  };
  auto pow_x = [&](int dst, int x) {  // x^BN_X, left to right over BN_X's bits
    if (lane < NC) s[dst][lane] = s[x][lane];
    __syncwarp();
    for (int bit = 62 - __clzll(bn_x); bit >= 0; --bit) {
      mul(dst, dst, dst);
      if ((bn_x >> bit) & 1) mul(dst, dst, x);
    }
  };

  if (lane < 24) {
    const int c = lane >> 1;
    sh.frob[c / 6][c % 6][lane & 1] = svtpu::load_fe(frob + lane * 16);
  }
  // _combine: f1 * f2 with an identity input's loop value replaced by one
  const bool inf1 = lhs_inf[e] != 0, inf2 = rhs_inf[e] != 0;
  if (lane < NC) {
    const Fe one = lane == 0 ? svtpu::mont_one(f) : svtpu::fzero();
    s[T0][lane] = inf1 ? one : svtpu::load_fe(f1 + (lane * n + e) * 16);
    s[T1][lane] = inf2 ? one : svtpu::load_fe(f2 + (lane * n + e) * 16);
  }
  __syncwarp();
  mul(F, T0, T1);

  // the inverse: conj(f) * N^-1 with N = f conj(f) = a0^2 - v a1^2 in Fq6
  conj(Y1, F);
  mul(TMP, F, Y1);  // N in components 0-5, zeros in 6-11
  if (lane < 3) {   // cofactors c0 = n0^2 - xi n1 n2, c1 = xi n2^2 - n0 n1, c2 = n1^2 - n0 n2
    const Fq2 n0 = {s[TMP][0], s[TMP][1]}, n1 = {s[TMP][2], s[TMP][3]}, n2 = {s[TMP][4], s[TMP][5]};
    Fq2 c;
    if (lane == 0) c = f2sub(f2mul(n0, n0, f), f2xi(f2mul(n1, n2, f), f), f);
    else if (lane == 1) c = f2sub(f2xi(f2mul(n2, n2, f), f), f2mul(n0, n1, f), f);
    else c = f2sub(f2mul(n1, n1, f), f2mul(n0, n2, f), f);
    sh.c6[lane][0] = c.c0;
    sh.c6[lane][1] = c.c1;
  }
  __syncwarp();
  if (lane == 0) {  // norm = n0 c0 + xi (n2 c1 + n1 c2) in Fq2, then its inverse
    const Fq2 n0 = {s[TMP][0], s[TMP][1]}, n1 = {s[TMP][2], s[TMP][3]}, n2 = {s[TMP][4], s[TMP][5]};
    const Fq2 c0 = {sh.c6[0][0], sh.c6[0][1]}, c1 = {sh.c6[1][0], sh.c6[1][1]}, c2 = {sh.c6[2][0], sh.c6[2][1]};
    const Fq2 nm = f2add(f2mul(n0, c0, f), f2xi(f2add(f2mul(n2, c1, f), f2mul(n1, c2, f), f), f), f);
    const Fe t = svtpu::fadd(svtpu::fmul(nm.c0, nm.c0, f), svtpu::fmul(nm.c1, nm.c1, f), f);
    const Fe ti = fermat_inv(t, sh.powers, f);
    sh.ninv[0] = svtpu::fmul(nm.c0, ti, f);
    sh.ninv[1] = fneg(svtpu::fmul(nm.c1, ti, f), f);
  }
  __syncwarp();
  if (lane < 3) {  // N^-1 = c * ninv, as the Fq12 (N^-1, 0)
    const Fq2 r = f2mul({sh.c6[lane][0], sh.c6[lane][1]}, {sh.ninv[0], sh.ninv[1]}, f);
    s[TMP][2 * lane] = r.c0;
    s[TMP][2 * lane + 1] = r.c1;
  } else if (lane < NC && lane >= 6) {
    s[TMP][lane] = svtpu::fzero();
  }
  __syncwarp();
  mul(TMP, Y1, TMP);  // f^-1

  // easy part: f^((p^6 - 1)(p^2 + 1))
  mul(F, Y1, TMP);
  frob_map(TMP, F, 2);
  mul(F, TMP, F);

  // hard part: f^((p^4 - p^2 + 1) / r), util/bn254.final_exponentiation_chain
  frob_map(Y0, F, 1);   // fp
  frob_map(TMP, F, 2);  // fp2
  mul(Y0, Y0, TMP);
  frob_map(TMP, TMP, 1);  // fp3
  mul(Y0, Y0, TMP);       // y0 = fp fp2 fp3
  pow_x(FU, F);
  pow_x(FU2, FU);
  pow_x(FU3, FU2);
  frob_map(TMP, FU, 1);
  conj(Y3, TMP);         // y3 = conj(frob(fu))
  frob_map(TMP, FU2, 1);  // fu2p
  mul(Y4, FU, TMP);
  conj(Y4, Y4);          // y4 = conj(fu fu2p)
  frob_map(Y2, FU2, 2);  // y2
  conj(Y5, FU2);         // y5
  frob_map(TMP, FU3, 1);  // fu3p
  mul(Y6, FU3, TMP);
  conj(Y6, Y6);  // y6 = conj(fu3 fu3p)
  conj(Y1, F);   // y1
  mul(T0, Y6, Y6);
  mul(T0, T0, Y4);
  mul(T0, T0, Y5);
  mul(T1, Y3, Y5);
  mul(T1, T1, T0);
  mul(T0, T0, Y2);
  mul(T1, T1, T1);
  mul(T1, T1, T0);
  mul(T1, T1, T1);
  mul(T0, T1, Y1);
  mul(T1, T1, Y0);
  mul(T0, T0, T0);
  mul(T0, T0, T1);
  store_fq12(out, s[T0], n, e, lane);
}

}  // namespace

extern "C" int svtpu_fq12_mul(const void* a, const void* b, void* out, int64_t n,
                              const void* field_words, void* stream) {
  if (n <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  fq12_mul_kernel<<<svtpu::grid_for(n, MUL_WARPS), MUL_WARPS * WARP, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b), static_cast<int64_t*>(out),
      n, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_miller_loop(const void* px, const void* py, const void* lam, const void* c3,
                                 const void* is_dbl, void* out, int64_t n2, int64_t half,
                                 int steps, const void* field_words, void* stream) {
  if (n2 <= 0) return 0;
  if (steps < 0 || steps > MAX_STEPS) return static_cast<int>(cudaErrorInvalidValue);
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  miller_loop_kernel<<<static_cast<unsigned>(n2), WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(px), static_cast<const int64_t*>(py),
      static_cast<const int64_t*>(lam), static_cast<const int64_t*>(c3),
      static_cast<const int64_t*>(is_dbl), static_cast<int64_t*>(out), n2, half, steps, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svtpu_final_exp(const void* f1, const void* f2, const void* lhs_inf,
                               const void* rhs_inf, const void* frob, void* out, int64_t n,
                               uint64_t bn_x, const void* field_words, void* stream) {
  if (n <= 0) return 0;
  const svtpu::Field f = svtpu::field_from_host(static_cast<const uint32_t*>(field_words));
  final_exp_kernel<<<static_cast<unsigned>(n), WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(f1), static_cast<const int64_t*>(f2),
      static_cast<const uint8_t*>(lhs_inf), static_cast<const uint8_t*>(rhs_inf),
      static_cast<const int64_t*>(frob), static_cast<int64_t*>(out), n, bn_x, f);
  return static_cast<int>(cudaGetLastError());
}
