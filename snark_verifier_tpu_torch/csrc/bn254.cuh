// Shared device routines for the BN254 kernels (K1-K9).
//
// Field elements cross the kernel boundary in the port's tensor layout: 16
// little-endian 16-bit limbs held as int64, Montgomery form with R = 2^256.
// Inside a kernel they are repacked into 8 x 32-bit words in registers.  R is
// 2^256 either way, so the Montgomery values, and every result, are identical
// to the JAX package's limb for limb.
//
// Semantics mirror snark_verifier_tpu/ops/field_pallas.py (tmul/tadd/tsub)
// and ops/curve_pallas.py (_add_core/_dbl_core) exactly, including for
// inputs that are not reduced below p: the Montgomery product is the unique
// (a*b + m*p) / 2^256 followed by one conditional subtract, and the point
// formulas run the same field operations on the same operands.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace svtpu {

constexpr int NW = 8;  // 32-bit words per field element

// Modulus words (little-endian) and the word-level Montgomery constant
// n0 = -p^-1 mod 2^32; derived on the host from util/bn254 and passed by value
// as a kernel parameter.
struct Field {
  uint32_t p[NW];
  uint32_t n0;
};

struct Fe {
  uint32_t w[NW];
};

struct G1 {
  Fe x, y, z;
};

inline Field field_from_host(const uint32_t* words) {
  Field f;
  for (int i = 0; i < NW; ++i) f.p[i] = words[i];
  f.n0 = words[NW];
  return f;
}

// ---- layout conversion: 16 x int64 16-bit limbs <-> 8 x u32 words ---------

__device__ __forceinline__ Fe load_fe(const int64_t* src) {
  const longlong2* s = reinterpret_cast<const longlong2*>(src);
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    longlong2 v = s[k];
    r.w[k] = static_cast<uint32_t>(v.x) | (static_cast<uint32_t>(v.y) << 16);
  }
  return r;
}

__device__ __forceinline__ void store_fe(int64_t* dst, const Fe& a) {
  longlong2* d = reinterpret_cast<longlong2*>(dst);
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    longlong2 v;
    v.x = static_cast<long long>(a.w[k] & 0xFFFFu);
    v.y = static_cast<long long>(a.w[k] >> 16);
    d[k] = v;
  }
}

// ---- 256-bit add / sub with carry-flag PTX ---------------------------------

// r = a + b; returns the carry out (0 or 1).
__device__ __forceinline__ uint32_t add_words(uint32_t r[NW], const uint32_t a[NW],
                                              const uint32_t b[NW]) {
  uint32_t c;
  const uint32_t zero = 0;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, %25, %25;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7]), "=r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(zero));
  return c;
}

// r = a - b; returns the borrow out (0 or 1).
__device__ __forceinline__ uint32_t sub_words(uint32_t r[NW], const uint32_t a[NW],
                                              const uint32_t b[NW]) {
  uint32_t bw;
  const uint32_t zero = 0;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %25, %25;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7]), "=r"(bw)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(zero));
  return bw & 1u;  // 0 - 0 - borrow: all ones when a borrow came out
}

// ---- modular add / sub (field_pallas.tadd / tsub) --------------------------

// (a + b), minus p when the sum carried out or is >= p.
__device__ __forceinline__ Fe fadd(const Fe& a, const Fe& b, const Field& f) {
  Fe s, d;
  const uint32_t carry = add_words(s.w, a.w, b.w);
  const uint32_t borrow = sub_words(d.w, s.w, f.p);
  return (carry || !borrow) ? d : s;
}

// (a - b), plus p when it borrowed (the carry of that add is dropped).
__device__ __forceinline__ Fe fsub(const Fe& a, const Fe& b, const Field& f) {
  Fe d, c;
  const uint32_t borrow = sub_words(d.w, a.w, b.w);
  add_words(c.w, d.w, f.p);
  return borrow ? c : d;
}

// ---- Montgomery product (field_pallas.tmul), CIOS on 32-bit words ----------

// a * b * 2^-256 mod p.  Each row adds a*b[i] and then m*p with
// m = t[0] * n0, which clears the low word; the sum of the m's is the unique
// m < 2^256 of the SOS form in ops/field.py, so the result is the same
// integer (a*b + m*p) / 2^256 < 2^256 + p, reduced by one conditional
// subtract.  The row products are 32x32->64 multiply-adds (IMAD.WIDE).
__device__ __forceinline__ Fe fmul(const Fe& a, const Fe& b, const Field& f) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c = static_cast<uint64_t>(a.w[j]) * b.w[i] + t[j] + (c >> 32);
      t[j] = static_cast<uint32_t>(c);
    }
    uint64_t s = static_cast<uint64_t>(t[NW]) + (c >> 32);
    t[NW] = static_cast<uint32_t>(s);
    t[NW + 1] = static_cast<uint32_t>(s >> 32);

    const uint32_t m = t[0] * f.n0;
    c = static_cast<uint64_t>(m) * f.p[0] + t[0];
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c = static_cast<uint64_t>(m) * f.p[j] + t[j] + (c >> 32);
      t[j - 1] = static_cast<uint32_t>(c);
    }
    s = static_cast<uint64_t>(t[NW]) + (c >> 32);
    t[NW - 1] = static_cast<uint32_t>(s);
    t[NW] = t[NW + 1] + static_cast<uint32_t>(s >> 32);
  }
  Fe r, d;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = t[j];
  const uint32_t borrow = sub_words(d.w, r.w, f.p);
  return (t[NW] || !borrow) ? d : r;
}

// ---- Montgomery product with two carry chains (mont_pow, K2, K3, K5, K6, K8) -

// acc[0..7] += the 8 words of the products x0..x3 * y placed at word pairs
// (0,1) (2,3) (4,5) (6,7), and top += the carry out: one carry chain of
// mad.lo.cc / madc.hi.cc in one asm statement.
__device__ __forceinline__ void mad_chain(uint32_t* acc, uint32_t& top, uint32_t x0, uint32_t x1, uint32_t x2,
                                          uint32_t x3, uint32_t y) {
  const uint32_t zero = 0;
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, %14;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]),
        "+r"(acc[7]), "+r"(top)
      : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(y), "r"(zero));
}

// e0 += f0, and its carry enters the chain that adds the odd-word products
// a1, a3, a5, a7 times y into f[1..8] (f[8] == 0 before), carry out into
// top (== 0 before).
__device__ __forceinline__ void merge_mad_chain(uint32_t& e0, uint32_t* f, uint32_t& top, const uint32_t* a,
                                                uint32_t y) {
  const uint32_t zero = 0;
  asm("add.cc.u32 %0, %0, %10;\n\t"
      "madc.lo.cc.u32 %1, %11, %15, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %15, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %15, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %15, %4;\n\t"
      "madc.lo.cc.u32 %5, %13, %15, %5;\n\t"
      "madc.hi.cc.u32 %6, %13, %15, %6;\n\t"
      "madc.lo.cc.u32 %7, %14, %15, %7;\n\t"
      "madc.hi.cc.u32 %8, %14, %15, %8;\n\t"
      "addc.u32 %9, %9, %16;"
      : "+r"(e0), "+r"(f[1]), "+r"(f[2]), "+r"(f[3]), "+r"(f[4]), "+r"(f[5]), "+r"(f[6]), "+r"(f[7]),
        "+r"(f[8]), "+r"(top)
      : "r"(f[0]), "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(y), "r"(zero));
}

// a * b * 2^-256 mod p, the same integer as fmul: CIOS rows, but each row's
// products go into two accumulators, E for the even words of a (and p), F
// for the odd ones, so every row is two carry chains of 8 multiply-adds
// that run side by side instead of one chain of 16 (fmul's 64-bit
// multiply-adds each wait on the carry word of the one before).  Between
// rows the sum is E + e8 2^256 + F, both at word 0; after the row's m * p
// the low word is 0 and the division by 2^32 only renames registers: F[1..8]
// becomes E, E[1..7] and e8 become F.  The first row needs no chain, and
// each later row starts by adding F[0] into E[0] (the carry enters F's
// chain).  Every carry is kept (f9, e8), so the result equals fmul's for
// any a, b < 2^256, not only reduced ones.  A word-level simulation of this
// schedule is held against (a b + m p) / 2^256 in tests/test_torch_field.py.
// Inside mont_pow on an H100 SXM (700 W) a product takes 0.43 us against
// fmul's 0.59 (chip_smoke.py).  K4, K7 and K9 keep fmul.
__device__ __forceinline__ Fe fmul_eo(const Fe& a, const Fe& b, const Field& f) {
  uint32_t E[NW], F[NW + 1], e8 = 0, f9 = 0;
#pragma unroll
  for (int k = 0; k < NW; k += 2) {
    E[k] = a.w[k] * b.w[0];
    E[k + 1] = __umulhi(a.w[k], b.w[0]);
    F[k + 1] = a.w[k + 1] * b.w[0];
    F[k + 2] = __umulhi(a.w[k + 1], b.w[0]);
  }
  F[0] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (i > 0) {
      F[NW] = 0;
      f9 = 0;
      merge_mad_chain(E[0], F, f9, a.w, b.w[i]);
      mad_chain(E, e8, a.w[0], a.w[2], a.w[4], a.w[6], b.w[i]);
    }
    const uint32_t m = E[0] * f.n0;
    mad_chain(E, e8, f.p[0], f.p[2], f.p[4], f.p[6], m);
    mad_chain(F + 1, f9, f.p[1], f.p[3], f.p[5], f.p[7], m);
    // divide by 2^32 (E[0] is 0 now): swap the accumulators' roles
    uint32_t nE[NW], nF[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      nE[k] = F[k + 1];
      nF[k] = k + 1 < NW ? E[k + 1] : e8;
    }
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      E[k] = nE[k];
      F[k] = nF[k];
    }
    e8 = f9;
  }
  Fe r, d;
  const uint32_t top = e8 + add_words(r.w, E, F);
  const uint32_t borrow = sub_words(d.w, r.w, f.p);
  return (top || !borrow) ? d : r;
}

__device__ __forceinline__ Fe fzero() {
  Fe r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = 0;
  return r;
}

// Montgomery one, R mod p = 2^256 mod p: 0 - p wrapped to 2^256 - p, then
// p subtracted while the value is still >= p (at most 5 times for BN254).
__device__ __forceinline__ Fe mont_one(const Field& f) {
  Fe r, d;
  const Fe z = fzero();
  sub_words(r.w, z.w, f.p);
  while (!sub_words(d.w, r.w, f.p)) r = d;
  return r;
}

__device__ __forceinline__ G1 g1_identity(const Field& f) {
  G1 r;
  r.x = fzero();
  r.y = mont_one(f);
  r.z = fzero();
  return r;
}

// 9 * t as the add chain 2t, 4t, 8t, 8t + t (b3 = 3 * b, b = 3).
__device__ __forceinline__ Fe mul_b3(const Fe& t, const Field& f) {
  const Fe t2 = fadd(t, t, f);
  const Fe t4 = fadd(t2, t2, f);
  const Fe t8 = fadd(t4, t4, f);
  return fadd(t8, t, f);
}

// ---- complete G1 formulas (Renes-Costello-Batina 2015, a = 0, b3 = 9) ------

// Algorithm 7, same operations and operands as curve_pallas._add_core.
__device__ __forceinline__ G1 g1_add(const G1& p, const G1& q, const Field& f) {
  Fe t0 = fmul(p.x, q.x, f);
  Fe t1 = fmul(p.y, q.y, f);
  Fe t2 = fmul(p.z, q.z, f);
  Fe t3 = fmul(fadd(p.x, p.y, f), fadd(q.x, q.y, f), f);
  t3 = fsub(t3, fadd(t0, t1, f), f);
  Fe t4 = fmul(fadd(p.y, p.z, f), fadd(q.y, q.z, f), f);
  t4 = fsub(t4, fadd(t1, t2, f), f);
  Fe x3 = fmul(fadd(p.x, p.z, f), fadd(q.x, q.z, f), f);
  Fe y3 = fsub(x3, fadd(t0, t2, f), f);
  x3 = fadd(t0, t0, f);
  t0 = fadd(x3, t0, f);
  t2 = mul_b3(t2, f);
  Fe z3 = fadd(t1, t2, f);
  t1 = fsub(t1, t2, f);
  y3 = mul_b3(y3, f);
  G1 r;
  r.x = fsub(fmul(t3, t1, f), fmul(t4, y3, f), f);
  r.y = fadd(fmul(t1, z3, f), fmul(y3, t0, f), f);
  r.z = fadd(fmul(z3, t4, f), fmul(t0, t3, f), f);
  return r;
}

// Algorithm 9, same operations and operands as curve_pallas._dbl_core.
__device__ __forceinline__ G1 g1_double(const G1& p, const Field& f) {
  Fe t0 = fmul(p.y, p.y, f);
  Fe z3 = fadd(t0, t0, f);
  z3 = fadd(z3, z3, f);
  z3 = fadd(z3, z3, f);
  Fe t1 = fmul(p.y, p.z, f);
  Fe t2 = mul_b3(fmul(p.z, p.z, f), f);
  Fe x3 = fmul(t2, z3, f);
  Fe y3 = fadd(t0, t2, f);
  z3 = fmul(t1, z3, f);
  t1 = fadd(t2, t2, f);
  t2 = fadd(t1, t2, f);
  t0 = fsub(t0, t2, f);
  y3 = fadd(fmul(t0, y3, f), x3, f);
  t1 = fmul(p.x, p.y, f);
  x3 = fmul(t0, t1, f);
  G1 r;
  r.x = fadd(x3, x3, f);
  r.y = y3;
  r.z = z3;
  return r;
}

// ---- one complete add on a group of lanes (K2 and K5) ----------------------

// Fe slots of one group's shared memory: p (0-2), q (3-5), the products of a
// level (6-11), the second level's operands (12-17).
constexpr int ADD_SLOTS = 18;

// 16-byte shared-memory moves of one Fe (slots are 32-byte aligned).
__device__ __forceinline__ Fe lds_fe(const Fe* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 a = q[0], b = q[1];
  Fe r;
  r.w[0] = a.x, r.w[1] = a.y, r.w[2] = a.z, r.w[3] = a.w;
  r.w[4] = b.x, r.w[5] = b.y, r.w[6] = b.z, r.w[7] = b.w;
  return r;
}

__device__ __forceinline__ void sts_fe(Fe* p, const Fe& v) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  q[1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

// c ? a : b, word by word: selects on values (a ternary on Fe lvalues
// selects an address and puts them in local memory).
__device__ __forceinline__ Fe fe_sel(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// Word j of a, as a select chain: no register array is indexed at run time.
__device__ __forceinline__ uint32_t fe_word(const Fe& a, int j) {
  uint32_t r = a.w[0];
#pragma unroll
  for (int k = 1; k < NW; ++k) r = j == k ? a.w[k] : r;
  return r;
}

// RCB15 alg. 7 (g1_add's operations and operands) on the G lanes of one
// group, lane k of it (G a power of two from 8 to 32; every lane of the
// warp runs this, `sync` names them).  On entry s[0..2] hold p and s[3..5]
// q; every lane returns p + q, and s[0..2] still hold p.  Its 12 products
// run as two levels of six independent products on lanes 0-5 (lanes 6 and
// up repeat lane 0's), with fmul_eo: level 1 {x1 x2, y1 y2, z1 z2,
// (x1 + y1)(x2 + y2), (y1 + z1)(y2 + z2), (x1 + z1)(x2 + z2)}, level 2
// {t3 t1, t4 y3, t1 z3, y3 t0, z3 t4, t0 t3}.  Lane k reads its own level-1
// operands from the slots and forms its own sums; the products go through
// the slots.  The modular adds between the levels (18 of them) are split
// over the lanes: lane r computes only level-2 operand r, the six chains in
// lockstep as six steps of one add (or an add and a sub, selected) on
// operands selected by the lane's role, and writes it; the longest chain,
// y3's, is six operations.  Each lane then reads its pair.  The output
// equals g1_add's bit for bit for any inputs below 2^256, since fmul_eo
// gives fmul's integer.
template <int G>
__device__ __forceinline__ G1 g1_add_group(Fe* s, int k, unsigned sync, const Field& f) {
  static_assert(G >= 8 && G <= 32 && (G & (G - 1)) == 0, "a group is 8, 16 or 32 lanes");
  const int role = k < 6 ? k : 0;
  // level 1: roles 0-2 the coordinates themselves, 3-5 the sums of (0, 1), (1, 2), (0, 2)
  const int ia = role < 3 ? role : (role == 4 ? 1 : 0);
  const int ib = role < 3 ? role : (role == 3 ? 1 : 2);
  const Fe pa = lds_fe(s + ia), pb = lds_fe(s + ib), qa = lds_fe(s + 3 + ia), qb = lds_fe(s + 3 + ib);
  const bool raw = role < 3;
  Fe prod = fmul_eo(fe_sel(raw, pa, fadd(pa, pb, f)), fe_sel(raw, qa, fadd(qa, qb, f)), f);
  if (k < 6) sts_fe(s + 6 + k, prod);
  __syncwarp(sync);
  const Fe t0 = lds_fe(s + 6), t1 = lds_fe(s + 7), t2 = lds_fe(s + 8);
  // slots 12-17 get t3 (role 0), t4 (1), y3 (2), t0 (3), z3 (4), t1 (5),
  // each the end of its role's chain:
  //   t3 = r3 - (t0 + t1); t4 = r4 - (t1 + t2); t0 = (t0 + t0) + t0;
  //   y = r5 - (t0 + t2), y3 = 9 y; 9 t2 = 8 t2 + t2, z3 = t1 + 9 t2, t1 = t1 - 9 t2
  const Fe rr = lds_fe(s + 9 + (role < 3 ? role : 0));
  Fe w = fadd(fe_sel(role == 1, t1, fe_sel(role >= 4, t2, t0)), fe_sel(role == 0, t1, fe_sel(role == 3, t0, t2)),
           f);  // step 1
  const Fe d = fsub(rr, w, f);  // step 2
  w = fe_sel(role < 3, d, fadd(w, fe_sel(role == 3, t0, w), f));
  const Fe y = w;
  if (k < 2 || k == 3) sts_fe(s + 12 + k, w);  // t3, t4, t0 are done
  w = fadd(w, w, f);                            // step 3: 2 y, 8 t2
  w = fadd(w, fe_sel(role == 2, w, t2), f);     // step 4: 4 y, 9 t2
  const Fe z = fadd(fe_sel(role == 2, w, t1), w, f);  // step 5: 8 y, z3
  w = fe_sel(role == 5, fsub(t1, w, f), z);     //         t1
  if (k == 4 || k == 5) sts_fe(s + 12 + k, w);
  w = fadd(w, y, f);  // step 6: y3 = 8 y + y
  if (k == 2) sts_fe(s + 12 + k, w);
  // level 2, role r multiplies slot 12 + ra by slot 12 + rb:
  // {t3 t1, t4 y3, t1 z3, y3 t0, z3 t4, t0 t3}
  const int ra = role == 2 ? 5 : (role == 3 ? 2 : (role == 5 ? 3 : role));
  const int rb = role == 0 ? 5 : (role == 1 ? 2 : (role == 2 ? 4 : (role == 3 ? 3 : (role == 4 ? 1 : 0))));
  __syncwarp(sync);
  prod = fmul_eo(lds_fe(s + 12 + ra), lds_fe(s + 12 + rb), f);
  if (k < 6) sts_fe(s + 6 + k, prod);  // every lane read level 1's products before the sync above
  __syncwarp(sync);
  G1 r;
  r.x = fsub(lds_fe(s + 6), lds_fe(s + 7), f);
  r.y = fadd(lds_fe(s + 8), lds_fe(s + 9), f);
  r.z = fadd(lds_fe(s + 10), lds_fe(s + 11), f);
  return r;
}

// ---- one complete doubling on a group of lanes (K3) ------------------------

// Fe slots of one doubling group: p (0-2), level 1's products a, b, c, d
// (3-6), level 2's operands t2, z3, y3, e (7-10), level 2's products (11-14).
constexpr int DBL_SLOTS = 15;
constexpr int DBL_GROUP = 4;  // lanes per doubling: one product of each level a lane

// RCB15 alg. 9 (g1_double's operations and operands) on the DBL_GROUP lanes
// of one group, lane k of it (every lane of the warp runs this, `sync`
// names them).  On entry s[0..2] hold p; every lane returns 2 p.  Its 8
// products run as two levels of four independent products, one a lane,
// with fmul_eo: level 1 {y y, y z, z z, x y} = {a, b, c, d}, level 2 {t2 z3,
// b z3, e y3, e d}.  The modular adds between the levels are split over the
// lanes by role, in lockstep on operands selected by the lane: lane 0 forms
// z3 = 8 a, lane 1 t2 = 9 c, lane 2 y3 = a + t2, lane 3 e = a - 3 t2, and
// writes it; the longest chain, e's, is 7 adds and a sub.  After level 2
// every lane forms x3 = 2 (e d), y3 = e y3 + t2 z3, z3 = b z3.  The output
// equals g1_double's bit for bit for any inputs below 2^256, since fmul_eo
// gives fmul's integer and a modular add's result depends only on the sum.
__device__ __forceinline__ G1 g1_double_group(Fe* s, int k, unsigned sync, const Field& f) {
  // level 1: lanes 0-3 multiply slots (1, 1), (1, 2), (2, 2), (0, 1)
  const int ia = k == 2 ? 2 : (k == 3 ? 0 : 1);
  const int ib = k == 1 || k == 2 ? 2 : 1;
  Fe prod = fmul_eo(lds_fe(s + ia), lds_fe(s + ib), f);
  sts_fe(s + 3 + k, prod);
  __syncwarp(sync);
  const Fe a = lds_fe(s + 3), c = lds_fe(s + 5);
  Fe w = fe_sel(k == 0, a, c);
  w = fadd(w, w, f);  // 2 a, 2 c
  w = fadd(w, w, f);  // 4 a, 4 c
  w = fadd(w, w, f);  // 8 a = z3, 8 c
  if (k == 0) sts_fe(s + 8, w);
  const Fe t2 = fadd(w, c, f);  // 9 c = t2
  if (k == 1) sts_fe(s + 7, t2);
  const Fe v = fadd(t2, fe_sel(k == 3, t2, a), f);  // y3 = a + t2; 2 t2
  if (k == 2) sts_fe(s + 9, v);
  const Fe e = fsub(a, fadd(v, t2, f), f);  // e = a - 3 t2
  if (k == 3) sts_fe(s + 10, e);
  // level 2: lanes 0-3 multiply slots (7, 8), (4, 8), (10, 9), (10, 6)
  const int ra = k == 0 ? 7 : (k == 1 ? 4 : 10);
  const int rb = k == 2 ? 9 : (k == 3 ? 6 : 8);
  __syncwarp(sync);
  prod = fmul_eo(lds_fe(s + ra), lds_fe(s + rb), f);
  sts_fe(s + 11 + k, prod);
  __syncwarp(sync);
  const Fe ed = lds_fe(s + 14);
  G1 r;
  r.x = fadd(ed, ed, f);
  r.y = fadd(lds_fe(s + 13), lds_fe(s + 11), f);
  r.z = lds_fe(s + 12);
  return r;
}

inline int grid_for(int64_t n, int block) {
  return static_cast<int>((n + block - 1) / block);
}

}  // namespace svtpu
