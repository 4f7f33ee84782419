// Montgomery arithmetic over F_p, p an odd prime < 2^32, R = 2^32.
//
// Device counterpart of zkstark_tpu/field/fp.py:318-427 (mont_reduce_f,
// mont_mul_f, add_f, sub_f). The TPU has no 32x32->64 multiply and builds it
// from 16-bit limbs; Hopper has it natively ((uint64_t)a*b, __umulhi), so the
// limb product and the p = 3*2^30+1 shift/add special case (_mp_hi) are not
// carried over.
//
// The trouble spot: p may exceed 2^31 (p = 3221225473), so 2p > 2^32.
//  * In REDC, t + m*p can exceed 2^64 and u = (t + m*p) / 2^32 can exceed
//    2^32. It is computed as hi(t) + hi(m*p) + (lo(t) != 0) in 64 bits
//    (the low words sum to 0 or 2^32 by the choice of m), which is exact,
//    then reduced once. A naive (t + (uint64_t)m*p) >> 32 overflows.
//  * In add, a + b can wrap 32 bits; the sum is taken in 64 bits.
// Both give the JAX results bit for bit, including on unreduced inputs.
//
// 2p > 2^32 also rules out lazy reduction: a value kept in [0, 2p) does not
// fit a word, so every add and subtract reduces to [0, p) at once.
//
// fp_mul_r and fp_add_r are the forms for operands known to be reduced
// (a, b < p), as every word inside the NTT row kernels and the FRI fold is:
// they stay in 32 bits and take about half the machine ops (fp_sub never
// needed more). On reduced operands they return the same words as fp_mul and
// fp_add (the one residue in [0, p)); on others they are not defined.
#pragma once

#include <cstdint>

struct Fp {
  uint32_t p;     // the prime
  uint32_t pinv;  // -p^{-1} mod 2^32
};

__device__ __forceinline__ uint32_t fp_reduce(uint64_t t, Fp f) {
  const uint32_t lo = static_cast<uint32_t>(t);
  const uint32_t hi = static_cast<uint32_t>(t >> 32);
  const uint32_t m = lo * f.pinv;
  const uint64_t u = static_cast<uint64_t>(hi) + __umulhi(m, f.p) + (lo != 0u ? 1u : 0u);
  return u >= f.p ? static_cast<uint32_t>(u - f.p) : static_cast<uint32_t>(u);
}

__device__ __forceinline__ uint32_t fp_mul(uint32_t a, uint32_t b, Fp f) {
  return fp_reduce(static_cast<uint64_t>(a) * b, f);
}

__device__ __forceinline__ uint32_t fp_add(uint32_t a, uint32_t b, Fp f) {
  const uint64_t s = static_cast<uint64_t>(a) + b;
  return s >= f.p ? static_cast<uint32_t>(s - f.p) : static_cast<uint32_t>(s);
}

__device__ __forceinline__ uint32_t fp_sub(uint32_t a, uint32_t b, Fp f) {
  const uint32_t d = a - b;
  return a < b ? d + f.p : d;
}

// a·b·R^{-1} mod p for a, b < p. With m = lo(t)·p^{-1} mod 2^32 the low words
// of t and m·p are equal, so (t - m·p)/2^32 = hi(t) - hi(m·p) exactly, a value
// in (-p, p): one borrow test brings it to [0, p).
__device__ __forceinline__ uint32_t fp_mul_r(uint32_t a, uint32_t b, Fp f) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(t) * (0u - f.pinv);
  const uint32_t hi = static_cast<uint32_t>(t >> 32);
  const uint32_t mph = __umulhi(m, f.p);
  const uint32_t d = hi - mph;
  return hi < mph ? d + f.p : d;
}

// a + b mod p for a, b < p, as a - (p - b) with one borrow test: no 33-bit sum.
__device__ __forceinline__ uint32_t fp_add_r(uint32_t a, uint32_t b, Fp f) {
  const uint32_t nb = f.p - b;
  const uint32_t d = a - nb;
  return a < nb ? d + f.p : d;
}

// Montgomery form -> standard residue (the reference's residue()): REDC of the
// word itself.
__device__ __forceinline__ uint32_t fp_from_mont(uint32_t a, Fp f) {
  return fp_reduce(static_cast<uint64_t>(a), f);
}
