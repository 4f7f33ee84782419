// The witness of each AIR of ``protocol/air.py``: its recurrence as one
// compiled host loop over F_p, for any odd prime p < 2^32.
//
// A trace of one column is a sequence; mulfib8's is a row of 8 registers a
// step, each written to its own column (column-major, the layout the
// prover's LDE takes: one column after the other).
//
// Built by g++ (``protocol/witness.py``), not by nvcc: the kernel build
// takes ``csrc/*.cu`` only. A plain C interface, loaded with ctypes, which
// releases the GIL for the call.
//
// The state is held in Montgomery form (x·2^32 mod p), so each step costs
// multiplies and no division, and each row's word is written in the same
// pass: the Montgomery word itself, or x·r mod p for another factor r (r = 1:
// the canonical value). Every product of two residues is reduced before any
// sum. p > 2^31.5 for the stark-101 prime, so the REDC sum t + m·p can pass
// 2^64: it is added by 32-bit halves.

#include <algorithm>
#include <cstdint>

namespace {

// The recurrence kinds; protocol/air.py names them (`Air.recurrence`).
enum Kind : int { kFibonacciSq = 0, kFibonacci = 1, kSquareChain = 2, kWork = 3, kMulfib8 = 4 };

struct Fp {
  uint64_t p;
  uint32_t p_inv_neg;  // −p^{-1} mod 2^32

  // a·b·2^{-32} mod p for a, b < p: t < p² < p·2^32, so the REDC result is
  // below 2p before its one conditional subtraction.
  inline uint64_t mul(uint64_t a, uint64_t b) const {
    uint64_t t = a * b;
    uint64_t m = static_cast<uint32_t>(static_cast<uint32_t>(t) * p_inv_neg);
    // (t + m·p) / 2^32 by halves: the low halves sum to 0 or to 2^32
    uint64_t u = (t >> 32) + ((m * p) >> 32) + (static_cast<uint32_t>(t) != 0);
    return u >= p ? u - p : u;
  }

  inline uint64_t add(uint64_t a, uint64_t b) const {
    uint64_t s = a + b;  // < 2p < 2^33
    return s >= p ? s - p : s;
  }
};

// The rows given before the recurrence starts: [1, secret] for the two-term
// recurrences, [secret] for the one-term ones.
template <int K>
constexpr int64_t kSeedRows = (K == kFibonacciSq || K == kFibonacci) ? 2 : 1;

// The next state from the last two (a the older; the one-term recurrences
// read only b); c is the AIR's constant, Montgomery form.
template <int K>
inline uint64_t next(const Fp& f, uint64_t a, uint64_t b, uint64_t c) {
  if constexpr (K == kFibonacciSq) return f.add(f.mul(a, a), f.mul(b, b));
  if constexpr (K == kFibonacci) return f.add(a, b);
  if constexpr (K == kSquareChain) return f.add(f.mul(b, b), c);
  return f.add(f.mul(f.mul(b, b), b), c);  // kWork: b³ + c
}

// Up to kLanes recurrences step together, so that their dependent chains of
// multiplies overlap in the core. The loops over the lanes stay rolled:
// unrolled at -O3 they run no faster and triple the build's time.
constexpr int64_t kLanes = 8;

template <int K, bool kMontWords>
void run(const Fp& f, const uint32_t* secrets, int64_t batch, int64_t len, uint64_t c,
         uint64_t r, uint64_t one, uint64_t r2, uint32_t* out, uint32_t* last) {
  auto word = [&](uint64_t x) {
    return static_cast<uint32_t>(kMontWords ? x : f.mul(x, r));
  };
  for (int64_t b0 = 0; b0 < batch; b0 += kLanes) {
    const int64_t lanes = std::min(kLanes, batch - b0);
    uint64_t a[kLanes], b[kLanes];
    uint32_t* row[kLanes];
    #pragma GCC unroll 1
    for (int64_t l = 0; l < lanes; ++l) {
      row[l] = out + (b0 + l) * len;
      const uint64_t s = f.mul(secrets[b0 + l], r2);
      if (kSeedRows<K> == 2) {
        a[l] = one;
        b[l] = s;
        row[l][0] = word(one);
        if (len > 1) row[l][1] = word(s);
      } else {
        a[l] = 0;
        b[l] = s;
        row[l][0] = word(s);
      }
    }
    for (int64_t i = kSeedRows<K>; i < len; ++i) {
      #pragma GCC unroll 1
      for (int64_t l = 0; l < lanes; ++l) {
        const uint64_t x = next<K>(f, a[l], b[l], c);
        a[l] = b[l];
        b[l] = x;
        row[l][i] = word(x);
      }
    }
    // the last row's state: b, or a where a two-term trace has one row
    #pragma GCC unroll 1
    for (int64_t l = 0; l < lanes; ++l) {
      const uint64_t x = (kSeedRows<K> == 2 && len == 1) ? a[l] : b[l];
      last[b0 + l] = static_cast<uint32_t>(f.mul(x, 1));
    }
  }
}

// Winterfell's mulfib8: 8 registers a row, row 0 = 1, b, s0·s1, …, s_j =
// s_{j−2}·s_{j−1}; the next row s0' = s6·s7, s1' = s7·s0', s_j' =
// s_{j−2}'·s_{j−1}'. Register j of row i goes to column j: out + (b·8 + j)·len
// + i. last is s6 of the last row, the statement's result.
constexpr int kRegs = 8;

template <bool kMontWords>
void run_mulfib8(const Fp& f, const uint32_t* secrets, int64_t batch, int64_t len, uint64_t r,
                 uint64_t one, uint64_t r2, uint32_t* out, uint32_t* last) {
  auto word = [&](uint64_t x) {
    return static_cast<uint32_t>(kMontWords ? x : f.mul(x, r));
  };
  for (int64_t b = 0; b < batch; ++b) {
    uint32_t* col = out + b * kRegs * len;
    uint64_t s[kRegs];
    s[0] = one;
    s[1] = f.mul(secrets[b], r2);
    for (int j = 2; j < kRegs; ++j) s[j] = f.mul(s[j - 2], s[j - 1]);
    for (int64_t i = 0; i < len; ++i) {
      for (int j = 0; j < kRegs; ++j) col[j * len + i] = word(s[j]);
      if (i + 1 == len) break;
      const uint64_t s0 = f.mul(s[6], s[7]);
      s[1] = f.mul(s[7], s0);
      s[0] = s0;
      for (int j = 2; j < kRegs; ++j) s[j] = f.mul(s[j - 2], s[j - 1]);
    }
    last[b] = static_cast<uint32_t>(f.mul(s[6], 1));
  }
}

template <int K>
void dispatch(const Fp& f, const uint32_t* secrets, int64_t batch, int64_t len, uint64_t c,
              uint64_t r, uint64_t one, uint64_t r2, uint32_t* out, uint32_t* last) {
  if (r == one)
    run<K, true>(f, secrets, batch, len, c, r, one, r2, out, last);
  else
    run<K, false>(f, secrets, batch, len, c, r, one, r2, out, last);
}

}  // namespace

// `batch` traces of `len` rows into out (batch × len, row-major): row i of
// trace j is x_i·r mod p, x the recurrence `kind` from secrets[j] (< p) with
// the constant c (< p). last[j] is the trace's last value x_{len−1}
// (canonical). r < p. Returns 0, or 1 for an unknown kind. kMulfib8 writes
// batch × 8 × len (each trace's 8 columns) and ignores c; its last[j] is
// register 6 of the last row.
extern "C" int zk_witness(int kind, const uint32_t* secrets, int64_t batch, int64_t len,
                          uint32_t c, uint32_t r, uint32_t p, uint32_t p_inv_neg,
                          uint32_t* out, uint32_t* last) {
  const Fp f{p, p_inv_neg};
  const uint64_t one = (uint64_t{1} << 32) % p;  // 2^32 mod p: the Montgomery form of 1
  const uint64_t r2 = one * one % p;             // 2^64 mod p: mul(x, r2) = x·2^32
  const uint64_t cm = f.mul(c, r2);
  switch (kind) {
    case kFibonacciSq:
      dispatch<kFibonacciSq>(f, secrets, batch, len, cm, r, one, r2, out, last);
      return 0;
    case kFibonacci:
      dispatch<kFibonacci>(f, secrets, batch, len, cm, r, one, r2, out, last);
      return 0;
    case kSquareChain:
      dispatch<kSquareChain>(f, secrets, batch, len, cm, r, one, r2, out, last);
      return 0;
    case kWork:
      dispatch<kWork>(f, secrets, batch, len, cm, r, one, r2, out, last);
      return 0;
    case kMulfib8:
      if (r == one)
        run_mulfib8<true>(f, secrets, batch, len, r, one, r2, out, last);
      else
        run_mulfib8<false>(f, secrets, batch, len, r, one, r2, out, last);
      return 0;
    default:
      return 1;
  }
}
