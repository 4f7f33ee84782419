// Kernel: the composition's inverse denominators, every constraint and point
// of the coset domain in one launch.
//
// Counterpart of zkstark_tpu/protocol/prover.py:53-160 composition_constants
// (fp.inv_f, a 32-step Fermat scan, and fp.powers_iota_f of field/fp.py:450,
// 484), which builds one vector a constraint over the coset
// x_j = offset·h^j, j < d:
//
//   Boundary(step):       1/(x_j - g^step)
//   Transition(exempt):   Π_{e ∈ exempt} (x_j - g^e) · 1/(x_j^n - 1)
//
// written as rows of one (n_constraints, d) tensor of Montgomery words, in
// alpha order. What the design does about each part:
//  * x_j comes from the two small tables of the geometric scale (the host's
//    ops/ntt_kernel.py GeoScale, as composition.cu reads them) and the offset;
//    no vector of the domain exists.
//  * x_j^n = offset^n·(h^n)^j takes only `blowup` values (h^n has order
//    d/n = blowup), so 1/(x_j^n - 1) is a table of `blowup` words made on the
//    host and read at j mod blowup: a transition costs one product a
//    point and exempt point.
//  * The boundaries need a true inversion a point. A thread takes kTile points
//    (kThreads apart, so that a warp's stores stay contiguous), forms the
//    prefix products of their denominators, inverts the last one by Fermat
//    (x^(p-2): 32 squarings and up to 32 products) and walks back, two
//    products a point: Montgomery's batch inversion, 3 + 64/kTile products a
//    point and constraint instead of 64. The denominators are never 0 (the
//    coset is disjoint from <g>), and points past d take 1.
// The constraint system and the table arrive by value as kernel parameters
// (the host's ops/constants.py encodes them): no upload, no device table.
// Every operand is a reduced residue and every op returns the one residue in
// [0, p), so the words equal those of the JAX package's form.
//
// Bound by the operations at these sizes: two boundary rows cost about 2·(3 +
// 64/8 + 2) products of 6 ops a point against 4 bytes a point and row written.
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;
constexpr int kMaxWords = 768;  // the encoded system and the table, words

struct ConstArgs {
  const uint32_t* ga;  // h^(j >> shift << shift), Montgomery
  const uint32_t* gb;  // h^(j & mask), Montgomery
  int shift;
  uint32_t offset;     // the coset offset, Montgomery
  uint32_t one;        // R mod p
  uint32_t* out;       // (n_constraints, d)
  int64_t d;
  int zmask;           // blowup - 1
  int ztab;            // where the table of 1/(x^n - 1) starts in `words`
  Fp field;
  // [n_constraints] then per constraint [0, g^step] or [1, n_exempt, g^e...],
  // all Montgomery; from `ztab` on, 1/(x_j^n - 1) at j mod blowup
  uint32_t words[kMaxWords];
};

__device__ __forceinline__ uint32_t fermat_inverse(uint32_t a, uint32_t one, Fp f) {
  const uint32_t e = f.p - 2u;
  uint32_t r = one;
  for (int bit = 31; bit >= 0; --bit) {
    r = fp_mul_r(r, r, f);
    if ((e >> bit) & 1u) r = fp_mul_r(r, a, f);
  }
  return r;
}

__global__ void __launch_bounds__(kThreads) constants_kernel(const ConstArgs a) {
  const Fp f = a.field;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile * kThreads + threadIdx.x;
  const uint32_t mask = (1u << a.shift) - 1u;
  uint32_t x[kTile];
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const int64_t j = base + static_cast<int64_t>(k) * kThreads;
    const uint32_t jj = static_cast<uint32_t>(j < a.d ? j : 0);
    x[k] = fp_mul_r(fp_mul_r(__ldg(a.ga + (jj >> a.shift)), __ldg(a.gb + (jj & mask)), f),
                    a.offset, f);
  }
  const int n_con = static_cast<int>(a.words[0]);
  int w = 1;
  for (int c = 0; c < n_con; ++c) {
    uint32_t v[kTile];
    if (a.words[w] == 0u) {  // a boundary: batch inversion of x - g^step
      const uint32_t point = a.words[w + 1];
      w += 2;
      uint32_t pre[kTile];
      uint32_t acc = a.one;
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const bool in = base + static_cast<int64_t>(k) * kThreads < a.d;
        v[k] = in ? fp_sub(x[k], point, f) : a.one;
        pre[k] = acc;
        acc = fp_mul_r(acc, v[k], f);
      }
      uint32_t inv = fermat_inverse(acc, a.one, f);
#pragma unroll
      for (int k = kTile - 1; k >= 0; --k) {
        const uint32_t den = v[k];
        v[k] = fp_mul_r(inv, pre[k], f);
        inv = fp_mul_r(inv, den, f);
      }
    } else {  // a transition: the exempt factors times the table's 1/(x^n - 1)
      const int n_ex = static_cast<int>(a.words[w + 1]);
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const int64_t j = base + static_cast<int64_t>(k) * kThreads;
        v[k] = a.words[a.ztab + (static_cast<int>(j) & a.zmask)];
      }
      for (int e = 0; e < n_ex; ++e) {
        const uint32_t ge = a.words[w + 2 + e];
#pragma unroll
        for (int k = 0; k < kTile; ++k) v[k] = fp_mul_r(fp_sub(x[k], ge, f), v[k], f);
      }
      w += 2 + n_ex;
    }
    uint32_t* row = a.out + static_cast<int64_t>(c) * a.d;
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int64_t j = base + static_cast<int64_t>(k) * kThreads;
      if (j < a.d) __stcs(row + j, v[k]);
    }
  }
}

}  // namespace

// words: n_words host words, the encoded constraint system and from ztab on
// the table of 1/(x_j^n - 1) (`blowup` = zmask + 1 words); ga, gb, shift: the
// two-table form of h^j for j < d; offset, one: Montgomery; out: (n_constraints,
// d). 1 <= d <= 2^32.
extern "C" int zk_constants(const uint32_t* words, int n_words, int ztab, int zmask,
                            const uint32_t* ga, const uint32_t* gb, int shift, uint32_t offset,
                            uint32_t one, uint32_t* out, int64_t d, uint32_t p, uint32_t pinv,
                            cudaStream_t stream) {
  if (n_words < 1 || n_words > kMaxWords || ztab < 1 || zmask < 0 || (zmask & (zmask + 1)) ||
      ztab + zmask >= n_words || d < 1 || d > (1LL << 32) || shift < 0 || shift > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConstArgs a{ga, gb, shift, offset, one, out, d, zmask, ztab, Fp{p, pinv}, {}};
  for (int i = 0; i < n_words; ++i) a.words[i] = words[i];
  const int64_t per_block = static_cast<int64_t>(kTile) * kThreads;
  const int64_t blocks = (d + per_block - 1) / per_block;
  constants_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
