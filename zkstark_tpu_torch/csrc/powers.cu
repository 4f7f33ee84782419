// Kernel: the geometric sequence [scale·base^j for j < n] in Montgomery form.
//
// Counterpart of zkstark_tpu/field/fp.py:469 device_powers_f and :484
// powers_iota_f, which XLA compiled into one elementwise program on the TPU
// (powers_iota_f: log2(n) selects and products an element, from its index
// bits). As plain tensor ops that is log2(n) rounds of int64 temporaries of
// the whole vector; here it is one launch that writes each word once.
//
// Bound by bytes: 4 written a word against about one product (6 integer ops)
// a word. base^j = A[j >> s]·B[j & (2^s - 1)], the two-table form of geo.cuh,
// with scale folded into A; the tables (about 2·sqrt(n) words) are built on
// the host and kept on the device per (field, base, n, scale) by
// ops/powers.py. One product and a share of two cached loads a word. A thread
// writes kGroups groups of 4 consecutive words with one 16-byte store each (a
// warp 512 contiguous bytes), a block's groups 4·kThreads words apart. Tables
// of fewer than 4 words: one word a thread. (Building base^j0 from the bits
// of a thread's first index instead, with the powers base^(2^b) passed by
// value, ran at half this speed on the card: PERF.md.)
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;  // groups of 4 words a thread

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    powers_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ ta,
                  const uint32_t* __restrict__ tb, int shift, int64_t n, Fp f) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kGroups;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {  // a block's groups kThreads·VEC words apart
    const int64_t j = (first + g * kThreads + threadIdx.x) * VEC;
    if (j >= n) return;
    const uint32_t a = __ldg(ta + (j >> shift));
    const int64_t k = j & ((int64_t{1} << shift) - 1);
    if constexpr (VEC == 4) {
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(tb + k));
      *reinterpret_cast<uint4*>(out + j) =
          make_uint4(fp_mul_r(a, b.x, f), fp_mul_r(a, b.y, f), fp_mul_r(a, b.z, f),
                     fp_mul_r(a, b.w, f));
    } else {
      out[j] = fp_mul_r(a, __ldg(tb + k), f);
    }
  }
}

}  // namespace

// out: n words, 16-byte aligned; ta: (n >> shift) words, tb: 2^shift words,
// 16-byte aligned, both on the device; every input reduced below p.
extern "C" int zk_powers(uint32_t* out, int64_t n, const uint32_t* ta, const uint32_t* tb,
                         int shift, uint32_t p, uint32_t pinv, cudaStream_t stream) {
  if (n < 0 || n > (int64_t{1} << 40) || shift < 0 || shift > 31 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0u ||
      (reinterpret_cast<uintptr_t>(tb) & 15u) != 0u) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const Fp f{p, pinv};
    const bool vec = shift >= 2;  // a group of 4 words shares its A word
    const int64_t per_block = static_cast<int64_t>(kThreads) * kGroups * (vec ? 4 : 1);
    const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
    if (vec) {
      powers_kernel<4><<<blocks, kThreads, 0, stream>>>(out, ta, tb, shift, n, f);
    } else {
      powers_kernel<1><<<blocks, kThreads, 0, stream>>>(out, ta, tb, shift, n, f);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
