// Kernel: the rank-1 endpoint fix of the trace interpolation.
//
// Counterpart of the correction in zkstark_tpu/protocol/air.py:423-440
// interpolate_trace, which XLA fused into the program around its INTT. The
// trace has n - 1 points on the size-n subgroup <g>; the INTT of it (the
// missing point taken as 0) gives c0, and the free value a_b at the missing
// point is chosen so that coefficient n - 1 vanishes:
//
//   c[b, j] = c0[b, j] + v[j]·a_b,   a_b = -c0[b, n-1] / v[n-1],
//   v = INTT(e_{n-1}),  v[j] = n^{-1}·g^{-(n-1)j} = n^{-1}·g^j.
//
// So v[j]·a_b = -c0[b, n-1]·g^{j+1}: every word is
//
//   c[b, j] = c0[b, j] - g^j·s_b,   s_b = c0[b, n-1]·g,
//
// with g^j from the two small tables of the geometric scale (geo.cuh, the
// host's ops/ntt_kernel.py GeoScale): no table of n words is read. Every
// operand is a reduced residue and every op returns the one residue in [0, p),
// so the words equal those of the reference's form.
//
// One launch for the whole batch at every n, including the four-step sizes
// where no row fits one block (2^21 and 2^25 for the 2^24 and 2^28 proofs):
// a thread takes four neighbouring words of one row. Bound by bytes (4 read,
// 4 written a word) against two products and a subtract a word. The output
// is a separate tensor: word n - 1 of a row, which every thread of the row
// reads, becomes 0.
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kThreads = 256;

struct FixArgs {
  const uint32_t* c0;  // (batch, n) Montgomery
  uint32_t* out;       // (batch, n) Montgomery
  const uint32_t* ga;  // g^(j >> shift << shift), Montgomery
  const uint32_t* gb;  // g^(j & mask), Montgomery
  int shift;
  uint32_t g;          // the generator, Montgomery
  int64_t n;
  Fp field;
};

template <int PER>
__global__ void __launch_bounds__(kThreads) endpoint_fix_kernel(const FixArgs a) {
  const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * PER;
  if (j0 >= a.n) return;
  const Fp f = a.field;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * a.n;
  const uint32_t s = fp_mul_r(__ldg(a.c0 + row + a.n - 1), a.g, f);
  const uint32_t mask = (1u << a.shift) - 1u;
  uint32_t v[PER];
  if constexpr (PER == 4) {
    const uint4 t = __ldcs(reinterpret_cast<const uint4*>(a.c0 + row + j0));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldcs(a.c0 + row + j0);
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const uint32_t j = static_cast<uint32_t>(j0 + e);
    const uint32_t gj = fp_mul_r(__ldg(a.ga + (j >> a.shift)), __ldg(a.gb + (j & mask)), f);
    v[e] = fp_sub(v[e], fp_mul_r(gj, s, f), f);
  }
  if constexpr (PER == 4) {
    __stcs(reinterpret_cast<uint4*>(a.out + row + j0), make_uint4(v[0], v[1], v[2], v[3]));
  } else {
    a.out[row + j0] = v[0];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

}  // namespace

// c0, out: (batch, n) uint32, not overlapping; ga, gb, shift: the two-table
// form of g^j for j < n; g: the generator of the size-n subgroup (Montgomery).
// 2 <= n <= 2^31, batch <= 65535.
extern "C" int zk_endpoint_fix(const uint32_t* c0, uint32_t* out, const uint32_t* ga,
                               const uint32_t* gb, int shift, uint32_t g, int64_t batch,
                               int64_t n, uint32_t p, uint32_t pinv, cudaStream_t stream) {
  if (batch < 0 || batch > 65535 || n < 2 || n > (1LL << 31) || shift < 0 || shift > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0) {
    const FixArgs a{c0, out, ga, gb, shift, g, n, Fp{p, pinv}};
    const bool vec = n % 4 == 0 && aligned16(c0) && aligned16(out);
    const int64_t threads = vec ? n / 4 : n;
    const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                    static_cast<unsigned>(batch));
    if (vec) {
      endpoint_fix_kernel<4><<<grid, kThreads, 0, stream>>>(a);
    } else {
      endpoint_fix_kernel<1><<<grid, kThreads, 0, stream>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
