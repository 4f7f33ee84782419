// Kernel D: batched length-m constant-geometry (Pease) NTT row transforms.
//
// Replaces zkstark_tpu/ops/ntt_kernel.py _ntt_cols_pease_kernel. One block
// transforms one row of m <= 8192 Montgomery residues in shared memory
// (4*m bytes, 32 KB at m = 8192). Every stage has the same form: with
// h = m/2 and W_t[i] = tw[(i >> t) << t] (tw[j] = w^j, j < h),
//
//   a = x[i] + x[i+h],  b = W_t[i] * (x[i] - x[i+h]),  x'[2i] = a, x'[2i+1] = b.
//
// Natural order in, bit-reversed order out, as the TPU kernel. The last
// stage's twiddles are all w^0, so it skips the multiply: m/2 * (log2 m - 1)
// Montgomery multiplies in all, against m/2 * log2 m in ntt_rows.
//
// A stage reads i and i+h and writes 2i and 2i+1, so it cannot run in place.
// Each thread holds its pairs in registers across one barrier and writes
// them back into the same buffer, one 8-byte store per pair; there is no
// second buffer, so the block stays under the 48 KB that needs no opt-in.
// Like ntt_rows it is bound on chip (shared-memory traffic and integer
// multiplies per stage); each element crosses device memory once each way.
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxPairs = 8;  // (8192 / 2) / 512: pairs per thread at most

__global__ void ntt_rows_pease_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                                      const uint32_t* __restrict__ tw, int log_m, Fp f) {
  extern __shared__ __align__(16) uint32_t s[];
  uint2* s2 = reinterpret_cast<uint2*>(s);
  const int m = 1 << log_m;
  const int h = m >> 1;
  const int pairs = h / static_cast<int>(blockDim.x);  // blockDim.x divides h
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s[i] = x[base + i];
  }
  __syncthreads();
  for (int t = 0; t < log_m; ++t) {
    const bool last = t == log_m - 1;
    uint32_t a[kMaxPairs];
    uint32_t b[kMaxPairs];
#pragma unroll
    for (int r = 0; r < kMaxPairs; ++r) {
      if (r < pairs) {
        const int i = threadIdx.x + r * blockDim.x;
        const uint32_t top = s[i];
        const uint32_t bot = s[i + h];
        const uint32_t d = fp_sub(top, bot, f);
        a[r] = fp_add(top, bot, f);
        b[r] = last ? d : fp_mul(d, __ldg(tw + ((i >> t) << t)), f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxPairs; ++r) {
      if (r < pairs) {
        s2[threadIdx.x + r * blockDim.x] = make_uint2(a[r], b[r]);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    out[base + i] = s[i];
  }
}

}  // namespace

// x, out: (batch, 2^log_m) uint32; x natural order, out bit-reversed;
// tw: (2^(log_m - 1),) uint32 Montgomery powers of w; 1 <= log_m <= 13.
extern "C" int zk_ntt_rows_pease(const uint32_t* x, uint32_t* out, const uint32_t* tw, int log_m,
                                 int64_t batch, uint32_t p, uint32_t pinv, cudaStream_t stream) {
  if (log_m < 1 || log_m > 13 || batch < 0 || batch > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0) {
    const int m = 1 << log_m;
    const int threads = m / 2 < kMaxThreads ? m / 2 : kMaxThreads;
    const size_t smem = static_cast<size_t>(m) * sizeof(uint32_t);
    ntt_rows_pease_kernel<<<static_cast<unsigned>(batch), threads, smem, stream>>>(
        x, out, tw, log_m, Fp{p, pinv});
  }
  return static_cast<int>(cudaGetLastError());
}
