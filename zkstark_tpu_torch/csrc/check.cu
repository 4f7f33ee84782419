// Test entry points: the fp.cuh device functions on explicit operands, so a
// check on the card can hold them against exact integers; an empty kernel,
// whose device time is the launch floor; and the text of a CUDA error code
// for the Python wrappers' exceptions.
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

__global__ void fp_check_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int64_t n, Fp f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = a[i], y = b[i];
  out[i] = fp_mul(x, y, f);
  out[n + i] = fp_add(x, y, f);
  out[2 * n + i] = fp_sub(x, y, f);
  out[3 * n + i] = fp_reduce(x, f);  // from_mont
  out[4 * n + i] = fp_mul_r(x, y, f);
  out[5 * n + i] = fp_add_r(x, y, f);
}

__global__ void empty_kernel() {}

}  // namespace

// a, b: (n,) uint32 -> out: (6, n) rows mont_mul, add, sub, from_mont(a), and the
// reduced-input forms fp_mul_r, fp_add_r (meaningful where a, b < p).
extern "C" int zk_fp_check(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                           uint32_t p, uint32_t pinv, cudaStream_t stream) {
  if (n < 0 || n > 0x7fffffffLL * 256) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    fp_check_kernel<<<blocks, 256, 0, stream>>>(a, b, out, n, Fp{p, pinv});
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel that does nothing: the floor under any launch's
// device time.
extern "C" int zk_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* zk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
