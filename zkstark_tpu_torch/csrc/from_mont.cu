// Kernel: Montgomery form -> standard residues, word by word.
//
// Counterpart of zkstark_tpu/field/fp.py from_mont_f where the JAX package
// applies it to the LDE's output before the trace commit
// (zkstark_tpu/parallel/pipeline.py:64, zkstark_tpu/protocol/fused.py:107),
// which XLA fused into the program around it. As plain tensor ops it widens
// every word to int64 (temporaries of 8 bytes a point: 2 GB each at 2^28
// points) in some twenty launches; here it is one REDC of each uint32 word
// (fp_from_mont of fp.cuh) in registers.
//
// Bound by bytes: 4 read and 4 written a word against one REDC (5 integer
// ops). A thread moves four words (one 16-byte load and store) where the
// pointers allow it, and a grid-stride loop keeps the grid at a few waves.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

template <int PER>
__global__ void __launch_bounds__(kThreads)
    from_mont_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t n,
                     Fp f) {
  const int64_t groups = n / PER;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    if constexpr (PER == 4) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(in) + g);
      __stcs(reinterpret_cast<uint4*>(out) + g,
             make_uint4(fp_from_mont(v.x, f), fp_from_mont(v.y, f), fp_from_mont(v.z, f),
                        fp_from_mont(v.w, f)));
    } else {
      out[g] = fp_from_mont(__ldcs(in + g), f);
    }
  }
  // the words past the last group of four (none when PER = 1)
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < n - groups * PER) out[groups * PER + t] = fp_from_mont(in[groups * PER + t], f);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

}  // namespace

// in, out: n uint32 words each (Montgomery in, standard residues out), not
// overlapping.
extern "C" int zk_from_mont(const uint32_t* in, uint32_t* out, int64_t n, uint32_t p,
                            uint32_t pinv, cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const Fp f{p, pinv};
    const bool vec = aligned16(in) && aligned16(out);
    const int64_t groups = vec ? n / 4 : n;
    const int64_t blocks =
        std::min(kMaxBlocks, std::max<int64_t>(1, (groups + kThreads - 1) / kThreads));
    if (vec) {
      from_mont_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(in, out, n, f);
    } else {
      from_mont_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(in, out, n, f);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
