// Kernel D: batched length-m constant-geometry (Pease) NTT row transforms.
//
// Replaces zkstark_tpu/ops/ntt_kernel.py _ntt_cols_pease_kernel. One block
// transforms one row of m <= 8192 reduced Montgomery residues. Every radix-2
// stage t has the same form: with h = m/2 and W_t[i] = tw[(i >> t) << t]
// (tw[j] = w^j, j < h),
//
//   a = x[i] + x[i+h],  b = W_t[i] * (x[i] - x[i+h]),  x'[2i] = a, x'[2i+1] = b.
//
// Natural order in, bit-reversed order out, as the TPU kernel. The last
// stage's twiddles are all w^0, so it skips the multiply.
//
// On this card the transform is bound by integer instruction slots and by
// shared-memory round trips (each element crosses device memory once each
// way), so the design spends as few of both as it can:
//
//  * Two stages per pass. A thread that holds x[i], x[i+m/4], x[i+m/2],
//    x[i+3m/4] (i < m/4) computes stage t and stage t+1 in registers and owns
//    the four neighbouring outputs x''[4i .. 4i+3]: with e = (i >> t) << t,
//
//      a0 = x0 + x2   b0 = tw[e]       * (x0 - x2)
//      a1 = x1 + x3   b1 = tw[e + m/4] * (x1 - x3)
//      x''[4i]   = a0 + a1     x''[4i+1] = tw[2e] * (a0 - a1)
//      x''[4i+2] = b0 + b1     x''[4i+3] = tw[2e] * (b0 - b1)
//
//    so a pass costs four conflict-free 4-byte loads and one 16-byte store a
//    task. An odd log2(m) ends with one radix-2 stage, which is the last one
//    and has no multiply at all.
//  * One barrier per pass: passes ping-pong between two shared-memory
//    buffers (2 * 4m bytes, 64 KB at m = 8192, opted in). The first pass
//    reads the row straight from device memory and the last one stores
//    straight to it, so there is no load loop and no copy-out loop.
//  * One kernel instance per row length: h, the task count, the thread count
//    and every twiddle shift are constants, and the pass loop is unrolled at
//    compile time.
//  * 32-bit arithmetic on reduced residues (fp_mul_r, fp_add_r, fp_sub of
//    fp.cuh): about half the machine ops of the 64-bit forms. The rows must
//    hold reduced residues (< p), as every word of the four-step does.
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kMaxThreads = 512;

__host__ __device__ constexpr int pease_threads(int log_m) {
  // one thread per radix-4 task (m/4), per pair where m = 2
  const int tasks = log_m >= 2 ? (1 << (log_m - 2)) : 1;
  return tasks < kMaxThreads ? tasks : kMaxThreads;
}

__host__ __device__ constexpr int pease_passes(int log_m) { return log_m / 2 + (log_m & 1); }

// Shared-memory words: a pass that neither reads nor writes device memory
// needs both buffers, so three passes or more take two, two passes one.
__host__ __device__ constexpr int pease_smem_words(int log_m) {
  const int passes = pease_passes(log_m);
  return (passes >= 3 ? 2 : passes == 2 ? 1 : 0) << log_m;
}

// Stages T and T+1 of a length-2^LOG_M row from src to dst. LAST: stage T+1
// is the transform's last (its twiddles and tw[e] are all w^0).
template <int LOG_M, int T, bool LAST>
__device__ __forceinline__ void radix4_pass(const uint32_t* __restrict__ src,
                                            uint32_t* __restrict__ dst,
                                            const uint32_t* __restrict__ tw, Fp f) {
  constexpr int H = 1 << (LOG_M - 1);
  constexpr int Q = H >> 1;
  constexpr int THREADS = pease_threads(LOG_M);
#pragma unroll
  for (int r = 0; r < Q / THREADS; ++r) {
    const int i = static_cast<int>(threadIdx.x) + r * THREADS;
    const uint32_t x0 = src[i];
    const uint32_t x1 = src[i + Q];
    const uint32_t x2 = src[i + H];
    const uint32_t x3 = src[i + H + Q];
    const int e = (i >> T) << T;
    const uint32_t a0 = fp_add_r(x0, x2, f);
    const uint32_t a1 = fp_add_r(x1, x3, f);
    const uint32_t d0 = fp_sub(x0, x2, f);
    const uint32_t d1 = fp_sub(x1, x3, f);
    const uint32_t b0 = LAST ? d0 : fp_mul_r(d0, __ldg(tw + e), f);
    const uint32_t b1 = fp_mul_r(d1, __ldg(tw + e + Q), f);
    uint4 z;
    z.x = fp_add_r(a0, a1, f);
    z.y = fp_sub(a0, a1, f);
    z.z = fp_add_r(b0, b1, f);
    z.w = fp_sub(b0, b1, f);
    if (!LAST) {
      const uint32_t w2 = __ldg(tw + 2 * e);
      z.y = fp_mul_r(z.y, w2, f);
      z.w = fp_mul_r(z.w, w2, f);
    }
    reinterpret_cast<uint4*>(dst)[i] = z;
  }
}

// The last stage of an odd log2(m), from src to the output row: no multiply.
template <int LOG_M>
__device__ __forceinline__ void radix2_last(const uint32_t* __restrict__ src,
                                            uint32_t* __restrict__ dst, Fp f) {
  constexpr int H = 1 << (LOG_M - 1);
  constexpr int THREADS = pease_threads(LOG_M);
#pragma unroll
  for (int r = 0; r < (H + THREADS - 1) / THREADS; ++r) {
    const int i = static_cast<int>(threadIdx.x) + r * THREADS;
    if (H % THREADS == 0 || i < H) {
      const uint32_t top = src[i];
      const uint32_t bot = src[i + H];
      reinterpret_cast<uint2*>(dst)[i] = make_uint2(fp_add_r(top, bot, f), fp_sub(top, bot, f));
    }
  }
}

// Passes P, P+1, ... of the row: the compile-time loop over the passes.
template <int LOG_M, int P>
__device__ __forceinline__ void run_passes(const uint32_t* __restrict__ x,
                                           uint32_t* __restrict__ out,
                                           const uint32_t* __restrict__ tw, uint32_t* s, Fp f) {
  constexpr int M = 1 << LOG_M;
  constexpr int R4 = LOG_M / 2;  // radix-4 passes
  constexpr bool ODD = (LOG_M & 1) != 0;
  const uint32_t* src = P == 0 ? x : s + ((P - 1) & 1) * M;
  if constexpr (P < R4) {
    constexpr bool TO_OUT = P == R4 - 1 && !ODD;
    uint32_t* dst = TO_OUT ? out : s + (P & 1) * M;
    radix4_pass<LOG_M, 2 * P, TO_OUT>(src, dst, tw, f);
    if constexpr (!TO_OUT) {
      __syncthreads();
      run_passes<LOG_M, P + 1>(x, out, tw, s, f);
    }
  } else if constexpr (ODD) {
    radix2_last<LOG_M>(src, out, f);
  }
}

template <int LOG_M>
__global__ void __launch_bounds__(pease_threads(LOG_M))
    ntt_rows_pease_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                          const uint32_t* __restrict__ tw, Fp f) {
  extern __shared__ __align__(16) uint32_t s[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) << LOG_M;
  run_passes<LOG_M, 0>(x + base, out + base, tw, s, f);
}

template <int LOG_M>
cudaError_t launch_pease(const uint32_t* x, uint32_t* out, const uint32_t* tw, int64_t batch,
                         Fp f, cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(pease_smem_words(LOG_M)) * sizeof(uint32_t);
  if constexpr (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(ntt_rows_pease_kernel<LOG_M>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  ntt_rows_pease_kernel<LOG_M>
      <<<static_cast<unsigned>(batch), pease_threads(LOG_M), smem, stream>>>(x, out, tw, f);
  return cudaGetLastError();
}

}  // namespace

// x, out: (batch, 2^log_m) uint32 reduced residues, both 16-byte aligned;
// x natural order, out bit-reversed; tw: (2^(log_m - 1),) uint32 Montgomery
// powers of w; 1 <= log_m <= 13.
extern "C" int zk_ntt_rows_pease(const uint32_t* x, uint32_t* out, const uint32_t* tw, int log_m,
                                 int64_t batch, uint32_t p, uint32_t pinv, cudaStream_t stream) {
  if (log_m < 1 || log_m > 13 || batch < 0 || batch > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0u) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const Fp f{p, pinv};
  cudaError_t rc = cudaErrorInvalidValue;
  switch (log_m) {
#define ZK_PEASE_CASE(L)                                \
  case L:                                               \
    rc = launch_pease<L>(x, out, tw, batch, f, stream); \
    break;
    ZK_PEASE_CASE(1)
    ZK_PEASE_CASE(2)
    ZK_PEASE_CASE(3)
    ZK_PEASE_CASE(4)
    ZK_PEASE_CASE(5)
    ZK_PEASE_CASE(6)
    ZK_PEASE_CASE(7)
    ZK_PEASE_CASE(8)
    ZK_PEASE_CASE(9)
    ZK_PEASE_CASE(10)
    ZK_PEASE_CASE(11)
    ZK_PEASE_CASE(12)
    ZK_PEASE_CASE(13)
#undef ZK_PEASE_CASE
  }
  return static_cast<int>(rc);
}
