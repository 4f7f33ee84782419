// Kernel D: batched length-m constant-geometry (Pease) NTT row transforms,
// with the contract of kernel B (ntt.cu): the LDE's scales fused in.
//
// Replaces zkstark_tpu/ops/ntt_kernel.py _ntt_cols_pease_kernel together
// with the glue XLA fused around it in the JAX four-step (the coset scales,
// the zero tail, the U·V twiddle and the bit-reversing gathers). One block
// transforms one row of m <= 8192 reduced Montgomery residues. Every radix-2
// stage t has the same form: with h = m/2 and W_t[i] = tw[(i >> t) << t]
// (tw[j] = w^j, j < h),
//
//   a = x[i] + x[i+h],  b = W_t[i] * (x[i] - x[i+h]),  x'[2i] = a, x'[2i+1] = b.
//
// After the last stage, slot i holds frequency brev(i). The last stage's
// twiddles are all w^0, so it skips the multiply.
//
// The contract (ntt.cu's, and `period`):
//   load   the first `valid` words of the row (its tail up to m is zero and
//          is never read), each times a[e >> shift]·b[e & mask] for
//          e = i·es + (r & pmask)·rs when a pre-scale is given, straight
//          into the first pass's registers;
//   store  each word times ut[(r & pmask) >> vlog][j]·vt[(r & pmask) & vmask][j]
//          (the four-step twiddle), times a geometric factor at the word's
//          FREQUENCY k, times a scalar, where given. j is the column as
//          stored: k itself in natural order, the slot i (k = brev(i)) in
//          bit-reversed order. So the geometric factor is indexed by the
//          frequency (k = __brev(i) >> (32 - log_m), a few ops), and the
//          twiddle tables are read as stored, contiguous and 16 bytes at a
//          time: a caller of the bit-reversed order hands them over with
//          their columns permuted once on the host (ops/ntt_kernel.py
//          `_device_uv(..., brev=True)`).
//   order  BITREV = true: the TPU kernel's order, slot i = frequency
//          brev(i); the last pass stores straight to device memory. The
//          four-step then undoes the order for free in its transposes
//          (transpose.cu, `brev`). BITREV = false: natural order; the last
//          pass stores into shared memory, under an XOR swizzle that makes
//          both its 16-byte stores and the bit-reversed reads of the store
//          loop free of bank conflicts, and the store loop writes each row in
//          natural order (one more barrier and one more shared-memory round
//          trip of the row).
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
//    reads the row straight from device memory and, in bit-reversed order,
//    the last one stores straight to it.
//  * One kernel instance per row length and order: h, the task count, the
//    thread count and every twiddle shift are constants, and the pass loop
//    is unrolled at compile time.
//  * 32-bit arithmetic on reduced residues (fp_mul_r, fp_add_r, fp_sub of
//    fp.cuh): about half the machine ops of the 64-bit forms. The rows must
//    hold reduced residues (< p), as every word of the four-step does.
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"
#include "geo.cuh"

namespace {

constexpr int kMaxThreads = 512;

struct PeaseArgs {
  const uint32_t* x;  // (batch, valid)
  uint32_t* out;      // (batch, m)
  const uint32_t* tw;
  int valid;
  Geo pre, post;
  const uint32_t* ut;  // (period >> vlog, m) as stored, nullptr: no twiddle
  const uint32_t* vt;  // (1 << vlog, m)
  int vlog;
  uint32_t scale;
  int has_scale;
  uint32_t pmask;  // the row of the factors is r & pmask
  Fp f;
};

__host__ __device__ constexpr int pease_threads(int log_m) {
  // one thread per radix-4 task (m/4), per pair where m = 2
  const int tasks = log_m >= 2 ? (1 << (log_m - 2)) : 1;
  return tasks < kMaxThreads ? tasks : kMaxThreads;
}

__host__ __device__ constexpr int pease_passes(int log_m) { return log_m / 2 + (log_m & 1); }

// Shared-memory words. Bit-reversed order: a pass that neither reads nor
// writes device memory needs both buffers, so three passes or more take two,
// two passes one. Natural order: the last pass writes shared memory too, into
// the buffer its source is not.
__host__ __device__ constexpr int pease_smem_words(int log_m, bool bitrev) {
  const int passes = pease_passes(log_m);
  if (!bitrev) return (passes >= 2 ? 2 : 1) << log_m;
  return (passes >= 3 ? 2 : passes == 2 ? 1 : 0) << log_m;
}

// The first pass's source: the input row, its tail zero, times the pre-scale.
struct FromRow {
  const uint32_t* xr;
  int valid;
  Geo pre;
  uint32_t prow;
  Fp f;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    if (i >= valid) return 0u;
    const uint32_t e = __ldg(xr + i);
    return pre.a == nullptr ? e : fp_mul_r(e, geo_factor(pre, prow, static_cast<uint32_t>(i), f), f);
  }
};

struct FromShared {
  const uint32_t* s;
  __device__ __forceinline__ uint32_t operator()(int i) const { return s[i]; }
};

// A pass's destination in shared memory, slot order.
struct ToShared {
  uint32_t* s;
  __device__ __forceinline__ void put4(int i, uint4 z) const { reinterpret_cast<uint4*>(s)[i] = z; }
  __device__ __forceinline__ void put2(int i, uint2 z) const { reinterpret_cast<uint2*>(s)[i] = z; }
};

// The swizzle of the natural-order mode's last buffer: slot j lives at
// j ^ ((j >> (LOG_M - 5)) & 31). The store loop reads the slots brev(k) for
// 32 consecutive k, which differ only in their top five bits: the XOR spreads
// them over the 32 banks. Rows shorter than 1024 words keep slot order.
template <int LOG_M>
__device__ __forceinline__ int swizzle_key(int j) {
  if constexpr (LOG_M >= 10) {
    return (j >> (LOG_M - 5)) & 31;
  } else {
    return 0;
  }
}

// The natural-order mode's last pass: 16-byte (8-byte) stores of aligned
// groups, whose words trade places by the key's low bits.
template <int LOG_M>
struct ToSwizzled {
  uint32_t* s;
  __device__ __forceinline__ void put4(int i, uint4 z) const {
    const int key = swizzle_key<LOG_M>(4 * i);
    if (key & 1) z = make_uint4(z.y, z.x, z.w, z.z);
    if (key & 2) z = make_uint4(z.z, z.w, z.x, z.y);
    reinterpret_cast<uint4*>(s)[i ^ (key >> 2)] = z;
  }
  __device__ __forceinline__ void put2(int i, uint2 z) const {
    const int key = swizzle_key<LOG_M>(2 * i);
    if (key & 1) z = make_uint2(z.y, z.x);
    reinterpret_cast<uint2*>(s)[i ^ (key >> 1)] = z;
  }
};

__device__ __forceinline__ uint32_t geo_or_one(const Geo& g, uint32_t prow, uint32_t k, uint32_t v,
                                               Fp f) {
  return g.a == nullptr ? v : fp_mul_r(v, geo_factor(g, prow, k, f), f);
}

// The bit-reversed mode's last pass: the store factors, then straight to the
// output row. Slot j holds frequency brev(j).
template <int LOG_M>
struct ToRowBitrev {
  uint32_t* orow;
  const uint32_t* ur;  // the twiddle rows as stored, nullptr: none
  const uint32_t* vr;
  Geo post;
  uint32_t prow;
  uint32_t scale;
  int has_scale;
  Fp f;
  __device__ __forceinline__ uint32_t finish(uint32_t v, uint32_t u, uint32_t w, int j) const {
    if (ur != nullptr) v = fp_mul_r(fp_mul_r(v, u, f), w, f);
    const uint32_t k = __brev(static_cast<uint32_t>(j)) >> (32 - LOG_M);
    v = geo_or_one(post, prow, k, v, f);
    if (has_scale) v = fp_mul_r(v, scale, f);
    return v;
  }
  __device__ __forceinline__ void put4(int i, uint4 z) const {
    uint4 u = make_uint4(0u, 0u, 0u, 0u), w = u;
    if (ur != nullptr) {
      u = __ldg(reinterpret_cast<const uint4*>(ur) + i);
      w = __ldg(reinterpret_cast<const uint4*>(vr) + i);
    }
    z.x = finish(z.x, u.x, w.x, 4 * i);
    z.y = finish(z.y, u.y, w.y, 4 * i + 1);
    z.z = finish(z.z, u.z, w.z, 4 * i + 2);
    z.w = finish(z.w, u.w, w.w, 4 * i + 3);
    reinterpret_cast<uint4*>(orow)[i] = z;
  }
  __device__ __forceinline__ void put2(int i, uint2 z) const {
    uint2 u = make_uint2(0u, 0u), w = u;
    if (ur != nullptr) {
      u = __ldg(reinterpret_cast<const uint2*>(ur) + i);
      w = __ldg(reinterpret_cast<const uint2*>(vr) + i);
    }
    z.x = finish(z.x, u.x, w.x, 2 * i);
    z.y = finish(z.y, u.y, w.y, 2 * i + 1);
    reinterpret_cast<uint2*>(orow)[i] = z;
  }
};

// Stages T and T+1 of a length-2^LOG_M row from src to dst. LAST: stage T+1
// is the transform's last (its twiddles and tw[e] are all w^0).
template <int LOG_M, int T, bool LAST, class Src, class Dst>
__device__ __forceinline__ void radix4_pass(const Src& src, const Dst& dst,
                                            const uint32_t* __restrict__ tw, Fp f) {
  constexpr int H = 1 << (LOG_M - 1);
  constexpr int Q = H >> 1;
  constexpr int THREADS = pease_threads(LOG_M);
#pragma unroll
  for (int r = 0; r < Q / THREADS; ++r) {
    const int i = static_cast<int>(threadIdx.x) + r * THREADS;
    const uint32_t x0 = src(i);
    const uint32_t x1 = src(i + Q);
    const uint32_t x2 = src(i + H);
    const uint32_t x3 = src(i + H + Q);
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
    dst.put4(i, z);
  }
}

// The last stage of an odd log2(m): no multiply.
template <int LOG_M, class Src, class Dst>
__device__ __forceinline__ void radix2_last(const Src& src, const Dst& dst, Fp f) {
  constexpr int H = 1 << (LOG_M - 1);
  constexpr int THREADS = pease_threads(LOG_M);
#pragma unroll
  for (int r = 0; r < (H + THREADS - 1) / THREADS; ++r) {
    const int i = static_cast<int>(threadIdx.x) + r * THREADS;
    if (H % THREADS == 0 || i < H) {
      const uint32_t top = src(i);
      const uint32_t bot = src(i + H);
      dst.put2(i, make_uint2(fp_add_r(top, bot, f), fp_sub(top, bot, f)));
    }
  }
}

// Passes P, P+1, ... of the row: the compile-time loop over the passes. Pass
// P writes buffer P & 1 (a barrier after it), the last pass `last`.
template <int LOG_M, int P, class Src, class Last>
__device__ __forceinline__ void run_passes(const Src& src, const Last& last,
                                           const uint32_t* __restrict__ tw, uint32_t* s, Fp f) {
  constexpr int M = 1 << LOG_M;
  constexpr int R4 = LOG_M / 2;  // radix-4 passes
  constexpr bool ODD = (LOG_M & 1) != 0;
  if constexpr (P < R4) {
    if constexpr (P == R4 - 1 && !ODD) {
      radix4_pass<LOG_M, 2 * P, true>(src, last, tw, f);
    } else {
      uint32_t* dst = s + (P & 1) * M;
      radix4_pass<LOG_M, 2 * P, false>(src, ToShared{dst}, tw, f);
      __syncthreads();
      run_passes<LOG_M, P + 1>(FromShared{dst}, last, tw, s, f);
    }
  } else if constexpr (ODD) {
    radix2_last<LOG_M>(src, last, f);
  }
}

template <int LOG_M, bool BITREV>
__global__ void __launch_bounds__(pease_threads(LOG_M)) ntt_rows_pease_kernel(const PeaseArgs a) {
  extern __shared__ __align__(16) uint32_t s[];
  constexpr int M = 1 << LOG_M;
  constexpr int THREADS = pease_threads(LOG_M);
  const uint32_t row = blockIdx.x;
  const uint32_t prow = row & a.pmask;
  const Fp f = a.f;
  const FromRow in{a.x + static_cast<int64_t>(row) * a.valid, a.valid, a.pre, prow, f};
  uint32_t* orow = a.out + (static_cast<int64_t>(row) << LOG_M);
  const bool twiddle = a.ut != nullptr;
  const uint32_t* ur = twiddle ? a.ut + (static_cast<int64_t>(prow >> a.vlog) << LOG_M) : nullptr;
  const uint32_t* vr =
      twiddle ? a.vt + (static_cast<int64_t>(prow & ((1u << a.vlog) - 1u)) << LOG_M) : nullptr;
  if constexpr (BITREV) {
    const ToRowBitrev<LOG_M> last{orow, ur, vr, a.post, prow, a.scale, a.has_scale, f};
    run_passes<LOG_M, 0>(in, last, a.tw, s, f);
  } else {
    // the last pass writes the buffer its source is not
    uint32_t* res = s + ((pease_passes(LOG_M) - 1) & 1) * M;
    run_passes<LOG_M, 0>(in, ToSwizzled<LOG_M>{res}, a.tw, s, f);
    __syncthreads();
    for (int k = threadIdx.x; k < M; k += THREADS) {
      const int j = static_cast<int>(__brev(static_cast<uint32_t>(k)) >> (32 - LOG_M));
      uint32_t v = res[j ^ swizzle_key<LOG_M>(j)];
      if (twiddle) v = fp_mul_r(fp_mul_r(v, __ldg(ur + k), f), __ldg(vr + k), f);
      v = geo_or_one(a.post, prow, static_cast<uint32_t>(k), v, f);
      if (a.has_scale) v = fp_mul_r(v, a.scale, f);
      orow[k] = v;
    }
  }
}

template <int LOG_M, bool BITREV>
cudaError_t launch_pease(const PeaseArgs& a, int64_t batch, cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(pease_smem_words(LOG_M, BITREV)) * sizeof(uint32_t);
  if constexpr (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(ntt_rows_pease_kernel<LOG_M, BITREV>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  ntt_rows_pease_kernel<LOG_M, BITREV>
      <<<static_cast<unsigned>(batch), pease_threads(LOG_M), smem, stream>>>(a);
  return cudaGetLastError();
}

template <int LOG_M>
cudaError_t launch_order(const PeaseArgs& a, int64_t batch, int bitrev, cudaStream_t stream) {
  return bitrev ? launch_pease<LOG_M, true>(a, batch, stream)
                : launch_pease<LOG_M, false>(a, batch, stream);
}

}  // namespace

// x: (batch, valid) uint32 reduced residues, valid <= m = 2^log_m, 1 <= log_m
// <= 13; out: (batch, m), natural order (bitrev = 0) or slot i = frequency
// brev(i) (bitrev = 1). tw: (2^(log_m - 1),) uint32 Montgomery powers of w.
// pre_*/post_*: the geometric factor on load / on store at the frequency (a
// null: off). ut, vt: the twiddle tables as stored (null: off), 1 << vlog
// rows in vt. has_scale: every output times `scale`. The factors take row
// r & pmask. out, ut and vt 16-byte aligned (8 where m = 2).
extern "C" int zk_ntt_rows_pease(const uint32_t* x, uint32_t* out, const uint32_t* tw, int log_m,
                                 int64_t batch, int valid, const uint32_t* pre_a,
                                 const uint32_t* pre_b, int pre_shift, uint32_t pre_es,
                                 uint32_t pre_rs, const uint32_t* post_a, const uint32_t* post_b,
                                 int post_shift, uint32_t post_es, uint32_t post_rs,
                                 const uint32_t* ut, const uint32_t* vt, int vlog, uint32_t scale,
                                 int has_scale, uint32_t pmask, int bitrev, uint32_t p,
                                 uint32_t pinv, cudaStream_t stream) {
  // the stores and the twiddle rows go 16 bytes at a time (8 where m = 2)
  const uintptr_t align = log_m >= 2 ? 15u : 7u;
  const auto misaligned = [align](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & align) != 0u;
  };
  if (log_m < 1 || log_m > 13 || batch < 0 || batch > 0x7fffffff || valid < 0 ||
      valid > (1 << log_m) || vlog < 0 || vlog > 30 || (ut == nullptr) != (vt == nullptr) ||
      misaligned(out) || misaligned(ut) || misaligned(vt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  PeaseArgs a;
  a.x = x;
  a.out = out;
  a.tw = tw;
  a.valid = valid;
  a.pre = Geo{pre_a, pre_b, pre_shift, pre_es, pre_rs};
  a.post = Geo{post_a, post_b, post_shift, post_es, post_rs};
  a.ut = ut;
  a.vt = vt;
  a.vlog = vlog;
  a.scale = scale;
  a.has_scale = has_scale;
  a.pmask = pmask;
  a.f = Fp{p, pinv};
  cudaError_t rc = cudaErrorInvalidValue;
  switch (log_m) {
#define ZK_PEASE_CASE(L)                                  \
  case L:                                                 \
    rc = launch_order<L>(a, batch, bitrev, stream); \
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
