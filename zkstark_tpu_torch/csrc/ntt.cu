// Kernel B: batched length-m NTT row transforms with the LDE's scales fused in.
//
// Replaces zkstark_tpu/ops/ntt_kernel.py _ntt_cols_kernel (and, on the card,
// the jnp radix-2 chain of zkstark_tpu/ntt/core.py _butterflies) together
// with the elementwise glue that XLA fused around it on the TPU: the coset
// pre-scale by offset^j, the zero padding of the coefficients, the four-step
// twiddle U·V and the INTT's 1/n.
//
// One block transforms one row of m = 2^log_m <= 8192 Montgomery residues:
//   load   the first `valid` words of the row (16-byte loads where the row is
//          aligned), each times a[e >> shift]·b[e & mask] for its flat
//          exponent e = i·es + r·rs when a pre-scale is given; the tail up to
//          m is zero and is never read;
//   passes a Stockham autosort transform between two shared-memory buffers:
//          radix 8 with a thread's 8 words in registers (3 stages per pass),
//          then one radix-4 or radix-2 pass for the stages left over, so
//          m = 8192 takes 5 passes and 5 barriers, and no bit-reversed
//          scatter is needed (natural order in, natural order out). A pass
//          reads j + r·m/R (neighbouring threads, neighbouring words) and
//          writes j0 + k·Ns; the buffers carry one pad word per 32, which
//          makes the stride-8 writes of the first pass conflict free (the
//          second pass, Ns = 8, keeps a 2-way conflict on its writes);
//   store  the natural-order result (16-byte stores), each word times
//          ut[r >> vlog][i]·vt[r & vmask][i] (the four-step twiddle), times a
//          geometric factor as on load, times a scalar, where given.
// The row r of every factor is the block's row masked by `pmask`: the rows of
// one transform (a power of two, the batch period), so that a batch of B
// four-step transforms is one launch of B times the rows, each transform's
// rows taking the same factors.
//
// The twiddles of a pass are read once per radix-R task into registers from
// a table laid out pass by pass: the pass with Ns = 2^s starts at offset
// Ns - 1 and holds W^{r·q} at (r - 1)·Ns + q for 1 <= r < R, q < Ns, with
// W = w^{m/(R·Ns)}, so neighbouring threads read neighbouring words. The
// first pass (Ns = 1) multiplies by nothing.
//
// The kernel is compiled once per row length (13 instances), so every stride
// and address pad of a pass is a constant. Every word is a reduced residue
// (the inputs must be: x < p), which lets the arithmetic stay in 32 bits
// (fp_mul_r, fp_add_r of fp.cuh).
//
// What bounds it: integer op issue (one Montgomery product, one add
// and one subtract per radix-2 butterfly) and shared-memory traffic; device
// memory is crossed once each way. p = 3·2^30+1 > 2^31, so 2p does not fit a
// word and the sums cannot be kept lazily in [0, 2p): every add and subtract
// reduces (fp.cuh).
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"
#include "geo.cuh"

namespace {

struct RowsArgs {
  const uint32_t* x;  // (batch, valid)
  uint32_t* out;      // (batch, m)
  const uint32_t* tw;
  int valid;
  int vec_in, vec_out;  // 16-byte global accesses are possible
  uint32_t w8_1, w8_2, w8_3;  // W8, W8^2 = W4, W8^3 (Montgomery), W8 = w^{m/8}
  Geo pre, post;
  const uint32_t* ut;  // (rows >> vlog, m), nullptr: no twiddle
  const uint32_t* vt;  // (1 << vlog, m)
  int vlog;
  uint32_t scale;
  int has_scale;
  uint32_t pmask;  // the row of the factors is r & pmask
  Fp f;
};

// threads of the block that transforms a row of 2^log_m words
__host__ __device__ constexpr int block_threads(int log_m) {
  const int tasks = (1 << log_m) / 8;
  const int cap = log_m > 12 ? 512 : 256;
  return tasks < 32 ? 32 : (tasks > cap ? cap : tasks);
}

// words of one padded shared-memory buffer
__host__ __device__ constexpr int buffer_words(int log_m) { return (1 << log_m) + ((1 << log_m) >> 5); }

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void bfly(uint32_t& a, uint32_t& b, Fp f) {
  const uint32_t s = fp_add_r(a, b, f);
  b = fp_sub(a, b, f);
  a = s;
}

// One Stockham pass of radix R = 2^LOGR at Ns = 2^NS_LOG over a row of
// 2^LOG_M words, from src to dst. Every stride is a compile-time constant, so
// where it is a multiple of 32 the pad of an address is one too.
template <int LOGR, int LOG_M, int NS_LOG>
__device__ __forceinline__ void stockham_pass(const uint32_t* src, uint32_t* dst,
                                              const RowsArgs& a) {
  constexpr int R = 1 << LOGR;
  constexpr int NS = 1 << NS_LOG;
  constexpr int STRIDE = 1 << (LOG_M - LOGR);
  constexpr int THREADS = block_threads(LOG_M);
  const Fp f = a.f;
  const uint32_t* __restrict__ pass_tw = a.tw + (NS - 1);
  constexpr int ITERS = (STRIDE + THREADS - 1) / THREADS;
#pragma unroll 1
  for (int it = 0; it < ITERS; ++it) {
    const int j = threadIdx.x + it * THREADS;
    if (STRIDE % THREADS != 0 && j >= STRIDE) break;
    const int q = j & (NS - 1);
    uint32_t v[R];
    if constexpr (STRIDE % 32 == 0) {
      const int pj = pad(j);
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = src[pj + r * (STRIDE + STRIDE / 32)];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = src[pad(j + r * STRIDE)];
    }
    if constexpr (NS_LOG > 0) {  // the first pass multiplies by w^0 only
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = fp_mul_r(v[r], __ldg(pass_tw + (r - 1) * NS + q), f);
    }
    // the DIF network in registers: afterwards v[pos] is output brev(pos)
    if constexpr (LOGR == 3) {
      bfly(v[0], v[4], f);
      bfly(v[1], v[5], f);
      bfly(v[2], v[6], f);
      bfly(v[3], v[7], f);
      v[5] = fp_mul_r(v[5], a.w8_1, f);
      v[6] = fp_mul_r(v[6], a.w8_2, f);
      v[7] = fp_mul_r(v[7], a.w8_3, f);
    }
    if constexpr (LOGR >= 2) {
#pragma unroll
      for (int h = 0; h < R; h += 4) {
        bfly(v[h], v[h + 2], f);
        bfly(v[h + 1], v[h + 3], f);
        v[h + 3] = fp_mul_r(v[h + 3], a.w8_2, f);
      }
    }
#pragma unroll
    for (int h = 0; h < R; h += 2) bfly(v[h], v[h + 1], f);
    const int j0 = ((j >> NS_LOG) << (NS_LOG + LOGR)) | q;
    uint32_t y[R];  // natural order
    if constexpr (LOGR == 3) {
      y[0] = v[0], y[1] = v[4], y[2] = v[2], y[3] = v[6];
      y[4] = v[1], y[5] = v[5], y[6] = v[3], y[7] = v[7];
    } else if constexpr (LOGR == 2) {
      y[0] = v[0], y[1] = v[2], y[2] = v[1], y[3] = v[3];
    } else {
      y[0] = v[0], y[1] = v[1];
    }
    if constexpr (NS % 32 == 0) {
      const int p0 = pad(j0);
#pragma unroll
      for (int k = 0; k < R; ++k) dst[p0 + k * (NS + NS / 32)] = y[k];
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) dst[pad(j0 + k * NS)] = y[k];
    }
  }
}

// The passes from Ns = 2^NS_LOG on, alternating between the two buffers;
// the result ends in `src` after an even number of passes, else in `dst`.
template <int LOG_M, int NS_LOG>
__device__ __forceinline__ void stockham_passes(uint32_t* src, uint32_t* dst, const RowsArgs& a) {
  if constexpr (NS_LOG + 3 <= LOG_M) {
    stockham_pass<3, LOG_M, NS_LOG>(src, dst, a);
    __syncthreads();
    stockham_passes<LOG_M, NS_LOG + 3>(dst, src, a);
  } else if constexpr (NS_LOG < LOG_M) {
    stockham_pass<LOG_M - NS_LOG, LOG_M, NS_LOG>(src, dst, a);
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t post_ops(uint32_t v, uint32_t u, uint32_t w, uint32_t row,
                                             uint32_t i, const RowsArgs& a) {
  const Fp f = a.f;
  if (a.ut != nullptr) v = fp_mul_r(fp_mul_r(v, u, f), w, f);
  if (a.post.a != nullptr) v = fp_mul_r(v, geo_factor(a.post, row, i, f), f);
  if (a.has_scale) v = fp_mul_r(v, a.scale, f);
  return v;
}

template <int LOG_M>
__global__ void __launch_bounds__(block_threads(LOG_M)) ntt_rows_kernel(const RowsArgs a) {
  extern __shared__ uint32_t smem[];
  constexpr int M = 1 << LOG_M;
  constexpr int THREADS = block_threads(LOG_M);
  constexpr int PASSES = (LOG_M + 2) / 3;
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + buffer_words(LOG_M);
  const uint32_t row = blockIdx.x;
  const uint32_t prow = row & a.pmask;
  const Fp f = a.f;
  const int tid = threadIdx.x;

  const uint32_t* xr = a.x + static_cast<int64_t>(row) * a.valid;
  if (a.vec_in) {
    for (int q = tid; q < (a.valid >> 2); q += THREADS) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(xr) + q);
      uint32_t e[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * q + k;
        if (a.pre.a != nullptr) e[k] = fp_mul_r(e[k], geo_factor(a.pre, prow, i, f), f);
        buf0[pad(i)] = e[k];
      }
    }
  } else {
    for (int i = tid; i < a.valid; i += THREADS) {
      uint32_t e = __ldg(xr + i);
      if (a.pre.a != nullptr) e = fp_mul_r(e, geo_factor(a.pre, prow, i, f), f);
      buf0[pad(i)] = e;
    }
  }
  for (int i = a.valid + tid; i < M; i += THREADS) buf0[pad(i)] = 0u;
  __syncthreads();

  stockham_passes<LOG_M, 0>(buf0, buf1, a);
  const uint32_t* res = PASSES % 2 ? buf1 : buf0;

  uint32_t* orow = a.out + (static_cast<int64_t>(row) << LOG_M);
  const bool twiddle = a.ut != nullptr;
  const uint32_t* ur = twiddle ? a.ut + (static_cast<int64_t>(prow >> a.vlog) << LOG_M) : nullptr;
  const uint32_t* vr =
      twiddle ? a.vt + (static_cast<int64_t>(prow & ((1u << a.vlog) - 1u)) << LOG_M) : nullptr;
  if (a.vec_out) {
    for (int q = tid; q < (M >> 2); q += THREADS) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      uint4 w = u;
      if (twiddle) {
        u = __ldg(reinterpret_cast<const uint4*>(ur) + q);
        w = __ldg(reinterpret_cast<const uint4*>(vr) + q);
      }
      const int i = 4 * q;
      const int pi = pad(i);  // i..i+3 share one group of 32
      uint4 o;
      o.x = post_ops(res[pi], u.x, w.x, prow, i, a);
      o.y = post_ops(res[pi + 1], u.y, w.y, prow, i + 1, a);
      o.z = post_ops(res[pi + 2], u.z, w.z, prow, i + 2, a);
      o.w = post_ops(res[pi + 3], u.w, w.w, prow, i + 3, a);
      reinterpret_cast<uint4*>(orow)[q] = o;
    }
  } else {
    for (int i = tid; i < M; i += THREADS) {
      const uint32_t u = twiddle ? __ldg(ur + i) : 0u;
      const uint32_t w = twiddle ? __ldg(vr + i) : 0u;
      orow[i] = post_ops(res[pad(i)], u, w, prow, i, a);
    }
  }
}

template <int LOG_M>
cudaError_t launch_rows(const RowsArgs& a, int64_t batch, cudaStream_t stream) {
  constexpr size_t smem = 2 * static_cast<size_t>(buffer_words(LOG_M)) * sizeof(uint32_t);
  if constexpr (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(ntt_rows_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  ntt_rows_kernel<LOG_M>
      <<<static_cast<unsigned>(batch), block_threads(LOG_M), smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

}  // namespace

// x: (batch, valid) uint32 reduced residues, valid <= m = 2^log_m, 1 <= log_m
// <= 13; out: (batch, m); natural order in and out. tw: the (m - 1)-word pass
// table; w8_*: W8, W4, W8^3 for W8 = w^{m/8} (unused where m is too short for
// them). pre_*/post_*: the geometric factor on load / on store (a null: off).
// ut, vt: the twiddle tables (null: off), 1 << vlog rows in vt. has_scale:
// every output times `scale`. The factors take row r & pmask.
extern "C" int zk_ntt_rows(const uint32_t* x, uint32_t* out, const uint32_t* tw, int log_m,
                           int64_t batch, int valid, uint32_t w8_1, uint32_t w8_2, uint32_t w8_3,
                           const uint32_t* pre_a, const uint32_t* pre_b, int pre_shift,
                           uint32_t pre_es, uint32_t pre_rs, const uint32_t* post_a,
                           const uint32_t* post_b, int post_shift, uint32_t post_es,
                           uint32_t post_rs, const uint32_t* ut, const uint32_t* vt, int vlog,
                           uint32_t scale, int has_scale, uint32_t pmask, uint32_t p,
                           uint32_t pinv, cudaStream_t stream) {
  if (log_m < 1 || log_m > 13 || batch < 0 || batch > 0x7fffffff || valid < 0 ||
      valid > (1 << log_m) || vlog < 0 || vlog > 30 || (ut == nullptr) != (vt == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const int m = 1 << log_m;
  RowsArgs a;
  a.x = x;
  a.out = out;
  a.tw = tw;
  a.valid = valid;
  a.vec_in = (valid % 4 == 0 && aligned16(x)) ? 1 : 0;
  a.vec_out = (m % 4 == 0 && aligned16(out) && aligned16(ut) && aligned16(vt)) ? 1 : 0;
  a.w8_1 = w8_1;
  a.w8_2 = w8_2;
  a.w8_3 = w8_3;
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
#define ZK_ROWS_CASE(L) \
  case L:               \
    rc = launch_rows<L>(a, batch, stream); \
    break;
    ZK_ROWS_CASE(1)
    ZK_ROWS_CASE(2)
    ZK_ROWS_CASE(3)
    ZK_ROWS_CASE(4)
    ZK_ROWS_CASE(5)
    ZK_ROWS_CASE(6)
    ZK_ROWS_CASE(7)
    ZK_ROWS_CASE(8)
    ZK_ROWS_CASE(9)
    ZK_ROWS_CASE(10)
    ZK_ROWS_CASE(11)
    ZK_ROWS_CASE(12)
    ZK_ROWS_CASE(13)
#undef ZK_ROWS_CASE
  }
  return static_cast<int>(rc);
}
