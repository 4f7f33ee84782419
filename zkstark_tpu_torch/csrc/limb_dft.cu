// Kernel H: batched length-m DFT rows as limb-matrix products on the tensor
// cores, 128 <= m <= 16384: the row transform of the four-step NTT past 2^26.
//
// Replaces zkstark_tpu/ops/mxu_ntt.py dft_matmul + _recombine +
// col_transform_mxu (for rows instead of columns), and with them the limb
// tensors that XLA wrote to device memory between the product and the
// recombination on the TPU. m = k1·k2, k1 >= k2, both at most 128:
//
//   X[t + k1·s] = sum_{j2} W2^{j2·s} · w^{t·j2} · sum_{j1} W1^{t·j1} · x[j1·k2 + j2]
//
// with W1 = w^{k2}, W2 = w^{k1}. A radix-k DFT y[i] = sum_j W^{ij}·x[j] on
// Montgomery words is an exact integer product over 8-bit limbs: with
// AW[c][i][j] the word whose byte a is byte_c(to_mont(W^{ij})·2^{8a} mod p)
// (built on the host, ops/limb_dft.py), the limb sums
//
//   T_c[i] = sum_j sum_a byte_a(AW[c][i][j]) · byte_a(x[j])
//
// recombine to V = sum_c T_c·2^{8c}, congruent to R·y[i], and one REDC of V is
// y[i] in Montgomery form. T_c <= 255²·512 < 2^25 fits the s32 accumulator of
// mma.sync.m16n8k32.u8.u8 with no chunking of the contraction (the TPU's
// bf16 -> f32 products had to be chunked at 64), and V <= 512·255·(p - 1) <
// p·2^32 meets fp_reduce's precondition for every odd prime below 2^32.
//
// The contraction index of the product is 4·j + a, so a B fragment register
// is a data word as it lies in memory (a u32 word is its four limbs, packed)
// and an A fragment register is a word of AW; the host stores AW in fragment
// order, one 16-byte load per lane and k-step. M is (c, i): a warp takes a
// block of 16 outputs i for all four c at once, so each thread ends up with
// T_0..T_3 of its own outputs in registers and recombines them there.
//
// One block transforms one row, held in shared memory:
//   load    the first `valid` words (16-byte loads where aligned), each times
//           the geometric pre-scale where given, as X[j1][j2]; rows of X past
//           the valid prefix are zero and the first stage's contraction stops
//           after them (an LDE's pass 1 contracts 1/blowup of k1);
//   stage 1 contracts j1: a[t][j2], times the in-row twiddle w^{t·j2} from a
//           (k1, k2) table, into Y[t][j2];
//   stage 2 contracts j2: output t + k1·s, times the four-step twiddle
//           ut[r >> vlog][o]·vt[r & vmask][o], a geometric post-scale and a
//           scalar, where given, stored to device memory as 8-byte pairs.
// The row strides of X and Y are padded (k2 + 8 and k2 + 4 words) so that the
// fragment reads of both stages hit 32 different banks.
//
// What bounds it: with tensor cores the arithmetic (16·k multiply-adds a word
// and stage) is far from the card's rate and device memory is crossed once
// each way; what this version pays for is the matrix: every warp streams its
// A fragments from L2 for every group of 32 columns (k/4 KB per 16 x 32
// outputs, the next k-step's loads in flight behind this one's products), so
// it lives on occupancy: 128 registers a thread and 16 warps an SM measured
// faster than a wider warp tile with half the matrix traffic and 8 warps.
// The rows are read and written with streaming hints that keep them from
// evicting the matrix from L2. Holding the matrix in shared memory across
// several rows, or wgmma with the matrix as the shared operand, is the next
// step.
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"
#include "geo.cuh"

namespace {

constexpr int kTiles = 4;  // 8-column tiles a warp accumulates side by side

struct LimbArgs {
  const uint32_t* x;  // (batch, valid)
  uint32_t* out;      // (batch, k1·k2)
  const uint4* af1;   // fragment-ordered limb matrix of stage 1 (radix k1, root w^{k2})
  const uint4* af2;   // and of stage 2 (radix k2, root w^{k1})
  const uint32_t* tw; // (k1, k2) in-row twiddle w^{t·j2}, Montgomery
  int log_k1, log_k2;
  int valid;
  int vec_in;  // 16-byte global loads are possible
  Geo pre, post;
  const uint32_t* ut;  // (rows >> vlog, m), nullptr: no twiddle
  const uint32_t* vt;  // (1 << vlog, m)
  int vlog;
  uint32_t scale;
  int has_scale;
  Fp f;
};

// D(16 x 8, s32) += A(16 x 32, u8, row) · B(32 x 8, u8, col)
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// V = T_0 + T_1·2^8 + T_2·2^16 + T_3·2^24 < p·2^32, then REDC
__device__ __forceinline__ uint32_t recombine(int t0, int t1, int t2, int t3, Fp f) {
  const uint64_t v = static_cast<uint64_t>(static_cast<uint32_t>(t0)) +
                     (static_cast<uint64_t>(static_cast<uint32_t>(t1)) << 8) +
                     (static_cast<uint64_t>(static_cast<uint32_t>(t2)) << 16) +
                     (static_cast<uint64_t>(static_cast<uint32_t>(t3)) << 24);
  return fp_reduce(v, f);
}

// One radix-k stage over a row in shared memory. The word of contraction
// index j and column n is src[j·sj + n·sn]; the contraction runs over the
// first 8·ksteps indices (the rest are known to be zero). For every output
// i < k and every pair of columns n, n + 1 < ncols (n even), emit(i, n, y0,
// y1) receives the two Montgomery outputs.
template <int THREADS, class Emit>
__device__ __forceinline__ void dft_stage(const uint32_t* src, int sj, int sn, const uint4* af,
                                          int log_k, int ksteps, int ncols, Fp f, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int k = 1 << log_k;
  const int iblocks = (k + 15) >> 4;
  const int ksteps_all = k >> 3;
  const int ngroups = (ncols + 8 * kTiles - 1) / (8 * kTiles);
#pragma unroll 1
  for (int u = warp; u < iblocks * ngroups; u += THREADS / 32) {
    const int ib = u / ngroups;
    const int n0 = (u - ib * ngroups) * 8 * kTiles;
    int acc[4][kTiles][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][q][e] = 0;
    const uint4* afp = af + static_cast<size_t>(ib) * ksteps_all * 128 + lane;
    const uint32_t* bp = src + tg * sj + (n0 + g) * sn;
    uint4 a[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = __ldg(afp + c * 32);
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      uint4 an[4];  // the next k-step's fragments, in flight behind this one's products
      const int kn = ks + 1 < ksteps ? ks + 1 : ks;
#pragma unroll
      for (int c = 0; c < 4; ++c) an[c] = __ldg(afp + (kn * 4 + c) * 32);
#pragma unroll
      for (int q = 0; q < kTiles; ++q) {
        if (n0 + 8 * q < ncols) {  // the same for every lane of the warp
          const uint32_t* b = bp + 8 * ks * sj + 8 * q * sn;
          const uint32_t b0 = b[0];
          const uint32_t b1 = b[4 * sj];
#pragma unroll
          for (int c = 0; c < 4; ++c) mma_u8(acc[c][q], a[c], b0, b1);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = an[c];
    }
#pragma unroll
    for (int q = 0; q < kTiles; ++q) {
      if (n0 + 8 * q < ncols) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * ib + g + 8 * h;
          if (i < k) {
            const uint32_t y0 = recombine(acc[0][q][2 * h], acc[1][q][2 * h], acc[2][q][2 * h],
                                          acc[3][q][2 * h], f);
            const uint32_t y1 = recombine(acc[0][q][2 * h + 1], acc[1][q][2 * h + 1],
                                          acc[2][q][2 * h + 1], acc[3][q][2 * h + 1], f);
            emit(i, n0 + 8 * q + 2 * tg, y0, y1);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t post_ops(uint32_t v, uint32_t u, uint32_t w, uint32_t row,
                                             uint32_t o, const LimbArgs& a) {
  const Fp f = a.f;
  if (a.ut != nullptr) v = fp_mul_r(fp_mul_r(v, u, f), w, f);
  if (a.post.a != nullptr) v = fp_mul_r(v, geo_factor(a.post, row, o, f), f);
  if (a.has_scale) v = fp_mul_r(v, a.scale, f);
  return v;
}

// 16 warps an SM, 128 registers a thread: two blocks of 256 threads where two
// rows fit the SM's shared memory, one block of 512 where one does (m = 16384)
template <int THREADS>
__global__ void __launch_bounds__(THREADS, 512 / THREADS) limb_dft_rows_kernel(const LimbArgs a) {
  constexpr int kThreads = THREADS;
  extern __shared__ uint32_t smem[];
  const int k1 = 1 << a.log_k1;
  const int k2 = 1 << a.log_k2;
  const int log_m = a.log_k1 + a.log_k2;
  const int sx = k2 + 8;
  const int sy = k2 + 4;
  uint32_t* X = smem;            // [j1][j2], row stride sx
  uint32_t* Y = smem + k1 * sx;  // [t][j2], row stride sy
  const uint32_t row = blockIdx.x;
  const Fp f = a.f;
  const int tid = threadIdx.x;

  // rows of X that hold input, rounded up to whole k-steps of 8
  const int ksteps1 = (((a.valid + k2 - 1) >> a.log_k2) + 7) >> 3;
  const int fill = (ksteps1 * 8) << a.log_k2;
  const uint32_t* xr = a.x + static_cast<int64_t>(row) * a.valid;
  if (a.vec_in) {
    for (int q = tid; q < (a.valid >> 2); q += kThreads) {
      const uint4 t = __ldcs(reinterpret_cast<const uint4*>(xr) + q);
      uint32_t e[4] = {t.x, t.y, t.z, t.w};
      const int i = 4 * q;
      if (a.pre.a != nullptr) {
#pragma unroll
        for (int d = 0; d < 4; ++d) e[d] = fp_mul_r(e[d], geo_factor(a.pre, row, i + d, f), f);
      }
      // k2 and sx are multiples of 4: the four words share a row of X
      *reinterpret_cast<uint4*>(X + (i >> a.log_k2) * sx + (i & (k2 - 1))) =
          make_uint4(e[0], e[1], e[2], e[3]);
    }
  } else {
    for (int i = tid; i < a.valid; i += kThreads) {
      uint32_t e = __ldcs(xr + i);
      if (a.pre.a != nullptr) e = fp_mul_r(e, geo_factor(a.pre, row, i, f), f);
      X[(i >> a.log_k2) * sx + (i & (k2 - 1))] = e;
    }
  }
  for (int i = a.valid + tid; i < fill; i += kThreads) X[(i >> a.log_k2) * sx + (i & (k2 - 1))] = 0u;
  __syncthreads();

  // stage 1: contract j1 (X[j1][n = j2]); a[t][j2]·w^{t·j2} -> Y[t][j2]
  dft_stage<THREADS>(X, sx, 1, a.af1, a.log_k1, ksteps1, k2, f,
            [&](int t, int j2, uint32_t y0, uint32_t y1) {
              const uint2 w = __ldg(reinterpret_cast<const uint2*>(a.tw + (t << a.log_k2) + j2));
              *reinterpret_cast<uint2*>(Y + t * sy + j2) =
                  make_uint2(fp_mul_r(y0, w.x, f), fp_mul_r(y1, w.y, f));
            });
  __syncthreads();

  // stage 2: contract j2 (Y[n = t][j2]); output index t + k1·s
  uint32_t* orow = a.out + (static_cast<int64_t>(row) << log_m);
  const bool twiddle = a.ut != nullptr;
  const uint32_t* ur = twiddle ? a.ut + (static_cast<int64_t>(row >> a.vlog) << log_m) : nullptr;
  const uint32_t* vr =
      twiddle ? a.vt + (static_cast<int64_t>(row & ((1u << a.vlog) - 1u)) << log_m) : nullptr;
  dft_stage<THREADS>(Y, 1, sy, a.af2, a.log_k2, k2 >> 3, k1, f,
            [&](int s, int t, uint32_t y0, uint32_t y1) {
              const int o = (s << a.log_k1) + t;
              uint2 u = make_uint2(0u, 0u);
              uint2 w = u;
              if (twiddle) {
                u = __ldg(reinterpret_cast<const uint2*>(ur + o));
                w = __ldg(reinterpret_cast<const uint2*>(vr + o));
              }
              __stcs(reinterpret_cast<uint2*>(orow + o),
                     make_uint2(post_ops(y0, u.x, w.x, row, o, a),
                                post_ops(y1, u.y, w.y, row, o + 1, a)));
            });
}

// the largest dynamic shared memory with which two blocks share an SM
// (227 KB a block at most, 1 KB reserved per block)
constexpr int kTwoBlocksSmem = 113 * 1024;

template <int THREADS>
cudaError_t launch_limb(const LimbArgs& a, int64_t batch, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        limb_dft_rows_kernel<THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
  }
  limb_dft_rows_kernel<THREADS><<<static_cast<unsigned>(batch), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

}  // namespace

// x: (batch, valid) uint32 reduced residues, valid <= m = 2^(log_k1 + log_k2),
// 4 <= log_k1 <= 7, log_k2 = log_k1 or log_k1 - 1 >= 3; out: (batch, m);
// natural order in and out. af1, af2: the fragment-ordered limb matrices of
// the two stages; tw: the (k1, k2) in-row twiddle. pre_*/post_*: the geometric
// factor on load / on store (a null: off). ut, vt: the twiddle tables (null:
// off), 1 << vlog rows in vt. has_scale: every output times `scale`. out, tw,
// ut and vt must be 8-byte aligned.
extern "C" int zk_limb_dft_rows(const uint32_t* x, uint32_t* out, const uint32_t* af1,
                                const uint32_t* af2, const uint32_t* tw, int log_k1, int log_k2,
                                int64_t batch, int valid, const uint32_t* pre_a,
                                const uint32_t* pre_b, int pre_shift, uint32_t pre_es,
                                uint32_t pre_rs, const uint32_t* post_a, const uint32_t* post_b,
                                int post_shift, uint32_t post_es, uint32_t post_rs,
                                const uint32_t* ut, const uint32_t* vt, int vlog, uint32_t scale,
                                int has_scale, uint32_t p, uint32_t pinv, cudaStream_t stream) {
  const auto misaligned8 = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 7u) != 0u; };
  if (log_k1 < 4 || log_k1 > 7 || log_k2 < 3 || log_k2 > log_k1 || log_k1 - log_k2 > 1 ||
      batch < 0 || batch > 0x7fffffff || valid < 1 || valid > (1 << (log_k1 + log_k2)) ||
      vlog < 0 || vlog > 30 || (ut == nullptr) != (vt == nullptr) || !aligned16(af1) ||
      !aligned16(af2) || misaligned8(out) || misaligned8(tw) || misaligned8(ut) ||
      misaligned8(vt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  LimbArgs a;
  a.x = x;
  a.out = out;
  a.af1 = reinterpret_cast<const uint4*>(af1);
  a.af2 = reinterpret_cast<const uint4*>(af2);
  a.tw = tw;
  a.log_k1 = log_k1;
  a.log_k2 = log_k2;
  a.valid = valid;
  a.vec_in = (valid % 4 == 0 && aligned16(x)) ? 1 : 0;
  a.pre = Geo{pre_a, pre_b, pre_shift, pre_es, pre_rs};
  a.post = Geo{post_a, post_b, post_shift, post_es, post_rs};
  a.ut = ut;
  a.vt = vt;
  a.vlog = vlog;
  a.scale = scale;
  a.has_scale = has_scale;
  a.f = Fp{p, pinv};
  const int k1 = 1 << log_k1;
  const int k2 = 1 << log_k2;
  const int smem = k1 * ((k2 + 8) + (k2 + 4)) * static_cast<int>(sizeof(uint32_t));
  return static_cast<int>(smem > kTwoBlocksSmem ? launch_limb<512>(a, batch, smem, stream)
                                                 : launch_limb<256>(a, batch, smem, stream));
}
