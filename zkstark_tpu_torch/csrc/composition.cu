// Kernel I: the pointwise constraint composition, with from_mont fused in.
//
// Counterpart of zkstark_tpu/protocol/prover.py composition_eval and the
// from_mont after it, which XLA fused into one elementwise pass on the TPU
// and which as plain tensor ops are a few hundred launches over int64
// temporaries of the whole domain. For each of B proofs and each point j < d:
//
//   cp[j] = sum_c alpha_c · num_c(j) · inv_den_c[j],   res[j] = from_mont(cp[j])
//
// The constraint system is a small program in device memory (the host's
// ops/composition.py Program), the same for every thread:
//
//   [n_constraints] then per constraint
//     [0, value]                 num = f[j] - value                  (boundary)
//     [1, n_ops, (op, arg)...]   num = the postfix program's result  (transition)
//       OP_F      push f[(j + arg) mod d]      (f(g^k x_j): arg = k·blowup)
//                 or, with w > 1 columns, f_c[(j + s) mod d] for
//                 arg = c·d + s: column c of the proof's (w, d) rows
//       OP_X      push x_j = offset · h^j      (two table words and a scalar)
//       OP_CONST  push arg                     (Montgomery)
//       OP_ADD, OP_SUB, OP_MUL  pop b, pop a, push a op b
//
// The host has checked that the stack stays within kDepth and ends with one
// value. Every operand is a reduced residue and every op returns the one
// residue in [0, p), so the words equal those of the plain field ops.
//
// A shard of the sharded prover (parallel/pipeline.py) holds `len` < d points,
// j = start + i for i < len, and the first `hlen` words of the next shard's
// block as a halo: f(g^k x_j) is then row[i + arg] while that is below len,
// else halo[i + arg - len] (hlen >= the largest arg; no wrap). Without a halo
// len = d, start = 0 and the read wraps mod d. The inverse denominators are
// read at column start + i of their (n_constraints, d) rows, and x_j from the
// tables at start + i.
//
// A trace of w > 1 columns (the instance kWide) holds each proof's columns
// one after the other, (batch, w, d), and is never a shard's block. Its
// boundaries on a column c > 0 come as transition programs (OP_F c·d, OP_CONST
// value, OP_SUB); the boundary kind reads column 0. kWide = false is the one
// column's instance as it was: it reads neither `width` nor `log_d`.
//
// Bound by bytes: 4 read for f (its shifted reads hit cache), 4 per constraint
// for the inverse denominators, 8 written, against some tens of integer ops
// a point. So a thread takes four neighbouring points and moves 16 bytes per
// access wherever the domain, the shifts and the pointers allow it.
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

enum : uint32_t { OP_F = 0, OP_X = 1, OP_CONST = 2, OP_ADD = 3, OP_SUB = 4, OP_MUL = 5 };
constexpr int kDepth = 8;
constexpr int kThreads = 256;

struct CompArgs {
  const uint32_t* f;       // (batch, len) Montgomery
  const uint32_t* halo;    // (batch, hlen) Montgomery, or null: the reads wrap mod len
  const uint32_t* inv;     // (n_constraints, d) Montgomery, read from column start
  const uint32_t* alphas;  // (batch, n_constraints) Montgomery
  const uint32_t* prog;
  const uint32_t* ga;      // h^(j >> shift << shift), Montgomery
  const uint32_t* gb;      // h^(j & mask), Montgomery
  int shift;
  uint32_t offset;         // the coset offset, Montgomery
  uint32_t* cp;            // (batch, len) Montgomery
  uint32_t* res;           // (batch, len) standard residues
  int64_t len;             // points of this call
  int64_t hlen;
  int64_t start;           // the domain index of point 0
  int64_t d;
  Fp field;
  int64_t width;           // columns a proof (kWide)
  int log_d;               // log2 d (kWide)
};

template <int PER>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&v)[PER]) {
  if constexpr (PER == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int PER>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&v)[PER]) {
  if constexpr (PER == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int PER, bool kWide>
__global__ void __launch_bounds__(kThreads) composition_kernel(const CompArgs a) {
  const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * PER;
  if (j0 >= a.len) return;
  const Fp f = a.field;
  const int64_t b = blockIdx.y;
  const uint32_t* frow = a.f + b * a.len * (kWide ? a.width : 1);
  const uint32_t* hrow = a.halo == nullptr ? nullptr : a.halo + b * a.hlen;
  const uint32_t* pw = a.prog;
  const int n_con = static_cast<int>(__ldg(pw++));
  const uint32_t* alpha = a.alphas + b * n_con;
  uint32_t acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) acc[e] = 0u;
  for (int c = 0; c < n_con; ++c) {
    uint32_t num[PER];
    if (__ldg(pw++) == 0u) {
      const uint32_t value = __ldg(pw++);
      load_words<PER>(frow + j0, num);
#pragma unroll
      for (int e = 0; e < PER; ++e) num[e] = fp_sub(num[e], value, f);
    } else {
      const int n_ops = static_cast<int>(__ldg(pw++));
      // the top of the stack stays in registers (num); st holds what is below it
      uint32_t st[kDepth - 1][PER];
      int below = -1;  // values in st; -1: the stack is empty
      for (int o = 0; o < n_ops; ++o) {
        const uint32_t op = __ldg(pw + 2 * o);
        const uint32_t arg = __ldg(pw + 2 * o + 1);
        if (op <= OP_CONST) {  // a push
          if (below >= 0) {
#pragma unroll
            for (int e = 0; e < PER; ++e) st[below][e] = num[e];
          }
          ++below;
          if (kWide && op == OP_F) {
            // arg = c·d + s, s < d; with PER = 4, s a multiple of 4
            const int64_t at = j0 + (arg & static_cast<uint32_t>(a.d - 1));
            load_words<PER>(frow + (arg >> a.log_d) * a.len + (at < a.len ? at : at - a.len), num);
          } else if (op == OP_F) {
            // arg < d; with PER = 4 a multiple of 4, like j0, len and hlen
            const int64_t at = j0 + arg;
            if (at < a.len) {
              load_words<PER>(frow + at, num);
            } else if (hrow != nullptr) {
              load_words<PER>(hrow + (at - a.len), num);
            } else {
              load_words<PER>(frow + (at - a.len), num);
            }
          } else if (op == OP_X) {
            const uint32_t mask = (1u << a.shift) - 1u;
#pragma unroll
            for (int e = 0; e < PER; ++e) {
              const int64_t j = a.start + j0 + e;
              const uint32_t hj = fp_mul_r(__ldg(a.ga + (j >> a.shift)),
                                           __ldg(a.gb + (static_cast<uint32_t>(j) & mask)), f);
              num[e] = fp_mul_r(hj, a.offset, f);
            }
          } else {
#pragma unroll
            for (int e = 0; e < PER; ++e) num[e] = arg;
          }
        } else {  // pop b (the top), pop a, push a op b
          --below;
#pragma unroll
          for (int e = 0; e < PER; ++e) {
            const uint32_t x = st[below][e];
            const uint32_t y = num[e];
            num[e] = op == OP_MUL ? fp_mul_r(x, y, f)
                                  : (op == OP_ADD ? fp_add_r(x, y, f) : fp_sub(x, y, f));
          }
        }
      }
      pw += 2 * n_ops;
    }
    uint32_t inv[PER];
    load_words<PER>(a.inv + c * a.d + a.start + j0, inv);
    const uint32_t al = __ldg(alpha + c);
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      acc[e] = fp_add_r(acc[e], fp_mul_r(fp_mul_r(num[e], inv[e], f), al, f), f);
    }
  }
  uint32_t res[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) res[e] = fp_from_mont(acc[e], f);
  store_words<PER>(a.cp + b * a.len + j0, acc);
  store_words<PER>(a.res + b * a.len + j0, res);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

}  // namespace

// f: (batch, len), or (batch, width, len) for width > 1 columns (then no
// halo, and d a power of two); halo: (batch, hlen) or null (then len = d, start = 0);
// inv: (n_constraints, d); alphas: (batch, n_constraints); prog: the program's
// `prog_words` words; ga, gb, shift: the two-table form of h^j for j < d;
// offset: the coset offset (Montgomery); cp, res: (batch, len), points
// start .. start + len - 1. shifts_by_4: every OP_F argument is a multiple of 4.
// batch <= 65535.
extern "C" int zk_composition(const uint32_t* f, const uint32_t* halo, int64_t hlen,
                              const uint32_t* inv, const uint32_t* alphas, const uint32_t* prog,
                              int prog_words, int shifts_by_4, const uint32_t* ga,
                              const uint32_t* gb, int shift, uint32_t offset, uint32_t* cp,
                              uint32_t* res, int64_t batch, int64_t len, int64_t start, int64_t d,
                              uint32_t p, uint32_t pinv, int64_t width, cudaStream_t stream) {
  if (batch < 0 || batch > 65535 || d < 0 || d > (1LL << 40) || prog_words < 1 || shift < 0 ||
      shift > 31 || len < 0 || start < 0 || start + len > d || hlen < 0 ||
      (halo == nullptr && (len != d || start != 0)) || width < 1 ||
      (width > 1 && (halo != nullptr || (d & (d - 1)) != 0 || width * d > (1LL << 32)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0 && len > 0) {
    int log_d = 0;
    while ((int64_t{1} << log_d) < d) ++log_d;
    const CompArgs a{f,  halo, inv,  alphas, prog, ga,    gb, shift, offset,
                     cp, res,  len,  hlen,   start, d,    Fp{p, pinv}, width, log_d};
    const bool vec = shifts_by_4 && d % 4 == 0 && len % 4 == 0 && hlen % 4 == 0 && start % 4 == 0 &&
                     aligned16(f) && aligned16(inv) && aligned16(cp) && aligned16(res) &&
                     (halo == nullptr || aligned16(halo));
    const int64_t threads = vec ? len / 4 : len;
    const int64_t blocks = (threads + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
    if (width > 1) {
      if (vec) {
        composition_kernel<4, true><<<grid, kThreads, 0, stream>>>(a);
      } else {
        composition_kernel<1, true><<<grid, kThreads, 0, stream>>>(a);
      }
    } else if (vec) {
      composition_kernel<4, false><<<grid, kThreads, 0, stream>>>(a);
    } else {
      composition_kernel<1, false><<<grid, kThreads, 0, stream>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
