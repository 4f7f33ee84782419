// Kernel G: one evaluation-form FRI fold, with from_mont fused in.
//
// Counterpart of zkstark_tpu/protocol/prover.py fri_fold_eval without the
// Merkle tree, which XLA fused into one elementwise pass on the TPU and which
// as plain tensor ops is seven field ops of several launches each over int64
// temporaries. For each of B proofs, with a = evals[j], b = evals[j + m/2]:
//
//   folded[j] = (a + b)/2 + beta * (a - b)/(2 x_j),   res[j] = from_mont(folded[j])
//
// on the layer's half-domain x_j = off * base^j. 1/x_j is geometric, so it is
// not a table of m/2 words: inv_base^j = A[j >> s] * B[j & (2^s - 1)] from two
// small cached device tables (the GeoScale tables of the NTT row kernel), and
// the scalar beta/(2 off) is one product a thread; beta is read from device
// memory, so the host never waits for the challenge. Montgomery products are
// exact modulo p and every operand is a reduced residue, so the outputs are
// the canonical words the JAX arrays hold.
//
// Bound by bytes: 4 m read and 2 * 2 m written per proof against about 45
// integer ops an output. So each thread moves 16 bytes per access (four
// neighbouring outputs) wherever the half-domain allows it.
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

struct FoldArgs {
  const uint32_t* evals;  // (batch, 2 * half) Montgomery, reduced
  const uint32_t* beta;   // (batch,) Montgomery, reduced
  const uint32_t* ga;     // inv_base^(j >> shift << shift), Montgomery
  const uint32_t* gb;     // inv_base^(j & mask), Montgomery
  int shift;
  uint32_t* folded;       // (batch, half) Montgomery
  uint32_t* res;          // (batch, half) standard residues
  int64_t half;
  uint32_t scale;         // 1/(2 off), Montgomery
  uint32_t inv2;          // 1/2, Montgomery
  Fp f;
};

__device__ __forceinline__ void fold_one(const FoldArgs& a, int64_t j, uint32_t x, uint32_t y,
                                         uint32_t c, uint32_t* fo, uint32_t* re) {
  const uint32_t mask = (1u << a.shift) - 1u;
  const uint32_t ix = fp_mul_r(__ldg(a.ga + (j >> a.shift)),
                               __ldg(a.gb + (static_cast<uint32_t>(j) & mask)), a.f);
  const uint32_t even = fp_mul_r(fp_add_r(x, y, a.f), a.inv2, a.f);
  const uint32_t odd = fp_mul_r(fp_mul_r(fp_sub(x, y, a.f), ix, a.f), c, a.f);
  *fo = fp_add_r(even, odd, a.f);
  *re = fp_from_mont(*fo, a.f);
}

template <bool VEC>
__global__ void fri_fold_kernel(const FoldArgs a) {
  constexpr int PER = VEC ? 4 : 1;
  const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * PER;
  if (j0 >= a.half) return;
  const int64_t b = blockIdx.y;
  const uint32_t* row = a.evals + b * 2 * a.half;
  const uint32_t c = fp_mul_r(a.scale, __ldg(a.beta + b), a.f);  // beta / (2 off)
  uint32_t* fo = a.folded + b * a.half + j0;
  uint32_t* re = a.res + b * a.half + j0;
  if constexpr (VEC) {
    const uint4 x = *reinterpret_cast<const uint4*>(row + j0);
    const uint4 y = *reinterpret_cast<const uint4*>(row + a.half + j0);
    uint4 o, r;
    fold_one(a, j0, x.x, y.x, c, &o.x, &r.x);
    fold_one(a, j0 + 1, x.y, y.y, c, &o.y, &r.y);
    fold_one(a, j0 + 2, x.z, y.z, c, &o.z, &r.z);
    fold_one(a, j0 + 3, x.w, y.w, c, &o.w, &r.w);
    *reinterpret_cast<uint4*>(fo) = o;
    *reinterpret_cast<uint4*>(re) = r;
  } else {
    fold_one(a, j0, row[j0], row[a.half + j0], c, fo, re);
  }
}

constexpr int kThreads = 256;

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

}  // namespace

// evals: (batch, 2 * half) -> folded, res: (batch, half); beta: (batch,);
// ga, gb, shift: the two-table form of inv_base^j for j < half; scale and
// inv2 Montgomery scalars. batch <= 65535.
extern "C" int zk_fri_fold(const uint32_t* evals, const uint32_t* beta, const uint32_t* ga,
                           const uint32_t* gb, int shift, uint32_t* folded, uint32_t* res,
                           int64_t batch, int64_t half, uint32_t scale, uint32_t inv2,
                           uint32_t p, uint32_t pinv, cudaStream_t stream) {
  if (batch < 0 || batch > 65535 || half < 0 || half > (1LL << 40) || shift < 0 || shift > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0 && half > 0) {
    const FoldArgs a{evals, beta, ga, gb, shift, folded, res, half, scale, inv2, Fp{p, pinv}};
    const bool vec = half % 4 == 0 && aligned16(evals) && aligned16(folded) && aligned16(res);
    const int64_t threads = vec ? half / 4 : half;
    const int64_t blocks = (threads + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
    if (vec) {
      fri_fold_kernel<true><<<grid, kThreads, 0, stream>>>(a);
    } else {
      fri_fold_kernel<false><<<grid, kThreads, 0, stream>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
