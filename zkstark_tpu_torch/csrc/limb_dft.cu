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
// y[i] in Montgomery form. T_c <= 255²·512 < 2^25 fits the s32 accumulator
// with no chunking of the contraction (the TPU's bf16 -> f32 products had to
// be chunked at 64), and V <= 512·255·(p - 1) < p·2^32 meets fp_reduce's
// precondition for every odd prime below 2^32.
//
// What bounds it is the tensor cores' u8 rate (16·k multiply-adds a word and
// stage), if the matrix does not cost more than the products: with mma.sync,
// every warp streams its A fragments from L2 for every 16 x 32 outputs, 1 MB a
// row and stage against 64 KB of data, and the kernel runs at the L2's rate.
// So the products are wgmma.mma_async m64nNk32 (s32 += u8·u8) with both
// operands in shared memory:
//
//  * the limb matrix is the A operand. The host stores it tile by tile in the
//    instruction's shared-memory layout (no swizzle: core matrices of 8 rows x
//    16 bytes, K-major), so a run of k-steps of a tile pair is one contiguous
//    block that one cp.async.bulk brings into a ring slot behind an mbarrier;
//    nothing but that copy ever touches the matrix. A tile pair is 128 rows
//    (c, i) ordered so that the thread that holds rows g and g + 8 of both
//    tiles' accumulators holds T_0..T_3 of its own outputs and recombines them
//    in registers. One pair is 32 outputs i x all N = k columns: the matrix
//    crosses L2 -> shared memory once a row and stage (256 KB at k = 128, a
//    quarter of what the 16 x 32 warp tiles read from L2);
//  * the data is the B operand, which must be K-major too. Stage 2 contracts
//    j2, contiguous in Y[t][j2] already; stage 1 contracts j1, the strided
//    index of the row, so the loader writes the row transposed, XT[j2][j1],
//    16 bytes (four j1) a store. A u32 word is its four limbs, packed: the
//    contraction index is 4·j + a and no limb is ever split off.
//
// A block is persistent (one an SM, rows blockIdx.x, + gridDim.x, ...) and
// warp-specialised: two consumer warpgroups, each taking every other tile pair
// with its own three-slot ring of matrix chunks (the chunk sequence is fixed,
// so the ring runs ahead across pairs, stages and rows), and one loader
// warpgroup that brings the next row into XT (with the geometric pre-scale)
// while the consumers are in stage 2. Rows of XT past the valid prefix are
// zero and the first stage's contraction stops after them (an LDE's pass 1
// contracts 1/blowup of k1). Stage 1 writes a[t][j2]·w^{t·j2} into Y; stage 2
// stores output t + k1·s, times the four-step twiddle
// ut[r >> vlog][o]·vt[r & vmask][o], a geometric post-scale and a scalar,
// where given, to device memory as 8-byte pairs with streaming hints. The row
// r of every factor (the pre-scale's too) is the row masked by `pmask`, the
// batch period of ntt.cu: only the index changes, not the pipeline.
//
// What limits it now (NVIDIA H100 80GB HBM3, 700 W; the times are in PERF.md):
// with the epilogue switched off the products alone take 1.5 times the tensor
// cores' bound at 8192 x 16384 (an m64n128k32 reads 6 KB of shared memory for
// 64 clocks of products, and the ring's refills and the loader write there
// too), and the epilogue, about 21 integer ops an output on the 8 consumer
// warps, does not run under them: the two groups meet at the stage barriers
// and so multiply and recombine in step. Making them take turns at the tensor
// cores (one group's epilogue under the other's products) measured slower: one
// group alone does not keep the tensor cores busy, and its products slow down
// beside the other's integer work. At k2 = 64 the first stage's instructions
// are only 64 columns wide (a pair of rows side by side would fill them).
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"
#include "geo.cuh"

namespace {

constexpr int kConsumers = 2;             // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSlots = 3;                 // ring slots a consumer warpgroup
constexpr int kChunk = 4;                 // k-steps (of 32 contraction bytes) a slot
constexpr int kStepBytes = 4096;          // a tile pair's 128 rows x 32 bytes
constexpr int kSlotBytes = kChunk * kStepBytes;
constexpr int kRingBytes = kConsumers * kSlots * kSlotBytes;
constexpr int kBarBytes = 64;
// registers a thread after the warpgroups have traded (setmaxnreg): the
// launch gives each of the 384 threads 168
constexpr int kConsumerRegs = 232;
constexpr int kLoaderRegs = 40;
// named barriers (0 is __syncthreads')
constexpr int kBarXtFull = 1, kBarXtEmpty = 2, kBarY = 3;

struct LimbArgs {
  const uint32_t* x;    // (batch, valid)
  uint32_t* out;        // (batch, k1·k2)
  const uint8_t* af1;   // tile-ordered limb matrix of stage 1 (radix k1, root w^{k2})
  const uint8_t* af2;   // and of stage 2 (radix k2, root w^{k1})
  const uint32_t* tw;   // (k1, k2) in-row twiddle w^{t·j2}, Montgomery
  int batch;
  int valid;
  int vec_in;  // 16-byte global loads are possible
  Geo pre, post;
  const uint32_t* ut;  // (rows >> vlog, m), nullptr: no twiddle
  const uint32_t* vt;  // (1 << vlog, m)
  int vlog;
  uint32_t scale;
  int has_scale;
  uint32_t pmask;  // the row of the factors is r & pmask (the batch period)
  Fp f;
};

// ---- PTX: mbarrier, bulk copy, named barriers, wgmma ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The spin lives inside the PTX so that the compiler sees straight-line,
// warp-uniform code around the wgmma instructions.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LIMB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra LIMB_DONE;\n"
      "bra LIMB_WAIT;\n"
      "LIMB_DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// global -> shared, `bytes` a multiple of 16, completion counted on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int ID, int COUNT>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
}

template <int ID, int COUNT>
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
}

// generic-proxy writes to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, no swizzle, K-major: core matrices of 8
// rows x 16 bytes (128 contiguous bytes); `lbo` bytes between the two core
// matrices of a k-step, `sbo` bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D(64 x N, s32) (+)= A(64 x 32, u8, K-major) · B(N x 32, u8, K-major), both
// from shared memory; acc == 0 overwrites D. Thread (warp w of the group,
// lane 4g + tq) holds d[4j + 2h + e] = D[16w + g + 8h][8j + 2tq + e].
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.u8 {"
        "%0, %1, %2, %3}, "
        "%4, %5, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
};

// V = T_0 + T_1·2^8 + T_2·2^16 + T_3·2^24 < p·2^32 as three 64-bit
// multiply-adds, then REDC in the short form of fp_mul_r: hi(V) < p, so
// hi(V) - hi(m·p) lies in (-p, p) and one borrow test brings it to [0, p),
// the same residue as fp_reduce(V). The epilogue is integer work on 8 warps,
// a half of the kernel's time: every op here counts.
__device__ __forceinline__ uint32_t recombine(int t0, int t1, int t2, int t3, Fp f) {
  uint32_t lo, hi;
  asm("{\n.reg .u64 v;\n"
      "cvt.u64.u32 v, %2;\n"
      "mad.wide.u32 v, %3, 256, v;\n"
      "mad.wide.u32 v, %4, 65536, v;\n"
      "mad.wide.u32 v, %5, 16777216, v;\n"
      "mov.b64 {%0, %1}, v;\n}\n"
      : "=r"(lo), "=r"(hi)
      : "r"(t0), "r"(t1), "r"(t2), "r"(t3));
  const uint32_t m = lo * (0u - f.pinv);
  const uint32_t mph = __umulhi(m, f.p);
  const uint32_t d = hi - mph;
  return hi < mph ? d + f.p : d;
}

// A consumer warpgroup's feed of matrix chunks: every thread of the group
// carries the same state, the elected one starts the copies. The sequence is
// row after row, stage 1 then stage 2, the group's tile pairs p = wg, wg + 2,
// ..., each pair's k-steps in chunks of kChunk.
struct Feed {
  const uint8_t* mat1;
  const uint8_t* mat2;
  int pairs1, pairs2;      // tile pairs of each stage
  int ksteps1, ksteps2;    // k-steps contracted (stage 1: the valid prefix's)
  int kall1, kall2;        // k-steps stored a pair
  uint32_t ring, bars;     // shared addresses of the group's slots and barriers
  int wg;
  uint32_t total, started;
  int st, p, ch;

  // start copies until kSlots chunks are in flight past `complete`, the
  // number of chunks whose products are known to have been read
  __device__ __forceinline__ void pump(uint32_t complete, bool elected) {
    while (started < total && started < complete + kSlots) {
      const int ksteps = st ? ksteps2 : ksteps1;
      const int ks0 = ch * kChunk;
      const int nks = min(kChunk, ksteps - ks0);
      if (elected) {
        const uint32_t slot = started % kSlots;
        const uint32_t bytes = static_cast<uint32_t>(nks) * kStepBytes;
        const uint8_t* src = (st ? mat2 : mat1) +
                             (static_cast<size_t>(p) * (st ? kall2 : kall1) + ks0) * kStepBytes;
        mbar_expect_tx(bars + 8u * slot, bytes);
        bulk_copy(ring + slot * kSlotBytes, src, bytes, bars + 8u * slot);
      }
      __syncwarp();
      ++started;
      if (ks0 + kChunk < ksteps) {
        ++ch;
      } else {
        ch = 0;
        p += kConsumers;
        if (p >= (st ? pairs2 : pairs1)) {
          st ^= 1;
          p = wg;
          if (p >= (st ? pairs2 : pairs1)) st ^= 1;  // no pair of that stage is this group's
        }
      }
    }
  }
};

// The accumulators are in flight between a product's start and its wait: the
// compiler must neither move nor touch them there.
template <int N>
__device__ __forceinline__ void fence_registers(int (&acc)[2][N / 2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int q = 0; q < N / 2; ++q) asm volatile("" : "+r"(acc[t][q])::"memory");
}

// NKS k-steps of a tile pair: matrix slot at shared address a0, data rows at
// b0; `carry`: the accumulators hold earlier k-steps' sums.
template <int N, int NKS>
__device__ __forceinline__ void chunk_products(int (&acc)[2][N / 2], uint32_t a0, uint32_t b0,
                                            uint32_t sbo, bool carry) {
  static_assert(kChunk == 4, "chunk_products is instantiated for 1..4 k-steps");
#pragma unroll
  for (int s = 0; s < NKS; ++s) {
    const uint64_t db = smem_desc(b0 + 256u * s, 128u, sbo);
    const int accumulate = (carry || s > 0) ? 1 : 0;
    Wgmma<N>::mma(acc[0], smem_desc(a0 + s * kStepBytes, 128u, 256u), db, accumulate);
    Wgmma<N>::mma(acc[1], smem_desc(a0 + s * kStepBytes + 2048u, 128u, 256u), db, accumulate);
  }
}

// One radix-k stage on the tensor cores, for one consumer warpgroup: its tile
// pairs p = wg, wg + 2, ... < pairs, each contracted over `ksteps` k-steps
// against the N data rows at shared address `data` (k-step s at data + 256·s,
// groups of 8 rows `sbo` bytes apart). For every output i < k of its pairs and
// every pair of columns n, n + 1 (n even), emit(i, n, y0, y1) receives the two
// Montgomery outputs, each already times its factor fold(i, n, load(i, n))
// where `has_factor`. With EARLY the factors' words are fetched while the
// pair's last products run (the stage-2 tables come from L2 or device memory,
// and one warp a scheduler has nothing else to hide that latency behind);
// otherwise in the epilogue (the in-row twiddle, 64 KB and close). `consumed`
// counts the group's chunks.
template <int N, bool EARLY, class Load, class Fold, class Emit>
__device__ __forceinline__ void dft_stage(Feed& feed, uint32_t& consumed, uint32_t data,
                                          uint32_t sbo, int pairs, int ksteps, int k, Fp f,
                                          bool elected, bool has_factor, Load load, Fold fold,
                                          Emit emit) {
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll 1
  for (int p = feed.wg; p < pairs; p += kConsumers) {
    int acc[2][N / 2];
    const int i = 32 * p + 8 * w + g;
#pragma unroll 1
    for (int ks0 = 0; ks0 < ksteps; ks0 += kChunk) {
      const uint32_t slot = consumed % kSlots;
      mbar_wait(feed.bars + 8u * slot, (consumed / kSlots) & 1u);
      const uint32_t a0 = feed.ring + slot * kSlotBytes;
      const int nks = min(kChunk, ksteps - ks0);
      fence_registers<N>(acc);
      wgmma_fence();
      // a chunk's products in one basic block: a branch between two of them
      // would make the compiler fence each one off from the one before
      switch (nks) {
        case 4: chunk_products<N, 4>(acc, a0, data + 256u * ks0, sbo, ks0 > 0); break;
        case 3: chunk_products<N, 3>(acc, a0, data + 256u * ks0, sbo, ks0 > 0); break;
        case 2: chunk_products<N, 2>(acc, a0, data + 256u * ks0, sbo, ks0 > 0); break;
        default: chunk_products<N, 1>(acc, a0, data + 256u * ks0, sbo, ks0 > 0); break;
      }
      wgmma_commit();
      ++consumed;
      if (ks0 + kChunk < ksteps) {
        wgmma_wait<1>();  // the chunk before this one has been read
        feed.pump(consumed - 1, elected);
      }
    }
    uint4 words[N / 8];
    if (EARLY && has_factor && i < k) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) words[j] = load(i, 8 * j + 2 * tq);
    }
    wgmma_wait<0>();
    fence_registers<N>(acc);
    feed.pump(consumed, elected);
    if (i < k) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        // rows g (c even) and g + 8 (c odd) of tile 0 (c = 0, 1) and tile 1 (c = 2, 3)
        uint32_t y0 = recombine(acc[0][4 * j], acc[0][4 * j + 2], acc[1][4 * j],
                                acc[1][4 * j + 2], f);
        uint32_t y1 = recombine(acc[0][4 * j + 1], acc[0][4 * j + 3], acc[1][4 * j + 1],
                                acc[1][4 * j + 3], f);
        if (has_factor) {
          if (!EARLY) words[j] = load(i, 8 * j + 2 * tq);
          const uint2 c = fold(i, 8 * j + 2 * tq, words[j]);
          y0 = fp_mul_r(y0, c.x, f);
          y1 = fp_mul_r(y1, c.y, f);
        }
        emit(i, 8 * j + 2 * tq, y0, y1);
      }
    }
  }
}

// The loader warpgroup's part of one row: the first `valid` words, each times
// the pre-scale where given, transposed into XT[j2][j1] (group of 8 j2 at
// 32·k1 bytes, four j1 at 128, a j2 at 16), zeros up to whole k-steps. A thread
// takes four j1 x four j2: four 16-byte loads, then four 16-byte stores in an
// order that spreads a quarter-warp over all banks.
template <int LOG_K1, int LOG_K2>
__device__ __forceinline__ void load_row(const LimbArgs& a, uint32_t row, uint8_t* xt,
                                         int ksteps1) {
  constexpr int k1 = 1 << LOG_K1;
  constexpr int k2 = 1 << LOG_K2;
  const Fp f = a.f;
  const uint32_t* xr = a.x + static_cast<int64_t>(row) * a.valid;
  const int items = 2 * ksteps1 * (k2 / 4);
#pragma unroll 1
  for (int it = threadIdx.x & 127; it < items; it += 128) {
    const int q = it >> (LOG_K2 - 2);
    const int jb = it & (k2 / 4 - 1);
    uint32_t e[4][4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int idx = (4 * q + d) * k2 + 4 * jb;
      if (a.vec_in && idx + 4 <= a.valid) {
        const uint4 t = __ldcs(reinterpret_cast<const uint4*>(xr + idx));
        e[d][0] = t.x;
        e[d][1] = t.y;
        e[d][2] = t.z;
        e[d][3] = t.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) e[d][c] = idx + c < a.valid ? __ldcs(xr + idx + c) : 0u;
      }
    }
    if (a.pre.a != nullptr) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int idx = (4 * q + d) * k2 + 4 * jb;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (idx + c < a.valid) {
            e[d][c] = fp_mul_r(e[d][c], geo_factor(a.pre, row & a.pmask, idx + c, f), f);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int c = (s + (jb >> 1)) & 3;
      uint32_t v[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        v[d] = c == 0 ? e[d][0] : c == 1 ? e[d][1] : c == 2 ? e[d][2] : e[d][3];
      }
      const int j2 = 4 * jb + c;
      *reinterpret_cast<uint4*>(xt + (j2 >> 3) * (32 * k1) + q * 128 + (j2 & 7) * 16) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int LOG_K1, int LOG_K2>
__global__ void __launch_bounds__(kThreads, 1) limb_dft_rows_kernel(const LimbArgs a) {
  constexpr int k1 = 1 << LOG_K1;
  constexpr int k2 = 1 << LOG_K2;
  constexpr int log_m = LOG_K1 + LOG_K2;
  constexpr int pairs1 = (k1 + 31) / 32;
  constexpr int pairs2 = (k2 + 31) / 32;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xt = smem;                       // XT[j2][j1], 4·m bytes
  uint8_t* y = smem + 4 * k1 * k2;          // Y[t][j2], 4·m bytes
  uint8_t* ring = smem + 8 * k1 * k2;       // kConsumers x kSlots slots
  uint8_t* bars = ring + kRingBytes;        // kConsumers x kSlots mbarriers
  // the warpgroup's number, from a shuffle so that the compiler knows it to
  // be the same for the whole warp (the wgmma sequences branch on it)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const Fp f = a.f;

  // rows of XT that hold input, in whole k-steps of 8
  const int ksteps1 = (((a.valid + k2 - 1) >> LOG_K2) + 7) >> 3;
  const int ksteps2 = k2 >> 3;
  const int rows_mine =
      (a.batch - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
      static_cast<int>(gridDim.x);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers * kSlots; ++i) mbar_init(smem_u32(bars) + 8u * i, 1u);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- the loader warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoaderRegs));
#pragma unroll 1
    for (int r = 0; r < rows_mine; ++r) {
      const uint32_t row = blockIdx.x + static_cast<uint32_t>(r) * gridDim.x;
      if (r > 0) bar_sync<kBarXtEmpty, kThreads>();
      load_row<LOG_K1, LOG_K2>(a, row, xt, ksteps1);
      fence_async_shared();
      bar_arrive<kBarXtFull, kThreads>();
    }
    return;
  }

  // ---- a consumer warpgroup ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const bool elected = (threadIdx.x & 127) == 0;
  const int nch1 = (ksteps1 + kChunk - 1) / kChunk;
  const int nch2 = (ksteps2 + kChunk - 1) / kChunk;
  const int mine1 = pairs1 > wg ? (pairs1 - wg + kConsumers - 1) / kConsumers : 0;
  const int mine2 = pairs2 > wg ? (pairs2 - wg + kConsumers - 1) / kConsumers : 0;
  Feed feed;
  feed.mat1 = a.af1;
  feed.mat2 = a.af2;
  feed.pairs1 = pairs1;
  feed.pairs2 = pairs2;
  feed.ksteps1 = ksteps1;
  feed.ksteps2 = ksteps2;
  feed.kall1 = k1 >> 3;
  feed.kall2 = k2 >> 3;
  feed.ring = smem_u32(ring) + wg * kSlots * kSlotBytes;
  feed.bars = smem_u32(bars) + 8u * wg * kSlots;
  feed.wg = wg;
  feed.total = static_cast<uint32_t>(rows_mine) * (mine1 * nch1 + mine2 * nch2);
  feed.started = 0;
  feed.st = 0;
  feed.p = wg;
  feed.ch = 0;
  uint32_t consumed = 0;
  feed.pump(0u, elected);

  const bool twiddle = a.ut != nullptr;
#pragma unroll 1
  for (int r = 0; r < rows_mine; ++r) {
    const uint32_t row = blockIdx.x + static_cast<uint32_t>(r) * gridDim.x;
    bar_sync<kBarXtFull, kThreads>();
    // stage 1: contract j1 (XT[n = j2][j1]); a[t][j2]·w^{t·j2} -> Y[t][j2]
    dft_stage<k2, false>(
        feed, consumed, smem_u32(xt), 32u * k1, pairs1, ksteps1, k1, f, elected, true,
        [&](int t, int j2) {
          const uint2 w = __ldg(reinterpret_cast<const uint2*>(a.tw + (t << LOG_K2) + j2));
          return make_uint4(w.x, w.y, 0u, 0u);
        },
        [&](int, int, const uint4& w) { return make_uint2(w.x, w.y); },
        [&](int t, int j2, uint32_t y0, uint32_t y1) {
          *reinterpret_cast<uint2*>(y + (t >> 3) * (32 * k2) + (j2 >> 2) * 128 + (t & 7) * 16 +
                                    (j2 & 3) * 4) = make_uint2(y0, y1);
        });
    if (r + 1 < rows_mine) bar_arrive<kBarXtEmpty, kThreads>();
    fence_async_shared();
    bar_sync<kBarY, 128 * kConsumers>();  // Y is whole
    // stage 2: contract j2 (Y[n = t][j2]); output index t + k1·s
    uint32_t* orow = a.out + (static_cast<int64_t>(row) << log_m);
    const uint32_t prow = row & a.pmask;
    const uint32_t* ur = twiddle ? a.ut + (static_cast<int64_t>(prow >> a.vlog) << log_m) : nullptr;
    const uint32_t* vr =
        twiddle ? a.vt + (static_cast<int64_t>(prow & ((1u << a.vlog) - 1u)) << log_m) : nullptr;
    // the factor of output o: the four-step twiddle, the post-scale, the scalar
    dft_stage<k1, true>(
        feed, consumed, smem_u32(y), 32u * k2, pairs2, ksteps2, k2, f, elected,
        twiddle || a.post.a != nullptr || a.has_scale != 0,
        [&](int s, int t) {
          if (!twiddle) return make_uint4(0u, 0u, 0u, 0u);
          const int o = (s << LOG_K1) + t;
          const uint2 u = __ldg(reinterpret_cast<const uint2*>(ur + o));
          const uint2 w = __ldg(reinterpret_cast<const uint2*>(vr + o));
          return make_uint4(u.x, u.y, w.x, w.y);
        },
        [&](int s, int t, const uint4& uw) {
          const int o = (s << LOG_K1) + t;
          uint2 c = make_uint2(0u, 0u);
          bool have = false;
          if (twiddle) {
            c = make_uint2(fp_mul_r(uw.x, uw.z, f), fp_mul_r(uw.y, uw.w, f));
            have = true;
          }
          if (a.post.a != nullptr) {
            const uint2 q =
                make_uint2(geo_factor(a.post, prow, o, f), geo_factor(a.post, prow, o + 1, f));
            c = have ? make_uint2(fp_mul_r(c.x, q.x, f), fp_mul_r(c.y, q.y, f)) : q;
            have = true;
          }
          if (a.has_scale) {
            c = have ? make_uint2(fp_mul_r(c.x, a.scale, f), fp_mul_r(c.y, a.scale, f))
                     : make_uint2(a.scale, a.scale);
          }
          return c;
        },
        [&](int s, int t, uint32_t y0, uint32_t y1) {
          __stcs(reinterpret_cast<uint2*>(orow + (s << LOG_K1) + t), make_uint2(y0, y1));
        });
    bar_sync<kBarY, 128 * kConsumers>();  // stage 2 has read Y
  }
}

template <int LOG_K1, int LOG_K2>
cudaError_t launch_limb(const LimbArgs& a, cudaStream_t stream) {
  const int smem = (8 << (LOG_K1 + LOG_K2)) + kRingBytes + kBarBytes;
  cudaError_t rc =
      cudaFuncSetAttribute(limb_dft_rows_kernel<LOG_K1, LOG_K2>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  int dev = 0, sms = 0;
  rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.batch < sms ? a.batch : sms;
  limb_dft_rows_kernel<LOG_K1, LOG_K2><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

}  // namespace

// x: (batch, valid) uint32 reduced residues, valid <= m = 2^(log_k1 + log_k2),
// 4 <= log_k1 <= 7, log_k2 = log_k1 or log_k1 - 1 >= 3; out: (batch, m);
// natural order in and out. af1, af2: the tile-ordered limb matrices of the
// two stages; tw: the (k1, k2) in-row twiddle. pre_*/post_*: the geometric
// factor on load / on store (a null: off). ut, vt: the twiddle tables (null:
// off), 1 << vlog rows in vt. has_scale: every output times `scale`. The
// factors take row r & pmask. out, tw, ut and vt must be 8-byte aligned.
extern "C" int zk_limb_dft_rows(const uint32_t* x, uint32_t* out, const uint32_t* af1,
                                const uint32_t* af2, const uint32_t* tw, int log_k1, int log_k2,
                                int64_t batch, int valid, const uint32_t* pre_a,
                                const uint32_t* pre_b, int pre_shift, uint32_t pre_es,
                                uint32_t pre_rs, const uint32_t* post_a, const uint32_t* post_b,
                                int post_shift, uint32_t post_es, uint32_t post_rs,
                                const uint32_t* ut, const uint32_t* vt, int vlog, uint32_t scale,
                                int has_scale, uint32_t pmask, uint32_t p, uint32_t pinv,
                                cudaStream_t stream) {
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
  a.af1 = reinterpret_cast<const uint8_t*>(af1);
  a.af2 = reinterpret_cast<const uint8_t*>(af2);
  a.tw = tw;
  a.batch = static_cast<int>(batch);
  a.valid = valid;
  a.vec_in = (valid % 4 == 0 && aligned16(x)) ? 1 : 0;
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
  switch (log_k1 * 8 + log_k2) {
    case 4 * 8 + 3: rc = launch_limb<4, 3>(a, stream); break;
    case 4 * 8 + 4: rc = launch_limb<4, 4>(a, stream); break;
    case 5 * 8 + 4: rc = launch_limb<5, 4>(a, stream); break;
    case 5 * 8 + 5: rc = launch_limb<5, 5>(a, stream); break;
    case 6 * 8 + 5: rc = launch_limb<6, 5>(a, stream); break;
    case 6 * 8 + 6: rc = launch_limb<6, 6>(a, stream); break;
    case 7 * 8 + 6: rc = launch_limb<7, 6>(a, stream); break;
    case 7 * 8 + 7: rc = launch_limb<7, 7>(a, stream); break;
  }
  return static_cast<int>(rc);
}
