// Kernel E: tiled transpose of a uint32 matrix whose tail may be missing.
//
// Replaces the transposes that XLA fused into the four-step NTT on the TPU
// (zkstark_tpu/ops/ntt_kernel.py ntt_fourstep: the column-oriented kernel
// calls and `b.T`), which on the card were `.t().contiguous()` passes and a
// `torch.cat` of zeros. src is the first `valid` words of a row-major
// (rows, cols) matrix; the words from `valid` on count as zero and are never
// read. dst is the full (cols, rows) transpose. A launch transposes `batch`
// such matrices, src matrix b at b·valid words, dst matrix b at b·rows·cols:
// a batch of four-step transforms. With `brev` the rows of dst come in
// bit-reversed order, dst[brev(c)][r] = src[r][c]: the Pease row kernel
// (ntt_pease.cu) leaves its output in bit-reversed column order, and the
// transpose after it puts the transform back into natural order at no cost,
// since a warp still writes 128 consecutive bytes of one dst row.
//
// What bounds it: device memory, one read and one write of the matrix. A
// block moves a 32 x 32 tile through shared memory (33 words a row, so the
// column reads hit 32 banks), and every warp reads and writes 128
// consecutive bytes.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerStep = 8;

// brev_shift: 0, or 32 - log2(cols) for bit-reversed dst rows (cols > 1).
__global__ void transpose_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                                 int rows, int cols, int64_t valid, int brev_shift) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;
  src += static_cast<int64_t>(blockIdx.z) * valid;
  dst += static_cast<int64_t>(blockIdx.z) * rows * cols;
  for (int dy = threadIdx.y; dy < kTile; dy += kRowsPerStep) {
    const int r = r0 + dy;
    const int c = c0 + threadIdx.x;
    const int64_t idx = static_cast<int64_t>(r) * cols + c;
    tile[dy][threadIdx.x] = (r < rows && c < cols && idx < valid) ? src[idx] : 0u;
  }
  __syncthreads();
  for (int dy = threadIdx.y; dy < kTile; dy += kRowsPerStep) {
    const int c = c0 + dy;
    const int r = r0 + threadIdx.x;
    const int64_t d = brev_shift ? __brev(static_cast<uint32_t>(c)) >> brev_shift : c;
    if (c < cols && r < rows) dst[d * rows + r] = tile[threadIdx.x][dy];
  }
}

// Blocks of 2^log_elem words: output word o of a matrix is word e of element
// (c, r), read from element (r, c); `per` words a matrix. VEC words a thread
// (4: 16-byte accesses).
template <int VEC>
__global__ void transpose_blocks_kernel(const uint32_t* __restrict__ src,
                                        uint32_t* __restrict__ dst, int log_rows, int cols,
                                        int log_elem, int64_t total, int64_t per, int64_t valid) {
  int64_t o = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (o >= total) return;
  const int64_t b = o / per;
  src += b * valid;
  dst += b * per;
  o -= b * per;
  const int64_t q = o >> log_elem;
  const int64_t e = o & ((int64_t{1} << log_elem) - 1);
  const int64_t c = q >> log_rows;
  const int64_t r = q & ((int64_t{1} << log_rows) - 1);
  const int64_t idx = ((r * cols + c) << log_elem) + e;
  if constexpr (VEC == 4) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (idx + 3 < valid) {
      v = __ldg(reinterpret_cast<const uint4*>(src + idx));
    } else {
      v.x = idx < valid ? src[idx] : 0u;
      v.y = idx + 1 < valid ? src[idx + 1] : 0u;
      v.z = idx + 2 < valid ? src[idx + 2] : 0u;
    }
    *reinterpret_cast<uint4*>(dst + o) = v;
  } else {
    dst[o] = idx < valid ? src[idx] : 0u;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

}  // namespace

// src: `batch` arrays of `valid` <= rows*cols*elem words, each the head of a
// row-major (rows, cols, elem) uint32 array; dst: `batch` (cols, rows, elem)
// arrays. elem is a power of two; with elem > 1 rows is one too. brev: dst
// rows in bit-reversed order (elem = 1, cols a power of two).
extern "C" int zk_transpose(const uint32_t* src, uint32_t* dst, int rows, int cols, int elem,
                            int64_t valid, int64_t batch, int brev, cudaStream_t stream) {
  const int64_t per = static_cast<int64_t>(rows) * cols * elem;
  if (rows < 0 || cols < 0 || elem < 1 || (elem & (elem - 1)) || valid < 0 || valid > per ||
      (elem > 1 && (rows & (rows - 1))) || batch < 0 ||
      (brev && (elem > 1 || cols < 1 || (cols & (cols - 1))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = per * batch;
  if (elem > 1) {
    if (total > 0) {
      const int log_elem = 31 - __builtin_clz(static_cast<unsigned>(elem));
      const int log_rows = 31 - __builtin_clz(static_cast<unsigned>(rows));
      constexpr int kThreads = 256;
      const bool vec = elem % 4 == 0 && (batch == 1 || valid % 4 == 0) && aligned16(src) &&
                       aligned16(dst);
      const int64_t threads = vec ? total / 4 : total;
      const int64_t blocks = (threads + kThreads - 1) / kThreads;
      if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
      if (vec) {
        transpose_blocks_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            src, dst, log_rows, cols, log_elem, total, per, valid);
      } else {
        transpose_blocks_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            src, dst, log_rows, cols, log_elem, total, per, valid);
      }
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t gy = (static_cast<int64_t>(rows) + kTile - 1) / kTile;
  const int64_t gx = (static_cast<int64_t>(cols) + kTile - 1) / kTile;
  if (gy > 65535 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int brev_shift = brev && cols > 1 ? 32 - (31 - __builtin_clz(static_cast<unsigned>(cols))) : 0;
  if (gx > 0 && gy > 0 && batch > 0) {
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(batch));
    transpose_kernel<<<grid, dim3(kTile, kRowsPerStep), 0, stream>>>(src, dst, rows, cols, valid,
                                                                     brev_shift);
  }
  return static_cast<int>(cudaGetLastError());
}
