// Kernel E: tiled transpose of a uint32 matrix whose tail may be missing.
//
// Replaces the transposes that XLA fused into the four-step NTT on the TPU
// (zkstark_tpu/ops/ntt_kernel.py ntt_fourstep: the column-oriented kernel
// calls and `b.T`), which on the card were `.t().contiguous()` passes and a
// `torch.cat` of zeros. src is the first `valid` words of a row-major
// (rows, cols) matrix; the words from `valid` on count as zero and are never
// read. dst is the full (cols, rows) transpose.
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

__global__ void transpose_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                                 int rows, int cols, int64_t valid) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;
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
    if (c < cols && r < rows) dst[static_cast<int64_t>(c) * rows + r] = tile[threadIdx.x][dy];
  }
}

}  // namespace

// src: `valid` <= rows*cols words of a row-major (rows, cols) uint32 matrix;
// dst: (cols, rows).
extern "C" int zk_transpose(const uint32_t* src, uint32_t* dst, int rows, int cols, int64_t valid,
                            cudaStream_t stream) {
  if (rows < 0 || cols < 0 || valid < 0 || valid > static_cast<int64_t>(rows) * cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t gy = (static_cast<int64_t>(rows) + kTile - 1) / kTile;
  const int64_t gx = (static_cast<int64_t>(cols) + kTile - 1) / kTile;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (gx > 0 && gy > 0) {
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
    transpose_kernel<<<grid, dim3(kTile, kRowsPerStep), 0, stream>>>(src, dst, rows, cols, valid);
  }
  return static_cast<int>(cudaGetLastError());
}
