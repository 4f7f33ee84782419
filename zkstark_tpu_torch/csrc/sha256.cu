// Kernel A: batched SHA-256 of Merkle leaves and nodes.
//
// Replaces zkstark_tpu/ops/sha256_kernel.py _leaf_kernel (sha256_leaf) and
// _node_kernel (sha256_node). SHA-256 is bound by 32-bit integer ALU work,
// about a thousand adds, rotates, xors and ands per 64-byte compression,
// against 4 (leaf) or 64 (node) bytes read per hash. So: one thread per
// hash, the 16-word rolling message schedule and the state in registers
// (the loops are fully unrolled, so every index is a constant), rotates on
// the funnel shifter, 16-byte vector loads and stores, and the node's second
// block, the constant padding of a 64-byte message, as a precomputed
// schedule-plus-K table. Any n >= 1 is taken; the ragged last block is
// masked.
//
// Reference semantics (merkle.rs:30-45): leaf = SHA256(u32 big-endian),
// node = SHA256(left || right); digests are 8 big-endian words.
#include <cstdint>

#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

using namespace sha256;

__device__ __forceinline__ void store_digest(uint32_t* out, const uint32_t st[8]) {
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(st[0], st[1], st[2], st[3]);
  o[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

__global__ void sha256_leaf(const uint32_t* __restrict__ vals, uint32_t* __restrict__ out,
                            int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16];
  w[0] = vals[i];
  w[1] = 0x80000000u;
#pragma unroll
  for (int j = 2; j < 15; ++j) w[j] = 0u;
  w[15] = 32u;  // message length in bits
  uint32_t st[8];
  init_state(st);
  compress(st, w);
  store_digest(out + i * 8, st);
}

__global__ void sha256_node(const uint32_t* __restrict__ children, uint32_t* __restrict__ out,
                            int64_t k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const uint4* c = reinterpret_cast<const uint4*>(children + i * 16);
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = c[q];
    w[4 * q + 0] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  uint32_t st[8];
  init_state(st);
  compress(st, w);
  compress_pad512(st);
  store_digest(out + i * 8, st);
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// vals: (n,) uint32 residues -> out: (n, 8) digests.
extern "C" int zk_sha256_leaf(const uint32_t* vals, uint32_t* out, int64_t n,
                              cudaStream_t stream) {
  if (n < 0 || n > 0x7fffffffLL * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) sha256_leaf<<<blocks_for(n), kThreads, 0, stream>>>(vals, out, n);
  return static_cast<int>(cudaGetLastError());
}

// children: (2k, 8) digests, 16-byte aligned -> out: (k, 8) parents.
extern "C" int zk_sha256_node(const uint32_t* children, uint32_t* out, int64_t k,
                              cudaStream_t stream) {
  if (k < 0 || k > 0x7fffffffLL * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0) sha256_node<<<blocks_for(k), kThreads, 0, stream>>>(children, out, k);
  return static_cast<int>(cudaGetLastError());
}
