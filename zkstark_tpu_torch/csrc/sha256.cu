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
// sha256_tree_tail is sha256_node for the shape the Merkle trees really
// launch: above its first few levels a tree has fewer parents than the card
// has threads, a launch a level is then nothing but the host's enqueue
// (20-30 us each, log2(n) of them a tree), and the JAX package left these
// levels to XLA, which fused them into the one program. Here one block a
// tree hashes level after level: thread j < parents hashes its two children,
// writes the parent to device memory (every level is kept: the openings read
// them) and hands it to the next level through shared memory. What bounds it
// is latency, not throughput: one dependent node hash a level. It can start
// from the residues (the leaf hashes inside), so that a tree of at most
// 2 * kTailMax values is one launch.
//
// Both hash kernels also take the TPU kernels' own word-plane layout (the
// template parameter kPlanes): digest i as word w at out[w * n + i], 8 planes
// of n words, as _leaf_kernel and _node_kernel store it (sha256_kernel.py:
// 152-178), flat on the card (no 128-lane rows). The plane-major node reads
// its 16 message words from two sets of 8 planes, `left` and `right`, each
// plane `stride` words apart: for a level stored in bit-reversed order
// (node_planes_folded) the left children are the first half of each plane and
// the right children the second. Thread i then loads word w of its children
// from left[w * stride + i] and right[w * stride + i] and stores word w of its
// parent at out[w * k + i]: every load and store is 128 consecutive bytes a
// warp, where the row-major node reads four 16-byte vectors at a 64-byte
// stride. The arithmetic is the same; kPlanes = false is the row-major kernel
// as it was.
//
// sha256_leaf_rows is the leaf of a trace of w columns: leaf i of a tree
// hashes row i, its w words big-endian, in one block for w <= 13 (52 bytes of
// message, the pad byte and the 8-byte length fit 64). The columns lie one
// after the other, (trees, w, n): thread i reads word c at c·n + i, so a
// warp's loads of one column are 128 consecutive bytes.
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

// Digest i of n: row-major at out[i * 8], or word w at out[w * n + i].
template <bool kPlanes>
__device__ __forceinline__ void store_hash(uint32_t* out, int64_t i, int64_t n,
                                           const uint32_t st[8]) {
  if constexpr (kPlanes) {
#pragma unroll
    for (int w = 0; w < 8; ++w) out[w * n + i] = st[w];
  } else {
    store_digest(out + i * 8, st);
  }
}

template <bool kPlanes>
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
  store_hash<kPlanes>(out, i, n, st);
}

// Row-major: children (2k, 8) at `left`, `right` and `stride` unused (they
// come last, so the row-major instance's parameters keep their offsets).
// Plane-major: word w of the left child of parent i at left[w * stride + i],
// of the right child at right[w * stride + i].
template <bool kPlanes>
__global__ void sha256_node(const uint32_t* __restrict__ left, uint32_t* __restrict__ out,
                            int64_t k, const uint32_t* __restrict__ right, int64_t stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= k) return;
  uint32_t w[16];
  if constexpr (kPlanes) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      w[q] = left[q * stride + i];
      w[8 + q] = right[q * stride + i];
    }
  } else {
    const uint4* c = reinterpret_cast<const uint4*>(left + i * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = c[q];
      w[4 * q + 0] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
  uint32_t st[8];
  init_state(st);
  compress(st, w);
  compress_pad512(st);
  store_hash<kPlanes>(out, i, k, st);
}

constexpr int kRowMax = 13;  // most words of a row leaf: one block

// Leaf g of trees·2^log_n: tree g >> log_n, row i = g & (2^log_n − 1) of its
// (width, 2^log_n) columns.
__global__ void sha256_leaf_rows(const uint32_t* __restrict__ vals, uint32_t* __restrict__ out,
                                 int64_t leaves, int log_n, int width) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= leaves) return;
  const int64_t n = int64_t{1} << log_n;
  const uint32_t* row = vals + (g >> log_n) * width * n + (g & (n - 1));
  uint32_t w[16];
#pragma unroll
  for (int c = 0; c < 15; ++c) {
    w[c] = c < width ? __ldg(row + c * n) : (c == width ? 0x80000000u : 0u);
  }
  w[15] = 32u * static_cast<uint32_t>(width);  // message length in bits
  uint32_t st[8];
  init_state(st);
  compress(st, w);
  store_digest(out + g * 8, st);
}

constexpr int kTailMax = 1024;  // most parents of a tail's first level: one thread each

// One block a tree, blockDim.x >= t threads. in: the children of the first
// level, (trees, 2t, 8) digests, or with from_values (trees, 2t) residues.
// out: the levels back to back, each (trees, k, 8): with from_values the 2t
// leaves first, then k = t, t/2, ..., 1.
__global__ void __launch_bounds__(kTailMax) sha256_tree_tail(const uint32_t* __restrict__ in,
                                                             uint32_t* __restrict__ out, int t,
                                                             int from_values) {
  __shared__ uint4 buf[2 * kTailMax];  // the level just hashed, two uint4 a digest
  const int64_t tree = blockIdx.x;
  const int64_t trees = gridDim.x;
  const int j = threadIdx.x;
  uint32_t w[16];
  uint32_t st[8];
  uint32_t* level = out;
  if (from_values) {
    if (j < t) {
      const int64_t leaf = (tree * t + j) * 2;
      const uint2 v = *reinterpret_cast<const uint2*>(in + leaf);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t m[16];
        m[0] = h ? v.y : v.x;
        m[1] = 0x80000000u;
#pragma unroll
        for (int q = 2; q < 15; ++q) m[q] = 0u;
        m[15] = 32u;
        init_state(st);
        compress(st, m);
        store_digest(level + (leaf + h) * 8, st);
#pragma unroll
        for (int q = 0; q < 8; ++q) w[8 * h + q] = st[q];
      }
    }
    level += trees * t * 16;
  } else if (j < t) {
    const uint4* c = reinterpret_cast<const uint4*>(in + (tree * t + j) * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = c[q];
      w[4 * q + 0] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
#pragma unroll 1
  for (int k = t;; k >>= 1) {
    if (j < k) {
      init_state(st);
      compress(st, w);
      compress_pad512(st);
      store_digest(level + (tree * k + j) * 8, st);
    }
    if (k == 1) break;
    __syncthreads();  // the level below has been read from buf
    if (j < k) {
      buf[2 * j] = make_uint4(st[0], st[1], st[2], st[3]);
      buf[2 * j + 1] = make_uint4(st[4], st[5], st[6], st[7]);
    }
    __syncthreads();
    if (j < k / 2) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = buf[4 * j + q];
        w[4 * q + 0] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
    }
    level += trees * k * 8;
  }
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
  if (n > 0) sha256_leaf<false><<<blocks_for(n), kThreads, 0, stream>>>(vals, out, n);
  return static_cast<int>(cudaGetLastError());
}

// vals: (trees, width, 2^log_n) residues, the columns of each tree one after
// the other, 1 <= width <= 13 -> out: (trees·2^log_n, 8) digests, 16-byte
// aligned, leaf i of a tree the hash of its row i.
extern "C" int zk_sha256_leaf_rows(const uint32_t* vals, uint32_t* out, int64_t trees, int log_n,
                                   int width, cudaStream_t stream) {
  if (trees < 0 || log_n < 0 || log_n > 40 || width < 1 || width > kRowMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t leaves = trees << log_n;
  if (leaves > 0x7fffffffLL * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (leaves > 0) {
    sha256_leaf_rows<<<blocks_for(leaves), kThreads, 0, stream>>>(vals, out, leaves, log_n, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// children: (2k, 8) digests, 16-byte aligned -> out: (k, 8) parents.
extern "C" int zk_sha256_node(const uint32_t* children, uint32_t* out, int64_t k,
                              cudaStream_t stream) {
  if (k < 0 || k > 0x7fffffffLL * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0) {
    sha256_node<false><<<blocks_for(k), kThreads, 0, stream>>>(children, out, k, nullptr, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals: (n,) uint32 residues -> out: (8, n) word planes, word w of hash i at
// out[w * n + i].
extern "C" int zk_sha256_leaf_planes(const uint32_t* vals, uint32_t* out, int64_t n,
                                     cudaStream_t stream) {
  if (n < 0 || n > 0x7fffffffLL * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) sha256_leaf<true><<<blocks_for(n), kThreads, 0, stream>>>(vals, out, n);
  return static_cast<int>(cudaGetLastError());
}

// left, right: 8 planes each, plane w at w * stride words (stride >= k); word w
// of parent i's left child at left[w * stride + i] -> out: (8, k) planes.
extern "C" int zk_sha256_node_planes(const uint32_t* left, const uint32_t* right, uint32_t* out,
                                     int64_t k, int64_t stride, cudaStream_t stream) {
  if (k < 0 || k > 0x7fffffffLL * kThreads || stride < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k > 0) {
    sha256_node<true><<<blocks_for(k), kThreads, 0, stream>>>(left, out, k, right, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// The top of `trees` Merkle trees in one launch. in: (trees, 2t, 8) digests,
// or with from_values (trees, 2t) residues, 8-byte aligned; t a power of two,
// 1 <= t <= 1024. out: the levels back to back, each (trees, k, 8): with
// from_values the 2t leaf digests first, then k = t, t/2, ..., 1.
extern "C" int zk_sha256_tree_tail(const uint32_t* in, uint32_t* out, int64_t trees, int t,
                                   int from_values, cudaStream_t stream) {
  if (trees < 0 || trees > 0x7fffffffLL || t < 1 || t > kTailMax || (t & (t - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (trees > 0) {
    const unsigned threads = static_cast<unsigned>(t < 32 ? 32 : t);
    sha256_tree_tail<<<static_cast<unsigned>(trees), threads, 0, stream>>>(in, out, t,
                                                                           from_values);
  }
  return static_cast<int>(cudaGetLastError());
}
