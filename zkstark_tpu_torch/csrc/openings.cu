// Kernel: every phase-4 opening of a proof (or a batch of proofs) in one
// launch, written straight into the packed result vector.
//
// Counterpart of zkstark_tpu/protocol/fused.py:225-316 (_take_val,
// _take_digest, _auth_path, sparse_openings), which XLA fused into the one
// compiled program of the fused core. As plain tensor ops the same gathers are
// some 330 launches at stark-101 and 900 at 2^24; the work itself is a few
// thousand words.
//
// The host (ops/openings.py) describes the result as segments, each a leaf
// of the packed vector in its order (sorted keys, lists in order), of shape
// (batch, q, n_idx) for values or (batch, q, n_idx, depth, 8) for auth paths,
// and hands over the arrays they read, tree by tree: the values, then the
// digest levels from the leaves up. Segment `s` reads tree arrays from
// `first` on, and slot `i` of query x opens index
//
//   idx = ((x & mask) + add[i]) & mask
//
// (the JAX index rules: x + k·blowup per shift with mask = 2^32 - 1; a FRI
// layer's x & (size - 1) and its partner + size/2). A value is
// values[idx]; level l of a path is the sibling digest levels[l][(idx >> l) ^ 1].
//
// One thread writes one word of the result. The segments, the pointer table
// and the sizes arrive by value as kernel parameters (Hopper with CUDA >= 12.1
// takes up to 32 KB of them): the level tensors are new allocations in every
// prove, and by value they need neither an upload nor a wait.
//
// A shard of the sharded prover (parallel/pipeline.py) passes its index; an
// array marked sharded is then this shard's block of 2^log_size words (or
// rows), which owns global index i when i >> log_size == shard and holds it
// at i & (2^log_size - 1); an array not marked is whole and read by shard 0
// alone. A word the shard does not own is written as 0, so that the bitwise OR
// of every shard's vector (Mesh.replicate) is the whole result. Without a
// shard (shard = -1) every array is whole and read.
//
// Bound by the latency of one dependent pair of loads (the query, then the
// word), not by bytes or operations: the result is a few KB.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegs = 64;
constexpr int kMaxArrays = 512;
constexpr int kMaxAdds = 8;

struct Seg {              // 14 words, all uint32 (the host's numpy layout)
  uint32_t out;           // the segment's first word in the result
  uint32_t first;         // its tree's values in the array table; levels follow
  uint32_t path;          // 0: one word a slot; 1: depth·8 words a slot
  uint32_t depth;
  uint32_t n_idx;         // slots a query
  uint32_t mask;
  uint32_t add[kMaxAdds];
};

struct Array {            // 16 bytes (the host's numpy layout)
  const uint32_t* ptr;    // (batch, 2^log_size[, 8]) whole, or a shard's block
  uint32_t log_size;
  uint32_t sharded;
};

struct OpenArgs {
  const uint32_t* queries;  // (batch, q)
  uint32_t* out;            // total words
  uint32_t total;
  int batch;
  int q;
  int n_segs;
  int shard;                // -1: no mesh
  Seg segs[kMaxSegs];
  Array arrays[kMaxArrays];
};

__global__ void __launch_bounds__(kThreads) openings_kernel(const OpenArgs a) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.total) return;
  int s = 0;
  while (s + 1 < a.n_segs && a.segs[s + 1].out <= i) ++s;
  // fields are read from the parameter space by index: no address of a
  // parameter is taken, so nothing is copied to local memory
  const uint32_t path = a.segs[s].path, n_idx = a.segs[s].n_idx, mask = a.segs[s].mask;
  const uint32_t width = path ? a.segs[s].depth * 8u : 1u;  // words a slot
  const uint32_t pos = i - a.segs[s].out;
  const uint32_t per_proof = static_cast<uint32_t>(a.q) * n_idx * width;
  const uint32_t b = pos / per_proof;
  const uint32_t rem = pos - b * per_proof;
  const uint32_t slot_all = rem / width;  // query · n_idx + slot
  const uint32_t word = rem - slot_all * width;
  const uint32_t qi = slot_all / n_idx;
  const uint32_t slot = slot_all - qi * n_idx;
  const uint32_t x = __ldg(a.queries + static_cast<int64_t>(b) * a.q + qi);
  uint32_t idx = ((x & mask) + a.segs[s].add[slot]) & mask;
  uint32_t col = 0;
  uint32_t row_words = 1;
  uint32_t k = a.segs[s].first;
  if (path) {
    const uint32_t level = word >> 3;
    idx = (idx >> level) ^ 1u;
    col = word & 7u;
    row_words = 8;
    k += 1 + level;
  }
  const uint32_t log_size = a.arrays[k].log_size, sharded = a.arrays[k].sharded;
  const uint32_t size = 1u << log_size;
  bool own = a.shard <= 0;
  if (sharded) {
    own = (idx >> log_size) == static_cast<uint32_t>(a.shard);
    idx &= size - 1u;
  }
  uint32_t v = 0u;
  if (own && idx < size) {
    const int64_t at = (static_cast<int64_t>(sharded ? 0u : b) * size + idx) * row_words + col;
    v = __ldg(a.arrays[k].ptr + at);
  }
  a.out[i] = v;
}

}  // namespace

// queries: (batch, q) uint32 on the device; out: `total` words; segs: n_segs
// host records of 14 uint32 (Seg); arrays: n_arrays host records of 16 bytes
// (Array); shard: this shard's index, or -1 without a mesh.
extern "C" int zk_openings(const uint32_t* queries, uint32_t* out, int64_t total, int batch,
                           int q, int shard, const void* segs, int n_segs, const void* arrays,
                           int n_arrays, cudaStream_t stream) {
  if (total < 0 || total > 0x7fffffffLL || batch < 0 || q < 0 || n_segs < 1 ||
      n_segs > kMaxSegs || n_arrays < 1 || n_arrays > kMaxArrays || shard < -1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    OpenArgs a{};
    a.queries = queries;
    a.out = out;
    a.total = static_cast<uint32_t>(total);
    a.batch = batch;
    a.q = q;
    a.n_segs = n_segs;
    a.shard = shard;
    const Seg* sg = static_cast<const Seg*>(segs);
    const Array* ar = static_cast<const Array*>(arrays);
    for (int s = 0; s < n_segs; ++s) {
      const Seg& g = sg[s];
      if (g.n_idx < 1 || g.n_idx > kMaxAdds || g.first >= static_cast<uint32_t>(n_arrays) ||
          (g.path && g.first + g.depth >= static_cast<uint32_t>(n_arrays))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      a.segs[s] = g;
    }
    for (int k = 0; k < n_arrays; ++k) {
      if (ar[k].log_size > 31) return static_cast<int>(cudaErrorInvalidValue);
      a.arrays[k] = ar[k];
    }
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    openings_kernel<<<blocks, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
