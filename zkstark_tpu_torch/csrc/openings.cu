// Kernel: the fused core's packed result in one launch: every phase-4
// opening, the Merkle roots, the free term and the chain's draws, written
// straight into the one vector the host fetches.
//
// Counterpart of zkstark_tpu/protocol/fused.py:225-316 (_take_val,
// _take_digest, _auth_path, sparse_openings) and of the packing at :151-168
// (the stacks of roots and draws, pack_tree), which XLA fused into the one
// compiled program of the fused core. As plain tensor ops the gathers alone
// are some 330 launches at stark-101 and 900 at 2^24; the work is a few
// thousand words.
//
// The host (ops/openings.py) describes the result as segments, each a leaf
// of the packed vector in its order, B-major: proof b's words of a leaf
// follow proof b - 1's. Kinds:
//   VALUES  tree t's values at idx = ((x & mask) + add[i]) & mask for each
//           query x and slot i: (q, n_idx) words a proof; (q, n_idx, w) for a
//           tree whose leaf is a row of w words, whose values are each proof's
//           w columns one after the other (a trace of w columns): the row;
//   PATHS   the auth paths there, level l the sibling digest
//           level[l][(idx >> l) ^ 1]: (q, n_idx, depth, 8) words a proof;
//   ROOTS   the top level of `count` trees: (count, 8) words a proof;
//   FIRST   tree t's value 0: one word a proof (the free term);
//   COPY    `count` words a proof from word `offset` of a source's rows,
//           `stride` apart (the chain's draws).
// A tree is its values, its digest levels in one allocation, level l at word
// 8·B·(2N - 2N/2^l) (hash/merkle.py Levels), and on a shard the whole
// levels above its subtree in a second one: at most three pointers, whatever
// its depth, and one where the values head the levels' allocation (the fused
// core's trees). Its level offsets come from shifts of its sizes.
//
// One block of threads writes one (segment, proof), chosen by blockIdx: the
// segment's record is uniform across the block, so no thread searches for
// its segment or reads a table entry of its own. A segment's record holds a
// copy of the record of the tree it reads (or its COPY source's pointer), so
// that a thread reaches every address from the segment's record alone, one
// load of the parameters shorter than through a table of trees (which only
// ROOTS reads); each thread loads its own query, with no staging and no
// barrier. In PATHS a thread's column is tid & 7 and its level and slot come
// from shifts of tid >> 3 against the segment's padded depth (2^lg rows a
// slot) and padded slot count (2^ln a query); VALUES and COPY take a word a
// thread. No division.
//
// The parameters go by value in one block sized to what it holds: a header
// of 10 words, 8 words a tree, 20 a segment (the host picks the smallest of
// the kernel's instances that holds them). They are read from the parameter
// space by index (__grid_constant__), so nothing is copied to local memory.
//
// A shard of the sharded prover (parallel/pipeline.py) passes its index; a
// sharded array is then this shard's block of 2^k words (or rows), which owns
// global index i when i >> k == shard and holds it at i & (2^k - 1); a whole
// array (a COPY source, a level above the subtree roots) is read by shard 0
// alone. A word the shard does not own is written as 0, so that the bitwise
// OR of every shard's vector (Mesh.replicate) is the whole result.
//
// Bound by the latency of a chain of dependent loads (the parameters, the
// query, then the word), not by bytes or operations: the result is a few KB.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
// header: queries (2), out (2), q, shard, batch, trees, the queries' row
// stride, segments
constexpr int kHeader = 10;
// tree: values (2), levels (2, or 0: the levels follow the values by `head`
// words of the same allocation), top (2), log_n | log_blk << 8 | sharded << 16
// | (width - 1) << 20, head
constexpr int kTree = 8;
// segment: out, code, per_proof, mask | stride, add[8] | offset | count, then
// its tree's record (VALUES, PATHS, FIRST) or its source's pointer (COPY)
constexpr int kSeg = 12 + kTree;
enum Kind : uint32_t { kValues = 0, kPaths = 1, kRoots = 2, kCopy = 3, kFirst = 4 };

template <int W>
struct Params {
  uint32_t w[W];
};

__device__ __forceinline__ const uint32_t* ptr_at(const uint32_t* w, uint32_t i) {
  return reinterpret_cast<const uint32_t*>((static_cast<uint64_t>(w[i + 1]) << 32) | w[i]);
}

// A tree's record, read once into registers.
struct Tree {
  const uint32_t* values;
  const uint32_t* levels;  // the block's levels (level 0 first)
  const uint32_t* top;     // the whole levels above a shard's subtree
  uint32_t log_n, log_blk, sharded, width;
};

__device__ __forceinline__ Tree tree_at(const uint32_t* t) {
  Tree r;
  r.values = ptr_at(t, 0);
  r.levels = ptr_at(t, 2);
  if (r.levels == nullptr) r.levels = r.values + t[7];  // after the values, one allocation
  r.top = ptr_at(t, 4);
  r.log_n = t[6] & 255u;
  r.log_blk = (t[6] >> 8) & 255u;
  r.sharded = (t[6] >> 16) & 15u;
  r.width = (t[6] >> 20) + 1u;
  return r;
}

// The address of word `col` of row `row` of digest level `level` of tree t,
// proof b, or null where this shard does not own it. Addresses first, loads
// after: a thread's loads then issue back to back.
__device__ __forceinline__ const uint32_t* level_ptr(const Tree& t, uint32_t level, uint32_t row,
                                                     uint32_t col, uint32_t b, uint32_t bsz,
                                                     int shard) {
  uint64_t at;
  const uint32_t* base;
  if (level <= t.log_blk) {  // the levels of the (block's) tree
    const uint32_t rows_log = t.log_blk - level;
    const uint64_t n2 = uint64_t{2} << t.log_blk;
    const uint64_t first = (t.sharded ? 1u : bsz) * (n2 - (n2 >> level));
    if (t.sharded) {
      if ((row >> rows_log) != static_cast<uint32_t>(shard)) return nullptr;
      row &= (1u << rows_log) - 1u;
      at = first + row;
    } else {
      if (shard > 0 || row >= (1u << rows_log)) return nullptr;
      at = first + (static_cast<uint64_t>(b) << rows_log) + row;
    }
    base = t.levels;
  } else {  // the whole levels above a shard's subtree
    const uint32_t l2 = level - t.log_blk - 1;
    const uint64_t r2 = uint64_t{2} << (t.log_n - t.log_blk - 1);
    if (shard > 0 || row >= (r2 >> (l2 + 1))) return nullptr;
    at = r2 - (r2 >> l2) + row;
    base = t.top;
  }
  return base + at * 8 + col;
}

// The address of tree t's value at idx for proof b (of its column 0, for a
// tree of rows), or null where this shard does not own it.
__device__ __forceinline__ const uint32_t* value_ptr(const Tree& t, uint32_t idx, uint32_t b,
                                                     int shard) {
  uint64_t at = idx;
  if (t.sharded) {
    if ((idx >> t.log_blk) != static_cast<uint32_t>(shard)) return nullptr;
    at = idx & ((1u << t.log_blk) - 1u);
  } else {
    if (shard > 0 || idx >= (1u << t.log_blk)) return nullptr;
    at += static_cast<uint64_t>(b) * t.width << t.log_blk;
  }
  return t.values + at;
}

__device__ __forceinline__ uint32_t load_or_0(const uint32_t* p) { return p ? __ldg(p) : 0u; }

template <int W>
__global__ void __launch_bounds__(kThreads) openings_kernel(const __grid_constant__ Params<W> p) {
  const uint32_t* w = p.w;
  const uint32_t q = w[4];
  const uint32_t b = blockIdx.y;
  const uint32_t tid = threadIdx.x;
  const uint32_t* queries = ptr_at(w, 0) + static_cast<uint64_t>(b) * w[8];
  const int shard = static_cast<int>(w[5]);
  const uint32_t bsz = w[6];
  const uint32_t* trees = w + kHeader;
  const uint32_t* seg = trees + kTree * w[7] + kSeg * blockIdx.x;
  const uint32_t code = seg[1];
  const uint32_t kind = code & 15u, ln = (code >> 4) & 15u, lg = (code >> 8) & 255u;
  const uint32_t tree = (code >> 16) & 255u, n_idx = code >> 24;
  const uint32_t per_proof = seg[2];
  uint32_t* out = const_cast<uint32_t*>(ptr_at(w, 2)) + seg[0] +
                  static_cast<uint64_t>(b) * per_proof;
  if (kind == kCopy) {
    const uint32_t* src = ptr_at(seg, 12) + static_cast<uint64_t>(b) * seg[3] + seg[4];
    for (uint32_t i = tid; i < per_proof; i += kThreads) {
      out[i] = shard > 0 ? 0u : __ldg(src + i);
    }
    return;
  }
  if (kind == kRoots) {
    for (uint32_t i = tid; i < per_proof; i += kThreads) {
      const Tree t = tree_at(trees + kTree * (tree + (i >> 3)));
      out[i] = load_or_0(level_ptr(t, t.log_n, 0u, i & 7u, b, bsz, shard));
    }
    return;
  }
  const Tree t = tree_at(seg + 12);
  if (kind == kFirst) {
    if (tid == 0) out[0] = load_or_0(value_ptr(t, 0u, b, shard));
    return;
  }
  const uint32_t mask = seg[3];
  const uint32_t slots = q << ln;  // query · 2^ln + slot, the slots padded to 2^ln
  if (kind == kValues) {
    for (uint32_t s = tid; s < slots; s += kThreads) {
      const uint32_t qi = s >> ln, slot = s & ((1u << ln) - 1u);
      if (slot >= n_idx) continue;
      const uint32_t idx = ((__ldg(queries + qi) & mask) + seg[4 + slot]) & mask;
      const uint32_t* src = value_ptr(t, idx, b, shard);
      if (t.width == 1) {
        out[qi * n_idx + slot] = load_or_0(src);
        continue;
      }
      // a row: word c of column c, the columns 2^log_n words apart
      for (uint32_t c = 0; c < t.width; ++c) {
        out[(qi * n_idx + slot) * t.width + c] =
            load_or_0(src ? src + (static_cast<uint64_t>(c) << t.log_blk) : nullptr);
      }
    }
    return;
  }
  // kPaths: a slot takes 2^lg rows of 8 threads, row = level. A pass covers
  // 2·step slots, each thread two of them, both loads issued before either
  // store, so that a segment of up to 2·step slots waits on one round of
  // loads (at stark-101 step is 4: the trace's 3 slots, a load a thread)
  const uint32_t depth = t.log_n;
  const uint32_t col = tid & 7u, row = tid >> 3;
  const uint32_t level = row & ((1u << lg) - 1u);
  const uint32_t step = kThreads >> (3 + lg);  // slots a pass
  for (uint32_t s0 = row >> lg; s0 < slots; s0 += 2 * step) {
    const uint32_t* src[2];
    uint32_t at[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint32_t s = s0 + k * step;
      const uint32_t qi = s >> ln, slot = s & ((1u << ln) - 1u);
      src[k] = nullptr;
      at[k] = ~0u;
      if (s < slots && slot < n_idx && level < depth) {
        const uint32_t idx = ((__ldg(queries + qi) & mask) + seg[4 + slot]) & mask;
        src[k] = level_ptr(t, level, (idx >> level) ^ 1u, col, b, bsz, shard);
        at[k] = ((qi * n_idx + slot) * depth + level) * 8u + col;
      }
    }
    const uint32_t v0 = load_or_0(src[0]), v1 = load_or_0(src[1]);
    if (at[0] != ~0u) out[at[0]] = v0;
    if (at[1] != ~0u) out[at[1]] = v1;
  }
}

template <int W>
int launch(const uint32_t* words, int n_words, int n_segs, int bsz, cudaStream_t stream) {
  Params<W> a{};
  for (int i = 0; i < n_words; ++i) a.w[i] = words[i];
  openings_kernel<W><<<dim3(static_cast<unsigned>(n_segs), static_cast<unsigned>(bsz)), kThreads,
                       0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words: the host's parameter block of n_words (ops/openings.py describe):
// the header, the tree records, then n_segs segment records; one block of
// threads per (segment, proof) of bsz proofs.
extern "C" int zk_openings(const void* words, int n_words, int n_segs, int bsz,
                           cudaStream_t stream) {
  const uint32_t* w = static_cast<const uint32_t*>(words);
  if (words == nullptr || n_segs < 1 || bsz < 1 || bsz > 65535 || n_words < kHeader ||
      static_cast<int64_t>(w[6]) != bsz || static_cast<int64_t>(w[9]) != n_segs ||
      n_words != kHeader + kTree * static_cast<int64_t>(w[7]) + kSeg * int64_t{n_segs}) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_words <= 256) return launch<256>(w, n_words, n_segs, bsz, stream);
  if (n_words <= 512) return launch<512>(w, n_words, n_segs, bsz, stream);
  if (n_words <= 768) return launch<768>(w, n_words, n_segs, bsz, stream);
  if (n_words <= 1024) return launch<1024>(w, n_words, n_segs, bsz, stream);
  if (n_words <= 2048) return launch<2048>(w, n_words, n_segs, bsz, stream);
  if (n_words <= 4096) return launch<4096>(w, n_words, n_segs, bsz, stream);
  if (n_words <= 8188) return launch<8188>(w, n_words, n_segs, bsz, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
