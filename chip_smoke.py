#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port, `zkstark_tpu_torch`.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one output line (or a few) each:
  0. the card's name and power limit (nvidia-smi); fails without CUDA;
  1. build the CUDA kernels (csrc/, nvcc sm_90a), the C++ verifier and, for
     phase 3's A/B only, the design of `openings` it replaced
     (`OLD_OPENINGS_CU`, kept in this script, not in the package);
  2. the fp.cuh field functions against exact integers and the plain-torch
     ops, on edge values next to p and 2^16 random pairs, for both primes;
     then the `Field` methods on the card against the CPU, `device_powers`
     and `powers_iota` through the `powers` kernel at 2^20: the main-path
     run whose `powers` launches are counted;
  3. each kernel against its plain-torch twin on the card at the prove
     path's shapes, with both times and the least time the card could take
     (its bound); the tolerance is 0 (the field has no rounding, so every
     output word must be equal). `ntt_rows` also at each fused option
     (pre-scale on a short valid prefix, the U·V twiddle, 1/n, post-scale)
     and `transpose` on a missing tail; `ntt_rows_pease` in the TPU
     kernel's bit-reversed order, then with every option of the `ntt_rows`
     contract in both orders beside `ntt_rows`; the two designs of the Pease
     route's bit reversal (natural rows and plain transposes, or bit-reversed
     rows and the transposes' bit-reversed rows), the transposes alone and
     the whole 2^24 and 2^25 LDE of each, in turns; ``period=`` on the three
     row kernels and the batched `transpose` at the passes of 16 LDEs of
     2^20 points; then `coset_ntt` at 2^13, 2^24 and 2^25 and `intt` at 2^10
     and 2^22 on the card, timed, the 2^25 call under torch.profiler, where
     every device kernel in the window must be one of the port's own (or a
     memset or memcpy); `coset_ntt` at 2^24, 2^25 and a batch of 16 at 2^20
     on both routes (DIT and ZKSTARK_PEASE=on) in turns, each 2 row launches
     and 3 transposes, equal across routes, the 2^25 and batched ones under
     the profiler like the 2^25 call. `limb_dft_rows` against
     its plain version and against `ntt_rows` at the 2^27 LDE's two passes and
     at 4096 x 4096, each fused option once, both primes; `composition`
     against `composition_eval_plain` for the three AIRs at 2^13 and for
     square-chain at 2^24, B = 1 and 3; `coset_ntt` at 2^27 timed and under
     the profiler like the 2^25 call; the kernels of the fused core's former
     plain-torch glue, `from_mont` (f_eval at 2^24, 2^13, 2^25),
     `endpoint_fix` (the INTT sizes 2^21, 2^10, 2^25, and B = 32 at 2^10),
     `constants` (2^24 square-chain and fibonacci-sq, stark-101) and
     `openings` (the fused core's whole packed result and the openings
     alone, stark-101 at B = 1 and 32, one 2^24 proof, shard 3 of 8 at
     2^24, with the parameter block's bytes; at stark-101 the wrapper's host
     time over 50 calls and the A/B in turns against the old design, device
     and host times), each with its device time under torch.profiler;
     `powers` at 2^20 against its plain twin; the launch
     floor (the profiled device time of an empty kernel launched through
     `_build`) with `openings`' share of it and `powers`' multiple, and the batched transposes of
     16 x (128 x 1024) and 16 x (1024 x 1024) as profiled device time beside
     `.t().contiguous()`'s;
  4. stark-101 proved on the card: the golden 7,836-byte transcript and
     final state, accepted by the port's verifier and the C++ verifier, every
     kernel launched, the Merkle trees in at most 20 node and tail launches;
  5. a 2^16-point square-chain proof on the card equals the CPU proof;
  6. the 2,097,151-step square-chain statement (2^24 evaluation points,
     21 FRI rounds) on the card: 22,496 proof bytes, both verifiers accept;
  7. the 4,194,303-step statement (2^25 points, 22 FRI rounds) through the
     operator entry points: ``python -m zkstark_tpu_torch prove`` in a
     subprocess on the Pease route (ZKSTARK_PEASE=on), ``... verify`` and
     the C++ verifier on its file, then ``tools.prove_big --trace-bits 22``
     in this process on the default DIT route: 24,252 proof bytes, the same
     bytes from both routes; the CLI's Pease route launches
     `ntt_rows_pease` 4 and `transpose` 6 times (two four-steps) and
     `ntt_rows` none; this is the main-path run whose kernel launches are
     counted (Pease from the CLI, the others from prove_big);
  8. a 2^16 checkpoint written on the card at the post-device barrier (and
     one at phase2) resumes on the CPU to phase 5's proof;
  9. the one-fetch path alone: stark-101 through ``prove(fused=True)`` equals
     the golden transcript and ``prove(fused=False)``, both verifiers accept,
     the fused core runs under ``torch.cuda.set_sync_debug_mode("error")``
     (no call that waits for the device), both paths in turns (7 warm
     proves each, median and spread, then 7 each with their spans), and
     the device's busy share of one profiled fused prove, which makes at most
     `MAX_STARK101_SPANS` device spans, none of plain torch: besides the
     port's kernels at most one copy each of the witness's upload (the
     trace's bytes) and the fetch (the packed vector's bytes, read from the
     profile's exported trace), and the two device-to-device copies of the
     same sizes around a replay of the core's CUDA graph; its first prove (composition
     constants built cold) is the main-path run whose launches of the glue
     kernels are counted; `_plain_loops` shows no plain-torch launch left in
     the interpolation, `from_mont` and the openings (also phase 11, at 2^24);
 10. batched: ``prove_batch`` of B = 32 and B = 64 stark-101 witnesses, every
     proof the golden one, proofs per second; ``prove_batch_pipelined`` over
     4 batches of 32; square-chain batches on the four-step route, B = 4 at
     2^16 and B = 16 at 2^20, the secrets s and p - s alternating (distinct
     witnesses, one public output), each proof equal to its solo proof,
     3 + 3 and 4 + 6 `ntt_rows` + `transpose` launches (one four-step a
     transform for the whole batch), peak memory and wall time; a batch of
     16 LDEs at 2^20 within 16 times one LDE's working set;
 11. pipelined: ``prove_pipelined`` of 8 stark-101 proofs, and of 3 proofs of
     the 2^24 statement at depth 2, each equal to phase 6's proof, with the
     per-proof time beside the solo warm times and the peak memory; the 2^24
     `prove()` and `prove(fused=False)` in turns, 5 each, as in phase 9; this is
     the main-path run of the one-fetch slice whose launches are counted;
 12. past 2^26: the 16,777,215-step square-chain statement (2^27 points,
     24 FRI rounds) through ``tools.prove_big.run(24, repeats=1)`` and once
     through the fused ``prove()``: the same bytes, of the length the proof
     layout gives, both verifiers accept, `limb_dft_rows` and `composition`
     launched, phase spans and peak memory; this is the main-path run of the
     big-domain slice whose launches are counted;
 13. the sharded prover on local meshes of the card (``parallel/``): stark-101
     at S = 2 and 8 (golden), the 2^21 square-chain statement at S = 8
     (17,612 B, equal to the solo proof), the 2^24 statement at S = 8 (phase
     6's 22,496 B), each with both verifiers, its core under the sync debug
     mode, its bytes between shards equal to the design's count, its warm
     time, launches, busy time and peak memory beside the solo prove's;
     ``prove_batch`` of 32 stark-101 proofs over 8 shards; the sharded 2^24
     LDE under torch.profiler (only the port's kernels and copies); the 2^24
     S = 8 prove is this slice's main-path run whose launches are counted.
     Phase 3 also holds the arguments the sharded prover added (`transpose`
     with block elements, `composition` on a shard with its halo) against
     their twins, and times `fri_fold` on the device at 2^24 and 2^21;
 14. ``tools.scaling_bench`` at 2^24 points over local meshes of 1, 2, 4 and
     8 shards, two warm repeats each, the same roots at every S;
 15. (run right after phase 3) the hash kernels on the TPU kernels' word-plane
     layout: `sha256_leaf` and `sha256_node` as plane-major instances against
     their plain twins and the row-major digests transposed, the A/B of both
     layouts in turns (row, planes, planes, row) with 50-call CUDA-event
     windows and profiled device times at 2^20 leaves and 2^19 parents, and a
     2^24-leaf tree through `build_levels` with and without the plane-major
     chain, every level equal, in turns; the chain's tree is the run whose
     plane-major launches are counted;
 16. (run after phase 13) the process-group mesh on NCCL: a spawned process
     starts a group of one on the card and proves stark-101 (one shard) and
     the 2^21 statement (two shards in the process) through it, each equal
     to its solo proof (7,836 B golden, 17,612 B);
 17. the bench twin: ``python -m zkstark_tpu_torch.tools.bench --repeats 5``
     in a subprocess, on phase 1's build (no rebuild): exit 0, and its last
     line the final headline, `stark101_prove_latency`, with every metric of
     `bench.py`'s default run (`ntt_ops_ratio_2e24` for `ntt_vpu_ratio_2e24`)
     present and positive, nothing skipped, the card's name and power limit;
     every kernel of its path launched; the record and the min, median and max
     of its 5 timed proves printed; then the twin's timed Merkle and NTT work
     in this process under torch.profiler, device busy time beside wall time;
 18. the wall time, the kernel JSON line, then the result line.

Every phase that proves checks the launch counters of its own route.

Any failure is an uncaught exception and a nonzero exit; nothing is caught.
"""

import json
import math
import os
import subprocess
from collections import Counter
import sys
import tempfile
import time

import numpy as np
import torch

from zkstark_tpu_torch.tools.roofline import (FOLD_OPS, FP_ADD, FP_MUL, FP_SUB, SHA_BLOCK,
                                              SHA_LEAF, SHA_NODE, SHA_ROUNDS, bound,
                                              limb_rows_bound, ntt_rows_bound)

GOLDEN_STATE = "d7eec91544f72a592145e7d505a2f274de740e0319ede8c983fd84c7736f6712"
GOLDEN_LEN = 7836
BIG_TRACE_BITS = 21  # 2^24 evaluation points at blowup 8
BIG_SECRET = 271828
BIG_PROOF_LEN = 22496
HUGE_TRACE_BITS = 22  # 2^25 evaluation points
HUGE_PROOF_LEN = 24252  # artifacts/PROVE_2e25_r04.jsonl
MID_TRACE_BITS = 18  # 2^21 evaluation points, 18 FRI rounds
MID_PROOF_LEN = 17612  # artifacts/SHARD_INVARIANCE_2e21_r04.jsonl
GIANT_TRACE_BITS = 24  # 2^27 evaluation points: n1 = 16384 > MAX_ROW, the limb route
GIANT_PROOF_LEN = 27956  # from the proof layout (`protocol.proof.expected_proof_len`)
# every proof launches these (below the four-step size: no transpose)
ROW_KERNELS = ("sha256_leaf", "sha256_node", "sha256_tree_tail", "ntt_rows", "composition")
# the most `sha256_node` + `sha256_tree_tail` launches of one stark-101 prove
# (or one batch of them): 3 a tree of 8192 values, 2 at 4096, 1 below
MAX_TREE_LAUNCHES = 20
DIT_KERNELS = (*ROW_KERNELS, "transpose")
FUSED_KERNELS = ("fs_chain", "fri_fold")  # the one-fetch path's own


SRC = {
    "sha256_leaf": ("zkstark_tpu_torch/csrc/sha256.cu", "zkstark_tpu/ops/sha256_kernel.py:105"),
    "sha256_node": ("zkstark_tpu_torch/csrc/sha256.cu", "zkstark_tpu/ops/sha256_kernel.py:139"),
    "sha256_tree_tail": ("zkstark_tpu_torch/csrc/sha256.cu", "zkstark_tpu/hash/merkle.py:146"),
    "ntt_rows": ("zkstark_tpu_torch/csrc/ntt.cu", "zkstark_tpu/ops/ntt_kernel.py:78"),
    "transpose": ("zkstark_tpu_torch/csrc/transpose.cu", "zkstark_tpu/ops/ntt_kernel.py:357"),
    "ntt_rows_pease": ("zkstark_tpu_torch/csrc/ntt_pease.cu", "zkstark_tpu/ops/ntt_kernel.py:125"),
    "fs_chain": ("zkstark_tpu_torch/csrc/fs_chain.cu", "zkstark_tpu/transcript/device_channel.py:63"),
    "fri_fold": ("zkstark_tpu_torch/csrc/fri_fold.cu", "zkstark_tpu/protocol/prover.py:255"),
    "limb_dft_rows": ("zkstark_tpu_torch/csrc/limb_dft.cu", "zkstark_tpu/ops/mxu_ntt.py:154"),
    "composition": ("zkstark_tpu_torch/csrc/composition.cu", "zkstark_tpu/protocol/prover.py:213"),
    "openings": ("zkstark_tpu_torch/csrc/openings.cu", "zkstark_tpu/protocol/fused.py:267"),
    "endpoint_fix": ("zkstark_tpu_torch/csrc/endpoint_fix.cu", "zkstark_tpu/protocol/air.py:423"),
    "from_mont": ("zkstark_tpu_torch/csrc/from_mont.cu", "zkstark_tpu/parallel/pipeline.py:64"),
    "constants": ("zkstark_tpu_torch/csrc/constants.cu", "zkstark_tpu/protocol/prover.py:53"),
    "sha256_leaf_planes": ("zkstark_tpu_torch/csrc/sha256.cu", "zkstark_tpu/ops/sha256_kernel.py:105"),
    "sha256_node_planes": ("zkstark_tpu_torch/csrc/sha256.cu", "zkstark_tpu/ops/sha256_kernel.py:139"),
    "powers": ("zkstark_tpu_torch/csrc/powers.cu", "zkstark_tpu/field/fp.py:484"),
}
# the hash kernels on the word-plane layout, driven by `build_levels` with its
# plane-major chain (phase 15)
PLANE_KERNELS = ("sha256_leaf_planes", "sha256_node_planes")
# the kernels of the fused core's former plain-torch glue, driven by the main
# path: `prove(STARK101)` (phase 9), which builds its composition constants cold
GLUE_KERNELS = ("openings", "endpoint_fix", "from_mont", "constants")
# the plain-torch loops the glue kernels replaced (`_plain_loops`), which must
# launch nothing but the port's kernels
PLAIN_LOOPS = ("interpolate_rank1_fix", "from_mont_f_eval", "opening_gathers")
# the most device spans (kernels and copies) of one profiled stark-101 fused
# prove: 48 kernels and the four copies below
MAX_STARK101_SPANS = 52
# the device spans of a fused prove that are not the port's kernels: at most
# one copy each, the witness's upload (host to device, the trace's bytes) and
# the packed result's fetch (device to host, the packed vector's bytes), and
# around a replay of the core's CUDA graph (``protocol/graph.py``) the
# witness's copy into the graph's input and the result's copy out of the
# graph (device to device, the trace's and the packed vector's bytes)
COPY_SPANS = (("Memcpy HtoD", "trace"), ("Memcpy DtoH", "packed"), ("Memcpy DtoD", "trace"),
              ("Memcpy DtoD", "packed"))
# csrc/constants.cu: the points a thread inverts with one Fermat inversion
CONST_TILE = 8


# The design of `openings` before its redesign, kept here only, to be timed in
# turns against the package's: one thread a word, a serial search for its
# segment, per-thread reads of a by-value table of every level's pointer
# (64 segments, 512 arrays: 11.8 KB of parameters), and a host table of
# every level rebuilt on each call. It reads the same trees, level by level.
OLD_OPENINGS_CU = r"""
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
"""
OLD_OPENINGS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                "old_openings")


def build_old_openings() -> None:
    """nvcc of `OLD_OPENINGS_CU` into build/old_openings (its own library)."""
    from zkstark_tpu_torch.ops import _build

    os.makedirs(OLD_OPENINGS_DIR, exist_ok=True)
    src = os.path.join(OLD_OPENINGS_DIR, "openings_old.cu")
    with open(src, "w") as f:
        f.write(OLD_OPENINGS_CU)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", os.path.join(OLD_OPENINGS_DIR, "libold.so"), src],
                   check=True, capture_output=True, text=True)


class OldOpenings:
    """The old wrapper: 14-word segment records (cached) and an (n, 2) table
    of (pointer, log2 size) of every array, rebuilt on each call."""

    MAX_ADDS = 8

    def __init__(self):
        import ctypes

        self.lib = ctypes.CDLL(os.path.join(OLD_OPENINGS_DIR, "libold.so"))
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        self.lib.zk_openings.argtypes = [p, p, i64, i, i, i, p, i, p, i, p]
        self.lib.zk_openings.restype = ctypes.c_int
        self.launches = 0
        self._segs = {}

    def segment_table(self, segments, lead, q, lengths):
        key = (segments, lead, q, lengths)
        if key not in self._segs:
            firsts = np.cumsum((0,) + lengths[:-1]).tolist()
            segs, total = [], 0
            for tree, path, mask, adds in segments:
                depth = lengths[tree] - 1
                words = int(np.prod(lead)) * q * len(adds) * (8 * depth if path else 1)
                if words:
                    segs.append([total, firsts[tree], int(path), depth if path else 0, len(adds),
                                 mask & 0xFFFFFFFF, *adds, *[0] * (self.MAX_ADDS - len(adds))])
                total += words
            self._segs[key] = (np.asarray(segs, dtype=np.uint32).reshape(-1, 14), total)
        return self._segs[key]

    @staticmethod
    def array_table(trees, lead, card):
        ptrs, words = [], []
        for tree in trees:  # whole trees that halve level by level: one shape comparison
            size = tree[0].shape[-1]
            shapes = [lead + (size,)] + [lead + (size >> k, 8) for k in range(len(tree) - 1)]
            if ([a.shape for a in tree] != shapes
                    or not all(a.dtype is torch.uint32 and a.get_device() == card
                               and a.is_contiguous() for a in tree)):
                raise ValueError("old openings: a tree that does not halve")
            ptrs += [a.data_ptr() for a in tree]
            words += [size.bit_length() - 1] + [size.bit_length() - 1 - k
                                                 for k in range(len(tree) - 1)]
        table = np.empty((len(ptrs), 2), dtype=np.uint64)
        table[:, 0], table[:, 1] = ptrs, words
        return table

    def __call__(self, queries, trees, segments):
        lead, q = tuple(queries.shape[:-1]), queries.shape[-1]
        segs, total = self.segment_table(segments, lead, q, tuple(len(t) for t in trees))
        table = self.array_table(trees, lead, queries.get_device())
        out = torch.empty(total, dtype=torch.uint32, device=queries.device)
        rc = self.lib.zk_openings(queries.data_ptr(), out.data_ptr(), total,
                                  int(np.prod(lead)), q, -1, segs.ctypes.data, len(segs),
                                  table.ctypes.data, len(table),
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old openings: CUDA error {rc}")
        self.launches += 1
        return out


def old_segments(segments) -> tuple:
    """The package's opening segments in the old design's form."""
    from zkstark_tpu_torch.ops import openings as open_op

    return tuple((g.tree, g.kind == open_op.PATHS, g.mask, g.adds) for g in segments)


def say(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over `iters` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    from zkstark_tpu_torch.field import fp

    assert a.shape == b.shape, (a.shape, b.shape)
    return int((fp.wide(a) - fp.wide(b)).abs().max().item())


def require_launched(counts: dict, names, what: str) -> None:
    """Each kernel in `names` launched at least once in the run `counts`
    was read after."""
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels {missing} were not launched: {counts}")


def require_few_tree_launches(counts: dict, what: str) -> int:
    """The Merkle trees of one stark-101 prove, or of one batch, take at most
    `MAX_TREE_LAUNCHES` node and tail launches (one a level or tail, whatever
    the batch); returns the count."""
    n = counts["sha256_node"] + counts["sha256_tree_tail"]
    if n > MAX_TREE_LAUNCHES:
        raise AssertionError(f"{what}: {n} node + tail launches, want <= {MAX_TREE_LAUNCHES}: {counts}")
    return n


def require_one_composition(counts: dict, what: str) -> None:
    """A proof, or a batch of proofs, launches the composition kernel once."""
    if counts["composition"] != 1:
        raise AssertionError(f"{what}: {counts['composition']} composition launches, want 1")


def sm_clocks() -> str:
    """The SM clock now and its maximum, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
    ).stdout.strip().splitlines()[0]


def phase0_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
    ).stdout.strip().splitlines()[0]
    say(line)
    say("phase0 clocks", sm_clocks())
    say(
        f"phase0 torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}"
    )
    return line


def phase1_build():
    """nvcc (one process per source) and g++ (the C++ verifier) at once."""
    from concurrent.futures import ThreadPoolExecutor

    from zkstark_tpu_torch import native
    from zkstark_tpu_torch.ops import _build

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        nvcc = pool.submit(timed, _build.kernels)
        cxx = pool.submit(timed, native.native)
        old = pool.submit(timed, build_old_openings)  # phase 3's A/B of the openings design
        nvcc_s, cxx_s, old_s = nvcc.result(), cxx.result(), old.result()
    wall = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines() if "Used" in ln or "spill" in ln]
    for ln in ptxas:
        say("phase1 ptxas", ln)
    say(f"phase1 build nvcc_s={nvcc_s:.3f} cxx_verifier_s={cxx_s:.3f} "
        f"old_openings_nvcc_s={old_s:.3f} wall_s={wall:.3f}")


def phase2_fp():
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import _build

    lib = _build.kernels()
    rng = np.random.default_rng(2)
    for fld in (fp.FIELD101, fp.FIELD_ALT):
        p = fld.p
        edges = np.array([0, 1, p - 2, p - 1, 1 << 31, (1 << 32) - 1], dtype=np.uint64)
        ea, eb = np.meshgrid(edges, edges)
        a = np.concatenate([ea.ravel(), rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)])
        b = np.concatenate([eb.ravel(), rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)])
        a, b = a.astype(np.uint32), b.astype(np.uint32)
        n = a.shape[0]
        da, db = fp.from_host(a, "cuda"), fp.from_host(b, "cuda")
        out = torch.empty((6, n), dtype=torch.uint32, device="cuda")
        _build.check(
            lib.zk_fp_check(
                da.data_ptr(), db.data_ptr(), out.data_ptr(), n, p, fld.p_inv_neg,
                _build.stream(da),
            ),
            "fp_check",
        )
        torch.cuda.synchronize()
        got = fp.to_host(out)
        # bit for bit with the plain-torch ops on every u32 input
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        plain = [fp.mont_mul_f(fld, ta, tb), fp.add_f(fld, ta, tb),
                 fp.sub_f(fld, ta, tb), fp.from_mont_f(fld, ta)]
        for row, want in enumerate(plain):
            if not np.array_equal(got[row], want.numpy()):
                raise AssertionError(f"fp.cuh row {row} differs from plain torch, p={p}")
        # and the exact field values on reduced inputs
        r_inv = pow(1 << 32, p - 2, p)
        checked = 0
        for i in range(n):
            x, y = int(a[i]), int(b[i])
            if x >= p or y >= p:
                continue
            exact = (x * y * r_inv % p, (x + y) % p, (x - y) % p, x * r_inv % p,
                     x * y * r_inv % p, (x + y) % p)  # the last two: fp_mul_r, fp_add_r
            if tuple(int(got[r][i]) for r in range(6)) != exact:
                raise AssertionError(f"fp.cuh wrong at a={x} b={y} p={p}")
            checked += 1
        say(f"phase2 fp.cuh p={p} pairs={n} exact_checked={checked} ok")
    return phase2_field_methods()


def phase2_field_methods() -> dict:
    """The `Field` methods on the card against the CPU, each prime: the
    device ops on random words, then `device_powers` and `powers_iota` at
    the size of the 2^20 domain, through the `powers` kernel. This is the
    main-path run of `powers`, whose launches are counted."""
    from zkstark_tpu_torch import ops
    from zkstark_tpu_torch.field import fp

    rng = np.random.default_rng(17)
    ops.reset_launch_counts()
    for fld in (fp.FIELD101, fp.FIELD_ALT):
        a, b = (fld.host_to_mont(rng.integers(0, fld.p, 1 << 16, dtype=np.uint64))
                for _ in range(2))
        for dev in ("cuda", "cpu"):
            ta, tb = fp.from_host(a, dev), fp.from_host(b, dev)
            got = [fld.mont_mul(ta, tb), fld.add(ta, tb), fld.sub(ta, tb), fld.neg(ta),
                   fld.to_mont(ta), fld.from_mont(ta), fld.pow_static(ta, 5), fld.inv(ta)]
            if dev == "cuda":
                on_card = [fp.to_host(t) for t in got]
        if any(not np.array_equal(x, fp.to_host(y)) for x, y in zip(on_card, got)):
            raise AssertionError(f"a Field method on the card differs from the CPU, p={fld.p}")
        base = fld.subgroup_generator(1 << 20)
        for name, fn in (("device_powers", lambda dev: fld.device_powers(base, 1 << 20, dev)),
                         ("powers_iota", lambda dev: fld.powers_iota(base, 1 << 20, 7, dev))):
            got = fn("cuda")
            if got.device.type != "cuda" or max_abs_err(got.cpu(), fn("cpu")):
                raise AssertionError(f"Field.{name} on the card differs from the CPU, p={fld.p}")
        say(f"phase2 Field methods p={fld.p}: mont_mul add sub neg to_mont from_mont pow_static "
            f"inv device_powers powers_iota on the card == cpu, tol=0")
    counts = ops.launch_counts()
    require_launched(counts, ("powers",), "Field.device_powers / Field.powers_iota")
    say(f"phase2 Field methods launches={json.dumps({'powers': counts['powers']})}")
    return counts


def _compare(name: str, label: str, kernel, plain, limit: dict, iters=20, library=None) -> dict:
    """One kernel call against its plain twin (tolerance 0), both timed."""
    err = max_abs_err(kernel(), plain())
    ms = cuda_ms(kernel, iters)
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, iters) if library else None
    say(f"phase3 {name} {label} max_abs_err={err} tol=0 ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={limit['bound_ms']:.4f} bound_by={limit['bound_by']} "
        f"share={limit['bound_ms'] / ms:.3f}"
        + (f" library_ms={library_ms:.4f}" if library else ""))
    if err:
        raise AssertionError(f"{name} {label} differs from its plain twin")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)


def phase3_kernels() -> dict:
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ntt import core as ntt_core
    from zkstark_tpu_torch.ops import ntt_kernel, sha256_kernel

    rng = np.random.default_rng(3)
    rows = {}

    vals = fp.from_host(rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64).astype(np.uint32), "cuda")
    n = vals.shape[0]
    rows["sha256_leaf"] = _compare(
        "sha256_leaf", "n=2^20",
        lambda: sha256_kernel.leaf_hash(vals), lambda: sha256_kernel.leaf_hash_plain(vals),
        bound(4 * n + 32 * n, n * SHA_LEAF),
    )
    children = fp.from_host(
        rng.integers(0, 1 << 32, (1 << 20, 8), dtype=np.uint64).astype(np.uint32), "cuda"
    )
    k = children.shape[0] // 2
    rows["sha256_node"] = _compare(
        "sha256_node", "k=2^19",
        lambda: sha256_kernel.node_hash_pairs(children),
        lambda: sha256_kernel.node_hash_pairs_plain(children),
        bound(64 * k + 32 * k, k * SHA_NODE),
    )

    fld = fp.FIELD101

    def rand_mont(shape):
        return fp.from_host(fld.host_to_mont(rng.integers(0, fld.p, shape, dtype=np.uint64)), "cuda")

    # (batch, m): stark-101 INTT and LDE; 2^21 INTT passes; 2^22 INTT;
    # 2^24 LDE; the 2^25 LDE's two passes (n1 = 8192, n2 = 4096)
    dit_shapes = ((1, 1024), (1, 8192), (1024, 2048), (2048, 1024), (2048, 2048),
                  (4096, 4096), (4096, 8192), (8192, 4096))
    pease_shapes = ((2048, 2048), (4096, 4096), (4096, 8192), (8192, 4096))
    for batch, m in dit_shapes:
        x = rand_mont((batch, m))
        w = ntt_core.forward_plan(m).root
        r = _compare("ntt_rows", f"batch={batch} m={m}",
                     lambda: ntt_kernel.ntt_rows(x, w), lambda: ntt_kernel.ntt_rows_plain(x, w),
                     ntt_rows_bound(batch, m, m))
        if (batch, m) == (4096, 4096):
            rows["ntt_rows"] = r
        del x
    for batch, m in pease_shapes:  # the TPU kernel's function: bit-reversed out, no option
        x = rand_mont((batch, m))
        w = ntt_core.forward_plan(m).root
        _compare("ntt_rows_pease", f"bitrev batch={batch} m={m}",
                 lambda: ntt_kernel.ntt_rows_pease(x, w, bitrev=True),
                 lambda: ntt_kernel.ntt_rows_pease_plain(x, w, bitrev=True),
                 ntt_rows_bound(batch, m, m))
        del x
    rows["ntt_rows_pease"] = phase3_pease_contract(rand_mont)
    phase3_period(rand_mont)

    # ntt_rows at each fused option, at the calls the prove path makes: pass 1
    # of the 2^25 and 2^24 LDEs (a short valid prefix, the coset pre-scale on
    # load, the U·V twiddle on store), pass 1 of the 2^22 INTT (1/n folded
    # into U), the stark-101 LDE and INTT (pre-scale; the scalar 1/n), and
    # the post-scale of a coset INTT's pass 2
    geo = ntt_kernel.GeoScale
    dev = torch.device("cuda", torch.cuda.current_device())
    for log_n, blowup in ((25, 8), (24, 8)):
        n = 1 << log_n
        w = ntt_core.forward_plan(n).root
        n1, n2, ut, vt = ntt_kernel._device_uv(n, w, None, fld, dev)
        x = rand_mont((n2, n1 // blowup))
        kw = dict(m=n1, pre=geo(5, n, col_stride=n2, row_stride=1), uv=(ut, vt))
        w1 = pow(w, n2, fld.p)
        _compare("ntt_rows", f"fused pre+uv batch={n2} valid={n1 // blowup} m={n1}",
                 lambda: ntt_kernel.ntt_rows(x, w1, fld, **kw),
                 lambda: ntt_kernel.ntt_rows_plain(x, w1, fld, **kw),
                 ntt_rows_bound(n2, n1 // blowup, n1, pre=True, uv=True))
        del x
    n = 1 << 22
    plan = ntt_core.inverse_plan(n)
    w = ntt_core._effective_root(plan)
    n1, n2, ut, vt = ntt_kernel._device_uv(n, w, plan.scale_mont, fld, dev)
    x = rand_mont((n2, n1))
    w1, w2 = pow(w, n2, fld.p), pow(w, n1, fld.p)
    _compare("ntt_rows", f"fused uv(1/n) batch={n2} m={n1}",
             lambda: ntt_kernel.ntt_rows(x, w1, fld, uv=(ut, vt)),
             lambda: ntt_kernel.ntt_rows_plain(x, w1, fld, uv=(ut, vt)),
             ntt_rows_bound(n2, n1, n1, uv=True))
    post = geo(pow(5, fld.p - 2, fld.p), n, col_stride=n1, row_stride=1)
    _compare("ntt_rows", f"fused post batch={n1} m={n2}",
             lambda: ntt_kernel.ntt_rows(x, w2, fld, post=post),
             lambda: ntt_kernel.ntt_rows_plain(x, w2, fld, post=post),
             ntt_rows_bound(n1, n2, n2, post=True))
    del x
    x = rand_mont((1, 1024))
    kw = dict(m=8192, pre=geo(5, 8192))
    w = ntt_core.forward_plan(8192).root
    _compare("ntt_rows", "fused pre batch=1 valid=1024 m=8192",
             lambda: ntt_kernel.ntt_rows(x, w, fld, **kw),
             lambda: ntt_kernel.ntt_rows_plain(x, w, fld, **kw),
             ntt_rows_bound(1, 1024, 8192, pre=True))
    plan = ntt_core.inverse_plan(1024)
    w = ntt_core._effective_root(plan)
    _compare("ntt_rows", "fused 1/n batch=1 m=1024",
             lambda: ntt_kernel.ntt_rows(x, w, fld, scale=plan.scale_mont),
             lambda: ntt_kernel.ntt_rows_plain(x, w, fld, scale=plan.scale_mont),
             ntt_rows_bound(1, 1024, 1024, scale=True))
    del x

    # transpose: the four-step's passes at 2^24 and 2^25 (the first on the
    # short coefficient vector) and the 2^22 INTT's
    for r_, c_, words in ((4096, 4096, 1 << 24), (512, 4096, 1 << 21), (1024, 4096, 1 << 22),
                          (4096, 8192, 1 << 25), (8192, 4096, 1 << 25), (2048, 2048, 1 << 22),
                          (2048, 2048, (1 << 22) - 1)):
        x = rand_mont(words)
        whole = words == r_ * c_
        r = _compare(
            "transpose", f"rows={r_} cols={c_} words={words}",
            lambda: ntt_kernel.transpose(x, r_, c_), lambda: ntt_kernel.transpose_plain(x, r_, c_),
            bound(4 * (words + r_ * c_), 0),
            library=(lambda: fp.as_i32(x).reshape(r_, c_).t().contiguous()) if whole else None,
        )
        if (r_, c_) == (4096, 4096):
            rows["transpose"] = r
        del x
    phase3_batched_transpose(rand_mont)
    say("phase3 clocks", sm_clocks())
    rows.update(phase3_chain_and_fold())
    rows.update(phase3_serial_kernels(rows["fs_chain"]))
    rows.update(phase3_limb_and_composition())
    rows.update(phase3_glue_kernels())
    rows["powers"] = phase3_powers()
    rows["openings"].update(phase3_launch_floor(rows["openings"], rows["powers"]))
    phase3_shard_contracts()
    phase3_lde()
    return rows


def phase3_pease_contract(rand_mont) -> dict:
    """`ntt_rows_pease` with the `ntt_rows` contract, in both orders, beside
    `ntt_rows` on the same call: every fused option at 4096 x 4096 (the
    kernel's table row, bit-reversed order, the four-step's), then the passes
    of the 2^24 LDE; then the two designs of the bit reversal, each a pass 1
    of the 2^24 LDE and the transpose after it: (a) natural order out of the
    kernel (a swizzled shared-memory round trip) and a plain transpose, (b)
    bit-reversed out and the transpose's bit-reversed rows."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ntt import core as ntt_core
    from zkstark_tpu_torch.ops import ntt_kernel

    fld, geo = fp.FIELD101, ntt_kernel.GeoScale
    dev = torch.device("cuda", torch.cuda.current_device())
    n = 1 << 24
    w = ntt_core.forward_plan(n).root
    out = None
    for label, batch, valid, m, opts in (
        ("all options", 4096, 4096, 4096, ("pre", "uv", "post", "scale")),
        ("2^24 pass 1 pre+uv", 4096, 512, 4096, ("pre", "uv")),
        ("2^24 pass 2 post", 4096, 4096, 4096, ("post",)),
    ):
        x = rand_mont((batch, valid))
        wm = pow(w, n // m, fld.p)
        for bitrev in (True, False):
            n1, n2, ut, vt = ntt_kernel._device_uv(n, w, None, fld, dev, bitrev)
            kw = dict(m=m)
            if "pre" in opts:
                kw["pre"] = geo(5, n, col_stride=n2, row_stride=1)
            if "uv" in opts:
                kw["uv"] = (ut, vt)
            if "post" in opts:
                kw["post"] = geo(pow(5, fld.p - 2, fld.p), n, col_stride=n1, row_stride=1)
            if "scale" in opts:
                kw["scale"] = fld.mont_scalar(3)
            order = "bitrev" if bitrev else "natural"
            r = _compare("ntt_rows_pease", f"{order} {label} batch={batch} valid={valid} m={m}",
                         lambda: ntt_kernel.ntt_rows_pease(x, wm, fld, bitrev=bitrev, **kw),
                         lambda: ntt_kernel.ntt_rows_pease_plain(x, wm, fld, bitrev=bitrev, **kw),
                         ntt_rows_bound(batch, valid, m, **{o: True for o in opts}))
            if bitrev and label == "all options":
                out = r
        # kw: the natural order's, whose tables are ntt_rows' too
        dit_ms = cuda_ms(lambda: ntt_kernel.ntt_rows(x, wm, fld, **kw), 20)
        if max_abs_err(ntt_kernel.ntt_rows(x, wm, fld, **kw),
                       ntt_kernel.ntt_rows_pease(x, wm, fld, **kw)):
            raise AssertionError(f"ntt_rows_pease {label} differs from ntt_rows")
        say(f"phase3 ntt_rows_pease {label} ==ntt_rows ntt_rows_ms={dit_ms:.4f}")
        del x
    phase3_bitrev_designs(rand_mont)
    return out


def _pease_lde(coeffs, n: int, bitrev: bool):
    """`coset_ntt(coeffs, n, 5)` on the Pease kernel by one of the two
    designs of the bit reversal: (a) natural-order rows and plain transposes,
    (b) bit-reversed rows and the transposes' bit-reversed rows."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ntt import core as ntt_core
    from zkstark_tpu_torch.ops import ntt_kernel

    fld = fp.FIELD101
    w = ntt_core.forward_plan(n).root
    dev = torch.device("cuda", torch.cuda.current_device())
    n1, n2, ut, vt = ntt_kernel._device_uv(n, w, None, fld, dev, bitrev)
    pre = ntt_kernel.GeoScale(5, n, col_stride=n2, row_stride=1)
    at = ntt_kernel.transpose(coeffs, -(-coeffs.shape[0] // n2), n2)
    at = ntt_kernel.ntt_rows_pease(at, pow(w, n2, fld.p), fld, m=n1, pre=pre, uv=(ut, vt),
                                   bitrev=bitrev)
    b = ntt_kernel.transpose(at.reshape(-1), n2, n1, brev=bitrev)
    d = ntt_kernel.ntt_rows_pease(b, pow(w, n1, fld.p), fld, bitrev=bitrev)
    return ntt_kernel.transpose(d.reshape(-1), n1, n2, brev=bitrev).reshape(-1)


def phase3_bitrev_designs(rand_mont) -> None:
    """The two designs of the Pease route's bit reversal, timed in turns
    (a, b, b, a; the least of each, 50 calls a window): the transposes alone
    (plain and with bit-reversed rows) at the four-step's shapes, and the
    whole 2^24 and 2^25 LDE of each design, composed from the kernels; each
    LDE equal to `coset_ntt`."""
    from zkstark_tpu_torch.ntt import core as ntt_core
    from zkstark_tpu_torch.ops import ntt_kernel

    def turns(fns, iters):
        times = {k: [] for k in fns}
        for k in (*fns, *reversed(fns)):
            times[k].append(cuda_ms(fns[k], iters))
        return {k: min(v) for k, v in times.items()}

    for r_, c_ in ((4096, 4096), (4096, 8192), (8192, 4096)):
        x = rand_mont(r_ * c_)
        t = turns({brev: (lambda brev=brev: ntt_kernel.transpose(x, r_, c_, brev=brev))
                   for brev in (False, True)}, 50)
        say(f"phase3 transpose rows={r_} cols={c_} plain ms={t[False]:.4f} "
            f"brev ms={t[True]:.4f} brev/plain={t[True] / t[False]:.3f}")
        del x
    for log_n in (24, 25):
        n = 1 << log_n
        coeffs = rand_mont(n // 8)
        want = ntt_core.coset_ntt(coeffs, n, 5)
        fns = {bitrev: (lambda bitrev=bitrev: _pease_lde(coeffs, n, bitrev))
               for bitrev in (False, True)}
        for bitrev, fn in fns.items():
            if max_abs_err(fn(), want):
                raise AssertionError(f"the Pease LDE by design {'b' if bitrev else 'a'} differs")
        t = turns(fns, 50)
        say(f"phase3 pease bit reversal coset_ntt n=2^{log_n}: (a) natural rows + plain "
            f"transposes ms={t[False]:.4f} (b) bitrev rows + brev transposes ms={t[True]:.4f} "
            f"b/a={t[True] / t[False]:.3f}")
        del coeffs, want


def phase3_period(rand_mont) -> None:
    """``period=`` on the three row kernels at the passes of the phase-10
    batch, 16 transforms of 2^20 points in one launch each (n1 = n2 = 1024):
    pass 1 with the coefficient prefix, the pre-scale and the twiddle, pass 2
    with the post-scale, against the plain twins."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ntt import core as ntt_core
    from zkstark_tpu_torch.ops import limb_dft, ntt_kernel

    fld, geo = fp.FIELD101, ntt_kernel.GeoScale
    dev = torch.device("cuda", torch.cuda.current_device())
    n, bsz = 1 << 20, 16
    w = ntt_core.forward_plan(n).root
    n1, n2 = ntt_kernel.split(n)
    kernels = (("ntt_rows", ntt_kernel.ntt_rows, ntt_kernel.ntt_rows_plain, {}, ntt_rows_bound),
               ("ntt_rows_pease", ntt_kernel.ntt_rows_pease, ntt_kernel.ntt_rows_pease_plain,
                {"bitrev": True}, ntt_rows_bound),
               ("limb_dft_rows", limb_dft.limb_dft_rows, limb_dft.limb_dft_rows_plain, {},
                limb_rows_bound))
    for name, fn, plain, extra, limit in kernels:
        _, _, ut, vt = ntt_kernel._device_uv(n, w, None, fld, dev, bool(extra))
        x = rand_mont((bsz * n2, n1 // 8))
        kw = dict(m=n1, pre=geo(5, n, col_stride=n2, row_stride=1), uv=(ut, vt), period=n2, **extra)
        w1 = pow(w, n2, fld.p)
        _compare(name, f"period={n2} pass 1 of {bsz} x 2^20 batch={bsz * n2} valid={n1 // 8} m={n1}",
                 lambda: fn(x, w1, fld, **kw), lambda: plain(x, w1, fld, **kw),
                 limit(bsz * n2, n1 // 8, n1, pre=True, uv=True), iters=10)
        x = rand_mont((bsz * n1, n2))
        kw = dict(post=geo(pow(5, fld.p - 2, fld.p), n, col_stride=n1, row_stride=1), period=n1,
                  **extra)
        w2 = pow(w, n1, fld.p)
        _compare(name, f"period={n1} pass 2 of {bsz} x 2^20 batch={bsz * n1} m={n2}",
                 lambda: fn(x, w2, fld, **kw), lambda: plain(x, w2, fld, **kw),
                 limit(bsz * n1, n2, n2, post=True), iters=10)
        del x


def phase3_batched_transpose(rand_mont) -> None:
    """`transpose` of a batch in one launch: the phase-10 batch's first
    transpose (16 coefficient vectors of 2^17 words as (128, 1024)) and its
    bit-reversed ones on the Pease route (16 of (1024, 1024)), beside one
    PyTorch call on the same words."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import ntt_kernel

    for bsz, r_, c_, words, brev in ((16, 128, 1024, 1 << 17, False), (16, 1024, 1024, 1 << 20, True),
                                     (16, 1024, 1024, 1 << 20, False)):
        x = rand_mont((bsz, words))
        _compare("transpose", f"batch={bsz} rows={r_} cols={c_} words={words} brev={int(brev)}",
                 lambda: ntt_kernel.transpose(x, r_, c_, brev=brev),
                 lambda: ntt_kernel.transpose_plain(x, r_, c_, brev=brev),
                 bound(4 * bsz * (words + r_ * c_), 0),
                 library=None if brev else (
                     lambda: fp.as_i32(x).reshape(bsz, r_, c_).transpose(1, 2).contiguous()))
        del x


def _all_equal(name: str, label: str, got, want) -> None:
    """Every tensor of `got` equals its twin in `want` (None where None)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None):
            raise AssertionError(f"{name} {label}: output {i} is missing on one side")
        if g is not None and g.numel() and max_abs_err(g, w):
            raise AssertionError(f"{name} {label}: output {i} differs from its plain twin")


def phase3_chain_and_fold() -> dict:
    """`fs_chain` at every entry point and `fri_fold` at every layer size
    against their plain versions (tolerance 0); the timed rows are the calls
    the one-fetch path makes (a root and one draw at B = 1; the first fold of
    the 2^24 statement)."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import fri_fold, fs_chain

    rng = np.random.default_rng(34)
    rows = {}

    def u32(shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)

    # no PyTorch call computes a SHA-256 chain or a modular fold: no library time
    for bsz in (1, 5, 64):
        state = u32((bsz, 8))
        state[:, 0] |= 0x80000000  # draws ≥ 2^31
        state, digest = fp.from_host(state, "cuda"), fp.from_host(u32((bsz, 8)), "cuda")
        word = fp.from_host(u32(bsz) | np.uint32(0x80000000), "cuda")
        for fld in (fp.FIELD101, fp.FIELD_ALT):
            for kw in (dict(digest=digest), dict(word=word), dict(draws=1), dict(draws=3),
                       dict(draws=4, query_range=8176), dict(digest=digest, draws=3),
                       dict(digest=digest, word=word, draws=3, query_range=8176)):
                _all_equal("fs_chain", f"B={bsz} p={fld.p} {sorted(kw)}",
                           fs_chain.chain_step(state, field=fld, **kw),
                           fs_chain.chain_step_plain(state, field=fld, **kw))
        _all_equal("fs_chain", f"B={bsz} absorb_hash", [fs_chain.absorb_hash(state, digest)],
                   [fs_chain.chain_step_plain(state, digest=digest)[0]])
        _all_equal("fs_chain", f"B={bsz} absorb_u32_le", [fs_chain.absorb_u32_le(state, word)],
                   [fs_chain.chain_step_plain(state, word=word)[0]])
        _all_equal("fs_chain", f"B={bsz} draw", fs_chain.draw(state, 2),
                   fs_chain.chain_step_plain(state, draws=2))
        # one boundary of the prove path: a root (two compressions), one draw
        r = _compare(
            "fs_chain", f"B={bsz} digest+1 draw",
            lambda: fs_chain.chain_step(state, digest=digest, draws=1)[0],
            lambda: fs_chain.chain_step_plain(state, digest=digest, draws=1)[0],
            bound(bsz * 4 * (8 + 8 + 8 + 2), bsz * (2 * SHA_BLOCK + SHA_ROUNDS + FP_MUL)),
        )
        if bsz == 1:
            rows["fs_chain"] = r

    for fld in (fp.FIELD101, fp.FIELD_ALT):
        p = fld.p
        for bsz in (1, 3):
            for log_m in range(1, 25):
                # above 2^16: every fourth size, and 2^21 (one shard's first
                # fold at 2^24 over 8 shards); the second prime at 2^24 only
                if log_m > 16 and (log_m % 4 and log_m != 21
                                   or fld is fp.FIELD_ALT and log_m < 24):
                    continue
                m = 1 << log_m
                vals = rng.integers(0, p, (bsz, m), dtype=np.uint64).astype(np.uint32)
                vals[0, : min(m, 3)] = np.array([0, 1, p - 1], dtype=np.uint32)[: min(m, 3)]
                vals[-1, m // 2 :] = p - 1
                evals = fp.from_host(vals, "cuda")
                beta = fp.from_host(rng.integers(0, p, bsz, dtype=np.uint64).astype(np.uint32), "cuda")
                base = fld.subgroup_generator(m)
                args = (beta, pow(base, p - 2, p), pow(5, p - 2, p), fld)
                label = f"B={bsz} m=2^{log_m} p={p}"
                _all_equal("fri_fold", label, fri_fold.fri_fold(evals, *args),
                           fri_fold.fri_fold_plain(evals, *args))
                if bsz == 1 and log_m in (21, 24) and fld is fp.FIELD101:
                    # both outputs are checked above; the timed calls return
                    # one. 2^24: the first fold of the 2^24 statement; 2^21:
                    # one shard's first fold of it on a local mesh of 8. The
                    # row's time is the kernel's own device time (the CUDA-event
                    # time of so short a call is the wrapper's enqueue)
                    limit = bound(bsz * (4 * m + 2 * 2 * m), bsz * (m // 2) * FOLD_OPS)
                    r = _compare("fri_fold", label, lambda: fri_fold.fri_fold(evals, *args)[1],
                                 lambda: fri_fold.fri_fold_plain(evals, *args)[1], limit)
                    dev_ms = device_ms(lambda: fri_fold.fri_fold(evals, *args), "fri_fold_kernel",
                                       20)
                    say(f"phase3 fri_fold {label} device_ms={dev_ms:.5f} (the wrapper's enqueue: "
                        f"{r['ms']:.4f}) bound_ms={limit['bound_ms']:.5f} "
                        f"share={limit['bound_ms'] / dev_ms:.3f}")
                    if log_m == 24:
                        rows["fri_fold"] = dict(r, ms=dev_ms, wrapper_ms=r["ms"])
                del evals
        say(f"phase3 fri_fold p={p} B in (1, 3) m=2..2^24 equal to the plain version, tol=0")
    return rows


def device_ms(fn, kernel: str, iters: int = 10, required: bool = True) -> float | None:
    """Mean device milliseconds of the kernel named `kernel` over `iters`
    calls of `fn`, from torch.profiler: the kernel's own spans, without the
    wrapper's enqueue that a CUDA-event time of a short call is made of.
    Where the profiler dropped every span of the window, raises, or with
    `required` false returns None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in (iters, 3 * iters, 10 * iters):  # longer windows if the first kept nothing
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(window):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        if spans:
            break
    if not spans:  # the profiler may drop a span of a window; it must not drop them all
        if not required:
            return None
        raise AssertionError(f"torch.profiler saw no launch of {kernel}")
    return sum(spans) / len(spans) / 1e3


def phase3_serial_kernels(chain_row: dict) -> dict:
    """The two kernels that latency bounds, not throughput. First the latency
    of one dependent SHA-256 compression on one thread: the device time of
    `fs_chain` with 2048 draws less that with 1024 (a draw is one compression
    that waits for the one before), over 1024. Then `fs_chain`'s own row with
    its device time and its bound (its compressions times that latency), and
    `sha256_tree_tail` against `tree_tail_plain`, every word equal, with the
    bound of its levels times one dependent node hash (two compressions; a
    leaf level one more)."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import fs_chain, sha256_kernel

    rng = np.random.default_rng(36)

    def u32(shape):
        return fp.from_host(rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32), "cuda")

    state, digest = u32((1, 8)), u32((1, 8))
    long_ms = [device_ms(lambda: fs_chain.chain_step(state, draws=n), "fs_chain_kernel", 5)
               for n in (1024, 2048)]
    compression_ms = (long_ms[1] - long_ms[0]) / 1024
    say(f"phase3 dependent compression on one thread: draws=1024 device_ms={long_ms[0]:.4f} "
        f"draws=2048 device_ms={long_ms[1]:.4f} one_compression_us={compression_ms * 1e3:.4f}")
    rows = {}

    # fs_chain, one boundary at B = 1: a root (two compressions) and one draw
    chain_ms = device_ms(lambda: fs_chain.chain_step(state, digest=digest, draws=1),
                         "fs_chain_kernel", 20)
    chain_bound = 3 * compression_ms
    say(f"phase3 fs_chain B=1 digest+1 draw device_ms={chain_ms:.5f} (the wrapper's enqueue: "
        f"{chain_row['ms']:.4f}) bound_ms={chain_bound:.5f} bound_by=operations "
        f"(3 dependent compressions) share={chain_bound / chain_ms:.3f}")
    rows["fs_chain"] = dict(chain_row, ms=chain_ms, bound_ms=chain_bound, bound_by="operations")

    # no PyTorch call computes a Merkle tree: no library time
    top = sha256_kernel.TAIL_PARENTS
    for trees, t in ((1, top), (32, top), (1, top // 2), (1, top // 4), (32, top // 4), (3, 16),
                     (1, 2), (5, 1)):
        for from_values in (False, True):
            level = u32(trees * 2 * t) if from_values else u32((trees * 2 * t, 8))
            label = f"trees={trees} parents={t} from_values={from_values}"
            _all_equal("sha256_tree_tail", label,
                       sha256_kernel.tree_tail(level, trees, from_values),
                       sha256_kernel.tree_tail_plain(level, trees, from_values))
            levels = t.bit_length()
            limit = dict(bound_ms=(2 * levels + from_values) * compression_ms, bound_by="operations")
            main_row = (trees, t, from_values) == (1, top, False)
            # the other shapes are for comparison: a window the profiler drops
            # reads "not measured" there, and fails only the table's row
            ms = device_ms(lambda: sha256_kernel.tree_tail(level, trees, from_values),
                           "sha256_tree_tail", 10, required=main_row)
            enqueue_ms = cuda_ms(lambda: sha256_kernel.tree_tail(level, trees, from_values), 20)
            dev_text = f"device_ms={ms:.5f}" if ms else "device_ms=not_measured"
            say(f"phase3 sha256_tree_tail {label} max_abs_err=0 tol=0 {dev_text} "
                f"wrapper_ms={enqueue_ms:.4f} bound_ms={limit['bound_ms']:.5f} "
                f"bound_by=operations ({levels} levels of one dependent node hash)"
                + (f" share={limit['bound_ms'] / ms:.3f}" if ms else ""))
            if main_row:
                # the plain version is thousands of launches: timed for this row only
                plain_ms = cuda_ms(lambda: sha256_kernel.tree_tail_plain(level, trees), 1)
                say(f"phase3 sha256_tree_tail {label} plain_ms={plain_ms:.4f}")
                rows["sha256_tree_tail"] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                                                library_ms=None, **limit)
    return rows


def phase3_limb_and_composition() -> dict:
    """`limb_dft_rows` against its plain version and `ntt_rows` at the calls
    of the 2^27 LDE and at the 2^24 LDE's shape, and `composition` against
    `composition_eval_plain` (tolerance 0 everywhere)."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ntt import core as ntt_core
    from zkstark_tpu_torch.ops import composition, limb_dft, ntt_kernel
    from zkstark_tpu_torch.protocol import prover as pr
    from zkstark_tpu_torch.protocol.air import AIRS, SQUARE_CHAIN
    from zkstark_tpu_torch.protocol.config import StarkConfig

    rng = np.random.default_rng(35)
    rows = {}

    def rand_mont(fld, shape):
        return fp.from_host(fld.host_to_mont(rng.integers(0, fld.p, shape, dtype=np.uint64)), "cuda")

    # no one PyTorch call computes an exact DFT over F_p: no library time; the
    # yardstick beside each line is `ntt_rows` on the same rows (m <= 8192)
    for fld in (fp.FIELD101, fp.FIELD_ALT):
        for batch, m in ((8192, 16384), (16384, 8192), (4096, 4096)):
            x = rand_mont(fld, (batch, m))
            w = ntt_core.forward_plan(m, fld).root
            label = f"batch={batch} m={m} p={fld.p}"
            if m <= ntt_kernel.MAX_ROW:
                if max_abs_err(limb_dft.limb_dft_rows(x, w, fld), ntt_kernel.ntt_rows(x, w, fld)):
                    raise AssertionError(f"limb_dft_rows {label} differs from ntt_rows")
            if fld is fp.FIELD101:
                r = _compare("limb_dft_rows", label,
                             lambda: limb_dft.limb_dft_rows(x, w, fld),
                             lambda: limb_dft.limb_dft_rows_plain(x, w, fld),
                             limb_rows_bound(batch, m, m), iters=10)
                if m <= ntt_kernel.MAX_ROW:
                    rows_ms = cuda_ms(lambda: ntt_kernel.ntt_rows(x, w, fld), 10)
                    say(f"phase3 limb_dft_rows {label} ==ntt_rows ntt_rows_ms={rows_ms:.4f} "
                        f"limb_over_ntt_rows={r['ms'] / rows_ms:.2f}")
                else:
                    rows["limb_dft_rows"] = r
            else:
                _all_equal("limb_dft_rows", label, [limb_dft.limb_dft_rows(x, w, fld)],
                           [limb_dft.limb_dft_rows_plain(x, w, fld)])
                say(f"phase3 limb_dft_rows {label} max_abs_err=0 tol=0")
            del x

    # each fused option at the calls the 2^27 path makes: pass 1 of the LDE
    # (a short valid prefix, the coset pre-scale, the U·V twiddle), pass 2 of
    # a coset INTT (the post-scale), pass 1 of an INTT (1/n folded into U), and
    # the scalar on a short call
    fld = fp.FIELD101
    geo = ntt_kernel.GeoScale
    dev = torch.device("cuda", torch.cuda.current_device())
    n = 1 << 27
    w = ntt_core.forward_plan(n).root
    n1, n2, ut, vt = ntt_kernel._device_uv(n, w, None, fld, dev)
    x = rand_mont(fld, (n2, n1 // 8))
    kw = dict(m=n1, pre=geo(5, n, col_stride=n2, row_stride=1), uv=(ut, vt))
    w1, w2 = pow(w, n2, fld.p), pow(w, n1, fld.p)
    _compare("limb_dft_rows", f"fused pre+uv batch={n2} valid={n1 // 8} m={n1}",
             lambda: limb_dft.limb_dft_rows(x, w1, fld, **kw),
             lambda: limb_dft.limb_dft_rows_plain(x, w1, fld, **kw),
             limb_rows_bound(n2, n1 // 8, n1, pre=True, uv=True), iters=10)
    del x
    x = rand_mont(fld, (n1, n2))
    post = geo(pow(5, fld.p - 2, fld.p), n, col_stride=n1, row_stride=1)
    _compare("limb_dft_rows", f"fused post batch={n1} m={n2}",
             lambda: limb_dft.limb_dft_rows(x, w2, fld, post=post),
             lambda: limb_dft.limb_dft_rows_plain(x, w2, fld, post=post),
             limb_rows_bound(n1, n2, n2, post=True), iters=10)
    del x
    plan = ntt_core.inverse_plan(1 << 16)
    wi = ntt_core._effective_root(plan)
    _, _, ut16, vt16 = ntt_kernel._device_uv(1 << 16, wi, plan.scale_mont, fld, dev)
    x = rand_mont(fld, (256, 256))
    _compare("limb_dft_rows", "fused uv(1/n) batch=256 m=256",
             lambda: limb_dft.limb_dft_rows(x, pow(wi, 256, fld.p), fld, uv=(ut16, vt16)),
             lambda: limb_dft.limb_dft_rows_plain(x, pow(wi, 256, fld.p), fld, uv=(ut16, vt16)),
             limb_rows_bound(256, 256, 256, uv=True))
    _compare("limb_dft_rows", "fused 1/n batch=256 m=256",
             lambda: limb_dft.limb_dft_rows(x, pow(wi, 256, fld.p), fld, scale=plan.scale_mont),
             lambda: limb_dft.limb_dft_rows_plain(x, pow(wi, 256, fld.p), fld, scale=plan.scale_mont),
             limb_rows_bound(256, 256, 256, scale=True))
    del x, ut, vt

    # composition: the three AIRs at 2^13 and both primes, then square-chain at
    # 2^24; no one PyTorch call computes it: no library time
    def comp_bound(cfg, bsz):
        mul, add, sub = pr.composition_program(cfg).field_ops
        d = cfg.eval_domain
        return bound(bsz * d * (4 + 8) + 4 * cfg.n_constraints * d,
                     bsz * d * (mul * FP_MUL + add * FP_ADD + sub * FP_SUB + 5))

    def comp_case(cfg, bsz):
        f = rand_mont(cfg.field, (bsz, cfg.eval_domain))
        alphas = rand_mont(cfg.field, (bsz, cfg.n_constraints))
        return f, alphas

    for name, air in AIRS.items():
        for fld in (fp.FIELD101, fp.FIELD_ALT):
            cfg = StarkConfig(field=fld, air=air, trace_len=1023, boundary_first=1, boundary_last=1,
                              coset_offset=5 if fld is fp.FIELD101 else 31)
            for bsz in (1, 3):
                f, alphas = comp_case(cfg, bsz)
                cp, res = pr.composition_eval_res(cfg, f, alphas)
                want = pr.composition_eval_plain(cfg, f, alphas)
                _all_equal("composition", f"{name} 2^13 B={bsz} p={fld.p}", [cp, res],
                           [want, fp.from_mont_f(fld, want)])
        say(f"phase3 composition {name} d=2^13 B in (1, 3) both primes equal to "
            "composition_eval_plain, tol=0")
    cfg = StarkConfig(trace_len=(1 << BIG_TRACE_BITS) - 1, boundary_last=1, air=SQUARE_CHAIN)
    for bsz in (3, 1):
        f, alphas = comp_case(cfg, bsz)
        cp, res = pr.composition_eval_res(cfg, f, alphas)
        want = pr.composition_eval_plain(cfg, f, alphas)
        _all_equal("composition", f"square-chain 2^24 B={bsz}", [cp, res],
                   [want, fp.from_mont_f(cfg.field, want)])
        del cp, res, want
        if bsz == 1:
            # both outputs are checked above; the timed calls return the residues
            rows["composition"] = _compare(
                "composition", "square-chain d=2^24 B=1",
                lambda: pr.composition_eval_res(cfg, f, alphas)[1],
                lambda: fp.from_mont_f(cfg.field, pr.composition_eval_plain(cfg, f, alphas)),
                comp_bound(cfg, 1),
            )
        del f, alphas
    say("phase3 composition square-chain d=2^24 B in (1, 3) equal to composition_eval_plain, tol=0")
    torch.cuda.empty_cache()
    return rows


def _random_trees(gen: torch.Generator, lead: tuple, sizes) -> tuple:
    """Random values lead + (n,) and digest levels lead + (k, 8), k = n … 1,
    for each tree size n, made on the card from `gen`, the levels of a tree
    in one allocation (`merkle.Levels`): (values, levels)."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.hash import merkle

    def u32(shape):
        return fp.narrow(torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64,
                                       device="cuda"))

    bsz = int(np.prod(lead))
    values, levels = [], []
    for n in sizes:
        values.append(u32(lead + (n,)))
        buf = u32((merkle.level_offset(n, n.bit_length(), bsz),))
        views = merkle._level_views(buf, bsz, n)
        levels.append(merkle.Levels([v.view(lead + v.shape[1:]) for v in views], buf))
    return values, levels


def phase3_glue_kernels() -> dict:
    """The four kernels that replaced the fused core's plain-torch glue
    (`openings`, `endpoint_fix`, `from_mont`, `constants`) against their plain
    twins (tolerance 0) at the prove path's shapes, each with its device time
    under torch.profiler beside the wrapper's CUDA-event time (at these sizes
    mostly the host's enqueue) and its bound; no one PyTorch call computes any
    of them: no library time. The table's row of each is the first shape."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import constants, elementwise
    from zkstark_tpu_torch.ops import openings as open_op
    from zkstark_tpu_torch.protocol import openings
    from zkstark_tpu_torch.protocol import prover as pr
    from zkstark_tpu_torch.protocol.air import AIRS
    from zkstark_tpu_torch.protocol.config import STARK101, StarkConfig

    rng = np.random.default_rng(39)
    gen = torch.Generator(device="cuda").manual_seed(39)
    rows = {}

    def row(name: str, label: str, kernel, plain, limit: dict, kernel_name: str) -> None:
        r = _compare(name, label, kernel, plain, limit)
        table = name not in rows
        dev_ms = device_ms(kernel, kernel_name, 20, required=table)
        say(f"phase3 {name} {label} {_device_line(dev_ms, r['ms'], limit)} library=none")
        if table:
            rows[name] = dict(r, ms=dev_ms, wrapper_ms=r["ms"])

    # from_mont: f_eval of the 2^24 statement, of stark-101, of 2^25; 4 bytes
    # read and written a word, one REDC (5 ops) a word
    for n in (1 << 24, 8192, 1 << 25):
        x = fp.from_host(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32), "cuda")
        row("from_mont", f"n={n}", lambda: elementwise.from_mont(x),
            lambda: elementwise.from_mont_plain(x), bound(8 * n, 5 * n), "from_mont_kernel")
        del x

    # endpoint_fix: the INTT sizes of the 2^24, stark-101 and 2^28 statements
    # and a batch of 32 stark-101 proofs; 4 bytes read and written a word (and
    # the two tables), two products and a subtract a word
    fld = fp.FIELD101
    for bsz, log_n in ((1, 21), (1, 10), (1, 25), (32, 10)):
        n = 1 << log_n
        c0 = fp.from_host(fld.host_to_mont(rng.integers(0, fld.p, (bsz, n), dtype=np.uint64)),
                          "cuda")
        tables = 4 * (n >> (log_n // 2)) + 4 * (1 << (log_n // 2))
        row("endpoint_fix", f"B={bsz} n=2^{log_n}", lambda: elementwise.endpoint_fix(c0),
            lambda: elementwise.endpoint_fix_plain(c0),
            bound(8 * bsz * n + tables, bsz * n * (2 * FP_MUL + FP_SUB)), "endpoint_fix_kernel")
        del c0

    # constants: the 2^24 square-chain statement's (one boundary, one
    # transition), stark-101's (two boundaries, one transition) and
    # fibonacci-sq at 2^24; the tensor written once, and a point's x_j (two
    # products), a boundary's subtract, three products and its share of the
    # tile's Fermat inversion (32 squarings, a product a set bit of p - 2),
    # a transition's subtract and product an exempt point
    for cfg in (_square_chain_cfg(BIG_TRACE_BITS, BIG_SECRET), STARK101,
                StarkConfig(trace_len=(1 << BIG_TRACE_BITS) - 1, boundary_first=1,
                            boundary_last=1, air=AIRS["fibonacci-sq"])):
        system = pr.constants_system(cfg)
        d = cfg.eval_domain
        fermat = 32 + bin(cfg.field.p - 2).count("1")
        ops = 0
        for kind, arg in system.constraints():
            ops += (FP_SUB + 3 * FP_MUL + fermat * FP_MUL / CONST_TILE if kind == 0
                    else len(arg) * (FP_SUB + FP_MUL))
        row("constants", f"{cfg.air.name} d=2^{d.bit_length() - 1} "
            f"constraints={cfg.n_constraints}",
            lambda: constants.inverse_denominators(system, cfg.field, "cuda"),
            lambda: constants.inverse_denominators_plain(system, cfg.field, "cuda"),
            bound(4 * cfg.n_constraints * d, d * (2 * FP_MUL + ops)), "constants_kernel")
        torch.cuda.empty_cache()

    rows["openings"] = phase3_openings(gen, rng)
    torch.cuda.empty_cache()
    return rows


def phase3_openings(gen, rng) -> dict:
    """`openings` at the prove path's shapes against its plain twin: the
    fused core's whole packed result (its launch on the main path) and the
    openings alone, for one stark-101 proof, a batch of 32, one proof at
    2^24 and shard 3 of 8 at 2^24; each word of the result read once and
    written once (and the queries), the index rule a word (an and, an add, an
    and, a shift, an xor). At stark-101: the wrapper's host time (mean of 50
    calls), the parameter block's bytes, and the A/B against the design it
    replaced (`OldOpenings`, kept in this script) in turns, device and host
    times. Returns the table's row: the packed result at stark-101."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import openings as open_op
    from zkstark_tpu_torch.parallel.merkle_sharded import shard_tree
    from zkstark_tpu_torch.protocol import fused, openings
    from zkstark_tpu_torch.protocol.config import STARK101

    table = None
    cases = ((STARK101, (1,), None), (STARK101, (32,), None),
             (_square_chain_cfg(BIG_TRACE_BITS, BIG_SECRET), (1,), None),
             (_square_chain_cfg(BIG_TRACE_BITS, BIG_SECRET), (1,), 8))
    for cfg, lead, shards in cases:
        d, q, bsz = cfg.eval_domain, cfg.n_queries, lead[0]
        values, levels = _random_trees(gen, lead, [d] + [d >> k for k in range(cfg.fri_rounds + 1)])
        idx = fp.from_host(rng.integers(0, cfg.query_range, lead + (q,), dtype=np.uint64)
                           .astype(np.uint32), "cuda")
        # the chain's draws: alphas, betas, then the queries (openings.draw_columns)
        draws = fp.from_host(np.concatenate(
            [rng.integers(0, 1 << 32, (bsz, cfg.n_constraints + cfg.fri_rounds), dtype=np.uint64)
             .astype(np.uint32), fp.to_host(idx)], axis=1), "cuda")
        qcol = openings.draw_columns(cfg)[2][0]
        args = [values[0], levels[0], values[1:], levels[1:]]
        kw = {}
        if shards:  # the trees of at least `shards` leaves as shard 3 holds them
            sh = [shard_tree(v, lv, shards) for v, lv in zip(values, levels)]
            args = [sh[0][0], sh[0][1], [t[0] for t in sh[1:]], [t[1] for t in sh[1:]]]
            kw = dict(shard=3, block=3)
        trees = openings.trees(*args, block=3 if shards else None)
        shard = 3 if shards else None
        label = (f"{cfg.air.name} d=2^{d.bit_length() - 1} B={bsz} q={q}"
                 + (f" shard 3/{shards}" if shards else ""))
        for what, segs, fn, srcs, qs in (
                ("packed", openings.packed_segments(cfg),
                 lambda: openings.packed_result(cfg, *args, draws, **kw), (draws,),
                 draws[:, qcol:]),
                ("openings", openings.segments(cfg),
                 lambda: openings.sparse_openings_packed(cfg, *args, idx, **kw), (), idx)):
            plan = open_op.describe(segs, lead, q, bool(shards), open_op._collect(qs, trees, srcs)[0])
            words = plan.total
            if shards:  # shard 3's words are the solo result's where it owns them
                solo = (openings.packed_result(cfg, values[0], levels[0], values[1:], levels[1:],
                                               draws) if what == "packed" else
                        openings.sparse_openings_packed(cfg, values[0], levels[0], values[1:],
                                                        levels[1:], idx))
                got = fp.as_i32(fn())
                mask = got != 0
                if (got[mask] != fp.as_i32(solo)[mask]).any():
                    raise AssertionError(f"openings {label}: a word differs from the solo result")
            r = _compare("openings", f"{what} {label} words={words}", fn,
                         lambda: open_op.openings_plain(qs, trees, segs, shard, srcs),
                         bound(8 * words + 4 * bsz * q, 5 * words))
            dev_ms = device_ms(fn, "openings_kernel", 20, required=table is None)
            say(f"phase3 openings {what} {label} {_device_line(dev_ms, r['ms'], r)} "
                f"param_block_bytes={plan.block_bytes} param_words={len(plan.words)} "
                f"segments={plan.n_segs} library=none")
            if table is None:
                table = dict(r, wrapper_ms=r["ms"])
        del values, levels, args, trees, draws
    # the table's row: the kernel on the fused core's own arguments
    table.update(_openings_host_and_ab())
    return table


def _openings_host_and_ab() -> dict:
    """At stark-101, on the arguments a fused prove's core passes `openings`
    (captured from one `fused_core_packed`: the trees in one allocation each,
    the queries a column of the draws): the kernel's profiled device time;
    the wrapper's host time (mean of 50 calls, host clock, no wait between
    them) of the packed result and of the openings alone; and the openings
    alone against the old design in turns (new, old, old, new), device time
    (profiled, 20 calls a turn) and host time (50 calls), on the same trees,
    level by level for the old design."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.hash import merkle
    from zkstark_tpu_torch.ops import openings as open_op
    from zkstark_tpu_torch.protocol import STARK101, STARK101_SECRET, fused, openings
    from zkstark_tpu_torch.protocol import prover as pr

    cfg = STARK101
    seen, wrapper = [], open_op.openings

    def spy(*args):
        seen.append(args)
        return wrapper(*args)

    trace = pr.trace_to_device(cfg, STARK101_SECRET, torch.device("cuda"))
    open_op.openings = spy
    try:
        fused.fused_core_packed(cfg, trace)
    finally:
        open_op.openings = wrapper
    queries, trees, packed_segs, shard, sources = seen[-1]

    def host_ms(fn, calls=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        ms = (time.perf_counter() - t0) / calls * 1e3
        torch.cuda.synchronize()
        return ms

    open_segs = openings.segments(cfg)
    idx = fp.as_u32(fp.as_i32(queries).contiguous())
    new = {"packed": lambda: open_op.openings(queries, trees, packed_segs, shard, sources),
           "openings": lambda: open_op.openings(idx, trees, open_segs)}
    if max_abs_err(new["packed"](), open_op.openings_plain(queries, trees, packed_segs, shard,
                                                          sources)):
        raise AssertionError("openings: the fused core's call differs from its plain twin")
    old = OldOpenings()
    old_trees = []
    for t in trees[: cfg.fri_rounds + 1]:  # the old design's arrays: the same words
        n = 1 << t.log_n
        views = merkle._level_views(t.levels[merkle.values_words(1, n):], 1, n)
        old_trees.append([t.levels[:n].view(1, n), *views[:-1]])
    old_segs = old_segments(open_segs)
    old_fn = lambda: old(idx, old_trees, old_segs)  # noqa: E731
    if max_abs_err(old_fn(), new["openings"]()):
        raise AssertionError("openings: the old design's words differ from the new one's")
    dev_ms = device_ms(new["packed"], "openings_kernel", 50)
    host = {k: host_ms(fn) for k, fn in new.items()}
    turns = {"new": [], "old": []}
    for which in ("new", "old", "old", "new"):
        fn = new["openings"] if which == "new" else old_fn
        turns[which].append((device_ms(fn, "openings_kernel", 20), host_ms(fn)))
    plan = open_op.describe(packed_segs, (1,), cfg.n_queries, False,
                            open_op._collect(queries, trees, sources)[0])
    say(f"phase3 openings stark-101 fused core's call: device_ms={dev_ms:.5f} "
        f"wrapper host_ms packed={host['packed']:.5f} openings={host['openings']:.5f} "
        f"(ops.openings, mean of 50 calls) param_block_bytes={plan.block_bytes} "
        f"param_words={len(plan.words)} trees={len(trees)} "
        f"in_one_allocation={sum(t.values is None for t in trees)} sources={len(sources)}")
    say("phase3 openings stark-101 A/B in turns new,old,old,new (openings alone): device_ms="
        + ",".join(f"{turns[w][i][0]:.5f}" for w, i in (("new", 0), ("old", 0), ("old", 1),
                                                        ("new", 1)))
        + " host_ms="
        + ",".join(f"{turns[w][i][1]:.5f}" for w, i in (("new", 0), ("old", 0), ("old", 1),
                                                        ("new", 1)))
        + f" old param bytes={4 * (8 + 64 * 14) + 16 * 512}")
    return dict(ms=dev_ms, wrapper_host_ms=host["packed"], wrapper_host_ms_openings=host["openings"],
                param_block_bytes=plan.block_bytes,
                old_device_ms=[t[0] for t in turns["old"]], new_device_ms=[t[0] for t in turns["new"]],
                old_host_ms=[t[1] for t in turns["old"]], new_host_ms=[t[1] for t in turns["new"]])


def phase3_powers() -> dict:
    """`powers` (`Field.powers_iota` / `device_powers` on a card) against
    its plain twin at n = 2^20, timed on the device (profiled, the launch
    being a few microseconds) beside the wrapper's CUDA-event time; bound:
    4 bytes written and one product a word."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import powers

    fld, n = fp.FIELD101, 1 << 20
    base = fld.subgroup_generator(n)
    limit = bound(4 * n, FP_MUL * n)
    fn = lambda: powers.powers(fld, base, n, 7, "cuda")  # noqa: E731
    r = _compare("powers", "n=2^20", fn, lambda: powers.powers_plain(fld, base, n, 7, "cuda"),
                 limit)
    dev_ms = device_ms(fn, "powers_kernel", 20)
    say(f"phase3 powers n=2^20 {_device_line(dev_ms, r['ms'], limit)} library=none")
    return dict(r, ms=dev_ms, wrapper_ms=r["ms"])


def _device_line(dev_ms: float | None, wrapper_ms: float, limit: dict) -> str:
    """A kernel's profiled device time beside its wrapper's and its bound."""
    if dev_ms is None:
        return f"device_ms=not measured (the profiler kept no span) wrapper_ms={wrapper_ms:.4f}"
    return (f"device_ms={dev_ms:.5f} (the wrapper's enqueue: {wrapper_ms:.4f}) "
            f"bound_ms={limit['bound_ms']:.5f} share={limit['bound_ms'] / dev_ms:.3f}")


def phase3_shard_contracts() -> None:
    """The kernel arguments the sharded prover added, against the plain
    twins at tolerance 0: `transpose` with block elements (the sharded
    six-step's send re-layout) at the shapes of stark-101 and 2^24 on a mesh
    of 8, a short valid prefix included; `composition` on one shard with its
    halo and start, also against the matching slice of the whole domain's
    launch."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import composition, ntt_kernel
    from zkstark_tpu_torch.protocol import prover as pr
    from zkstark_tpu_torch.protocol.air import SQUARE_CHAIN
    from zkstark_tpu_torch.protocol.config import STARK101, StarkConfig

    rng = np.random.default_rng(37)
    fld = fp.FIELD101

    def rand_mont(n):
        return fp.from_host(fld.host_to_mont(rng.integers(0, fld.p, n, dtype=np.uint64)), "cuda")

    # (rows a, cols S, elem b, valid): 2^24 at S = 8 (a = b = 512), stark-101
    # at S = 8 (a = 16, b = 8), a shard holding the coefficient prefix only
    for r_, c_, e_, words in ((512, 8, 512, 1 << 21), (16, 8, 8, 1024), (16, 8, 8, 1000),
                              (512, 8, 512, (1 << 21) - 5), (512, 8, 512, 0)):
        x = rand_mont(words)
        label = f"blocks rows={r_} cols={c_} elem={e_} words={words}"
        limit = bound(4 * (words + r_ * c_ * e_), 0)
        r = _compare("transpose", label,
                     lambda: ntt_kernel.transpose(x, r_, c_, elem=e_),
                     lambda: ntt_kernel.transpose_plain(x, r_, c_, elem=e_), limit,
                     library=(lambda: fp.as_i32(x).reshape(r_, c_, e_).transpose(0, 1).contiguous())
                     if words == r_ * c_ * e_ else None)
        dev_ms = device_ms(lambda: ntt_kernel.transpose(x, r_, c_, elem=e_), "transpose", 20,
                           required=False)
        say(f"phase3 transpose {label} {_device_line(dev_ms, r['ms'], limit)}")
        del x, r

    # ntt_rows as the 2^24 LDE on a mesh of 8 launches it on shard 3 in the
    # first pass: its 512 rows (j2 = 1536..2047) of the received block with
    # the coefficient prefix, the coset pre-scale, the shard's slice of the
    # six-step's U table, and base^{t·b} as the scale on store
    from zkstark_tpu_torch.parallel import ntt_sharded

    n, shards, t, blowup = 1 << 24, 8, 3, 8
    root = fld.subgroup_generator(n)
    offset = STARK101.coset_offset
    n1, n2, w, _, _ = ntt_sharded.sixstep_constants(n, root, False, fld, shards)
    ut, vt = ntt_sharded._device_tables(n, root, False, fld, shards, torch.device("cuda", 0))
    b, vblk = n2 // shards, vt.shape[0]
    x = fp.as_u32(torch.cat([fp.as_i32(rand_mont(b * n1 // blowup)).reshape(b, n1 // blowup),
                             torch.zeros((b, n1 - n1 // blowup), dtype=torch.int32,
                                         device="cuda")], dim=1).contiguous())
    kw = dict(m=n1, pre=ntt_kernel.GeoScale(offset, n, col_stride=n2, row_stride=1),
              uv=(ut[t * b // vblk : (t + 1) * b // vblk], vt),
              scale=ntt_sharded._shard_scale(fld, offset, t * b))
    assert kw["scale"] is not None and kw["uv"][0].shape[0] * vblk == b
    w1 = pow(w, n2, fld.p)
    r = _compare("ntt_rows", f"shard {t}/{shards} n=2^24 pass 1 pre+uv+scale batch={b} m={n1}",
                 lambda: ntt_kernel.ntt_rows(x, w1, fld, **kw),
                 lambda: ntt_kernel.ntt_rows_plain(x, w1, fld, **kw),
                 ntt_rows_bound(b, n1, n1, pre=True, uv=True, scale=True))
    del x, r, ut, vt

    for cfg, shards in ((STARK101, 8), (StarkConfig(trace_len=(1 << BIG_TRACE_BITS) - 1,
                                                    boundary_last=1, air=SQUARE_CHAIN), 8)):
        d = cfg.eval_domain
        points = d // shards
        reach = max(cfg.air.shifts) * cfg.blowup
        f = rand_mont(d)
        alphas = rand_mont(cfg.n_constraints)
        inv = pr.composition_constants(cfg, f.device)
        prog = pr.composition_program(cfg)
        whole = pr.composition_eval_res(cfg, f, alphas)
        for t in (0, 3, shards - 1):
            blk = f[t * points : (t + 1) * points].clone()
            halo = f[((t + 1) % shards) * points :][:reach].clone()
            kw = dict(halo=halo, start=t * points)
            got = composition.composition(blk, inv, alphas, prog, cfg.field, **kw)
            _all_equal("composition", f"shard {t}/{shards} d={d}", got,
                       composition.composition_plain(blk, inv, alphas, prog, cfg.field, **kw))
            _all_equal("composition", f"shard {t}/{shards} d={d} vs whole", got,
                       [w[t * points : (t + 1) * points] for w in whole])
        mul, add, sub = prog.field_ops
        label = f"shard 3/{shards} d={d} halo={reach}"
        limit = bound(points * (4 + 8) + 4 * reach + 4 * cfg.n_constraints * points,
                      points * (mul * FP_MUL + add * FP_ADD + sub * FP_SUB + 5))
        r = _compare("composition", label,
                     lambda: composition.composition(blk, inv, alphas, prog, cfg.field, **kw)[1],
                     lambda: composition.composition_plain(blk, inv, alphas, prog, cfg.field,
                                                           **kw)[1], limit)
        dev_ms = device_ms(lambda: composition.composition(blk, inv, alphas, prog, cfg.field, **kw),
                           "composition_kernel", 20, required=False)
        say(f"phase3 composition {label} {_device_line(dev_ms, r['ms'], limit)}")
        del f, whole, blk, halo
    torch.cuda.empty_cache()


OWN_KERNELS = ("ntt_rows_kernel", "transpose_kernel", "transpose_blocks_kernel", "ntt_rows_pease_kernel", "sha256_leaf",
               "sha256_node", "sha256_tree_tail", "fs_chain_kernel", "fri_fold_kernel", "limb_dft_rows_kernel",
               "composition_kernel", "openings_kernel", "endpoint_fix_kernel", "from_mont_kernel",
               "constants_kernel", "powers_kernel")


def _own_kernels_only(fn, what: str, own: str) -> dict:
    """One call of `fn` under torch.profiler: every device kernel in the
    window must be one of the port's own (or a memset or memcpy), `own`
    among them; returns the kernels by name."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not names:
        raise AssertionError("torch.profiler recorded no device activity")
    foreign = [k for k in names
               if not any(k_own in k for k_own in OWN_KERNELS)
               and not k.lower().startswith(("memset", "memcpy"))]
    say(f"phase3 {what} device kernels={json.dumps(dict(names))}")
    if foreign:
        raise AssertionError(f"{what} launched foreign kernels: {foreign}")
    if not any(own in k for k in names):
        raise AssertionError(f"{what} did not launch {own}")
    return names


def phase3_lde() -> None:
    """The LDE entry points on the card, timed; the 2^25 and 2^27 `coset_ntt`,
    the 2^25 one on the Pease route, and a batch of 16 at 2^20 on both
    routes, under torch.profiler, launch none but the port's own kernels; a
    four-step is 5 launches on every route, whatever the batch."""
    from zkstark_tpu_torch import ops
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ntt import core as ntt_core

    fld = fp.FIELD101
    rng = np.random.default_rng(33)

    def rand_mont(n):
        return fp.from_host(fld.host_to_mont(rng.integers(0, fld.p, n, dtype=np.uint64)), "cuda")

    for log_n in (13, 24, 25, 27):
        n = 1 << log_n
        coeffs = rand_mont(n // 8)
        ms = cuda_ms(lambda: ntt_core.coset_ntt(coeffs, n, 5), 5 if log_n >= 25 else 20)
        say(f"phase3 coset_ntt n=2^{log_n} coeffs=2^{log_n - 3} ms={ms:.4f}")
        if log_n >= 25:
            own = "limb_dft_rows_kernel" if log_n > 26 else "ntt_rows_kernel"
            _own_kernels_only(lambda: ntt_core.coset_ntt(coeffs, n, 5), f"coset_ntt n=2^{log_n}", own)
        del coeffs
        torch.cuda.empty_cache()
    for log_n in (10, 22):
        n = 1 << log_n
        evals = rand_mont(n)
        plan = ntt_core.inverse_plan(n)
        ms = cuda_ms(lambda: ntt_core.intt(evals, plan), 20)
        say(f"phase3 intt n=2^{log_n} ms={ms:.4f}")
        del evals
    # the same LDE on both routes, and a batch of 16 at 2^20 on both, in turns
    checks = (("off", 1, 24), ("on", 1, 24), ("on", 1, 24), ("off", 1, 24),
              ("off", 1, 25), ("on", 1, 25), ("on", 1, 25), ("off", 1, 25),
              ("off", 16, 20), ("on", 16, 20), ("on", 16, 20), ("off", 16, 20))
    inputs = {(bsz, log_n): rand_mont((bsz, (1 << log_n) // 8)).squeeze(0)
              for _, bsz, log_n in checks}
    outs, profiled = {}, set()
    for route, bsz, log_n in checks:
        os.environ["ZKSTARK_PEASE"] = route
        n = 1 << log_n
        coeffs = inputs[bsz, log_n]
        ops.reset_launch_counts()
        got = ntt_core.coset_ntt(coeffs, n, 5)
        counts = ops.launch_counts()
        rows = "ntt_rows_pease" if route == "on" else "ntt_rows"
        other = "ntt_rows" if route == "on" else "ntt_rows_pease"
        if (counts[rows], counts["transpose"], counts[other]) != (2, 3, 0):
            raise AssertionError(f"coset_ntt 2^{log_n} B={bsz} ZKSTARK_PEASE={route}: "
                                 f"not 2 + 3 launches: {counts}")
        want = outs.setdefault((bsz, log_n), got)
        if max_abs_err(got, want):
            raise AssertionError(f"coset_ntt 2^{log_n} B={bsz}: the two routes differ")
        ms = cuda_ms(lambda: ntt_core.coset_ntt(coeffs, n, 5), 50)
        say(f"phase3 coset_ntt n=2^{log_n} B={bsz} ZKSTARK_PEASE={route} ms={ms:.4f} "
            f"launches {rows}={counts[rows]} transpose={counts['transpose']}")
        if (log_n == 25 or bsz > 1) and (bsz, log_n, route) not in profiled:
            profiled.add((bsz, log_n, route))
            _own_kernels_only(lambda: ntt_core.coset_ntt(coeffs, n, 5),
                              f"coset_ntt n=2^{log_n} B={bsz} ZKSTARK_PEASE={route}",
                              "ntt_rows_pease_kernel" if route == "on" else "ntt_rows_kernel")
        del got, want
    os.environ.pop("ZKSTARK_PEASE")
    del inputs, outs
    torch.cuda.empty_cache()


def phase4_stark101():
    from zkstark_tpu_torch import STARK101, STARK101_SECRET, ops, prove, verify
    from zkstark_tpu_torch.native import verify_native

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    proof = prove(STARK101, STARK101_SECRET, device="cuda", fused=False)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = ops.launch_counts()
    if len(proof.data) != GOLDEN_LEN or proof.state.hex() != GOLDEN_STATE:
        raise AssertionError(f"stark-101 not golden: {len(proof.data)} B, {proof.state.hex()}")
    verify(proof, STARK101)
    verify_native(proof, STARK101)
    require_launched(counts, (*ROW_KERNELS, "fri_fold"), "stark-101")
    require_one_composition(counts, "stark-101")
    tree_launches = require_few_tree_launches(counts, "stark-101")
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        again = prove(STARK101, STARK101_SECRET, device="cuda", fused=False)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if again != proof:
            raise AssertionError("stark-101 proof changed between runs")
    timings = {}
    prove(STARK101, STARK101_SECRET, device="cuda", timings=timings, fused=False)
    say(
        f"phase4 stark101 host-synced golden bytes={len(proof.data)} state={proof.state.hex()[:8]} "
        f"verify=ok native=ok launches={json.dumps(counts)} node+tail_launches={tree_launches} "
        f"cold_s={cold:.4f} warm_s_min={min(warm):.4f} warm_s_median={sorted(warm)[2]:.4f} "
        f"phases={json.dumps({k: round(v, 5) for k, v in timings.items()})}"
    )


def _square_chain_cfg(trace_bits: int, secret: int):
    from zkstark_tpu_torch.protocol.air import SQUARE_CHAIN
    from zkstark_tpu_torch.protocol.config import StarkConfig

    trace_len = (1 << trace_bits) - 1
    trace = SQUARE_CHAIN.trace(trace_len, secret)
    return StarkConfig(trace_len=trace_len, boundary_last=int(trace[-1]), air=SQUARE_CHAIN)


def phase5_cross_check():
    from zkstark_tpu_torch import prove

    cfg = _square_chain_cfg(13, BIG_SECRET)
    t0 = time.perf_counter()
    on_card = prove(cfg, BIG_SECRET, device="cuda")
    t1 = time.perf_counter()
    on_cpu = prove(cfg, BIG_SECRET, device="cpu")
    t2 = time.perf_counter()
    if on_card != on_cpu:
        raise AssertionError("2^16 square-chain: cuda and cpu proofs differ")
    say(
        f"phase5 square-chain 2^16 points cuda==cpu bytes={len(on_card.data)} "
        f"cuda_s={t1 - t0:.3f} cpu_s={t2 - t1:.3f}"
    )
    return cfg, on_card


def phase6_big():
    from zkstark_tpu_torch import ops, prove, verify
    from zkstark_tpu_torch.native import verify_native
    from zkstark_tpu_torch.protocol.proof import expected_proof_len

    t0 = time.perf_counter()
    cfg = _square_chain_cfg(BIG_TRACE_BITS, BIG_SECRET)
    witness = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    proof = prove(cfg, BIG_SECRET, device="cuda", timings=timings, fused=False)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if len(proof.data) != BIG_PROOF_LEN or expected_proof_len(cfg) != BIG_PROOF_LEN:
        raise AssertionError(f"2^24 proof has {len(proof.data)} bytes, want {BIG_PROOF_LEN}")
    t0 = time.perf_counter()
    verify(proof, cfg)
    verify_s = time.perf_counter() - t0
    verify_native(proof, cfg)
    require_launched(counts, (*DIT_KERNELS, "fri_fold", *GLUE_KERNELS), "2^24")
    require_one_composition(counts, "2^24")
    warm_timings = {}
    t0 = time.perf_counter()
    again = prove(cfg, BIG_SECRET, device="cuda", timings=warm_timings, fused=False)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    if again != proof:
        raise AssertionError("2^24 proof changed between runs")
    say(
        f"phase6 square-chain host-synced trace_len={cfg.trace_len} eval_domain={cfg.eval_domain} "
        f"fri_rounds={cfg.fri_rounds} bytes={len(proof.data)} state={proof.state.hex()} "
        f"verify=ok verify_s={verify_s:.4f} native=ok witness_s={witness:.3f} "
        f"cold_s={cold:.3f} warm_s={warm:.3f} max_memory_allocated={peak} "
        f"launches={json.dumps(counts)}"
    )
    say(f"phase6 cold_phases={json.dumps({k: round(v, 4) for k, v in timings.items()})}")
    say(f"phase6 warm_phases={json.dumps({k: round(v, 4) for k, v in warm_timings.items()})}")
    return cfg, proof, warm


def _cli(args: list, env: dict) -> dict:
    """Run ``python -m zkstark_tpu_torch --json ARGS`` from the repository
    root; its last output line, parsed. Fails on a nonzero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "zkstark_tpu_torch", "--json", *args]
    res = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise AssertionError(
            f"{' '.join(cmd[2:])} exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}"
        )
    return json.loads(res.stdout.strip().splitlines()[-1])


def phase7_entry_points(tmp_dir: str) -> dict:
    """The 2^25 statement through the CLI (Pease route, subprocess) and
    prove_big (DIT route, this process); returns the main-path counts."""
    from zkstark_tpu_torch import ops
    from zkstark_tpu_torch.native import verify_native
    from zkstark_tpu_torch.protocol import Proof
    from zkstark_tpu_torch.protocol.proof import expected_proof_len
    from zkstark_tpu_torch.tools import prove_big

    trace_len = (1 << HUGE_TRACE_BITS) - 1
    out = os.path.join(tmp_dir, "proof_2e25.bin")
    statement = ["--air", "square-chain", "--trace-len", str(trace_len)]
    env = dict(os.environ, ZKSTARK_PEASE="on")
    torch.cuda.empty_cache()  # leave the card's memory to the subprocess
    t0 = time.perf_counter()
    cli = _cli(statement + ["prove", "--secret", str(BIG_SECRET), "--out", out], env)
    cli_s = time.perf_counter() - t0
    pease_counts = cli["kernel_launches"]
    require_launched(pease_counts, ("sha256_leaf", "sha256_node", "sha256_tree_tail",
                                    "ntt_rows_pease", *FUSED_KERNELS),
                     "CLI 2^25")
    # the Pease route's two four-steps (the 2^22 INTT, the 2^25 LDE): 2 row
    # launches and 3 transposes each, and nothing else of the NTT
    route = tuple(pease_counts[k] for k in ("ntt_rows_pease", "transpose", "ntt_rows"))
    if route != (4, 6, 0):
        raise AssertionError(f"CLI 2^25 on the Pease route: (ntt_rows_pease, transpose, "
                             f"ntt_rows) launches {route}, want (4, 6, 0)")
    boundary = str(cli["boundary_last"])
    checked = _cli(statement + ["--boundary-last", boundary, "verify", out], env)
    if not checked.get("verified"):
        raise AssertionError(f"the port's verifier rejected the 2^25 CLI proof: {checked}")
    with open(out, "rb") as f:
        cli_bytes = f.read()
    cli_proof = Proof.from_bytes(cli_bytes)
    say(
        f"phase7 cli prove (ZKSTARK_PEASE=on) bytes={len(cli_proof.data)} "
        f"prover_runtime_s={cli['prover_runtime_seconds']} witness_s={cli['witness_seconds']} "
        f"max_memory_allocated={cli['max_memory_allocated']} process_s={cli_s:.3f} "
        f"launches={json.dumps(pease_counts)} verify=ok "
        f"verify_s={checked['verifier_runtime_seconds']}"
    )

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    proof, cfg, _ = prove_big.run(HUGE_TRACE_BITS, device="cuda",
                                    emit=lambda r: say("phase7 prove_big", json.dumps(r)))
    torch.cuda.synchronize()
    dit_counts = ops.launch_counts()
    if cfg.boundary_last != int(boundary):
        raise AssertionError("prove_big and the CLI derived different public outputs")
    verify_native(cli_proof, cfg)
    if len(proof.data) != HUGE_PROOF_LEN or expected_proof_len(cfg) != HUGE_PROOF_LEN:
        raise AssertionError(f"2^25 proof has {len(proof.data)} bytes, want {HUGE_PROOF_LEN}")
    if proof.to_bytes() != cli_bytes:
        raise AssertionError("2^25: the DIT-route proof differs from the Pease-route CLI proof")
    require_launched(dit_counts, (*DIT_KERNELS, "fri_fold"), "prove_big 2^25")
    if dit_counts["ntt_rows_pease"]:
        raise AssertionError(f"the DIT route launched the Pease kernel: {dit_counts}")
    say(
        f"phase7 2^25 bytes={len(proof.data)} state={proof.state.hex()} cli==prove_big native=ok "
        f"launches={json.dumps(dit_counts)}"
    )
    # one warm prove with phase spans on each route, in turns, in this process
    from zkstark_tpu_torch import prove

    for route in ("off", "on"):
        os.environ["ZKSTARK_PEASE"] = route
        warm = {}
        t0 = time.perf_counter()
        again = prove(cfg, BIG_SECRET, device="cuda", timings=warm, fused=False)
        warm_s = time.perf_counter() - t0
        if again != proof:
            raise AssertionError(f"2^25 proof with ZKSTARK_PEASE={route} differs")
        say(f"phase7 warm ZKSTARK_PEASE={route} warm_s={warm_s:.3f} "
            f"phases={json.dumps({k: round(v, 4) for k, v in warm.items()})}")
    os.environ.pop("ZKSTARK_PEASE")
    return {**dit_counts, "ntt_rows_pease": pease_counts["ntt_rows_pease"]}


def phase8_checkpoint(tmp_dir: str, cfg, want) -> None:
    """A checkpoint written on the card resumes on the CPU to the bytes of
    the uninterrupted proof (phase 5)."""
    from zkstark_tpu_torch.protocol.checkpoint import ResumableProver

    for fused, barrier in ((True, "fused"), (False, "phase2")):
        path = os.path.join(tmp_dir, f"ckpt_{barrier}.npz")
        t0 = time.perf_counter()
        stopped = ResumableProver(cfg, BIG_SECRET, path, fused=fused, device="cuda").run(
            stop_after=barrier
        )
        t1 = time.perf_counter()
        if stopped is not None or not os.path.exists(path):
            raise AssertionError(f"no {barrier} checkpoint was written")
        size = os.path.getsize(path)
        resumed = ResumableProver(cfg, BIG_SECRET, path, fused=fused, device="cpu").run()
        t2 = time.perf_counter()
        if resumed != want:
            raise AssertionError(f"2^16 resumed from {barrier} on the cpu differs from phase 5")
        say(
            f"phase8 checkpoint {barrier} cuda->cpu resumed==phase5 file_bytes={size} "
            f"cuda_s={t1 - t0:.3f} cpu_resume_s={t2 - t1:.3f}"
        )


def _guarded_core(cfg, secret: int, mesh=None):
    """One fused prove (sharded over `mesh` where given) whose core (from the
    uploaded trace to the start of the one fetch) runs under the sync debug
    mode "error": any call that waits for the device raises. The caches must
    be warm."""
    from zkstark_tpu_torch.protocol import fused
    from zkstark_tpu_torch.protocol import prover as pr

    trace = pr.trace_to_device(cfg, secret, torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = fused.PendingFetch(fused.fused_core_packed(cfg, trace, mesh))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return pr.finish_fused(cfg, fused.unpack_out(cfg, pending.wait()))


def _device_busy(fn, copies: bool = False) -> dict:
    """One call of `fn` under torch.profiler: wall seconds, the device's busy
    seconds (the sum of its kernels and copies) and their count; with
    `copies`, also [name, bytes] of each device copy (`_copy_sizes`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("torch.profiler recorded no device activity")
    spans = [e.time_range.elapsed_us() for e in events]
    own = [e.time_range.elapsed_us() for e in events if any(k in e.name for k in OWN_KERNELS)]
    busy = sum(spans) / 1e6
    others = dict(Counter(e.name for e in events if not any(k in e.name for k in OWN_KERNELS)))
    out = dict(wall_s=round(wall, 5), device_busy_s=round(busy, 5), device_spans=len(spans),
               idle_share=round(1 - busy / wall, 4), own_kernel_spans=len(own),
               own_kernel_busy_s=round(sum(own) / 1e6, 6), plain_torch_spans=len(spans) - len(own),
               plain_torch_busy_s=round((sum(spans) - sum(own)) / 1e6, 6), other_spans=others)
    if copies:
        out["copies"] = _copy_sizes(prof)
    return out


def _copy_sizes(prof) -> list:
    """[name, bytes] of every device copy of a profile, read from its
    exported trace (the profiler's events carry no sizes); bytes -1 where
    the trace gives none."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"copies_{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [[e["name"], int(e.get("args", {}).get("bytes", -1))] for e in events
            if e.get("cat") == "gpu_memcpy"]


def require_only_io_copies(busy: dict, trace_bytes: int, packed_bytes: int, what: str) -> None:
    """Raises unless every device span of `busy` that is not the port's
    kernel is one of the fused path's copies (`COPY_SPANS`), each at most
    once: the witness's upload (host to device, `trace_bytes`), the packed
    result's fetch (device to host, `packed_bytes`) and, around a graph's
    replay, the two device-to-device copies of those sizes."""
    size = {"trace": trace_bytes, "packed": packed_bytes}
    allowed = [(kind, size[which]) for kind, which in COPY_SPANS]
    copies = busy["copies"]
    stray = [c for c in copies if not any(c[0].startswith(k) and c[1] == n for k, n in allowed)]
    if (stray or sum(busy["other_spans"].values()) != len(copies)
            or any(sum(c[0].startswith(k) and c[1] == n for c in copies) > 1 for k, n in allowed)):
        raise AssertionError(f"plain-torch device spans in {what}: {busy['other_spans']}, "
                             f"copies {copies}; allowed: at most one each of {allowed} (bytes)")


def _plain_loops(cfg, secret: int) -> dict:
    """The three groups that were plain-torch loops on the prove path before
    the glue kernels, each alone under torch.profiler on this statement's
    tensors (a window of 10 calls or more): its launches a call that are not
    the port's own kernels (copies included) and their summed device
    milliseconds, beside the launches of the port's kernels. The interpolation is `interpolate_trace` (its INTT
    and the endpoint fix), `from_mont` the fused core's step on f_eval, the
    openings the fused core's gathers into the packed vector. Raises unless
    each group launches no plain torch."""
    from zkstark_tpu_torch import ntt
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import elementwise
    from zkstark_tpu_torch.protocol import air, openings
    from zkstark_tpu_torch.protocol import prover as pr

    fld = cfg.field
    art = pr.ProverArtifacts()
    pr.prove(cfg, secret, device="cuda", artifacts=art, fused=False)
    trace = pr.trace_to_device(cfg, secret, torch.device("cuda"))
    coeffs = air.interpolate_trace(trace, cfg.trace_domain, fld)
    f_eval = ntt.coset_ntt(coeffs, cfg.eval_domain, cfg.coset_offset, fld)
    idx = fp.from_host(np.asarray(art.query_indices, dtype=np.uint32), "cuda")
    levels = [t.levels for t in art.layer_trees]
    groups = {
        "interpolate_rank1_fix": lambda: air.interpolate_trace(trace, cfg.trace_domain, fld),
        "from_mont_f_eval": lambda: elementwise.from_mont(f_eval, fld),
        "opening_gathers": lambda: openings.sparse_openings_device(
            cfg, art.f_res, art.f_tree.levels, art.layer_res, levels, idx),
    }
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in groups.items():
        fn()
        torch.cuda.synchronize()
        # a window of one short call may lose its spans: windows of several
        # calls, longer ones if the profiler kept none, counted a call
        for calls in (10, 30, 100):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if events:
                break
        else:
            raise AssertionError(f"torch.profiler recorded no device activity of {name}")
        own = [e.time_range.elapsed_us() for e in events if any(k in e.name for k in OWN_KERNELS)]
        plain = [e.time_range.elapsed_us() for e in events
                 if not any(k in e.name for k in OWN_KERNELS)]
        out[name] = dict(launches=len(plain) / calls, device_ms=round(sum(plain) / calls / 1e3, 5),
                         own_kernel_launches=len(own) / calls,
                         own_kernel_device_ms=round(sum(own) / calls / 1e3, 5), calls=calls)
    plain = {name: out[name]["launches"] for name in PLAIN_LOOPS if out[name]["launches"]}
    if plain:
        raise AssertionError(f"plain-torch launches left in the glue groups: {plain}: {out}")
    return out


def _paths_in_turns(cfg, secret: int, want, repeats: int, what: str) -> dict:
    """`prove()` (fused) and `prove(fused=False)` in turns (fused, host-synced,
    host-synced, fused, …), `repeats` warm proves each: the median, least and
    largest wall seconds of each path; then `repeats` more of each in turns
    with `timings`, whose spans wait for the device: the median of each span.
    Every proof must be `want`."""
    from zkstark_tpu_torch import prove

    def one(fused: bool, timings=None) -> float:
        t0 = time.perf_counter()
        got = prove(cfg, secret, device="cuda", fused=fused, timings=timings)
        torch.cuda.synchronize()
        if got != want:
            raise AssertionError(f"{what}: a proof changed between runs")
        return time.perf_counter() - t0

    order = [k % 4 in (0, 3) for k in range(2 * repeats)]  # fused, host, host, fused, …
    walls = {True: [], False: []}
    for fused in order:
        walls[fused].append(one(fused))
    spans = {True: {}, False: {}}
    for fused in order:
        t = {}
        one(fused, t)
        for k, v in t.items():
            spans[fused].setdefault(k, []).append(v)
    out = {}
    for fused, name in ((True, "fused"), (False, "host_synced")):
        w = sorted(walls[fused])
        out[name] = dict(median_s=float(np.median(w)), min_s=w[0], max_s=w[-1], n=len(w),
                         span_median_s={k: float(np.median(v)) for k, v in spans[fused].items()})
    say(f"{what} fused vs host-synced in turns, {repeats} each: "
        + " ".join(f"{k} median_s={v['median_s']:.6f} min_s={v['min_s']:.6f} "
                   f"max_s={v['max_s']:.6f} spans_median_s="
                   f"{json.dumps({a: round(b, 6) for a, b in v['span_median_s'].items()})}"
                   for k, v in out.items())
        + f" fused/host_synced={out['fused']['median_s'] / out['host_synced']['median_s']:.3f}")
    return out


def _warm_min(fn, want, repeats: int, what: str) -> float:
    """The least wall seconds of `repeats` calls of `fn`, each of which must
    return `want`."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        if got != want:
            raise AssertionError(f"{what}: the proof changed between runs")
    return best


def phase9_fused_solo() -> dict:
    """The one-fetch path alone at stark-101; returns the launches of its
    first fused prove, the main path's run that drives the glue kernels."""
    from zkstark_tpu_torch import STARK101, STARK101_SECRET, ops, prove, verify
    from zkstark_tpu_torch.native import verify_native
    from zkstark_tpu_torch.protocol import fused
    from zkstark_tpu_torch.protocol import prover as pr

    legacy = prove(STARK101, STARK101_SECRET, device="cuda", fused=False)
    # the main path's run: its composition constants are built cold, so that
    # every kernel of the path launches in it
    pr.composition_constants.cache_clear()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    proof = prove(STARK101, STARK101_SECRET, device="cuda")
    cold = time.perf_counter() - t0
    counts = ops.launch_counts()
    if len(proof.data) != GOLDEN_LEN or proof.state.hex() != GOLDEN_STATE or proof != legacy:
        raise AssertionError(f"fused stark-101 not golden: {len(proof.data)} B, {proof.state.hex()}")
    verify(proof, STARK101)
    verify_native(proof, STARK101)
    require_launched(counts, (*ROW_KERNELS, *FUSED_KERNELS, *GLUE_KERNELS), "fused stark-101")
    require_one_composition(counts, "fused stark-101")
    tree_launches = require_few_tree_launches(counts, "fused stark-101")
    if _guarded_core(STARK101, STARK101_SECRET) != proof:
        raise AssertionError("fused stark-101 under the sync debug mode differs")
    turns = _paths_in_turns(STARK101, STARK101_SECRET, proof, 7, "phase9 stark101")
    fused_s, legacy_s = turns["fused"]["min_s"], turns["host_synced"]["min_s"]
    timings = {}
    prove(STARK101, STARK101_SECRET, device="cuda", timings=timings)
    busy = _device_busy(lambda: prove(STARK101, STARK101_SECRET, device="cuda"), copies=True)
    if busy["device_spans"] > MAX_STARK101_SPANS:
        raise AssertionError(f"a stark-101 fused prove made {busy['device_spans']} device spans, "
                             f"want <= {MAX_STARK101_SPANS}: {busy}")
    # no plain torch left: besides the port's kernels, the witness's upload
    # and the packed result's fetch, one copy each of their sizes
    trace_bytes = 4 * pr.trace_to_device(STARK101, STARK101_SECRET, "cuda").numel()
    packed_bytes = 4 * sum(math.prod(s) for shape in fused.out_shapes(STARK101).values()
                           for s in (shape if isinstance(shape, list) else [shape]))
    require_only_io_copies(busy, trace_bytes, packed_bytes, "a stark-101 fused prove")
    say(
        f"phase9 stark101 fused golden bytes={len(proof.data)} fused==host_synced verify=ok "
        f"native=ok sync_debug_mode=error:ok launches={json.dumps(counts)} "
        f"node+tail_launches={tree_launches} all_launches={sum(counts.values())} first_s={cold:.4f} "
        f"warm_ms_min_fused={fused_s * 1e3:.3f} warm_ms_min_host_synced={legacy_s * 1e3:.3f} "
        f"spans={json.dumps({k: round(v, 5) for k, v in timings.items()})} "
        f"profiled={json.dumps(busy)}"
    )
    say(f"phase9 stark101 plain_loops={json.dumps(_plain_loops(STARK101, STARK101_SECRET))} "
        f"no plain launches in {list(PLAIN_LOOPS)}: ok")
    return counts


def phase10_batch(cfg16, proof16):
    from zkstark_tpu_torch import STARK101, STARK101_SECRET, ntt, ops, prove, verify
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.native import verify_native
    from zkstark_tpu_torch.protocol.batch import prove_batch, prove_batch_pipelined

    fld = fp.FIELD101

    golden = prove(STARK101, STARK101_SECRET, device="cuda")
    for bsz in (32, 64):
        secrets = [STARK101_SECRET] * bsz
        ops.reset_launch_counts()
        proofs = prove_batch(STARK101, secrets, device="cuda")
        counts = ops.launch_counts()
        if len(proofs) != bsz or any(p != golden for p in proofs):
            raise AssertionError(f"prove_batch B={bsz}: a proof is not the golden one")
        require_launched(counts, (*ROW_KERNELS, *FUSED_KERNELS), f"prove_batch B={bsz}")
        require_one_composition(counts, f"prove_batch B={bsz}")
        # a batch launches once a level or tail, not once a tree
        tree_launches = require_few_tree_launches(counts, f"prove_batch B={bsz}")
        best = _warm_min(lambda: prove_batch(STARK101, secrets, device="cuda"), proofs, 3,
                         f"prove_batch B={bsz}")
        say(f"phase10 prove_batch stark101 B={bsz} all golden batch_s_min={best:.4f} "
            f"proofs_per_s={bsz / best:.1f} node+tail_launches={tree_launches} "
            f"launches={json.dumps(counts)}")
    batches = [[STARK101_SECRET] * 32] * 4
    proofs = prove_batch_pipelined(STARK101, batches, depth=2, device="cuda")
    if len(proofs) != 128 or any(p != golden for p in proofs):
        raise AssertionError("prove_batch_pipelined: a proof is not the golden one")
    best = _warm_min(lambda: prove_batch_pipelined(STARK101, batches, depth=2, device="cuda"),
                     proofs, 3, "prove_batch_pipelined")
    say(f"phase10 prove_batch_pipelined stark101 4x32 depth=2 all golden stream_s_min={best:.4f} "
        f"proofs_per_s={128 / best:.1f}")
    # square-chain batches on the four-step route: B = 4 at 2^16 and B = 16 at
    # 2^20 (trace bits 17: a 2^17 INTT and a 2^20 LDE). The secrets s and p - s
    # alternate: their witnesses differ in row 0 and share the public output,
    # so a batch stride that gave one proof another's rows would show.
    p = fld.p
    for trace_bits, bsz, want_counts in ((13, 4, (3, 3)), (17, 16, (4, 6))):
        cfg = cfg16 if trace_bits == 13 else _square_chain_cfg(trace_bits, BIG_SECRET)
        secrets = [BIG_SECRET if i % 2 == 0 else p - BIG_SECRET for i in range(bsz)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        solo = {s: prove(cfg, s, device="cuda") for s in (BIG_SECRET, p - BIG_SECRET)}
        solo_peak = torch.cuda.max_memory_allocated()
        if trace_bits == 13 and solo[BIG_SECRET] != proof16:
            raise AssertionError("the solo 2^16 proof differs from phase 5")
        if solo[BIG_SECRET] == solo[p - BIG_SECRET]:
            raise AssertionError(f"2^{trace_bits + 3}: the secrets s and p - s gave one proof")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = prove_batch(cfg, secrets, device="cuda")
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        what = f"prove_batch square-chain 2^{trace_bits + 3} B={bsz}"
        if [g == solo[s] for g, s in zip(got, secrets)] != [True] * bsz:
            raise AssertionError(f"{what}: a proof differs from its solo proof")
        verify(got[1], cfg)
        verify_native(got[1], cfg)
        require_launched(counts, (*DIT_KERNELS, *FUSED_KERNELS), what)
        # each four-step is 2 row launches and 3 transposes for the whole batch
        if (counts["ntt_rows"], counts["transpose"]) != want_counts:
            raise AssertionError(f"{what}: (ntt_rows, transpose) launches "
                                 f"{(counts['ntt_rows'], counts['transpose'])}, want {want_counts}")
        best = _warm_min(lambda: prove_batch(cfg, secrets, device="cuda"), got, 2, what)
        say(f"phase10 {what} s,p-s alternating each==solo verify=ok native=ok cold_s={took:.4f} "
            f"warm_s_min={best:.4f} proofs_per_s={bsz / best:.2f} max_memory_allocated={peak} "
            f"solo_max_memory_allocated={solo_peak} launches={json.dumps(counts)}")
    # the batch's LDE alone: its working set against B times the solo one
    n, bsz = 1 << 20, 16
    coeffs = fp.from_host(fld.host_to_mont(np.random.default_rng(10).integers(
        0, p, (bsz, n // 8), dtype=np.uint64)), "cuda")
    sets = {}
    for b in (1, bsz):
        one = coeffs[:b].contiguous()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ntt.coset_ntt(one, n, 5)
        torch.cuda.synchronize()
        sets[b] = torch.cuda.max_memory_allocated() - base
    say(f"phase10 coset_ntt 2^20 working set B=1 {sets[1]} B={bsz} {sets[bsz]} "
        f"ratio={sets[bsz] / sets[1]:.3f}")
    if sets[bsz] > bsz * sets[1]:
        raise AssertionError(f"a batch of {bsz} LDEs takes more than {bsz} times one: {sets}")


def phase11_pipelined(cfg24, proof24, host_synced_warm_s: float) -> dict:
    """`prove_pipelined` at stark-101 and at the 2^24 statement; returns the
    launch counts of the 2^24 stream, the one-fetch slice's main-path run."""
    from zkstark_tpu_torch import STARK101, STARK101_SECRET, ops, prove, verify
    from zkstark_tpu_torch.native import verify_native
    from zkstark_tpu_torch.protocol import prove_pipelined

    golden = prove(STARK101, STARK101_SECRET, device="cuda")
    eight = [golden] * 8
    if prove_pipelined(STARK101, [STARK101_SECRET] * 8, depth=2, device="cuda") != eight:
        raise AssertionError("prove_pipelined: a stark-101 proof is not the golden one")
    best = _warm_min(lambda: prove_pipelined(STARK101, [STARK101_SECRET] * 8, depth=2, device="cuda"),
                     eight, 3, "prove_pipelined stark-101")
    say(f"phase11 prove_pipelined stark101 n=8 depth=2 all golden per_proof_ms={best / 8 * 1e3:.3f}")

    first = prove(cfg24, BIG_SECRET, device="cuda")  # fills the device caches
    if first != proof24:
        raise AssertionError("2^24: the fused proof differs from the host-synced one")
    if _guarded_core(cfg24, BIG_SECRET) != proof24:
        raise AssertionError("2^24: the fused proof under the sync debug mode differs")
    spans = {}
    prove(cfg24, BIG_SECRET, device="cuda", timings=spans)
    turns = _paths_in_turns(cfg24, BIG_SECRET, proof24, 5, "phase11 2^24")
    solo = turns["fused"]["min_s"]
    busy = _device_busy(lambda: prove(cfg24, BIG_SECRET, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    proofs = prove_pipelined(cfg24, [BIG_SECRET] * 3, depth=2, device="cuda")
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for p in proofs:
        if len(p.data) != BIG_PROOF_LEN or p != proof24:
            raise AssertionError("prove_pipelined 2^24: a proof differs from phase 6's")
    verify(proofs[-1], cfg24)
    verify_native(proofs[-1], cfg24)
    require_launched(counts, (*DIT_KERNELS, *FUSED_KERNELS, "openings", "endpoint_fix", "from_mont"),
                     "prove_pipelined 2^24")
    say(
        f"phase11 prove_pipelined square-chain 2^24 n=3 depth=2 bytes={len(proofs[0].data)} "
        f"==phase6 verify=ok native=ok sync_debug_mode=error:ok per_proof_s={stream_s / 3:.4f} "
        f"stream_s={stream_s:.4f} solo_fused_warm_s={solo:.4f} "
        f"solo_host_synced_warm_s={host_synced_warm_s:.4f} max_memory_allocated={peak} "
        f"launches={json.dumps(counts)}"
    )
    say(f"phase11 2^24 fused spans={json.dumps({k: round(v, 4) for k, v in spans.items()})} "
        f"profiled={json.dumps(busy)}")
    say(f"phase11 2^24 plain_loops={json.dumps(_plain_loops(cfg24, BIG_SECRET))} "
        f"no plain launches in {list(PLAIN_LOOPS)}: ok")
    return counts


def phase12_past_2e26() -> dict:
    """The 2^27-point statement through `tools.prove_big` (host-synced) and
    once through the fused `prove()`; returns the launch counts of the
    `prove_big` run, the big-domain slice's main-path run."""
    from zkstark_tpu_torch import ops, prove, verify
    from zkstark_tpu_torch.native import verify_native
    from zkstark_tpu_torch.ops import ntt_kernel
    from zkstark_tpu_torch.protocol.proof import expected_proof_len
    from zkstark_tpu_torch.tools import prove_big

    # the composition constants of the earlier statements (128 and 256 MB) are
    # evicted by the cache's byte budget once this statement's 1 GB entry is in;
    # the twiddle tables and the allocator's cached blocks go by hand
    ntt_kernel._device_uv.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    proof, cfg, rec = prove_big.run(GIANT_TRACE_BITS, repeats=1, device="cuda",
                                    emit=lambda r: say("phase12 prove_big", json.dumps(r)))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want_len = expected_proof_len(cfg)
    if len(proof.data) != want_len or want_len != GIANT_PROOF_LEN:
        raise AssertionError(f"2^27 proof has {len(proof.data)} bytes, the layout gives {want_len}")
    # prove_big.run has called both verifiers and compared the length with the layout
    if not (rec["verified"] and rec["verified_native"] and rec["layout_ok"]
            and rec["layout_bytes"] == want_len):
        raise AssertionError(f"prove_big's record does not show its three checks: {rec}")
    require_launched(counts, ("sha256_leaf", "sha256_node", "sha256_tree_tail", "ntt_rows",
                              "transpose", "fri_fold",
                              "limb_dft_rows", "composition", *GLUE_KERNELS), "prove_big 2^27")
    if counts["composition"] != 2:  # the cold prove and one warm prove
        raise AssertionError(f"prove_big 2^27: {counts['composition']} composition launches, want 2")
    warm = {}
    if prove(cfg, prove_big.SECRET, device="cuda", timings=warm, fused=False) != proof:
        raise AssertionError("2^27: the proof changed between runs")
    say(f"phase12 2^27 host-synced warm_phases={json.dumps({k: round(v, 4) for k, v in warm.items()})}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    spans = {}
    t0 = time.perf_counter()
    fused = prove(cfg, prove_big.SECRET, device="cuda", timings=spans)
    fused_s = time.perf_counter() - t0
    fused_counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if fused != proof:
        raise AssertionError("2^27: the fused proof differs from prove_big's")
    verify(fused, cfg)
    verify_native(fused, cfg)
    require_launched(fused_counts, ("limb_dft_rows", "composition", "sha256_tree_tail",
                                    *FUSED_KERNELS), "fused 2^27")
    require_one_composition(fused_counts, "fused 2^27")
    say(
        f"phase12 square-chain 2^27 trace_len={cfg.trace_len} fri_rounds={cfg.fri_rounds} "
        f"bytes={len(proof.data)} ==layout state={proof.state.hex()} prove_big==fused verify=ok "
        f"native=ok prove_big_warm_s={rec['value']} prove_big_max_memory_allocated="
        f"{rec['max_memory_allocated']} fused_s={fused_s:.3f} fused_max_memory_allocated={peak} "
        f"launches={json.dumps(counts)} fused_launches={json.dumps(fused_counts)}"
    )
    say(f"phase12 2^27 fused spans={json.dumps({k: round(v, 4) for k, v in spans.items()})}")
    return counts


def sharded_bytes(cfg, shards: int) -> dict:
    """The bytes a sharded prove moves between shards, by collective, as the
    design counts them (each shard its own rank): the six-step's three
    all_to_alls of the LDE; one gather of the S subtree roots a sharded tree;
    the layer gathered where a fold falls back to one device (m/2 < S), or
    else the last layer for the free term; the composition's halo and one
    exchange of the layer a sharded fold; the packed result replicated."""
    from zkstark_tpu_torch.protocol.fused import out_shapes

    d, word, s = cfg.eval_domain, 4, shards
    reach = max(cfg.air.shifts) * cfg.blowup
    out = {"all_to_all": 3 * d * word * (s - 1) // s, "all_gather": 0,
           "exchange": s * reach * word if reach and 1 < s <= d // reach else 0,
           "replicate": 0}
    trees, m, sharded = 2, d, True
    for _ in range(cfg.fri_rounds):
        if sharded and m // 2 >= s:
            out["exchange"] += word * m * (s - 1) // s
            trees += 1
        elif sharded:
            out["all_gather"] += word * m * (s - 1)
            sharded = False
        m //= 2
    if sharded:
        out["all_gather"] += word * m * (s - 1)
    out["all_gather"] += trees * 32 * s * (s - 1)
    packed = sum(int(np.prod(v)) for leaf in out_shapes(cfg).values()
                 for v in (leaf if isinstance(leaf, list) else [leaf]))
    out["replicate"] = word * packed * s * (s - 1)
    return out


SHARDED_KERNELS = ("ntt_rows", "transpose", "composition", "fri_fold", "fs_chain", "openings",
                   "endpoint_fix", "from_mont")


def _sharded_prove(cfg, secret: int, shards: int, want, what: str) -> dict:
    """A cold, a guarded and warm sharded proves of `cfg` on a local mesh of
    `shards` on the card, each equal to `want`; the warm one's launches,
    bytes between shards (equal to `sharded_bytes`), device busy time and
    peak memory."""
    from zkstark_tpu_torch import ops, prove, verify
    from zkstark_tpu_torch.native import verify_native
    from zkstark_tpu_torch.parallel import make_mesh

    mesh = make_mesh(shards, device="cuda")
    t0 = time.perf_counter()
    first = prove(cfg, secret, mesh=mesh)
    cold = time.perf_counter() - t0
    if first != want:
        raise AssertionError(f"{what}: the sharded proof differs from the solo one")
    verify(first, cfg)
    verify_native(first, cfg)
    if _guarded_core(cfg, secret, mesh) != want:
        raise AssertionError(f"{what}: the sharded proof under the sync debug mode differs")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    mesh.reset_bytes()
    warm = _warm_min(lambda: prove(cfg, secret, mesh=mesh), want, 1, what)
    counts = ops.launch_counts()
    moved = dict(mesh.bytes_moved)
    peak = torch.cuda.max_memory_allocated()
    predicted = sharded_bytes(cfg, shards)
    if moved != predicted:
        raise AssertionError(f"{what}: bytes between shards {moved}, the design counts {predicted}")
    require_launched(counts, SHARDED_KERNELS, what)
    if counts["sha256_leaf"] + counts["sha256_tree_tail"] <= 0:
        raise AssertionError(f"{what}: no SHA-256 kernel was launched: {counts}")
    busy = _device_busy(lambda: prove(cfg, secret, mesh=mesh))
    say(f"phase13 {what} S={shards} bytes={len(first.data)} ==solo verify=ok native=ok "
        f"sync_debug_mode=error:ok cold_s={cold:.4f} warm_s={warm:.4f} max_memory_allocated={peak} "
        f"bytes_between_shards={json.dumps(moved)} ==design "
        f"total={sum(moved.values())} launches={json.dumps(counts)} "
        f"all_launches={sum(counts.values())} profiled={json.dumps(busy)}")
    return counts


def _solo_numbers(cfg, secret: int, want, what: str) -> None:
    """The solo fused prove's warm time, launches, busy time and peak memory,
    for the line beside the sharded ones."""
    from zkstark_tpu_torch import ops, prove

    prove(cfg, secret, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    warm = _warm_min(lambda: prove(cfg, secret, device="cuda"), want, 1, what)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    busy = _device_busy(lambda: prove(cfg, secret, device="cuda"))
    say(f"phase13 {what} solo bytes={len(want.data)} warm_s={warm:.4f} "
        f"max_memory_allocated={peak} all_launches={sum(counts.values())} "
        f"profiled={json.dumps(busy)}")


def phase13_sharded(proof24) -> dict:
    """The sharded prover on local meshes of the card: stark-101 at S = 2 and
    8 (golden), the 2^21 square-chain statement at S = 8 (17,612 B, equal to
    the solo card proof), the 2^24 statement at S = 8 (phase 6's 22,496 B),
    `prove_batch` of 32 stark-101 proofs of two witnesses split over 8
    shards, each equal to the solo proof of its secret, and the
    sharded 2^24 LDE under torch.profiler (only the port's kernels and
    copies). Returns the launches of the 2^24 S = 8 prove, this slice's
    main-path run."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zkstark_tpu_torch import STARK101, STARK101_SECRET, ntt, prove
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.parallel import coset_ntt_sixstep, make_mesh
    from zkstark_tpu_torch.protocol.batch import prove_batch
    from zkstark_tpu_torch.protocol.proof import expected_proof_len

    golden = prove(STARK101, STARK101_SECRET, device="cuda")
    if len(golden.data) != GOLDEN_LEN or golden.state.hex() != GOLDEN_STATE:
        raise AssertionError("phase13: the solo stark-101 proof is not golden")
    _solo_numbers(STARK101, STARK101_SECRET, golden, "stark101")
    for shards in (2, 8):
        _sharded_prove(STARK101, STARK101_SECRET, shards, golden, "stark101")

    cfg21 = _square_chain_cfg(MID_TRACE_BITS, BIG_SECRET)
    solo21 = prove(cfg21, BIG_SECRET, device="cuda")
    if len(solo21.data) != MID_PROOF_LEN or expected_proof_len(cfg21) != MID_PROOF_LEN:
        raise AssertionError(f"2^21: the solo proof has {len(solo21.data)} bytes")
    _solo_numbers(cfg21, BIG_SECRET, solo21, "square-chain 2^21")
    _sharded_prove(cfg21, BIG_SECRET, 8, solo21, "square-chain 2^21")

    cfg24 = _square_chain_cfg(BIG_TRACE_BITS, BIG_SECRET)
    _solo_numbers(cfg24, BIG_SECRET, proof24, "square-chain 2^24")
    main_counts = _sharded_prove(cfg24, BIG_SECRET, 8, proof24, "square-chain 2^24")

    # 32 witnesses in 8 groups of 4, each group its own order of the two
    # secrets that meet the boundary (a[1] enters the trace only squared):
    # proof j of group g is STARK101_SECRET where bit j of 2g + 1 is set
    mesh = make_mesh(8, device="cuda")
    other = STARK101.field.p - STARK101_SECRET
    want = {STARK101_SECRET: golden, other: prove(STARK101, other, device="cuda")}
    if want[other] == golden:
        raise AssertionError("phase13: the two witnesses give the same proof")
    secrets = [STARK101_SECRET if (2 * (i // 4) + 1) >> (i % 4) & 1 else other for i in range(32)]
    proofs = prove_batch(STARK101, secrets, mesh=mesh)
    if len(proofs) != 32 or any(p != want[s] for s, p in zip(secrets, proofs)):
        raise AssertionError("prove_batch on the local mesh: proof i is not the solo proof of "
                             "secret i")
    best = _warm_min(lambda: prove_batch(STARK101, secrets, mesh=mesh), proofs, 2,
                     "prove_batch mesh")
    solo_best = _warm_min(lambda: prove_batch(STARK101, secrets, device="cuda"), proofs, 2,
                          "prove_batch solo")
    say(f"phase13 prove_batch stark101 B=32 over S=8 two secrets each ==solo batch_s_min={best:.4f} "
        f"proofs_per_s={32 / best:.1f} solo_batch_s_min={solo_best:.4f}")

    rng = np.random.default_rng(38)
    n = cfg24.eval_domain
    coeffs = fp.from_host(cfg24.field.host_to_mont(
        rng.integers(0, cfg24.field.p, n // 8, dtype=np.uint64)), "cuda")
    solo = ntt.coset_ntt(coeffs, n, cfg24.coset_offset)
    blocks = coset_ntt_sixstep(coeffs, n, cfg24.coset_offset, mesh)
    if max_abs_err(torch.cat([fp.as_i32(b) for b in blocks]).view(torch.uint32), solo):
        raise AssertionError("sharded 2^24 LDE differs from coset_ntt")
    ms = cuda_ms(lambda: coset_ntt_sixstep(coeffs, n, cfg24.coset_offset, mesh), 5)
    solo_ms = cuda_ms(lambda: ntt.coset_ntt(coeffs, n, cfg24.coset_offset), 5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        coset_ntt_sixstep(coeffs, n, cfg24.coset_offset, mesh)
        torch.cuda.synchronize()
    names = Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not names:
        raise AssertionError("torch.profiler recorded no device activity")
    foreign = [k for k in names if not any(own in k for own in OWN_KERNELS)
               and not k.lower().startswith(("memset", "memcpy"))]
    say(f"phase13 sharded coset_ntt n=2^24 S=8 ==coset_ntt ms={ms:.4f} solo_ms={solo_ms:.4f} "
        f"device kernels={json.dumps(dict(names))}")
    if foreign:
        raise AssertionError(f"the sharded 2^24 LDE launched foreign kernels: {foreign}")
    del coeffs, solo, blocks
    torch.cuda.empty_cache()
    return main_counts


def phase14_scaling_bench() -> list:
    """`tools.scaling_bench` at 2^24 points over local meshes of 1, 2, 4 and 8
    shards of the card, two warm repeats each (it raises unless every mesh
    gives the same roots, free term and final layer); on one card its
    scaling efficiency is the cost of S-fold launches, not scaling."""
    from zkstark_tpu_torch.tools import scaling_bench

    torch.cuda.empty_cache()
    records = scaling_bench.run(24, devices=(1, 2, 4, 8), repeats=2, device="cuda",
                                emit=lambda r: say("phase14 scaling_bench", json.dumps(r)))
    if [r["devices"] for r in records] != [1, 2, 4, 8]:
        raise AssertionError(f"scaling_bench printed {records}")
    torch.cuda.empty_cache()
    return records


def phase3_launch_floor(openings_row: dict, powers_row: dict) -> dict:
    """The two rows whose numbers timed the host: the device time of an
    empty kernel launched through `_build` (the launch floor, the mean of
    50 profiled launches), `openings`' device time against it, and the small
    batched transposes as profiled device time beside `.t().contiguous()`'s.
    Returns the floor's numbers."""
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import _build, ntt_kernel

    lib = _build.kernels()
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        _build.check(lib.zk_empty(stream), "empty_kernel")

    floor_ms = device_ms(empty, "empty_kernel", 50)
    say(f"phase3 launch floor: empty_kernel device_ms={floor_ms:.5f} (mean of 50 profiled launches)")
    share = floor_ms / openings_row["ms"]
    say(f"phase3 openings stark-101 device_ms={openings_row['ms']!r} against the launch floor "
        f"{floor_ms!r}: share={share!r} (unrounded; at most 2x the floor is a share >= 0.5: "
        f"{'met' if share >= 0.5 else 'not met'} in this run)")
    say(f"phase3 powers n=2^20 device_ms={powers_row['ms']:.5f} against the launch floor "
        f"{floor_ms:.5f}: {powers_row['ms'] / floor_ms:.2f}x the floor, "
        f"{powers_row['bound_ms'] / powers_row['ms']:.3f} of its bytes bound")
    rng = np.random.default_rng(40)
    for bsz, r_, c_ in ((16, 128, 1024), (16, 1024, 1024)):
        x = fp.from_host(rng.integers(0, 1 << 32, (bsz, r_ * c_), dtype=np.uint64)
                         .astype(np.uint32), "cuda")
        ours = device_ms(lambda: ntt_kernel.transpose(x, r_, c_), "transpose_kernel", 50)
        lib_ms = device_ms(lambda: fp.as_i32(x).reshape(bsz, r_, c_).transpose(1, 2).contiguous(),
                           "", 50)
        limit = bound(8 * bsz * r_ * c_, 0)
        say(f"phase3 transpose batch={bsz} rows={r_} cols={c_} device_ms={ours:.5f} "
            f"library .t().contiguous() device_ms={lib_ms:.5f} bound_ms={limit['bound_ms']:.5f} "
            f"share={limit['bound_ms'] / ours:.3f} library_share={limit['bound_ms'] / lib_ms:.3f}")
        del x
    return dict(launch_floor_ms=floor_ms, openings_share_of_floor=floor_ms / openings_row["ms"])


def _ab_turns(fns: dict, iters: int) -> dict:
    """CUDA-event ms of fns["row"] and fns["planes"] in turns (row, planes,
    planes, row), `iters` calls a window: {"row": [ms, ms], "planes": [...]}."""
    turns = {"row": [], "planes": []}
    for which in ("row", "planes", "planes", "row"):
        turns[which].append(cuda_ms(fns[which], iters))
    return turns


def _turns_text(turns: dict) -> str:
    return ("A/B in turns row,planes,planes,row ms="
            + ",".join(f"{ms:.4f}" for ms in (turns["row"][0], *turns["planes"], turns["row"][1])))


def phase15_planes() -> tuple:
    """The hash kernels on the TPU kernels' word-plane layout. Both
    plane-major kernels against their plain twins and against the row-major
    kernels' digests transposed (tolerance 0), then the A/B in turns (row,
    planes, planes, row), each turn a 50-call CUDA-event window, and the
    profiled device time of each layout: `sha256_leaf` at 2^20 leaves,
    `sha256_node` at 2^19 parents, beside the row-major rows' bounds; then a
    tree of 2^24 leaves through `build_levels` on both layouts (the chain:
    bit-reversed leaves, `node_planes_folded` down to 2^22 parents, every
    level turned natural row-major), every level equal, in turns. The chain's
    first tree is the run whose launches are counted. Returns the table's
    rows of the two plane-major kernels and those launches."""
    from zkstark_tpu_torch import ops
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.hash import merkle
    from zkstark_tpu_torch.ops import sha256_kernel as sk

    rng = np.random.default_rng(41)

    def u32(shape):
        words = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
        return fp.from_host(words, "cuda")

    def t(a):  # (n, 8) rows <-> (8, n) planes
        return fp.as_u32(fp.as_i32(a).t().contiguous())

    vals = u32(1 << 20)
    n = vals.shape[0]
    planes = sk.leaf_planes(vals)
    errs = [max_abs_err(planes, sk.leaf_planes_plain(vals)), max_abs_err(planes, t(sk.leaf_hash(vals)))]
    children = u32((8, 1 << 20))
    k = children.shape[1] // 2
    # the same children row-major: left child j then right child j
    pairs = torch.cat([fp.as_i32(children[:, :k]).t(), fp.as_i32(children[:, k:]).t()], 1)
    pairs = fp.as_u32(pairs.contiguous().reshape(2 * k, 8))
    folded = sk.node_planes_folded(children)
    interleaved = sk.node_planes(children)
    errs += [max_abs_err(folded, sk.node_planes_folded_plain(children)),
             max_abs_err(folded, t(sk.node_hash_pairs(pairs))),
             max_abs_err(interleaved, sk.node_planes_plain(children)),
             max_abs_err(interleaved, t(sk.node_hash_pairs(t(children))))]
    if any(errs):
        raise AssertionError(f"the plane-major kernels differ from their plain twins or the "
                             f"row-major digests: {errs}")
    del planes, folded, interleaved
    cases = (
        ("sha256_leaf_planes", "n=2^20", "sha256_leaf", bound(4 * n + 32 * n, n * SHA_LEAF),
         dict(row=lambda: sk.leaf_hash(vals), planes=lambda: sk.leaf_planes(vals)),
         lambda: sk.leaf_planes_plain(vals)),
        ("sha256_node_planes", "k=2^19 folded", "sha256_node", bound(64 * k + 32 * k, k * SHA_NODE),
         dict(row=lambda: sk.node_hash_pairs(pairs), planes=lambda: sk.node_planes_folded(children)),
         lambda: sk.node_planes_folded_plain(children)),
    )
    rows = {}
    for name, label, kernel, limit, fns, plain in cases:
        turns = _ab_turns(fns, 50)
        # each window launches one kernel only: its instance of the template
        dev = {which: device_ms(fns[which], kernel, 50) for which in fns}
        plain_ms = cuda_ms(plain, 3)
        share = {which: limit["bound_ms"] / dev[which] for which in dev}
        say(f"phase15 {name} {label} max_abs_err=0 tol=0 (plain twin and row-major digests "
            f"transposed) {_turns_text(turns)} device_ms row={dev['row']:.5f} "
            f"planes={dev['planes']:.5f} plain_ms={plain_ms:.4f} bound_ms={limit['bound_ms']:.4f} "
            f"bound_by={limit['bound_by']} share row={share['row']:.3f} planes={share['planes']:.3f}")
        rows[name] = dict(max_abs_err=0, ms=dev["planes"], plain_ms=plain_ms, library_ms=None,
                          **limit)
    del vals, children, pairs

    values = u32(1 << 24)
    trees = dict(row=lambda: merkle.build_levels(values),
                 planes=lambda: merkle.build_levels(values, planar_stop=merkle.PLANAR_STOP))
    ops.reset_launch_counts()
    chain = trees["planes"]()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    require_launched(launches, (*PLANE_KERNELS, "transpose"), "the plane-major tree")
    levels = trees["row"]()
    if len(chain) != len(levels) or any(max_abs_err(a, b) for a, b in zip(chain, levels)):
        raise AssertionError("the plane-major tree differs from the row-major tree")
    del chain, levels
    turns = _ab_turns(trees, 20)
    busy = {which: _device_busy(trees[which]) for which in trees}
    say(f"phase15 tree n=2^24 root equal on both layouts, every level equal; {_turns_text(turns)} "
        f"(20 trees a window) device_busy row={json.dumps(busy['row'])} "
        f"planes={json.dumps(busy['planes'])} "
        f"chain launches={json.dumps({k: v for k, v in launches.items() if v})}")
    del values
    torch.cuda.empty_cache()
    return rows, launches


def _group_of_one_worker(port: int) -> None:
    """One process of a process group of one on the card (NCCL for CUDA
    tensors): stark-101 on a mesh of one shard and the 2^21 square-chain
    statement on two shards in this process, the collectives through the
    group. Prints one JSON line."""
    import torch.distributed as dist

    from zkstark_tpu_torch import STARK101, STARK101_SECRET, prove
    from zkstark_tpu_torch.parallel import initialize_distributed, make_mesh

    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    if initialize_distributed() != 1:
        raise AssertionError("initialize_distributed: the group of one is not one")
    res = dict(backend=dist.get_backend_config())
    cfg21 = _square_chain_cfg(MID_TRACE_BITS, BIG_SECRET)
    for label, cfg, secret, shards in (("stark101", STARK101, STARK101_SECRET, 1),
                                       ("square-chain 2^21", cfg21, BIG_SECRET, 2)):
        solo = prove(cfg, secret, device="cuda")
        mesh = make_mesh(shards, device="cuda")
        if mesh.is_local or mesh.n_processes != 1:
            raise AssertionError("make_mesh in a group of one: not a process-group mesh")
        got = prove(cfg, secret, mesh=mesh)
        t0 = time.perf_counter()
        again = prove(cfg, secret, mesh=mesh)
        torch.cuda.synchronize()
        res[label] = dict(shards=shards, bytes=len(got.data), state=got.state.hex(),
                          equal_solo=(got.state, got.data) == (solo.state, solo.data),
                          equal_again=again == got, warm_s=round(time.perf_counter() - t0, 4),
                          bytes_moved=dict(mesh.bytes_moved))
    dist.destroy_process_group()
    print(json.dumps(res), flush=True)


def phase16_nccl_group() -> dict:
    """The process-group mesh on NCCL: a spawned process starts a group of
    one on the card and proves stark-101 (one shard) and the 2^21 statement
    (two shards in the process) through it; each proof equals the solo one,
    7,836 B golden and 17,612 B."""
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "--group-of-one", str(port)],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if run.returncode != 0:
        raise AssertionError(f"the NCCL group of one failed ({run.returncode}):\n{run.stderr[-4000:]}")
    res = json.loads(run.stdout.strip().splitlines()[-1])
    say(f"phase16 NCCL group of one: {json.dumps(res)}")
    if "cuda:nccl" not in res["backend"]:
        raise AssertionError(f"the group's backend is {res['backend']}, not NCCL")
    a, b = res["stark101"], res["square-chain 2^21"]
    if not (a["equal_solo"] and a["bytes"] == GOLDEN_LEN and a["state"] == GOLDEN_STATE):
        raise AssertionError("the NCCL group's stark-101 proof is not golden")
    if not (b["equal_solo"] and b["bytes"] == MID_PROOF_LEN and sum(b["bytes_moved"].values()) > 0):
        raise AssertionError("the NCCL group's 2^21 proof is not the solo proof")
    if not (a["equal_again"] and b["equal_again"]):
        raise AssertionError("the NCCL group's proofs changed between runs")
    return res


# the metrics of `bench.py`'s default run (not --all), as the twin names them
BENCH_METRICS = ("value", "vs_baseline", "warmup_prove_seconds", "verify_seconds",
                 "stark101_prove_pipelined_latency", "merkle_hashes_per_sec_2e20",
                 "ntt_points_per_sec_2e24", "ntt_sol_ratio_2e24", "ntt_ops_ratio_2e24",
                 "proofs_per_sec_b32", "proofs_per_sec_b64", "ntt_points_per_sec_2e27",
                 "total_bench_seconds")
# the kernels of the twin's default run: the fused stark-101 proves and
# batches, the Merkle trees, the 2^24 four-step and the 2^27 limb route
BENCH_KERNELS = ("sha256_leaf", "sha256_node", "sha256_tree_tail", "ntt_rows", "transpose",
                 "limb_dft_rows", "fs_chain", "fri_fold", "composition", *GLUE_KERNELS)
BENCH_BUDGET_S = 600  # the twin's own budget; its sections take well under a minute
BENCH_TIMEOUT_S = 700


def phase17_bench(smi: str) -> dict:
    """`python -m zkstark_tpu_torch.tools.bench --repeats 5` in a subprocess,
    on the kernels phase 1 built: exit 0, the last stdout line the final
    headline with every metric of `bench.py`'s default run, positive, none
    skipped, the card's name and power limit; every kernel of its path
    launched (its stderr's counts, from its warm-up on). Prints the record
    and the spread of the 5 timed proves; returns the run's launches."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "zkstark_tpu_torch.tools.bench", "--repeats", "5",
         "--budget", str(BENCH_BUDGET_S)],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"tools.bench exited {run.returncode}:\n{run.stderr[-4000:]}")
    records = [json.loads(ln) for ln in run.stdout.splitlines()]
    diag = {}
    for ln in run.stderr.splitlines():
        if ln.startswith("{"):
            d = json.loads(ln)
            diag[d.get("phase") or d.get("metric")] = d
    last = records[-1]
    if records[0].get("status") != "warming":
        raise AssertionError(f"tools.bench: the first record is not the warming line: {records[0]}")
    bad = [k for k in BENCH_METRICS if not (isinstance(last.get(k), (int, float)) and last[k] > 0)]
    bad += [k for k, v in last["phases"].items() if not v > 0]
    if (last["metric"] != "stark101_prove_latency" or last.get("provisional") or last.get("skipped")
            or last.get("reduced") or bad):
        raise AssertionError(f"tools.bench: the last record is not a whole headline ({bad}): {last}")
    if last["device"] != torch.cuda.get_device_name(0) or last["power_limit"] != smi.rsplit(",", 1)[1].strip():
        raise AssertionError(f"tools.bench: device {last['device']!r}, power {last['power_limit']!r}; "
                             f"nvidia-smi says {smi!r}")
    if diag["build_seconds"]["nvcc_seconds"] != 0.0:
        raise AssertionError("tools.bench rebuilt the kernels")
    times = sorted(diag["prove_seconds_all"]["value"])
    if len(times) != 5 or times[0] != last["value"]:
        raise AssertionError(f"tools.bench: prove_seconds_all {times}, headline {last['value']}")
    launches = diag["kernel_launches"]["value"]
    require_launched(launches, BENCH_KERNELS, "tools.bench")
    say(f"phase17 tools.bench record={json.dumps(last)}")
    say(f"phase17 tools.bench prove_seconds_all n=5 min={times[0]!r} median={times[2]!r} "
        f"max={times[-1]!r} build_seconds={diag['build_seconds']['value']!r} "
        f"launches={json.dumps({k: v for k, v in launches.items() if v})} wall_s={wall:.1f}")
    _bench_work_busy()
    return launches


def _bench_work_busy() -> None:
    """The twin's timed Merkle and NTT work, one warm run each in this process
    under torch.profiler: the device's busy time beside the host's wall time
    (inflated by the profiler), which says whether the host or the device
    sets the twin's throughput numbers."""
    from zkstark_tpu_torch import ntt
    from zkstark_tpu_torch.tools import bench

    leaves = bench.merkle_input(1 << 20, "cuda")
    x = bench.ntt_input(1 << 24, "cuda")
    plan = ntt.forward_plan(1 << 24)
    for label, fn in (("merkle_chain 8 trees of 2^20 leaves", lambda: bench.merkle_chain(leaves, 8)),
                      ("ntt_chain 8 transforms of 2^24", lambda: bench.ntt_chain(x, plan, 8))):
        fn()
        say(f"phase17 {label} {json.dumps(_device_busy(fn))}")
    del leaves, x
    torch.cuda.empty_cache()


def main():
    t_start = time.perf_counter()
    smi = phase0_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # phases 4-6 and prove_big take the default DIT route; phase 7 turns the
    # Pease route on for its CLI subprocess and for one timed prove
    os.environ.pop("ZKSTARK_PEASE", None)
    phase1_build()
    field_launches = phase2_fp()
    rows = phase3_kernels()
    plane_rows, plane_launches = phase15_planes()
    rows.update(plane_rows)
    phase4_stark101()
    cfg16, proof16 = phase5_cross_check()
    cfg24, proof24, warm24 = phase6_big()
    with tempfile.TemporaryDirectory() as tmp_dir:
        launches = phase7_entry_points(tmp_dir)
        phase8_checkpoint(tmp_dir, cfg16, proof16)
    main_launches = phase9_fused_solo()
    phase10_batch(cfg16, proof16)
    fused_launches = phase11_pipelined(cfg24, proof24, warm24)
    sharded_launches = phase13_sharded(proof24)
    phase16_nccl_group()
    del proof24
    phase14_scaling_bench()
    giant_launches = phase12_past_2e26()
    bench_launches = phase17_bench(smi)
    # the launches of a kernel are those of the main-path run that first drove
    # it: the 2^25 entry points (phase 7), the 2^24 pipelined stream (phase 11),
    # the 2^27 prove_big run (phase 12), the stark-101 fused prove with its
    # constants built cold (phase 9)
    for name in FUSED_KERNELS:
        launches[name] = fused_launches[name]
    for name in ("limb_dft_rows", "composition"):
        launches[name] = giant_launches[name]
    for name in GLUE_KERNELS:
        launches[name] = main_launches[name]
    for name in PLANE_KERNELS:
        launches[name] = plane_launches[name]
    launches["powers"] = field_launches["powers"]
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SRC[name][0],
            "replaces": SRC[name][1],
            "launches": launches[name],
            "max_abs_err": rows[name]["max_abs_err"],
            "ms": rows[name]["ms"],
            "plain_ms": rows[name]["plain_ms"],
            "bound_ms": rows[name]["bound_ms"],
            "bound_by": rows[name]["bound_by"],
            "library_ms": rows[name]["library_ms"],
            "launches_one_fetch_2e24_stream": fused_launches[name],
            "launches_prove_big_2e27": giant_launches[name],
            "launches_sharded_2e24_s8": sharded_launches[name],
            "launches_fused_stark101": main_launches[name],
            "launches_bench": bench_launches[name],
            **({k: rows[name][k] for k in ("launch_floor_ms", "wrapper_host_ms",
                                            "param_block_bytes")} if name == "openings" else {}),
        }
        for name in SRC
    ]
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError(f"a kernel was never launched on a main path: {kernels}")
    missing = [n for n in SHARDED_KERNELS if sharded_launches[n] <= 0]
    if missing:
        raise AssertionError(f"the sharded main path did not launch {missing}")
    say(f"wall_s={time.perf_counter() - t_start:.1f}")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    if sys.argv[1:2] == ["--group-of-one"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _group_of_one_worker(int(sys.argv[2]))
    else:
        main()
