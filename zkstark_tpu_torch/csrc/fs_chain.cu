// Kernel F: the Fiat-Shamir channel's hash chain, one thread per chain.
//
// Counterpart of zkstark_tpu/transcript/device_channel.py (absorb_hash,
// absorb_u32_le, draw_u32, draw_to_mont), which on the TPU was a few dozen
// XLA ops fused into the one prover program. The chain is serial scalar work:
// about 40 one-block hashes a proof, each depending on the one before. As
// plain tensor ops every compression would be hundreds of launches, so one
// launch here runs one whole challenge boundary: an optional commit (a
// 32-byte digest, two compressions, or a little-endian u32, one), then any
// number of draws, each returned with its Montgomery form (one REDC of
// draw * R^2, valid for any u32) and, for query indices, reduced modulo the
// query range. B proofs are B threads in lockstep.
//
// Nothing bounds it but latency: one thread runs about a thousand dependent
// integer ops a compression. Bytes and instruction slots are nowhere near a limit.
//
// Byte conventions (channel.rs:19-32): the state is 8 big-endian words; a
// digest commit hashes state || digest (64 bytes, so a second, constant
// padding block); a draw is state word 0, committed as 4 little-endian bytes,
// which as a message word is bswap32(draw), in a 36-byte one-block message.
#include <cstdint>

#include <cuda_runtime.h>

#include "fp.cuh"
#include "sha256.cuh"

namespace {

using namespace sha256;

struct ChainArgs {
  const uint32_t* state_in;  // (chains, 8)
  uint32_t* state_out;       // (chains, 8)
  const uint32_t* digest;    // (chains, 8) at digest_stride words a row, or null
  int64_t digest_stride;
  const uint32_t* word;      // (chains,) at word_stride words apart, or null
  int64_t word_stride;
  int n_draws;
  uint32_t* draws;           // (chains, n_draws) at draws_stride words a row
  int64_t draws_stride;
  uint32_t* mont;            // (chains, n_draws)
  uint32_t* mod;             // (chains, n_draws) at mod_stride words a row, or null
  int64_t mod_stride;
  uint32_t query_range;
  uint32_t r2;               // R^2 mod p
  Fp f;
  int64_t chains;
};

__global__ void fs_chain_kernel(const ChainArgs a) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= a.chains) return;
  uint32_t st[8];
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = a.state_in[c * 8 + i];
  if (a.digest != nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = st[i];
      w[8 + i] = a.digest[c * a.digest_stride + i];
    }
    init_state(st);
    compress(st, w);
    compress_pad512(st);
  }
  const int has_word = a.word != nullptr ? 1 : 0;
#pragma unroll 1
  for (int it = 0; it < has_word + a.n_draws; ++it) {
    uint32_t v;
    if (it < has_word) {
      v = a.word[c * a.word_stride];
    } else {
      v = st[0];
      const int64_t at = c * a.n_draws + (it - has_word);
      a.draws[c * a.draws_stride + (it - has_word)] = v;
      a.mont[at] = fp_mul(v, a.r2, a.f);
      if (a.mod != nullptr) a.mod[c * a.mod_stride + (it - has_word)] = v % a.query_range;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = st[i];
    w[8] = __byte_perm(v, 0u, 0x0123);  // the word's little-endian bytes
    w[9] = 0x80000000u;
#pragma unroll
    for (int i = 10; i < 15; ++i) w[i] = 0u;
    w[15] = 36u * 8u;  // message length in bits
    init_state(st);
    compress(st, w);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) a.state_out[c * 8 + i] = st[i];
}

constexpr int kThreads = 64;

}  // namespace

// One challenge boundary for `chains` independent channels: state_in (chains,
// 8) -> state_out, after committing digest (row c at digest + c *
// digest_stride; null: none), then word (chain c's at word + c * word_stride;
// null: none), then n_draws draws written to draws (row c at draws + c *
// draws_stride: the packed result's columns), mont ((chains, n_draws)) and
// mod (row c at mod + c * mod_stride; null: not wanted). state_out may alias
// state_in.
extern "C" int zk_fs_chain(const uint32_t* state_in, uint32_t* state_out, const uint32_t* digest,
                           int64_t digest_stride, const uint32_t* word, int64_t word_stride,
                           int n_draws, uint32_t* draws, int64_t draws_stride, uint32_t* mont,
                           uint32_t* mod, int64_t mod_stride, uint32_t query_range, uint32_t r2,
                           uint32_t p, uint32_t pinv, int64_t chains, cudaStream_t stream) {
  if (chains < 0 || chains > 0x7fffffffLL * kThreads || n_draws < 0 || digest_stride < 0 ||
      word_stride < 0 || draws_stride < 0 || mod_stride < 0 ||
      (mod != nullptr && query_range == 0u) ||
      (n_draws > 0 && (draws == nullptr || mont == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chains > 0) {
    const ChainArgs a{state_in, state_out,  digest, digest_stride, word,        word_stride,
                      n_draws,  draws,      draws_stride,  mont, mod,         mod_stride,
                      query_range, r2,      Fp{p, pinv},   chains};
    const unsigned blocks = static_cast<unsigned>((chains + kThreads - 1) / kThreads);
    fs_chain_kernel<<<blocks, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
