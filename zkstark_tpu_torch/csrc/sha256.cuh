// SHA-256 on one thread: the round constants, one compression with the
// 16-word rolling message schedule in registers (every loop fully unrolled,
// so every index is a constant), and the compression of the constant padding
// block of a 64-byte message as a precomputed schedule-plus-K table. Shared
// by the Merkle hash kernels (sha256.cu) and the Fiat-Shamir chain kernel
// (fs_chain.cu); each translation unit gets its own copy of the tables.
#pragma once

#include <cstdint>

namespace sha256 {

static __constant__ uint32_t K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

// Schedule word + K[t] of the padding block of a 64-byte message
// (0x80000000, 0 x 14, 512): message-independent, so precomputed.
static __constant__ uint32_t PAD_WK[64] = {
    0xC28A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF374u, 0x649B69C1u, 0xF0FE4786u,
    0x0FE1EDC6u, 0x240CF254u, 0x4FE9346Fu, 0x6CC984BEu, 0x61B9411Eu, 0x16F988FAu,
    0xF2C65152u, 0xA88E5A6Du, 0xB019FC65u, 0xB9D99EC7u, 0x9A1231C3u, 0xE70EEAA0u,
    0xFDB1232Bu, 0xC7353EB0u, 0x3069BAD5u, 0xCB976D5Fu, 0x5A0F118Fu, 0xDC1EEEFDu,
    0x0A35B689u, 0xDE0B7A04u, 0x58F4CA9Du, 0xE15D5B16u, 0x007F3E86u, 0x37088980u,
    0xA507EA32u, 0x6FAB9537u, 0x17406110u, 0x0D8CD6F1u, 0xCDAA3B6Du, 0xC0BBBE37u,
    0x83613BDAu, 0xDB48A363u, 0x0B02E931u, 0x6FD15CA7u, 0x521AFACAu, 0x31338431u,
    0x6ED41A95u, 0x6D437890u, 0xC39C91F2u, 0x9ECCABBDu, 0xB5C9A0E6u, 0x532FB63Cu,
    0xD2C741C6u, 0x07237EA3u, 0xA4954B68u, 0x4C191D76u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

__device__ __forceinline__ void init_state(uint32_t st[8]) {
  st[0] = 0x6A09E667u;
  st[1] = 0xBB67AE85u;
  st[2] = 0x3C6EF372u;
  st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu;
  st[5] = 0x9B05688Cu;
  st[6] = 0x1F83D9ABu;
  st[7] = 0x5BE0CD19u;
}

__device__ __forceinline__ void round_step(uint32_t v[8], uint32_t wk) {
  const uint32_t e = v[4];
  const uint32_t a = v[0];
  const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & v[5]) ^ (~e & v[6]);
  const uint32_t t1 = v[7] + s1 + ch + wk;
  const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & v[1]) ^ (a & v[2]) ^ (v[1] & v[2]);
  v[7] = v[6];
  v[6] = v[5];
  v[5] = e;
  v[4] = v[3] + t1;
  v[3] = v[2];
  v[2] = v[1];
  v[1] = a;
  v[0] = t1 + s0 + maj;
}

// One compression of the block w (clobbered: it holds the rolling schedule).
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15];
      const uint32_t w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    round_step(v, w[t & 15] + K[t]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

// The second compression of a node: the constant padding block.
__device__ __forceinline__ void compress_pad512(uint32_t st[8]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) round_step(v, PAD_WK[t]);
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

}  // namespace sha256
