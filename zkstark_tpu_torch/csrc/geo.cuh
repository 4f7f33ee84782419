// The geometric scale of the row-transform contract (ntt.cu, limb_dft.cu):
// element (row r, column i) is multiplied by base^e, e = i·es + r·rs, taken
// as a[e >> shift]·b[e & mask] from two small Montgomery tables (the host's
// ops/ntt_kernel.py GeoScale); a == nullptr turns it off.
#pragma once

#include <cstdint>

#include "fp.cuh"

struct Geo {
  const uint32_t* a;
  const uint32_t* b;
  int shift;
  uint32_t es, rs;
};

__device__ __forceinline__ uint32_t geo_factor(const Geo& g, uint32_t r, uint32_t i, Fp f) {
  const uint32_t e = i * g.es + r * g.rs;
  return fp_mul_r(__ldg(g.a + (e >> g.shift)), __ldg(g.b + (e & ((1u << g.shift) - 1u))), f);
}
