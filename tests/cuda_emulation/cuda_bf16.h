// Stand-in for <cuda_bf16.h>: bfloat16 storage (the upper 16 bits of a
// float32) with the conversions a kernel uses, rounding to nearest even as
// the CUDA intrinsics do.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};

static inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

static inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u)  // NaN stays a (quiet) NaN
    return {static_cast<uint16_t>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
