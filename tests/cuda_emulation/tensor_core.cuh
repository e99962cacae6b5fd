// CPU counterpart of voxelmorph_tpu_torch/csrc/tensor_core.cuh: the same
// functions and shared-memory layout (32-byte rows, halves swapped when bit
// 2 of the row index is set), for kernels compiled with the host's compiler
// against the stand-ins of this directory.
//
// Each CUDA thread (std::thread) is one lane of its warp and holds what its
// part of a product needs: a lane's FragA holds the two A rows of its
// outputs, g and g + 8 for lane 4 g + t (on the card the lanes exchange the
// rows inside the tensor cores; hopper.cuh's wgmma stand-in gives each lane
// its outputs in the accumulator layout of mma.m16n8). to_tf32 rounds to
// nearest, ties away from zero, as cvt.rna.tf32.f32 does.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace vxm {

struct FragA {
  float a[2][16];  // rows g and g + 8, k
};

inline int swz_half(int row, int half) { return half ^ ((row >> 2) & 1); }

inline int lane() {
  return (threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z)) % 32;
}

inline float to_float(float v) { return v; }
inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// element k of the 32-byte row `row`
template <typename T>
inline float element(const T* base, int row, int k) {
  constexpr int H = 16 / sizeof(T);  // values in a 16-byte half
  return to_float(base[row * 2 * H + swz_half(row, k / H) * H + k % H]);
}

template <typename T>
inline void load_a(FragA& f, const T* base, int row) {
  const int g = lane() / 4;
  for (int r = 0; r < 2; ++r)
    for (int k = 0; k < 32 / (int)sizeof(T); ++k) f.a[r][k] = element(base, row + g + 8 * r, k);
}

inline float to_tf32(float v) {
  uint32_t u;
  std::memcpy(&u, &v, sizeof u);
  if ((u & 0x7f800000u) != 0x7f800000u) {  // finite: keep 10 mantissa bits
    u += 0x1000u;
    u &= ~0x1fffu;
  }
  std::memcpy(&v, &u, sizeof v);
  return v;
}

template <typename F>
inline void split_tf32(F& big, F& small) {
  float* b = reinterpret_cast<float*>(&big);
  float* s = reinterpret_cast<float*>(&small);
  for (unsigned e = 0; e < sizeof(F) / sizeof(float); ++e) {
    const float v = b[e];
    b[e] = to_tf32(v);
    s[e] = to_tf32(v - b[e]);
  }
}

}  // namespace vxm
