// CPU counterpart of voxelmorph_tpu_torch/csrc/tensor_core.cuh: the same
// functions and shared-memory layout (32-byte rows, halves swapped when bit
// 2 of the row index is set), for kernels compiled with the host's compiler
// against the stand-ins of this directory.
//
// Each CUDA thread (std::thread) is one lane of its warp and holds what its
// part of the product needs: the accumulator follows the documented lane
// layout of mma.m16n8 (PTX ISA, "Matrix Fragments for mma.m16n8k16"), lane
// 4 g + t holding rows g and g + 8 and columns 2t, 2t + 1 of each n8 tile,
// so that elementwise work on Acc::c and store_acc touch each output in
// exactly one lane, as on the card. A lane's FragA holds the A rows and its
// FragB the B columns of its outputs (on the card the lanes exchange them
// inside the mma). The products are exact in f32 (bfloat16 and TF32
// operands) and are added in k order with f32 rounding to nearest; the
// tensor cores may round their sums otherwise, which the tests' tolerance
// covers. to_tf32 rounds to nearest, ties away from zero, as
// cvt.rna.tf32.f32 does.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace vxm {

struct FragA {
  float a[2][16];  // rows g and g + 8, k
};
struct FragB {
  float b[4][16];  // columns 2t, 2t + 1, 8 + 2t, 9 + 2t, k
};
struct Acc {
  float c[8];
};

inline int swz_half(int row, int half) { return half ^ ((row >> 2) & 1); }

inline void zero(Acc& a) {
  for (int e = 0; e < 8; ++e) a.c[e] = 0.f;
}

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

template <typename T>
inline void load_b(FragB& f, const T* base, int row) {
  const int t = lane() % 4;
  const int cols[4] = {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t};
  for (int c = 0; c < 4; ++c)
    for (int k = 0; k < 32 / (int)sizeof(T); ++k) f.b[c][k] = element(base, row + cols[c], k);
}

template <typename T>
inline void mma(Acc& d, const FragA& a, const FragB& b) {
  for (int e = 0; e < 8; ++e) {
    const int r = (e / 2) % 2;            // row g or g + 8
    const int c = e % 2 + 2 * (e / 4);    // column 2t, 2t + 1, 8 + 2t, 9 + 2t
    float s = d.c[e];
    for (int k = 0; k < 32 / (int)sizeof(T); ++k) s += a.a[r][k] * b.b[c][k];
    d.c[e] = s;
  }
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

inline void store_acc(float* tile, int ld, const Acc& a) {
  const int g = lane() / 4, t = lane() % 4;
  for (int n = 0; n < 2; ++n)
    for (int h = 0; h < 2; ++h) {
      tile[(g + 8 * h) * ld + 8 * n + 2 * t] = a.c[4 * n + 2 * h];
      tile[(g + 8 * h) * ld + 8 * n + 2 * t + 1] = a.c[4 * n + 2 * h + 1];
    }
}

}  // namespace vxm
