// Warp-level tensor-core helpers for Hopper (sm_90a): ldmatrix, mma.sync and
// the TF32 split, for the kernels of this directory.
//
// The operands live in shared memory as rows of 32 bytes: 16 bfloat16 or 8
// float32 values along k. The two 16-byte halves of a row are stored swapped
// when bit 2 of the row index is set (swz_half), so that the 8 rows an
// ldmatrix phase reads, any 8 consecutive rows, fall in 32 distinct banks.
//   A: 16 consecutive rows from `row` are the 16 rows (m) of an m16 x k tile;
//   B: 16 consecutive rows from `row` are the 16 columns (n) of a k x n16 tile
//      (B column-major), two n8 tiles of the mma.
// A warp's product m16 x n16 x k32B is two mma.sync (n8 each): m16n8k16 for
// bfloat16 and m16n8k8 for TF32, f32 sums. Acc holds the lane's 8 sums in the
// mma's layout (PTX ISA, "Matrix Fragments for mma.m16n8k16"): lane 4 g + t
// holds rows g and g + 8, columns 2t and 2t + 1 of each n8 tile, in the order
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), then the same at 8 + 2t.
//
// tests/cuda_emulation/tensor_core.cuh is this file's CPU counterpart, with
// the same functions and layouts, for the tests without a GPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace vxm {

struct FragA {
  uint32_t r[4];
};
struct FragB {
  uint32_t r[4];
};
struct Acc {
  float c[8];
};

// the 16-byte slot in which half `half` of row `row` is stored
__host__ __device__ __forceinline__ int swz_half(int row, int half) {
  return half ^ ((row >> 2) & 1);
}

__device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
  for (int e = 0; e < 8; ++e) a.c[e] = 0.f;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// lane l reads row row + l % 16, half l / 16: matrices (rows 0-7, k lo),
// (rows 8-15, k lo), (rows 0-7, k hi), (rows 8-15, k hi), the A fragment
template <typename T>
__device__ __forceinline__ void load_a(FragA& f, const T* base, int row) {
  const int l = threadIdx.x % 32;
  const int r = row + l % 16;
  ldsm_x4(f.r, reinterpret_cast<const char*>(base) + 32 * r + 16 * swz_half(r, l / 16));
}

// lane l reads column (row) row + l % 8 + 8 (l / 16), half (l / 8) % 2:
// matrices (n 0-7, k lo), (n 0-7, k hi), (n 8-15, k lo), (n 8-15, k hi),
// the B fragments of the two n8 tiles
template <typename T>
__device__ __forceinline__ void load_b(FragB& f, const T* base, int row) {
  const int l = threadIdx.x % 32;
  const int r = row + l % 8 + 8 * (l / 16);
  ldsm_x4(f.r, reinterpret_cast<const char*>(base) + 32 * r + 16 * swz_half(r, (l / 8) % 2));
}

// d += a * b over the tile's k (16 bfloat16 or 8 TF32 values)
template <typename T>
__device__ __forceinline__ void mma(Acc& d, const FragA& a, const FragB& b);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(Acc& d, const FragA& a, const FragB& b) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d.c[4 * n]), "+f"(d.c[4 * n + 1]), "+f"(d.c[4 * n + 2]), "+f"(d.c[4 * n + 3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[2 * n]),
          "r"(b.r[2 * n + 1]));
}

template <>
__device__ __forceinline__ void mma<float>(Acc& d, const FragA& a, const FragB& b) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d.c[4 * n]), "+f"(d.c[4 * n + 1]), "+f"(d.c[4 * n + 2]), "+f"(d.c[4 * n + 3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[2 * n]),
          "r"(b.r[2 * n + 1]));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// the 3xTF32 split of a float32 fragment: big = tf32(v) in place,
// small = tf32(v - big)
template <typename F>
__device__ __forceinline__ void split_tf32(F& big, F& small) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v = __uint_as_float(big.r[e]);
    big.r[e] = to_tf32(v);
    small.r[e] = to_tf32(v - __uint_as_float(big.r[e]));
  }
}

// the warp's m16 x n16 sums to tile[m * ld + n] (f32, row-major)
__device__ __forceinline__ void store_acc(float* tile, int ld, const Acc& a) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (g + 8 * h) * ld + 8 * n + 2 * t) =
          make_float2(a.c[4 * n + 2 * h], a.c[4 * n + 2 * h + 1]);
}

}  // namespace vxm
