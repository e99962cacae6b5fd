// Warp-level tensor-core helpers for Hopper (sm_90a): the ldmatrix load of
// an A fragment and the TF32 split, for the kernels of this directory
// (hopper.cuh's wgmma takes A in this fragment).
//
// The operands live in shared memory as rows of 32 bytes: 16 bfloat16 or 8
// float32 values along k. The two 16-byte halves of a row are stored swapped
// when bit 2 of the row index is set (swz_half), so that the 8 rows an
// ldmatrix phase reads, any 8 consecutive rows, fall in 32 distinct banks;
// for a buffer aligned to 1024 bytes this is TMA's 32-byte swizzle.
// 16 consecutive rows from `row` are the 16 rows (m) of an m16 x k tile,
// loaded into the A fragment of mma.m16n8k16 (bfloat16) or mma.m16n8k8
// (TF32; PTX ISA, "Matrix Fragments for mma.m16n8k16"): lane 4 g + t holds
// rows g and g + 8.
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

// the 16-byte slot in which half `half` of row `row` is stored
__host__ __device__ __forceinline__ int swz_half(int row, int half) {
  return half ^ ((row >> 2) & 1);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// lane l reads row row + l % 16, half l / 16: matrices (rows 0-7, k lo),
// (rows 8-15, k lo), (rows 0-7, k hi), (rows 8-15, k hi), the A fragment
template <typename T>
__device__ __forceinline__ void load_a(FragA& f, const T* base, int row) {
  const int l = threadIdx.x % 32;
  const int r = row + l % 16;
  ldsm_x4(f.r, reinterpret_cast<const char*>(base) + 32 * r + 16 * swz_half(r, l / 16));
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

}  // namespace vxm
