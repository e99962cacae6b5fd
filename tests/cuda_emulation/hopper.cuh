// CPU counterpart of voxelmorph_tpu_torch/csrc/hopper.cuh: the same
// functions, for kernels compiled with the host's compiler against the
// stand-ins of this directory.
//
// An mbarrier is an object with a mutex and a condition variable, its index
// kept in the 8 bytes of shared memory the kernel gives it; it counts
// arrivals and TMA's bytes and completes a phase when both reach zero, and
// a wait blocks until the phase of the given parity has completed, as on
// the card. A TMA load copies its box at once, zeros outside the tensor,
// through the 32-byte swizzle of the destination's shared-memory address
// (or none, as its map says), then reports its bytes (the innermost start
// coordinate must fall on 16 bytes, as on the card); a 1-D bulk copy
// likewise, without a swizzle. A
// wgmma runs at once and gives each lane its
// outputs in the accumulator layout of mma.m16n8 (lane 4 g + t: rows g and
// g + 8, columns 8 j + 2 t and 8 j + 2 t + 1 of each n8 block j), reading
// B's rows through the descriptor (start address, stride between 8-row
// groups, 32-byte swizzle); the operands are exact in f32 (bfloat16, or
// TF32, whose low 13 bits the tensor cores ignore) and are summed in k
// order with f32 rounding, where the tensor cores may round their sums
// otherwise, which the tests' tolerance covers. A wait is a barrier of the
// warp's lanes; fences, commits and setmaxnreg have nothing to do.
#pragma once
#include <cassert>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>

#include "cuda.h"
#include "cuda_bf16.h"
#include "cuda_runtime.h"
#include "tensor_core.cuh"

namespace vxm {

inline uint32_t smem_u32(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }

inline unsigned char* smem_at(uint32_t addr) {
  return reinterpret_cast<unsigned char*>(emu_shared_memory) + addr;
}

// the byte that `addr` names through the 32-byte swizzle
inline uint32_t swizzle32(uint32_t addr) { return addr ^ (((addr >> 7) & 1u) << 4); }

// --- mbarriers ---------------------------------------------------------------

struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int count = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;  // phases completed
};

inline std::deque<EmuBarrier>& emu_barriers() {
  static std::deque<EmuBarrier> barriers;
  return barriers;
}

inline EmuBarrier& barrier_of(uint64_t* bar) {
  uint64_t index;
  std::memcpy(&index, bar, sizeof index);
  return emu_barriers().at(index);
}

// the phase completes: both counts at zero
inline void settle(EmuBarrier& b) {
  assert(b.pending >= 0);
  if (b.pending == 0 && b.tx == 0) {
    ++b.phase;
    b.pending = b.count;
    b.cv.notify_all();
  }
}

inline void mbar_init(uint64_t* bar, int count) {
  auto& all = emu_barriers();  // one thread initialises while the block waits
  all.emplace_back();
  all.back().count = all.back().pending = count;
  const uint64_t index = all.size() - 1;
  std::memcpy(bar, &index, sizeof index);
}

inline void mbar_fence_init() {}

inline void mbar_arrive(uint64_t* bar, bool pred = true) {
  if (!pred) return;
  EmuBarrier& b = barrier_of(bar);
  std::lock_guard<std::mutex> lock(b.m);
  --b.pending;
  settle(b);
}

inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  EmuBarrier& b = barrier_of(bar);
  std::lock_guard<std::mutex> lock(b.m);
  b.tx += bytes;
  --b.pending;
  settle(b);
}

inline void mbar_complete_tx(uint64_t* bar, uint32_t bytes) {
  EmuBarrier& b = barrier_of(bar);
  std::lock_guard<std::mutex> lock(b.m);
  b.tx -= bytes;
  settle(b);
}

// cp.async copies are complete when issued (cuda_pipeline_primitives.h)
inline void cp_async_arrive(uint64_t* bar) { mbar_arrive(bar); }

inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  EmuBarrier& b = barrier_of(bar);
  std::lock_guard<std::mutex> lock(b.m);
  return (b.phase & 1u) != parity;
}

inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  EmuBarrier& b = barrier_of(bar);
  std::unique_lock<std::mutex> lock(b.m);
  b.cv.wait(lock, [&] { return (b.phase & 1u) != parity; });
}

// --- TMA ---------------------------------------------------------------------

inline void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, const int* coord) {
  const uint32_t base = smem_u32(dst);
  assert(base % 128 == 0 && (map->swizzle == CU_TENSOR_MAP_SWIZZLE_32B ||
                             map->swizzle == CU_TENSOR_MAP_SWIZZLE_NONE));
  const bool swizzled = map->swizzle == CU_TENSOR_MAP_SWIZZLE_32B;
  // the card faults on a box whose innermost start is not on 16 bytes
  assert(((long long)coord[0] * map->elem) % 16 == 0);
  uint32_t n = 1;
  for (int d = 0; d < map->rank; ++d) n *= map->box[d];
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t rest = i;
    bool inside = true;
    long long offset = 0;
    for (int d = 0; d < map->rank; ++d) {
      const long long c = coord[d] + (long long)(rest % map->box[d]);
      rest /= map->box[d];
      inside = inside && c >= 0 && c < (long long)map->dims[d];
      offset += c * (long long)map->strides[d];
    }
    const uint32_t at = base + i * map->elem;
    unsigned char* out = smem_at(swizzled ? swizzle32(at) : at);
    if (inside)
      std::memcpy(out, map->base + offset, map->elem);
    else
      std::memset(out, 0, map->elem);
  }
  mbar_complete_tx(bar, n * map->elem);
}

inline void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                        int c3, int c4) {
  assert(map->rank == 5);
  const int coord[5] = {c0, c1, c2, c3, c4};
  tma_load(dst, map, bar, coord);
}

inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  assert(map->rank == 3);
  const int coord[3] = {c0, c1, c2};
  tma_load(dst, map, bar, coord);
}

// a 1-D bulk copy: at once, then its bytes reported
inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  assert(bytes % 16 == 0 && smem_u32(dst) % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0);
  std::memcpy(dst, src, bytes);
  mbar_complete_tx(bar, bytes);
}

// --- registers ---------------------------------------------------------------

template <int R>
inline void setmaxnreg_dec() {}
template <int R>
inline void setmaxnreg_inc() {}

// --- wgmma -------------------------------------------------------------------

inline uint64_t desc_b32(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(256 >> 4) << 32) |
         (uint64_t(3) << 62);
}

inline void wgmma_fence() {}
inline void wgmma_commit() {}
// on the card the warp executes the wait together (.sync.aligned), after
// its lanes' ldmatrix reads that fed the products: here its lanes meet, so
// that no lane releases a stage another is still reading
template <int N>
inline void wgmma_wait() {
  __syncwarp();
}
template <int N>
inline void fence_sums(float (&)[N]) {}

// the value the tensor cores take of an operand: TF32 drops float32's low
// 13 bits
inline float operand(float v, bool tf32) {
  if (!tf32) return v;
  uint32_t u;
  std::memcpy(&u, &v, sizeof u);
  u &= ~0x1fffu;
  std::memcpy(&v, &u, sizeof v);
  return v;
}

template <typename T, int N>
struct Wgmma {
  static void mma(float* d, const FragA& a, uint64_t desc, int scale_d) {
    constexpr int K = 32 / sizeof(T);
    constexpr bool TF32 = sizeof(T) == 4;
    assert((desc >> 62) == 3);  // 32-byte swizzle
    const uint32_t start = (desc & 0x3FFF) << 4, sbo = ((desc >> 32) & 0x3FFF) << 4;
    assert(start % 256 == 0);
    const int g = lane() / 4, t = lane() % 4;
    for (int j = 0; j < N / 8; ++j)
      for (int u = 0; u < 2; ++u) {
        const int n = 8 * j + 2 * t + u;
        const uint32_t row = start + (n / 8) * sbo + (n % 8) * 32;
        float b[K];
        for (int k = 0; k < K; ++k) {
          T v;
          std::memcpy(&v, smem_at(swizzle32(row + k * sizeof(T))), sizeof v);
          b[k] = operand(to_float(v), TF32);
        }
        for (int h = 0; h < 2; ++h) {
          float s = scale_d ? d[4 * j + 2 * h + u] : 0.f;
          for (int k = 0; k < K; ++k) s += operand(a.a[h][k], TF32) * b[k];
          d[4 * j + 2 * h + u] = s;
        }
      }
  }
};

}  // namespace vxm
