// Stand-in for <cuda_runtime.h> that runs a CUDA C++ kernel on the CPU, for
// tests on machines without a GPU or nvcc. The blocks run in turn, on one
// std::thread per CUDA thread, with a std::barrier for __syncthreads(), and
// each finds its shared memory filled with NaN. The
// `<<<grid, block, smem, stream>>>` launch and `extern __shared__` arrays
// are rewritten by the test (tests/test_torch_kernel_emulation.py) into
// emu_launch(...) and a pointer to emu_shared_memory.
// <cuda_pipeline_primitives.h> beside it stands in for the asynchronous
// copies, tensor_core.cuh and hopper.cuh for csrc/'s headers of the same
// names, and cuda.h for the driver API's TMA descriptor. A warp's shuffles,
// reductions and __syncwarp() meet at a barrier of the warp's 32 threads.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#include "cuda.h"

struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};
static inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local unsigned emu_thread;  // the thread's index in its block
static std::barrier<>* emu_barrier = nullptr;
static std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;  // one per warp
static long long emu_warp_values[1024];
// 1024-byte aligned, as a kernel aligns its buffers: the 32-byte swizzle
// of TMA and wgmma is read off the shared-memory address
alignas(1024) static float emu_shared_memory[232448 / sizeof(float)];
// a pointer's address in the shared-memory window: its offset in the buffer
static size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<size_t>(static_cast<const char*>(p) -
                             reinterpret_cast<const char*>(emu_shared_memory));
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
enum { cudaEnableDefault = 0 };
typedef enum {
  cudaDriverEntryPointSuccess = 0,
  cudaDriverEntryPointSymbolNotFound = 1
} cudaDriverEntryPointQueryResult;
// the driver's functions by name: cuTensorMapEncodeTiled's stand-in
static cudaError_t cudaGetDriverEntryPoint(const char* symbol, void** fn, unsigned long long,
                                           cudaDriverEntryPointQueryResult* status = nullptr) {
  const bool found = std::strcmp(symbol, "cuTensorMapEncodeTiled") == 0;
  *fn = found ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
  if (status) *status = found ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
// one device of 132 SMs that holds one block of any kernel on each
static cudaError_t cudaGetDevice(int* device) { *device = 0; return cudaSuccess; }
static cudaError_t cudaDeviceGetAttribute(int* value, int, int) { *value = 132; return cudaSuccess; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}
static cudaError_t cudaGetLastError() { return cudaSuccess; }

#define __global__
#define __device__
#define __host__
#define __align__(n) alignas(n)
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __syncthreads() emu_barrier->arrive_and_wait()
// rounded apart: no fused multiply-add, as the intrinsics promise
static float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
// atomic read-modify-writes of device memory, here of host memory shared by
// the block's threads
static int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
static float atomicAdd(float* p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
// the high 32 bits of a 32 x 32-bit product
static unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)((unsigned long long)a * b >> 32);
}
// 1 + the index of the lowest set bit, 0 for 0
static int __ffs(int x) { return __builtin_ffs(x); }
static int __ffsll(long long x) { return __builtin_ffsll(x); }
// A warp's exchanges (shuffles, reductions) meet at a barrier of the
// warp's 32 threads, all of which call them: each thread posts its value,
// and reads the others' before any posts again.
template <class T, class F>
T emu_warp_exchange(T v, F read) {
  static_assert(sizeof(T) <= sizeof(long long));
  const unsigned warp = emu_thread / 32;
  std::memcpy(&emu_warp_values[emu_thread], &v, sizeof(T));
  emu_warp_barriers[warp]->arrive_and_wait();
  auto lane_value = [&](unsigned lane) {
    T r;
    std::memcpy(&r, &emu_warp_values[warp * 32 + lane], sizeof(T));
    return r;
  };
  const T r = read(emu_thread % 32, lane_value);
  emu_warp_barriers[warp]->arrive_and_wait();
  return r;
}
static void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barriers[emu_thread / 32]->arrive_and_wait();
}
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned delta) {
  return emu_warp_exchange(v, [&](unsigned lane, auto value) {
    return lane >= delta ? value(lane - delta) : v;
  });
}
template <class T>
T __shfl_down_sync(unsigned, T v, unsigned delta) {
  return emu_warp_exchange(v, [&](unsigned lane, auto value) {
    return lane + delta < 32 ? value(lane + delta) : v;
  });
}
static int __any_sync(unsigned, int v) {
  return emu_warp_exchange(v, [](unsigned, auto value) {
    int any = 0;
    for (unsigned lane = 0; lane < 32; ++lane) any |= value(lane) != 0;
    return any;
  });
}
static unsigned __reduce_add_sync(unsigned, unsigned v) {
  return emu_warp_exchange(v, [](unsigned, auto value) {
    unsigned sum = 0;
    for (unsigned lane = 0; lane < 32; ++lane) sum += value(lane);
    return sum;
  });
}

template <class K, class... A>
void emu_launch(dim3 grid, dim3 block, K kernel, A... args) {
  // one std::thread per CUDA thread of a block, kept for all the blocks,
  // which run one after another; a fresh barrier for each block's
  // __syncthreads(), which a thread leaves when it returns from the kernel
  const unsigned n = block.x * block.y * block.z;
  std::barrier<> between(n);
  emu_warp_barriers.clear();
  for (unsigned w = 0; w < n; w += 32)
    emu_warp_barriers.push_back(std::make_unique<std::barrier<>>(std::min(32u, n - w)));
  std::barrier<>* inner = nullptr;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t % block.x, t / block.x % block.y, t / (block.x * block.y));
      emu_thread = t;
      blockDim = block;
      gridDim = grid;
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            if (t == 0) {
              inner = emu_barrier = new std::barrier<>(n);
              // shared memory starts undefined on the card: NaN here, so
              // that a kernel that reads what it never wrote shows it
              std::fill(std::begin(emu_shared_memory), std::end(emu_shared_memory), NAN);
            }
            between.arrive_and_wait();  // the block's barrier exists
            blockIdx = dim3(bx, by, bz);
            kernel(args...);
            inner->arrive_and_drop();   // a thread that has returned waits no more
            between.arrive_and_wait();  // the block is done
            if (t == 0) delete inner;
          }
    });
  for (auto& t : threads) t.join();
}
