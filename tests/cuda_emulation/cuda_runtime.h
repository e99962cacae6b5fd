// Stand-in for <cuda_runtime.h> that runs a CUDA C++ kernel on the CPU, for
// tests on machines without a GPU or nvcc. Each block runs in turn, with one
// std::thread per CUDA thread and a std::barrier for __syncthreads(). The
// `<<<grid, block, smem, stream>>>` launch and `extern __shared__` arrays
// are rewritten by the test (tests/test_torch_kernel_emulation.py) into
// emu_launch(...) and a pointer to emu_shared_memory.
#pragma once
#include <barrier>
#include <cmath>
#include <thread>
#include <vector>

struct float4 {
  float x, y, z, w;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
thread_local dim3 threadIdx, blockIdx;
static std::barrier<>* emu_barrier = nullptr;
static float emu_shared_memory[232448 / sizeof(float)];

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
static cudaError_t cudaGetLastError() { return cudaSuccess; }

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __syncthreads() emu_barrier->arrive_and_wait()
// rounded apart: no fused multiply-add, as the intrinsics promise
static float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }

template <class K, class... A>
void emu_launch(dim3 grid, dim3 block, K kernel, A... args) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(block.x * block.y * block.z);
        emu_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned tz = 0; tz < block.z; ++tz)
          for (unsigned ty = 0; ty < block.y; ++ty)
            for (unsigned tx = 0; tx < block.x; ++tx)
              threads.emplace_back([=, &bar] {
                threadIdx = dim3(tx, ty, tz);
                blockIdx = dim3(bx, by, bz);
                kernel(args...);
                bar.arrive_and_drop();  // a thread that has returned waits no more
              });
        for (auto& t : threads) t.join();
      }
}
