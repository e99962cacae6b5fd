// Stand-in for <cuda_pipeline_primitives.h>: an asynchronous copy to shared
// memory (cp.async) becomes a plain copy that is complete when issued, so
// committing and waiting have nothing to do. The copy's rules are checked:
// 4, 8 or 16 bytes, aligned to its size at both ends, the last `zfill`
// bytes of the destination zeroed instead of read.
#pragma once
#include <cassert>
#include <cstddef>
#include <cstdint>
#include <cstring>

static inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                           size_t zfill = 0) {
  assert(size == 4 || size == 8 || size == 16);
  assert(zfill <= size);
  assert(reinterpret_cast<uintptr_t>(dst) % size == 0);
  assert(reinterpret_cast<uintptr_t>(src) % size == 0);
  std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<char*>(dst) + (size - zfill), 0, zfill);
}
static inline void __pipeline_commit() {}
static inline void __pipeline_wait_prior(size_t) {}
