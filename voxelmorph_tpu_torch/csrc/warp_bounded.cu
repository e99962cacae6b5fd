// Bounded-displacement trilinear warp, forward and backward, for Hopper
// (sm_90a).
//
// FORWARD. Replaces the Pallas TPU kernels of
// voxelmorph_tpu/ops/pallas_interp.py that compute the bounded warp forward: _warp_kernel (via _warp_fwd_impl),
// _warp_kernel_2d (via _warp_fwd_impl_2d) and _v5_kernel (via
// _warp_fwd_impl_v5). All three compute, for |shift| <= h,
//
//   out[x] = sum_{o in [-h,h]^3} prod_d max(0, 1 - |d_d(x) - o_d|) * vol[x + o]
//
// where d = clamp(x + shift, 0, dim - 1) - x is the shift after clamping the
// sampling coordinate to the volume, and vol is edge-padded. Only the 8 taps
// o_d in {floor(d_d), floor(d_d) + 1} carry a nonzero weight, so this kernel
// evaluates those 8 with the same per-term arithmetic as the tap sum
// (weights 1 - |d - o|, product z*y*x, multiply and add rounded apart) and in
// the same order; the terms it skips are exact zeros. Its result therefore
// equals the plain version (ops/warp_bounded.py: windowed_transform).
//
// Layout: channels-last, vol (B, D, H, W, C) and shift (B, D, H, W, 3), f32,
// contiguous; out (B, D, H, W, C). 1 <= C <= 4 and 1 <= h <= 4, both
// template parameters, so that every corner and channel loop unrolls.
//
// Bound: the function reads vol and shift once and writes out once, so it
// moves (C + 3 + C) * 4 bytes per voxel: at (80, 96, 112), C = 3 that is
// 31 MB, ~9 us at 3.35 TB/s. The arithmetic (~40 flops + 2C per tap-corner
// per voxel) is far below the card's f32 rate, so the bound is bytes.
// Design against it (an earlier version staged 4-plane tiles element by
// element, with a division per element, and ran at 23% of the bound):
// - Z-march. A block owns TY rows of 32 outputs (a warp per row, or per two
//   rows at halo 1) over a run of z-planes, and keeps a ring of 2h + 3 staged
//   planes of the volume (its rows and columns plus an h-voxel halo) in
//   shared memory. While it computes plane z, the copies of the planes that
//   z + 1 and z + 2 need are in flight, so the z halo is read once per run,
//   not once per 4 planes. One barrier per plane; the outputs of plane z go
//   out after the next plane's barrier, from the other of two buffers.
// - 16-byte cp.async row copies. Each staged (x, c) row is a contiguous run
//   of floats, described once per block; a warp copies it with 16-byte
//   cp.async where global and shared addresses agree modulo 16 bytes (every
//   row, when W * C is a multiple of 4), and 4-byte copies at the ends and
//   otherwise. Only voxels inside the volume are staged. No index is
//   clamped or divided per voxel: the ring starts zeroed, and a corner
//   outside the volume (only ever an upper corner of weight exactly 0)
//   reads that zero or a staged value, finite either way.
// - The shifts of an output row (32 * 3 floats) arrive the same way, and the
//   outputs go out through shared memory as 16-byte stores.
// - A warp's 32 corner reads are consecutive voxels (float4 for C = 4,
//   float2 for C = 2, stride-3 floats for C = 3), which hit distinct banks.
// - The grid (FwdTile) was sized by timing variants on an H100: the time of
//   a launch follows the warps an SM holds, against the z halo of short runs.
// nvcc -Xptxas -v: at halo 1, C = 3, 80 registers and 72 KB of shared
// memory, 3 blocks of 256 threads on an SM; at halo 2, C = 1, 64 registers
// and 88 KB, 2 blocks of 512 threads. No spills.
// Measured on an H100 (PERF.md, section 6, row 1): at (1, 80, 96, 112, 3),
// halo 1, 0.0317 ms, 29% of the byte bound; one elementwise op that moves
// the same bytes, timed alike from an L2 full of dirty lines, takes 0.0166
// ms (56%).

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TX = 32;  // voxels of a block row: one warp
constexpr int kMaxSmemBytes = 227 * 1024;

constexpr int round4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return imin(imax(v, lo), hi); }

// derivative of max(0, 1 - |t|): -sign(t) where |t| < 1, else 0 (0 at t = 0)
__device__ __forceinline__ float dtri(float t) {
  return fabsf(t) < 1.f ? (t > 0.f ? -1.f : (t < 0.f ? 1.f : 0.f)) : 0.f;
}

// The tier word of a predicated launch (ops/warp.py launches every branch
// of the tiered warp with the same device word, JAX's lax.switch index):
// the kernel runs only where the word names `serve`, or unconditionally
// when there is no word. Read before any staging or barrier, so a branch
// that is not taken returns at once and writes nothing. One thread of the
// first block counts the launches that ran in `worked` (if not null).
__device__ __forceinline__ bool selected(const int* tier, int serve, int* worked) {
  if (tier != nullptr && *tier != serve) return false;
  if (worked != nullptr && (blockIdx.x | blockIdx.y | blockIdx.z) == 0 &&
      (threadIdx.x | threadIdx.y) == 0)
    atomicAdd(worked, 1);
  return true;
}

// Offset (in floats) of a staged row's first voxel inside its shared row:
// the global address of the row's first voxel modulo 16 bytes, so that the
// row copies 16 bytes at a time; for C = 2 and 4 rounded down to a multiple
// of C, so that each voxel's channels load as one float2 or float4 (a row
// whose global address does not allow both is copied 4 bytes at a time).
template <int C>
__device__ __forceinline__ int row_offset(const float* base, long long first) {
  const int s = (int)(((uintptr_t)base >> 2) + (uintptr_t)first) & 3;
  return C == 4 ? 0 : (C == 2 ? s & 2 : s);
}

// Copy floats [0, n) of src to dst with cp.async, one lane of a warp each:
// 16 bytes at a time where both addresses agree modulo 16, 4 at the ends.
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n, int lane) {
  int head = n, body = 0;
  if ((((uintptr_t)src ^ (uintptr_t)dst) & 15) == 0) {
    head = (int)((16 - ((uintptr_t)src & 15)) & 15) / 4;
    head = head < n ? head : n;
    body = (n - head) / 4;
  }
  const int items = n - 3 * body;  // head, body chunks and tail
  for (int i = lane; i < items; i += 32) {
    if (i >= head && i < head + body) {
      const int o = head + 4 * (i - head);
      __pipeline_memcpy_async(dst + o, src + o, 16);
    } else {
      const int o = i < head ? i : i + 3 * body;
      __pipeline_memcpy_async(dst + o, src + o, 4);
    }
  }
}

// Store floats [0, n) of src (shared) to dst (global), one lane of a warp
// each: 16 bytes at a time where both addresses agree modulo 16.
__device__ __forceinline__ void store_row(float* dst, const float* src, int n, int lane) {
  int head = n, body = 0;
  if ((((uintptr_t)src ^ (uintptr_t)dst) & 15) == 0) {
    head = (int)((16 - ((uintptr_t)dst & 15)) & 15) / 4;
    head = head < n ? head : n;
    body = (n - head) / 4;
  }
  const int items = n - 3 * body;
  for (int i = lane; i < items; i += 32) {
    if (i >= head && i < head + body) {
      const int o = head + 4 * (i - head);
      *reinterpret_cast<float4*>(dst + o) = *reinterpret_cast<const float4*>(src + o);
    } else {
      const int o = i < head ? i : i + 3 * body;
      dst[o] = src[o];
    }
  }
}

// index of the lowest set bit of a nonzero mask
__device__ __forceinline__ int lowest_bit(unsigned m) { return __ffs((int)m) - 1; }
__device__ __forceinline__ int lowest_bit(unsigned long long m) {
  return __ffsll((long long)m) - 1;
}

// a voxel's C channels from shared memory (aligned by row_offset)
template <int C>
__device__ __forceinline__ void load_voxel(const float* p, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = p[c];
  }
}

// Runs of z-planes: run_len planes each (the last one ragged), as many runs
// as fill Tile::kWaves waves of the blocks the card holds at once
// (`resident`) without starting another, and no run shorter than
// Tile::kMinRun planes. Returns the number of runs.
template <class Tile>
int plan_runs(int B, int D, int H, int W, int resident, int* run_len) {
  const long long xy = (long long)B * ((H + Tile::TY - 1) / Tile::TY) * ((W + TX - 1) / TX);
  const long long fill = (long long)Tile::kWaves * resident / xy;
  const long long want = fill > 1 ? fill : 1;
  int len = (int)((D + want - 1) / want);
  len = len > Tile::kMinRun ? len : Tile::kMinRun;
  *run_len = len;
  return (D + len - 1) / len;
}

// The blocks of `kernel` (of `threads` threads and `smem` bytes of dynamic
// shared memory) that the current device holds at once, after raising the
// kernel's shared-memory limit to `smem`. 0 and the error if that fails.
// `cache` (one slot per device, zero until the first launch there) keeps
// the answer, so that only a kernel's first launch on a device asks the CUDA
// runtime: a tiered warp launches every branch's kernel each time.
constexpr int kMaxDevices = 64;

template <class K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int* blocks,
                            int (&cache)[kMaxDevices]) {
  *blocks = 0;
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && cache[device] > 0) {
    *blocks = cache[device];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) {
    *blocks = sms * per_sm;
    if (device < kMaxDevices) cache[device] = *blocks;
  }
  return err;
}

// The slot of the ring of R planes that holds plane zc + k, for a plane zc
// in slot zc_slot and |k| < R.
template <int R>
__device__ __forceinline__ int ring_slot(int zc_slot, int k) {
  int s = zc_slot + k;
  s += s < 0 ? R : 0;
  return s >= R ? s - R : s;
}

// A row copy: `n` floats from `src` floats past the start of a global plane
// to `dst` floats past the start of a shared slot; kind says which array.
// Each block describes its rows once, in shared memory.
struct RowTask {
  int src, dst, n, kind;
};

// Shared memory of the forward kernel, in floats: a ring of R volume planes
// (EY rows of VP floats and one row more), S shift planes (TY rows of SP
// floats), two output planes (TY rows of OP floats), the row tasks.
// A volume row holds the voxels of columns bx .. bx + EX at offset voff,
// the last one (x0 + TX + HALO) never staged.
// The block and run sizes were chosen by timing variants on an H100 at the
// main path's shapes (PERF.md, section 6): at halo 1, 8 warps of 2 rows,
// three blocks on each SM and runs of at least 4 planes; at larger halos,
// whose z halo costs more, 16 warps of 1 row (2 rows for one channel, whose
// voxels take the least work) and runs of at least 8.
template <int C, int HALO>
struct FwdTile {
  static constexpr int WARPS = HALO == 1 ? 8 : 16;       // a block's warps
  static constexpr int V = HALO == 1 || C == 1 ? 2 : 1;  // rows of a warp, WARPS apart
  static constexpr int TY = WARPS * V;
  static constexpr int kMinBlocksPerSM = HALO == 1 ? 3 : 2;
  static constexpr int kWaves = 1;
  static constexpr int kMinRun = HALO == 1 ? 4 : 8;
  static constexpr int S = 3;  // planes whose copies are in flight, plus one
  static constexpr int R = 2 * HALO + S;
  static constexpr int EY = TY + 2 * HALO, EX = TX + 2 * HALO;
  static constexpr int VP = round4((EX + 1) * C + 3);
  static constexpr int SP = round4(TX * 3) + 4;
  static constexpr int OP = round4(TX * C) + 4;
  static constexpr int kSlot = (EY + 1) * VP;
  static constexpr int kVol = R * kSlot;  // zeroed at the start
  static constexpr int kShift = kVol + S * TY * SP;
  static constexpr int kOut = kShift + 2 * TY * OP;
  static constexpr int kTasks = EY + TY;
  static constexpr int kBytes = 4 * (kOut + 4 * kTasks);
  static_assert(kBytes <= kMaxSmemBytes, "forward tile exceeds shared memory");
};

template <int C, int HALO>
__global__ void __launch_bounds__(TX * FwdTile<C, HALO>::WARPS,
                                  FwdTile<C, HALO>::kMinBlocksPerSM)
warp_bounded_fwd_kernel(const float* __restrict__ vol,
                        const float* __restrict__ shift,
                        float* __restrict__ out, int D, int H, int W, int runs,
                        int run_len, const int* tier, int serve, int* worked) {
  if (!selected(tier, serve, worked)) return;
  using T = FwdTile<C, HALO>;
  constexpr int R = T::R, S = T::S, EY = T::EY, VP = T::VP, TY = T::TY, NW = T::WARPS;
  extern __shared__ __align__(16) float tile[];
  float* const sring = tile + T::kVol;
  float* const obuf = tile + T::kShift;
  RowTask* const tasks = reinterpret_cast<RowTask*>(tile + T::kOut);
  const int lane = threadIdx.x, row = threadIdx.y, tid = row * TX + lane;
  const int b = blockIdx.z / runs;
  const int z0 = (blockIdx.z % runs) * run_len;
  const int z1 = imin(z0 + run_len, D);
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int bx = x0 - HALO, by = y0 - HALO;  // the box's first column and row
  const int xe = imin(x0 + TX, W), ye = imin(y0 + TY, H);  // the outputs' end
  const int rowf = W * C;                                  // floats of a row
  const long long planef = (long long)H * rowf, planes = (long long)H * W * 3;
  const float* volb = vol + (long long)b * D * planef;
  const float* shiftb = shift + (long long)b * D * planes;
  float* outb = out + (long long)b * D * planef;
  const int voff = row_offset<C>(volb, (long long)bx * C);
  const int soff = row_offset<1>(shiftb, (long long)x0 * 3);
  const int first = z0 - HALO, last = z1 - 1 + HALO;  // incoming planes

  // Zero the volume ring: the voxels of the box outside the volume are
  // never staged, and only corners of weight exactly 0 read them. Describe
  // the rows: the box's rows inside the volume, then the output rows' shifts.
  for (int i = tid; i < T::kVol / 4; i += TX * NW)
    reinterpret_cast<float4*>(tile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < T::kTasks; i += TX * NW) {
    RowTask t{0, 0, 0, 0};
    if (i < EY) {
      const int y = by + i, xa = imax(bx, 0), xb = imin(x0 + TX + HALO, W);
      if (y >= 0 && y < H)
        t = {y * rowf + xa * C, i * VP + voff + (xa - bx) * C, (xb - xa) * C, 0};
    } else if (y0 + i - EY < ye) {
      const int r = i - EY;
      t = {((y0 + r) * W + x0) * 3, r * T::SP + soff, (xe - x0) * 3, 1};
    }
    tasks[i] = t;
  }
  __syncthreads();

  // Stage the volume plane p and the shift plane p - HALO (the outputs of
  // the iteration that receives p); one cp.async group per p.
  auto stage = [&](int p) {
    const int q = p - HALO;
    const bool vin = p <= last && p >= 0 && p < D, sin = q >= z0 && q < z1;
    for (int i = row; i < T::kTasks; i += NW) {
      const RowTask t = tasks[i];
      if (t.n == 0) continue;
      if (t.kind == 0 && vin)
        copy_row(tile + (p - first) % R * T::kSlot + t.dst, volb + p * planef + t.src, t.n, lane);
      else if (t.kind == 1 && sin)
        copy_row(sring + (q - z0) % S * TY * T::SP + t.dst, shiftb + q * planes + t.src, t.n,
                 lane);
    }
    __pipeline_commit();
  };
  // The outputs of plane z, from the output buffer of parity z.
  auto store = [&](int z) {
#pragma unroll
    for (int u = 0; u < T::V; ++u) {
      const int r = row + u * NW, y = y0 + r;
      if (y >= ye) return;
      const long long v = ((long long)z * H + y) * W + x0;
      store_row(outb + v * C, obuf + ((z & 1) * TY + r) * T::OP + row_offset<1>(outb, v * C),
                (xe - x0) * C, lane);
    }
  };

  for (int k = 0; k < S - 1; ++k) stage(first + k);
  const int x = x0 + lane;
  const float fx = (float)x;
  for (int pin = first; pin <= last; ++pin) {
    __pipeline_wait_prior(S - 2);
    __syncthreads();
    stage(pin + S - 1);
    const int z = pin - HALO;
    if (z - 1 >= z0) store(z - 1);
    if (z < z0 || x >= W) continue;
    const float fz = (float)z;
    const int zc = (z - first) % R;
    // V rows at once, all in registers before any result is written, so
    // that their loads and arithmetic interleave; a row past the volume is
    // computed from unstaged shifts and never stored
    float acc[T::V][C];
#pragma unroll
    for (int u = 0; u < T::V; ++u) {
      const int r = row + u * NW;
      const float fy = (float)(y0 + r);
      const float* s = sring + ((z - z0) % S * TY + r) * T::SP + soff + lane * 3;
      const float dz = fminf(fmaxf(fz + s[0], 0.f), (float)(D - 1)) - fz;
      const float dy = fminf(fmaxf(fy + s[1], 0.f), (float)(H - 1)) - fy;
      const float dx = fminf(fmaxf(fx + s[2], 0.f), (float)(W - 1)) - fx;
      const float oz = floorf(dz), oy = floorf(dy), ox = floorf(dx);
      const float wz[2] = {fmaxf(0.f, 1.f - fabsf(dz - oz)),
                           fmaxf(0.f, 1.f - fabsf(dz - (oz + 1.f)))};
      const float wy[2] = {fmaxf(0.f, 1.f - fabsf(dy - oy)),
                           fmaxf(0.f, 1.f - fabsf(dy - (oy + 1.f)))};
      const float wx[2] = {fmaxf(0.f, 1.f - fabsf(dx - ox)),
                           fmaxf(0.f, 1.f - fabsf(dx - (ox + 1.f)))};
      // The lower corner lies in the volume and the upper one too, or else
      // on the zeroed pad or a staged plane with weight exactly 0. Clamping
      // the floors (a no-op for |shift| <= h) keeps every read in the tile.
      const int kz = clampi((int)oz, -HALO, HALO), ky = clampi((int)oy, -HALO, HALO);
      const int kx = clampi((int)ox, -HALO, HALO);
      const int s0 = ring_slot<R>(zc, kz), s1 = ring_slot<R>(s0, 1);
      const int in = (r + HALO + ky) * VP + voff + (lane + HALO + kx) * C;
      const float* const cz[2] = {tile + s0 * T::kSlot + in, tile + s1 * T::kSlot + in};
#pragma unroll
      for (int c = 0; c < C; ++c) acc[u][c] = 0.f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const float wzy = __fmul_rn(wz[a], wy[bb]);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float w = __fmul_rn(wzy, wx[k]);
            float v[C];
            load_voxel<C>(cz[a] + bb * VP + k * C, v);
#pragma unroll
            for (int c = 0; c < C; ++c) acc[u][c] = __fadd_rn(acc[u][c], __fmul_rn(v[c], w));
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < T::V; ++u) {
      const int r = row + u * NW;
      float* const orow = obuf + ((z & 1) * TY + r) * T::OP +
                          row_offset<1>(outb, (((long long)z * H + y0 + r) * W + x0) * C);
#pragma unroll
      for (int c = 0; c < C; ++c) orow[lane * C + c] = acc[u][c];
    }
  }
  __syncthreads();
  store(z1 - 1);
}

template <int C, int HALO>
cudaError_t launch(const float* vol, const float* shift, float* out, int B,
                   int D, int H, int W, const int* tier, int serve, int* worked,
                   cudaStream_t stream) {
  using T = FwdTile<C, HALO>;
  const int smem = T::kBytes;
  static int cache[kMaxDevices];
  int resident, run_len;
  const cudaError_t err =
      resident_blocks(warp_bounded_fwd_kernel<C, HALO>, TX * T::WARPS, smem, &resident, cache);
  if (err != cudaSuccess) return err;
  const int runs = plan_runs<T>(B, D, H, W, resident, &run_len);
  if ((long long)B * runs > 65535 || (H + T::TY - 1) / T::TY > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((W + TX - 1) / TX, (H + T::TY - 1) / T::TY, B * runs);
  const dim3 block(TX, T::WARPS);
  warp_bounded_fwd_kernel<C, HALO><<<grid, block, smem, stream>>>(
      vol, shift, out, D, H, W, runs, run_len, tier, serve, worked);
  return cudaGetLastError();
}

// BACKWARD. Replaces the Pallas TPU kernels that compute the VJP of the
// bounded warp: _bwd_kernel (via _bwd_impl_pallas), _bwd_kernel_2d (via
// _bwd_impl_pallas_2d) and _v5_dshift_kernel / _v5_dvol_kernel (via
// _bwd_impl_v5, whose TPU gradients are wrong and which is never a
// reference). Given the cotangent g of out, it computes the reference
// formulation (_warp_cf_bwd_ref; plain version warp_bounded_bwd_plain):
//
//   dvol[u]     = sum_o w_o(u - o) * g(u - o)            (zero where u - o
//                                                           is outside)
//   dshift_a(x) = [0 < x_a + shift_a < dim_a - 1]
//                 * sum_o dw_o/dd_a(x) * <vol[x + o], g(x)>
//
// with w_o(p) = prod_d tri(d_d(p) - o_d), tri(t) = max(0, 1 - |t|) and
// dtri(t) = -sign(t) for |t| < 1, else 0. The strict interior mask gives a
// zero dshift where x + shift lies exactly on 0 or dim - 1, as the Pallas
// kernel does (autograd of the plain forward would pass a gradient there).
//
// dvol is a gather at the flipped offset, so every output is written by one
// thread and there are no atomics: two launches give bit-equal results.
//
// Bound: the function reads vol, shift and g once and writes dvol and dshift
// once, (3C + 6) * 4 bytes per voxel: 51.6 MB at (80, 96, 112), C = 3, about
// 15 us at 3.35 TB/s; its arithmetic is far below the f32 rate, so the bound
// is bytes. An earlier version staged twice with a division per element
// and evaluated the clamp and tent weight of all (2h + 1)^3 sources of every
// output (27 at h = 1, 729 at h = 4), at 7% of the bound. This one:
// - marches in z like the forward (one warp per output row, a ring of 2h + 2
//   planes) and stages each plane once, by cp.async row copies: shift, g and
//   vol of the box (tile plus h-voxel halo);
// - converts each staged plane once into struct-of-arrays form: the clamped
//   displacement d(p) (three float arrays), and one word q(p) holding the
//   lower corner floor(d(p)) as three biased bytes, a byte of "outside the
//   volume" and the interior mask of p;
// - tests the sources of an output u with integers: p = u - o reaches u
//   only if o - floor(d(p)) is in {0, 1}^3, which is one subtraction and one
//   mask of q(p) against a pattern of o. The tests set bits of a mask (one
//   for all 27 or 125 offsets up to h = 2, one per plane of offsets above),
//   and the thread then visits only the set bits, lowest first, which is
//   the plain version's order; so the tent weights are evaluated, with the
//   plain version's expressions, only for the sources that reach u (8 on
//   average), and the lanes of a warp run the same loop however the
//   sources that reach them differ;
// - computes dshift from the same staged vol, g and d, with no second read,
//   its corners addressed without clamps as in the forward.
// What is left: the (2h + 1)^3 tests per output (27 at h = 1, 125 at h = 2),
// and, where neighbouring outputs are reached by different numbers of
// sources (random shifts; a smooth field is the opposite), a warp that runs
// its loop as often as its busiest lane.
// nvcc -Xptxas -v: at halo 1, C = 3, 80 registers and 72 KB of shared
// memory, 3 blocks of 256 threads on an SM; at halo 2, C = 1, 80 registers
// and 79 KB, 2 blocks. No spills.
// Measured on an H100 (PERF.md, section 6, row 4): at (1, 80, 96, 112, 3),
// halo 1, 0.109 ms, 14% of the byte bound, on random shifts and on smooth
// ones alike.
// Terms it skips are exact zeros, so both outputs equal the plain version.

template <int C, int HALO>
struct BwdLayout {
  static constexpr int S = 2;
  static constexpr int R = 2 * HALO + S;
  static constexpr int EX = TX + 2 * HALO;
  static constexpr int CP = round4(EX * C) + 4;          // g row pitch
  static constexpr int VP = round4((EX + 1) * C + 3);    // vol row pitch
  static constexpr int SP = round4(EX * 3) + 4;          // staged shift row pitch
  static constexpr int OP = round4(TX * C) + 4;          // dvol row pitch
  static constexpr int DP = round4(TX * 3) + 4;          // dshift row pitch
  static constexpr int bytes(int ty) {
    return 4 * (R * ((ey(ty) + 1) * VP + round4(ey(ty) * EX) * 4 + ey(ty) * CP) +
                S * ey(ty) * SP + ty * (OP + DP) + 4 * 3 * ey(ty));
  }
  static constexpr int ey(int ty) { return ty + 2 * HALO; }
  // Rows per block: 8 where two blocks fit on an SM, else the most that fit.
  static constexpr int ty() {
    return bytes(8) <= kMaxSmemBytes / 2 ? 8
           : bytes(4) <= kMaxSmemBytes / 2 ? 4
           : bytes(8) <= kMaxSmemBytes ? 8
           : bytes(4) <= kMaxSmemBytes ? 4 : 2;
  }
};

// Shared memory of the backward kernel, in floats: rings of R planes of
// vol (zeroed at the start, as in the forward), q, d (three arrays) and g;
// S planes of staged shift; a plane of dvol and dshift; the row tasks.
template <int C, int HALO>
struct BwdTile : BwdLayout<C, HALO> {
  using L = BwdLayout<C, HALO>;
  static constexpr int TY = L::ty();
  // three waves of shorter runs, which the block scheduler spreads over the
  // SMs as blocks finish (timed against one, two and four waves on an H100)
  static constexpr int kWaves = 3;
  // the blocks whose shared memory an SM holds (228 KB, 1 KB of it
  // reserved for each block), up to 3; registers are capped to match
  static constexpr int kMinBlocks = 3 * (L::bytes(TY) + 1024) <= 228 * 1024   ? 3
                                    : 2 * (L::bytes(TY) + 1024) <= 228 * 1024 ? 2
                                                                               : 1;
  static constexpr int kMinRun = 4;
  static constexpr int EY = TY + 2 * HALO;
  static constexpr int N = round4(EY * L::EX);  // voxels of a q or d plane
  static constexpr int kVSlot = (EY + 1) * L::VP;
  static constexpr int kQ = L::R * kVSlot;      // offsets: q, d, g, shift, out, tasks
  static constexpr int kD = kQ + L::R * N;
  static constexpr int kG = kD + L::R * 3 * N;
  static constexpr int kShift = kG + L::R * EY * L::CP;
  static constexpr int kOut = kShift + L::S * EY * L::SP;
  static constexpr int kTasks = kOut + TY * (L::OP + L::DP);
  static constexpr int kBytes = L::bytes(TY);
  static_assert(kBytes <= kMaxSmemBytes, "backward tile exceeds shared memory");
  static_assert(4 * (kTasks + 4 * 3 * EY) == kBytes, "layout and size disagree");
  // q(p): bytes 0-2 floor(d_x), floor(d_y), floor(d_z) + HALO + 1, byte 3
  // the interior mask (bits 0, 1, 2 for axis z, y, x); outside the volume
  // q is kOutside. The pattern of offset o has bytes o_a + HALO + 1 + kBias:
  // for a source inside, pattern - q has bytes o_a - floor(d_a) + kBias,
  // none negative, and matches kTarget under kMask exactly when each
  // o_a - floor(d_a) is 0 or 1 (kBias is even); for one outside, byte 2 is
  // at least 0x80.
  static constexpr int kBias = 2 * HALO + 2;
  static constexpr unsigned kMask = 0x00FEFEFEu;
  static constexpr unsigned kTarget = 0x00010101u * kBias;
  static constexpr unsigned kOutside = 0x00800000u;
  // offsets o in [-HALO, HALO]^3, in groups of PG planes of oz (all of them
  // up to HALO = 2): the mask of a group has NB bits in NW words,
  // bit (j K + iy) K + ix for o = (gz + j, iy, ix) - HALO
  static constexpr int K = 2 * HALO + 1;
  static constexpr int PG = K * K * K <= 128 ? K : 1;
  static constexpr int NB = PG * K * K;
  using Mask = std::conditional_t<(NB <= 32), unsigned, unsigned long long>;
  static constexpr int kMaskBits = 8 * sizeof(Mask);
  static constexpr int NW = (NB + kMaskBits - 1) / kMaskBits;
};

template <int C, int HALO>
__global__ void __launch_bounds__(TX * BwdTile<C, HALO>::TY, BwdTile<C, HALO>::kMinBlocks)
warp_bounded_bwd_kernel(const float* __restrict__ vol,
                        const float* __restrict__ shift,
                        const float* __restrict__ g,
                        float* __restrict__ dvol, float* __restrict__ dshift,
                        int D, int H, int W, int runs, int run_len,
                        const int* tier, int serve, int* worked) {
  if (!selected(tier, serve, worked)) return;
  using T = BwdTile<C, HALO>;
  constexpr int R = T::R, S = T::S, EX = T::EX, EY = T::EY, N = T::N, TY = T::TY;
  constexpr int CP = T::CP, VP = T::VP, SP = T::SP, K = T::K;
  extern __shared__ __align__(16) float tile[];
  unsigned* const qring = reinterpret_cast<unsigned*>(tile + T::kQ);
  float* const dring = tile + T::kD;
  float* const gring = tile + T::kG;
  float* const sring = tile + T::kShift;
  float* const obuf = tile + T::kOut;      // a plane of dvol rows
  float* const dsbuf = obuf + TY * T::OP;  // and of dshift rows
  RowTask* const tasks = reinterpret_cast<RowTask*>(tile + T::kTasks);
  const int lane = threadIdx.x, row = threadIdx.y, tid = row * TX + lane;
  const int b = blockIdx.z / runs;
  const int z0 = (blockIdx.z % runs) * run_len;
  const int z1 = imin(z0 + run_len, D);
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int bx = x0 - HALO, by = y0 - HALO;
  const int xe = imin(x0 + TX, W), ye = imin(y0 + TY, H);
  const int rowf = W * C;
  const long long planef = (long long)H * rowf, planes = (long long)H * W * 3;
  const float* volb = vol + (long long)b * D * planef;
  const float* gb = g + (long long)b * D * planef;
  const float* shiftb = shift + (long long)b * D * planes;
  float* dvolb = dvol + (long long)b * D * planef;
  float* dshiftb = dshift + (long long)b * D * planes;
  const int voff = row_offset<C>(volb, (long long)bx * C);
  const int goff = row_offset<C>(gb, (long long)bx * C);
  const int soff = row_offset<1>(shiftb, (long long)bx * 3);
  const int first = z0 - HALO, last = z1 - 1 + HALO;

  for (int i = tid; i < T::kQ / 4; i += TX * TY)
    reinterpret_cast<float4*>(tile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // row tasks: the box's rows inside the volume, of shift, g and vol
  if (tid < 3 * EY) {
    const int kind = tid / EY, r = tid % EY, y = by + r;
    const int xa = imax(bx, 0), xb = imin(x0 + TX + HALO, W);
    RowTask t{0, 0, 0, kind};
    if (y >= 0 && y < H) {
      if (kind == 0) t = {(y * W + xa) * 3, r * SP + soff + (xa - bx) * 3, (xb - xa) * 3, 0};
      else if (kind == 1) t = {y * rowf + xa * C, r * CP + goff + (xa - bx) * C, (xb - xa) * C, 1};
      else t = {y * rowf + xa * C, r * VP + voff + (xa - bx) * C, (xb - xa) * C, 2};
    }
    tasks[tid] = t;
  }
  __syncthreads();

  // Stage shift, g and vol of plane p; one cp.async group per p.
  auto stage = [&](int p) {
    if (p <= last && p >= 0 && p < D) {
      const int sl = (p - first) % R;
      for (int i = row; i < 3 * EY; i += TY) {
        const RowTask t = tasks[i];
        if (t.n == 0) continue;
        if (t.kind == 0)
          copy_row(sring + (p - first) % S * EY * SP + t.dst, shiftb + p * planes + t.src, t.n,
                   lane);
        else if (t.kind == 1)
          copy_row(gring + sl * EY * CP + t.dst, gb + p * planef + t.src, t.n, lane);
        else
          copy_row(tile + sl * T::kVSlot + t.dst, volb + p * planef + t.src, t.n, lane);
      }
    }
    __pipeline_commit();
  };
  // dvol and dshift of plane z, from the output buffers
  auto store = [&](int z) {
    const int y = y0 + row;
    if (y >= ye) return;
    const long long v = ((long long)z * H + y) * W + x0;
    store_row(dvolb + v * C, obuf + row * T::OP + row_offset<1>(dvolb, v * C), (xe - x0) * C,
              lane);
    store_row(dshiftb + v * 3, dsbuf + row * T::DP + row_offset<1>(dshiftb, v * 3),
              (xe - x0) * 3, lane);
  };

  for (int k = 0; k < S - 1; ++k) stage(first + k);
  const int x = x0 + lane, y = y0 + row;
  const bool active = x < W && y < H;
  const int center = (row + HALO) * EX + lane + HALO;  // this thread's box voxel
  for (int pin = first; pin <= last; ++pin) {
    __pipeline_wait_prior(S - 2);
    __syncthreads();
    stage(pin + S - 1);
    const int z = pin - HALO;

    // Convert plane pin: d and q of every box voxel.
    {
      const int sl = (pin - first) % R;
      unsigned* const q = qring + sl * N;
      float* const d = dring + sl * 3 * N;
      const float* const s = sring + (pin - first) % S * EY * SP + soff;
      const bool plane_in = pin >= 0 && pin < D;
      const float fz = (float)pin;
      for (int r = row; r < EY; r += TY) {
        const int py = by + r;
        const bool row_in = plane_in && py >= 0 && py < H;
        const float fy = (float)py;
        for (int rx = lane; rx < EX; rx += 32) {
          const int px = bx + rx;
          unsigned qv = T::kOutside;
          if (row_in && px >= 0 && px < W) {
            const float* sv = s + r * SP + rx * 3;
            const float fx = (float)px;
            const float az = fz + sv[0], ay = fy + sv[1], ax = fx + sv[2];
            const float dz = fminf(fmaxf(az, 0.f), (float)(D - 1)) - fz;
            const float dy = fminf(fmaxf(ay, 0.f), (float)(H - 1)) - fy;
            const float dx = fminf(fmaxf(ax, 0.f), (float)(W - 1)) - fx;
            const int v = r * EX + rx;
            d[v] = dz;
            d[N + v] = dy;
            d[2 * N + v] = dx;
            // floors clamped to [-HALO - 1, HALO] keep every byte of
            // pattern - q in range for a caller that breaks |shift| <= h
            const unsigned fqz = clampi((int)floorf(dz), -HALO - 1, HALO) + HALO + 1;
            const unsigned fqy = clampi((int)floorf(dy), -HALO - 1, HALO) + HALO + 1;
            const unsigned fqx = clampi((int)floorf(dx), -HALO - 1, HALO) + HALO + 1;
            const unsigned in = (az > 0.f && az < (float)(D - 1) ? 1u : 0u) |
                                (ay > 0.f && ay < (float)(H - 1) ? 2u : 0u) |
                                (ax > 0.f && ax < (float)(W - 1) ? 4u : 0u);
            qv = fqx | fqy << 8 | fqz << 16 | in << 24;
          }
          q[r * EX + rx] = qv;
        }
      }
    }
    __syncthreads();
    if (z >= z0 && active) {
      const int zc = (z - first) % R;  // slot of plane z

      // dvol: the sources p = u - o of u in the plain version's order of o
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll 1
      for (int gz = 0; gz < K; gz += T::PG) {
        typename T::Mask m[T::NW];
#pragma unroll
        for (int w = 0; w < T::NW; ++w) m[w] = 0;
#pragma unroll
        for (int j = 0; j < T::PG; ++j) {
          const int oz = gz + j - HALO;
          const unsigned* qs = qring + ring_slot<R>(zc, -oz) * N + center;
          const unsigned pz = (unsigned)(oz + HALO + 1 + T::kBias) << 16;
#pragma unroll
          for (int iy = 0; iy < K; ++iy) {
#pragma unroll
            for (int ix = 0; ix < K; ++ix) {
              const int bit = (j * K + iy) * K + ix;
              const unsigned pat = pz | (unsigned)(iy + 1 + T::kBias) << 8 |
                                   (unsigned)(ix + 1 + T::kBias);
              const unsigned qv = qs[-(iy - HALO) * EX - (ix - HALO)];
              if (((pat - qv) & T::kMask) == T::kTarget)
                m[bit / T::kMaskBits] |= (typename T::Mask)1 << (bit % T::kMaskBits);
            }
          }
        }
#pragma unroll
        for (int w = 0; w < T::NW; ++w) {
          typename T::Mask mw = m[w];
          while (mw) {
            const int bit = w * T::kMaskBits + lowest_bit(mw);
            mw &= mw - 1;
            const int j = bit / (K * K), r = bit - j * (K * K), iy = r / K;
            const int oz = gz + j - HALO, oy = iy - HALO, ox = r - iy * K - HALO;
            const int sl = ring_slot<R>(zc, -oz);
            const float* dp = dring + sl * 3 * N + center - oy * EX - ox;
            const float wz = fmaxf(0.f, 1.f - fabsf(dp[0] - (float)oz));
            const float wy = fmaxf(0.f, 1.f - fabsf(dp[N] - (float)oy));
            const float wx = fmaxf(0.f, 1.f - fabsf(dp[2 * N] - (float)ox));
            const float wt = __fmul_rn(__fmul_rn(wz, wy), wx);
            float gv[C];
            load_voxel<C>(gring + (sl * EY + row + HALO - oy) * CP + goff + (lane + HALO - ox) * C,
                          gv);
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(wt, gv[c]));
          }
        }
      }
      float* const orow = obuf + row * T::OP +
                          row_offset<1>(dvolb, (((long long)z * H + y) * W + x0) * C);
#pragma unroll
      for (int c = 0; c < C; ++c) orow[lane * C + c] = acc[c];

      // dshift: the 8 taps of this voxel's own displacement
      const float* dp = dring + zc * 3 * N + center;
      const float dz = dp[0], dy = dp[N], dx = dp[2 * N];
      const unsigned in = qring[zc * N + center] >> 24;
      float gx[C];
      load_voxel<C>(gring + (zc * EY + row + HALO) * CP + goff + (lane + HALO) * C, gx);
      const float oz = floorf(dz), oy = floorf(dy), ox = floorf(dx);
      float wz[2], wy[2], wx[2], dwz[2], dwy[2], dwx[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float rz = dz - (oz + (float)k);
        const float ry = dy - (oy + (float)k);
        const float rx = dx - (ox + (float)k);
        wz[k] = fmaxf(0.f, 1.f - fabsf(rz));
        wy[k] = fmaxf(0.f, 1.f - fabsf(ry));
        wx[k] = fmaxf(0.f, 1.f - fabsf(rx));
        dwz[k] = dtri(rz);
        dwy[k] = dtri(ry);
        dwx[k] = dtri(rx);
      }
      // corners as in the forward: the upper ones outside the volume read the
      // zeroed pad or a staged plane, with weight and derivative exactly 0
      const int kz = clampi((int)oz, -HALO, HALO), ky = clampi((int)oy, -HALO, HALO);
      const int kx = clampi((int)ox, -HALO, HALO);
      const int s0 = ring_slot<R>(zc, kz), s1 = ring_slot<R>(s0, 1);
      const int inb = (row + HALO + ky) * VP + voff + (lane + HALO + kx) * C;
      const float* const cz[2] = {tile + s0 * T::kVSlot + inb, tile + s1 * T::kVSlot + inb};
      float sz = 0.f, sy = 0.f, sx = 0.f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float t[C];
            load_voxel<C>(cz[a] + bb * VP + k * C, t);
            float gv = __fmul_rn(gx[0], t[0]);
#pragma unroll
            for (int c = 1; c < C; ++c) gv = __fadd_rn(gv, __fmul_rn(gx[c], t[c]));
            sz = __fadd_rn(sz, __fmul_rn(__fmul_rn(__fmul_rn(gv, dwz[a]), wy[bb]), wx[k]));
            sy = __fadd_rn(sy, __fmul_rn(__fmul_rn(__fmul_rn(gv, wz[a]), dwy[bb]), wx[k]));
            sx = __fadd_rn(sx, __fmul_rn(__fmul_rn(__fmul_rn(gv, wz[a]), wy[bb]), dwx[k]));
          }
        }
      }
      float* const srow = dsbuf + row * T::DP +
                          row_offset<1>(dshiftb, (((long long)z * H + y) * W + x0) * 3);
      srow[lane * 3 + 0] = (in & 1u) ? sz : 0.f;
      srow[lane * 3 + 1] = (in & 2u) ? sy : 0.f;
      srow[lane * 3 + 2] = (in & 4u) ? sx : 0.f;
    }
    __syncthreads();
    if (z >= z0) store(z);
  }
}

template <int C, int HALO>
cudaError_t launch_bwd(const float* vol, const float* shift, const float* g,
                       float* dvol, float* dshift, int B, int D, int H, int W,
                       const int* tier, int serve, int* worked, cudaStream_t stream) {
  using T = BwdTile<C, HALO>;
  const int smem = T::kBytes;
  static int cache[kMaxDevices];
  int resident, run_len;
  const cudaError_t err =
      resident_blocks(warp_bounded_bwd_kernel<C, HALO>, TX * T::TY, smem, &resident, cache);
  if (err != cudaSuccess) return err;
  const int runs = plan_runs<T>(B, D, H, W, resident, &run_len);
  if ((long long)B * runs > 65535 || (H + T::TY - 1) / T::TY > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((W + TX - 1) / TX, (H + T::TY - 1) / T::TY, B * runs);
  const dim3 block(TX, T::TY);
  warp_bounded_bwd_kernel<C, HALO><<<grid, block, smem, stream>>>(
      vol, shift, g, dvol, dshift, D, H, W, runs, run_len, tier, serve, worked);
  return cudaGetLastError();
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// f(Int<C>(), Int<h>()) for 1 <= C <= 4 and 1 <= h <= 4: the kernel
// instantiation of the shape
template <int c, class F>
cudaError_t dispatch_halo(int h, F f) {
  switch (h) {
    case 1: return f(Int<c>(), Int<1>());
    case 2: return f(Int<c>(), Int<2>());
    case 3: return f(Int<c>(), Int<3>());
    case 4: return f(Int<c>(), Int<4>());
    default: return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t dispatch(int C, int h, F f) {
  switch (C) {
    case 1: return dispatch_halo<1>(h, f);
    case 2: return dispatch_halo<2>(h, f);
    case 3: return dispatch_halo<3>(h, f);
    case 4: return dispatch_halo<4>(h, f);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int D, int H, int W, int C, int h) {
  return B < 1 || D < 1 || H < 1 || W < 1 || C < 1 || C > 4 || h < 1 || h > 4;
}

}  // namespace

// Plain C entry point for ctypes. Takes 1 <= C <= 4 channels and a halo
// 1 <= h <= 4, and refuses others. `tier` (a device int, or null to run
// unconditionally) and `serve`: the kernel runs only where *tier == serve;
// `worked` (a device int, or null) counts the launches that ran. Launches
// on `stream` and does not synchronise; returns the CUDA error of the
// launch (0 on success).
extern "C" int vxm_warp_bounded_fwd(const void* vol, const void* shift,
                                    void* out, int B, int D, int H, int W,
                                    int C, int h, const void* tier, int serve,
                                    void* worked, void* stream) {
  if (bad_shape(B, D, H, W, C, h)) return (int)cudaErrorInvalidValue;
  const float* v = static_cast<const float*>(vol);
  const float* s = static_cast<const float*>(shift);
  float* o = static_cast<float*>(out);
  const int* t = static_cast<const int*>(tier);
  int* wk = static_cast<int*>(worked);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(C, h, [&](auto c, auto hh) {
    return launch<decltype(c)::value, decltype(hh)::value>(v, s, o, B, D, H, W, t, serve, wk,
                                                           st);
  });
}


// Plain C entry point for ctypes: the VJP of vxm_warp_bounded_fwd. vol and
// g are (B, D, H, W, C), shift (B, D, H, W, 3), f32, contiguous; dvol and
// dshift have the shapes of vol and shift and are fully written. Takes the
// channels and halos of the forward, and its tier word. Launches on
// `stream` and does not synchronise; returns the CUDA error of the launch.
extern "C" int vxm_warp_bounded_bwd(const void* vol, const void* shift,
                                    const void* g, void* dvol, void* dshift,
                                    int B, int D, int H, int W, int C, int h,
                                    const void* tier, int serve, void* worked,
                                    void* stream) {
  if (bad_shape(B, D, H, W, C, h)) return (int)cudaErrorInvalidValue;
  const float* v = static_cast<const float*>(vol);
  const float* s = static_cast<const float*>(shift);
  const float* gg = static_cast<const float*>(g);
  float* dv = static_cast<float*>(dvol);
  float* ds = static_cast<float*>(dshift);
  const int* t = static_cast<const int*>(tier);
  int* wk = static_cast<int*>(worked);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(C, h, [&](auto c, auto hh) {
    return launch_bwd<decltype(c)::value, decltype(hh)::value>(v, s, gg, dv, ds, B, D, H, W, t,
                                                               serve, wk, st);
  });
}
