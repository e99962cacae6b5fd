// Bounded-displacement trilinear warp, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of voxelmorph_tpu/ops/pallas_interp.py that
// compute the bounded warp forward: _warp_kernel (via _warp_fwd_impl),
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
// contiguous; out (B, D, H, W, C). C <= 4.
//
// Bound: the function reads vol and shift once and writes out once, so it
// moves (C + 3 + C) * 4 bytes per voxel: at (80, 96, 112), C = 3 that is
// 31 MB, ~9 us at 3.35 TB/s. The arithmetic (~40 flops + 2C per tap-corner
// per voxel) is far below the card's f32 rate, so the bound is bytes.
// Design against it: one block stages its output tile (TZ x TY x TX voxels)
// plus an h-voxel halo of the volume in shared memory, with coalesced loads
// along the contiguous x*C run and edge-clamped indices (the edge padding is
// never materialised); each thread then reads its 8 corners from shared
// memory. The halo makes each volume byte come from L2 or DRAM more than once
// ((TZ+2h)(TY+2h)(TX+2h) / (TZ*TY*TX) = 2.0x at h=1, 3.4x at h=2), which is
// the first thing to cut when this kernel is made fast.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int TZ = 4;
constexpr int kMaxSmemBytes = 227 * 1024;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int C>
__global__ void __launch_bounds__(TX * TY)
warp_bounded_fwd_kernel(const float* __restrict__ vol,
                        const float* __restrict__ shift,
                        float* __restrict__ out, int D, int H, int W, int h,
                        int tiles_z) {
  extern __shared__ float tile[];
  const int b = blockIdx.z / tiles_z;
  const int z0 = (blockIdx.z % tiles_z) * TZ;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int ez = TZ + 2 * h, ey = TY + 2 * h, ex = TX + 2 * h;
  const long long batch_vox = (long long)b * D * H * W;
  const float* volb = vol + batch_vox * C;

  // Stage the tile and its halo; tile index (lz, ly, lx, c) holds
  // vol[clamp(z0 - h + lz), clamp(y0 - h + ly), clamp(x0 - h + lx), c].
  const int n = ez * ey * ex * C;
  for (int i = threadIdx.y * TX + threadIdx.x; i < n; i += TX * TY) {
    const int c = i % C;
    int r = i / C;
    const int lx = r % ex;
    r /= ex;
    const int ly = r % ey;
    const int lz = r / ey;
    const int gz = clampi(z0 - h + lz, 0, D - 1);
    const int gy = clampi(y0 - h + ly, 0, H - 1);
    const int gx = clampi(x0 - h + lx, 0, W - 1);
    tile[i] = volb[(((long long)gz * H + gy) * W + gx) * C + c];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float fx = (float)x, fy = (float)y;

  for (int lz = 0; lz < TZ; ++lz) {
    const int z = z0 + lz;
    if (z >= D) break;
    const float fz = (float)z;
    const long long v = batch_vox + ((long long)z * H + y) * W + x;
    const float dz = fminf(fmaxf(fz + shift[v * 3 + 0], 0.f), (float)(D - 1)) - fz;
    const float dy = fminf(fmaxf(fy + shift[v * 3 + 1], 0.f), (float)(H - 1)) - fy;
    const float dx = fminf(fmaxf(fx + shift[v * 3 + 2], 0.f), (float)(W - 1)) - fx;
    const float oz = floorf(dz), oy = floorf(dy), ox = floorf(dx);
    const float wz[2] = {fmaxf(0.f, 1.f - fabsf(dz - oz)),
                         fmaxf(0.f, 1.f - fabsf(dz - (oz + 1.f)))};
    const float wy[2] = {fmaxf(0.f, 1.f - fabsf(dy - oy)),
                         fmaxf(0.f, 1.f - fabsf(dy - (oy + 1.f)))};
    const float wx[2] = {fmaxf(0.f, 1.f - fabsf(dx - ox)),
                         fmaxf(0.f, 1.f - fabsf(dx - (ox + 1.f)))};
    // Tile coordinates of the lower corner. Clamping keeps a caller that
    // breaks |shift| <= h inside the tile; for |shift| <= h it never binds
    // except on an upper corner whose weight is exactly 0.
    const int tz = lz + h + (int)oz;
    const int ty = threadIdx.y + h + (int)oy;
    const int tx = threadIdx.x + h + (int)ox;
    int iz[2], iy[2], ix[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      iz[k] = clampi(tz + k, 0, ez - 1);
      iy[k] = clampi(ty + k, 0, ey - 1);
      ix[k] = clampi(tx + k, 0, ex - 1);
    }
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const float wzy = __fmul_rn(wz[a], wy[bb]);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float w = __fmul_rn(wzy, wx[k]);
          const float* t = tile + ((iz[a] * ey + iy[bb]) * ex + ix[k]) * C;
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[c] = __fadd_rn(acc[c], __fmul_rn(t[c], w));
        }
      }
    }
    float* o = out + v * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c];
  }
}

template <int C>
cudaError_t launch(const float* vol, const float* shift, float* out, int B,
                   int D, int H, int W, int h, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * C * (TZ + 2 * h) * (TY + 2 * h) * (TX + 2 * h);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      warp_bounded_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_z = (D + TZ - 1) / TZ;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, tiles_z * B);
  const dim3 block(TX, TY);
  warp_bounded_fwd_kernel<C><<<grid, block, smem, stream>>>(
      vol, shift, out, D, H, W, h, tiles_z);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and does not
// synchronise; returns the CUDA error of the launch (0 on success).
extern "C" int vxm_warp_bounded_fwd(const void* vol, const void* shift,
                                    void* out, int B, int D, int H, int W,
                                    int C, int h, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || h < 1 || (long long)B * ((D + TZ - 1) / TZ) > 65535)
    return (int)cudaErrorInvalidValue;
  const float* v = static_cast<const float*>(vol);
  const float* s = static_cast<const float*>(shift);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch<1>(v, s, o, B, D, H, W, h, st);
    case 2: return (int)launch<2>(v, s, o, B, D, H, W, h, st);
    case 3: return (int)launch<3>(v, s, o, B, D, H, W, h, st);
    case 4: return (int)launch<4>(v, s, o, B, D, H, W, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
