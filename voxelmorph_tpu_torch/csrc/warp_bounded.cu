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

// derivative of max(0, 1 - |t|): -sign(t) where |t| < 1, else 0 (0 at t = 0)
__device__ __forceinline__ float dtri(float t) {
  return fabsf(t) < 1.f ? (t > 0.f ? -1.f : (t < 0.f ? 1.f : 0.f)) : 0.f;
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
// thread and there are no atomics: two launches give bit-equal results. A
// block stages the shift and the cotangent of its output tile plus an
// h-voxel halo in shared memory, sums over the (2h + 1)^3 source positions
// u - o the terms whose weight is nonzero, in the plain version's order and
// with its per-term rounding; then it stages the volume tile and halo in the
// same shared memory and, for dshift, takes only the 8 taps o_d in
// {floor(d_d), floor(d_d) + 1} whose weights or weight derivatives can be
// nonzero. Load indices are clamped to the volume (edge padding, never
// materialised); a source position outside the volume is skipped.
//
// Bound: the function reads vol, shift and g once and writes dvol and dshift
// once, (3C + 6) * 4 bytes per voxel: 51.6 MB at (80, 96, 112), C = 3, about
// 15 us at 3.35 TB/s; its arithmetic is far below the f32 rate, so the bound
// is bytes. The halo re-reads and the (2h + 1)^3 weight evaluations per
// voxel of the dvol gather are what a faster version would cut first.

template <int C>
__global__ void __launch_bounds__(TX * TY)
warp_bounded_bwd_kernel(const float* __restrict__ vol,
                        const float* __restrict__ shift,
                        const float* __restrict__ g,
                        float* __restrict__ dvol, float* __restrict__ dshift,
                        int D, int H, int W, int h, int tiles_z) {
  extern __shared__ float tile[];
  constexpr int P = 3 + C;  // staged floats per voxel in the dvol pass
  const int b = blockIdx.z / tiles_z;
  const int z0 = (blockIdx.z % tiles_z) * TZ;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int ez = TZ + 2 * h, ey = TY + 2 * h, ex = TX + 2 * h;
  const long long batch_vox = (long long)b * D * H * W;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool active = x < W && y < H;

  // Pass 1: tile index (lz, ly, lx, k) holds shift (k < 3) or g (k >= 3) at
  // the clamped position (z0 - h + lz, y0 - h + ly, x0 - h + lx).
  const int n1 = ez * ey * ex * P;
  for (int i = tid; i < n1; i += TX * TY) {
    const int k = i % P;
    int r = i / P;
    const int lx = r % ex;
    r /= ex;
    const int ly = r % ey;
    const int lz = r / ey;
    const long long vox =
        batch_vox + ((long long)clampi(z0 - h + lz, 0, D - 1) * H +
                     clampi(y0 - h + ly, 0, H - 1)) * W +
        clampi(x0 - h + lx, 0, W - 1);
    tile[i] = k < 3 ? shift[vox * 3 + k] : g[vox * C + (k - 3)];
  }
  __syncthreads();

  if (active) {
    for (int lz = 0; lz < TZ; ++lz) {
      const int z = z0 + lz;
      if (z >= D) break;
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
      for (int oz = -h; oz <= h; ++oz) {
        const int pz = z - oz;
        if (pz < 0 || pz >= D) continue;
        const float fpz = (float)pz;
        for (int oy = -h; oy <= h; ++oy) {
          const int py = y - oy;
          if (py < 0 || py >= H) continue;
          const float fpy = (float)py;
          for (int ox = -h; ox <= h; ++ox) {
            const int px = x - ox;
            if (px < 0 || px >= W) continue;
            const float fpx = (float)px;
            const float* t =
                tile + (((lz + h - oz) * ey + (threadIdx.y + h - oy)) * ex +
                        (threadIdx.x + h - ox)) * P;
            const float dz = fminf(fmaxf(fpz + t[0], 0.f), (float)(D - 1)) - fpz;
            const float wz = fmaxf(0.f, 1.f - fabsf(dz - (float)oz));
            if (wz == 0.f) continue;
            const float dy = fminf(fmaxf(fpy + t[1], 0.f), (float)(H - 1)) - fpy;
            const float wy = fmaxf(0.f, 1.f - fabsf(dy - (float)oy));
            if (wy == 0.f) continue;
            const float dx = fminf(fmaxf(fpx + t[2], 0.f), (float)(W - 1)) - fpx;
            const float wx = fmaxf(0.f, 1.f - fabsf(dx - (float)ox));
            if (wx == 0.f) continue;
            const float w = __fmul_rn(__fmul_rn(wz, wy), wx);
#pragma unroll
            for (int c = 0; c < C; ++c)
              acc[c] = __fadd_rn(acc[c], __fmul_rn(w, t[3 + c]));
          }
        }
      }
      const long long v = batch_vox + ((long long)z * H + y) * W + x;
#pragma unroll
      for (int c = 0; c < C; ++c) dvol[v * C + c] = acc[c];
    }
  }
  __syncthreads();

  // Pass 2: the same shared memory now holds the volume, C floats per
  // voxel, edge-clamped, as in the forward kernel.
  const int n2 = ez * ey * ex * C;
  for (int i = tid; i < n2; i += TX * TY) {
    const int c = i % C;
    int r = i / C;
    const int lx = r % ex;
    r /= ex;
    const int ly = r % ey;
    const int lz = r / ey;
    const long long vox =
        batch_vox + ((long long)clampi(z0 - h + lz, 0, D - 1) * H +
                     clampi(y0 - h + ly, 0, H - 1)) * W +
        clampi(x0 - h + lx, 0, W - 1);
    tile[i] = vol[vox * C + c];
  }
  __syncthreads();
  if (!active) return;

  const float fx = (float)x, fy = (float)y;
  for (int lz = 0; lz < TZ; ++lz) {
    const int z = z0 + lz;
    if (z >= D) break;
    const float fz = (float)z;
    const long long v = batch_vox + ((long long)z * H + y) * W + x;
    const float az = fz + shift[v * 3 + 0];
    const float ay = fy + shift[v * 3 + 1];
    const float ax = fx + shift[v * 3 + 2];
    const float dz = fminf(fmaxf(az, 0.f), (float)(D - 1)) - fz;
    const float dy = fminf(fmaxf(ay, 0.f), (float)(H - 1)) - fy;
    const float dx = fminf(fmaxf(ax, 0.f), (float)(W - 1)) - fx;
    float gx[C];
#pragma unroll
    for (int c = 0; c < C; ++c) gx[c] = g[v * C + c];
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
    // tile coordinates of the lower corner, clamped as in the forward
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
    float sz = 0.f, sy = 0.f, sx = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float* t = tile + ((iz[a] * ey + iy[bb]) * ex + ix[k]) * C;
          float gv = __fmul_rn(gx[0], t[0]);
#pragma unroll
          for (int c = 1; c < C; ++c) gv = __fadd_rn(gv, __fmul_rn(gx[c], t[c]));
          sz = __fadd_rn(sz, __fmul_rn(__fmul_rn(__fmul_rn(gv, dwz[a]), wy[bb]), wx[k]));
          sy = __fadd_rn(sy, __fmul_rn(__fmul_rn(__fmul_rn(gv, wz[a]), dwy[bb]), wx[k]));
          sx = __fadd_rn(sx, __fmul_rn(__fmul_rn(__fmul_rn(gv, wz[a]), wy[bb]), dwx[k]));
        }
      }
    }
    dshift[v * 3 + 0] = (az > 0.f && az < (float)(D - 1)) ? sz : 0.f;
    dshift[v * 3 + 1] = (ay > 0.f && ay < (float)(H - 1)) ? sy : 0.f;
    dshift[v * 3 + 2] = (ax > 0.f && ax < (float)(W - 1)) ? sx : 0.f;
  }
}

template <int C>
cudaError_t launch_bwd(const float* vol, const float* shift, const float* g,
                       float* dvol, float* dshift, int B, int D, int H, int W,
                       int h, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 + C) * (TZ + 2 * h) * (TY + 2 * h) *
                      (TX + 2 * h);
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      warp_bounded_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_z = (D + TZ - 1) / TZ;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, tiles_z * B);
  const dim3 block(TX, TY);
  warp_bounded_bwd_kernel<C><<<grid, block, smem, stream>>>(
      vol, shift, g, dvol, dshift, D, H, W, h, tiles_z);
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


// Plain C entry point for ctypes: the VJP of vxm_warp_bounded_fwd. vol and
// g are (B, D, H, W, C), shift (B, D, H, W, 3), f32, contiguous; dvol and
// dshift have the shapes of vol and shift and are fully written. Launches on
// `stream` and does not synchronise; returns the CUDA error of the launch.
extern "C" int vxm_warp_bounded_bwd(const void* vol, const void* shift,
                                    const void* g, void* dvol, void* dshift,
                                    int B, int D, int H, int W, int C, int h,
                                    void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || h < 1 || (long long)B * ((D + TZ - 1) / TZ) > 65535)
    return (int)cudaErrorInvalidValue;
  const float* v = static_cast<const float*>(vol);
  const float* s = static_cast<const float*>(shift);
  const float* gg = static_cast<const float*>(g);
  float* dv = static_cast<float*>(dvol);
  float* ds = static_cast<float*>(dshift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch_bwd<1>(v, s, gg, dv, ds, B, D, H, W, h, st);
    case 2: return (int)launch_bwd<2>(v, s, gg, dv, ds, B, D, H, W, h, st);
    case 3: return (int)launch_bwd<3>(v, s, gg, dv, ds, B, D, H, W, h, st);
    case 4: return (int)launch_bwd<4>(v, s, gg, dv, ds, B, D, H, W, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
