// Trilinear warp by an unbounded displacement (the general gather), forward
// and backward, for Hopper (sm_90a).
//
// No Pallas kernel of the JAX package computes this function: there it is
// the corner-table gather of voxelmorph_tpu/ops/interp.py (interpn), left to
// XLA. The port's tiered warp (ops/warp.py) launches its branches in turn
// with the same device word, the tier index of JAX's lax.switch, and each
// kernel returns at once unless the word names it; this kernel is the
// gather branch, so that no branch needs the host to read the word.
//
// It computes the port's plain version (ops/warp_gather.py:
// warp_gather_plain, which is ops/interp.py:interpn on each sample) term for
// term:
//   loc_d  = x_d + shift_d, rounded once in f32
//   i_d    = clamp(floor(loc_d), 0, dim_d - 1)
//   w1_d   = clamp(loc_d, 0, dim_d - 1) - i_d,  w0_d = 1 - w1_d
//   out[x] = sum over the corners c = 0..7 (bit d of c: +1 along d) of
//            vol[corner] * ((w_z * w_y) * w_x), added in that order,
// with every product and sum rounded apart (__fmul_rn, __fadd_rn), as the
// plain version's separate tensor operations round them. The +1 corner of a
// coordinate on the top edge has weight exactly 0; it is read at the next
// voxel in flat order, wrapping at the end of the volume (the corner table's
// rule), or, on the wide-channel path (`wide`, which interpn takes above a
// 1 GiB corner table), at the flat index clipped to the last voxel.
//
// The backward is autograd's VJP of that plain version. dvol scatter-adds
// g * weight into each corner with atomics, so its sums run in another order
// than the plain version's (within a tolerance, as torch's own index_add_ on
// CUDA). dshift follows the order in which autograd sums its terms, so it is
// bit-equal:
//   table path: per dimension d, the terms q_c = sum_ch(g * vol[corner_c])
//     (channels added in the order of torch's reduction: channel_sum)
//     times the other two weights, of the corners with bit d set summed in
//     descending c, minus the same sum over the corners with bit d clear,
//     times the clamp's slope (1 inside, 0 beyond, at exactly 0 or dim - 1
//     1 for one channel and 0.5 for more: JAX's gradient of its clamp);
//   wide path: the signed terms summed in ascending c from 0, times 1 where
//     0 <= loc_d <= dim_d - 1 and 0 beyond (_LinearGatherWide's VJP).
//
// Layout: channels-last, vol (B, D, H, W, C) with 1 <= C <= 4, shift
// (B, D, H, W, 3), f32, contiguous; one thread per output voxel.
// Bound: it reads shift and 8 corners of vol per voxel; with the corners in
// cache it moves (C + 3 + C) * 4 bytes a voxel in the forward.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int D, H, W, C;
  long long V;  // voxels of a sample
};

// The per-voxel setup both directions share: clamped floor corner, weights
// and the flat index of the floor corner.
struct Cell {
  float loc[3], w0[3], w1[3];
  long long lin0;
  long long stride[3];
};

__device__ __forceinline__ void make_cell(const Geometry& g, long long v, const float* s,
                                          Cell& c) {
  const int x = (int)(v % g.W), y = (int)(v / g.W % g.H), z = (int)(v / ((long long)g.W * g.H));
  const int pos[3] = {z, y, x};
  const int dims[3] = {g.D, g.H, g.W};
  c.stride[0] = (long long)g.H * g.W;
  c.stride[1] = g.W;
  c.stride[2] = 1;
  c.lin0 = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float l = __fadd_rn((float)pos[d], s[d]);
    const float m = (float)(dims[d] - 1);
    long long i = (long long)floorf(l);
    i = i < 0 ? 0 : (i > dims[d] - 1 ? dims[d] - 1 : i);
    const float cl = fminf(fmaxf(l, 0.f), m);
    c.loc[d] = l;
    c.w1[d] = __fadd_rn(cl, -(float)i);
    c.w0[d] = __fadd_rn(1.f, -c.w1[d]);
    c.lin0 += i * c.stride[d];
  }
}

// The flat voxel index of corner `bits` of a cell: past the last voxel it
// wraps (the corner table) or is clipped to it (the wide-channel path).
__device__ __forceinline__ long long corner_index(const Cell& c, int bits, long long V,
                                                  bool wide) {
  const long long lin = c.lin0 + (bits & 1) * c.stride[0] + (bits >> 1 & 1) * c.stride[1] +
                        (bits >> 2 & 1) * c.stride[2];
  if (wide) return lin < V - 1 ? lin : V - 1;
  return lin < V ? lin : lin % V;
}

// sum_ch g[ch] * v[ch] over C <= 4 channels, added as torch's sum over the
// last axis of a (M, C) tensor adds them: in order on the CPU (the plain
// version that the CPU emulation of this kernel is held to); on the card,
// whose reduction pairs channel c with channel c + 2 first, (0 + 2) + 1 for
// three channels and (0 + 2) + (1 + 3) for four: the order of torch 2.11's
// CUDA reduction. chip_smoke.py (phase 2e) holds dshift to the plain version
// on the card bit for bit at 1 to 4 channels, so a torch that sums in
// another order fails there.
__device__ __forceinline__ float channel_sum(const float* g, const float* v, int C) {
  float t[4];
  for (int ch = 0; ch < C; ++ch) t[ch] = __fmul_rn(g[ch], v[ch]);
#ifdef __CUDA_ARCH__
  if (C == 1) return t[0];
  if (C == 2) return __fadd_rn(t[0], t[1]);
  if (C == 3) return __fadd_rn(__fadd_rn(t[0], t[2]), t[1]);
  return __fadd_rn(__fadd_rn(t[0], t[2]), __fadd_rn(t[1], t[3]));
#else
  float s = t[0];
  for (int ch = 1; ch < C; ++ch) s = __fadd_rn(s, t[ch]);
  return s;
#endif
}

__device__ __forceinline__ float wsel(const Cell& c, int bits, int d) {
  return (bits >> d & 1) ? c.w1[d] : c.w0[d];
}

// The tier word: the kernel runs only where it names `serve` (or no word).
// One thread of the first block counts the launches that ran.
__device__ __forceinline__ bool selected(const int* tier, int serve, int* worked) {
  if (tier != nullptr && *tier != serve) return false;
  if (worked != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(worked, 1);
  return true;
}

__global__ void __launch_bounds__(kThreads)
warp_gather_fwd_kernel(const float* __restrict__ vol, const float* __restrict__ shift,
                       float* __restrict__ out, Geometry g, long long total, bool wide,
                       const int* tier, int serve, int* worked) {
  if (!selected(tier, serve, worked)) return;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long b = t / g.V, v = t - b * g.V;
  const float* volb = vol + b * g.V * g.C;
  Cell c;
  make_cell(g, v, shift + t * 3, c);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int bits = 0; bits < 8; ++bits) {
    const float* p = volb + corner_index(c, bits, g.V, wide) * g.C;
    const float w = __fmul_rn(__fmul_rn(wsel(c, bits, 0), wsel(c, bits, 1)), wsel(c, bits, 2));
    for (int ch = 0; ch < g.C; ++ch) {
      const float term = __fmul_rn(p[ch], w);
      acc[ch] = bits == 0 ? term : __fadd_rn(acc[ch], term);
    }
  }
  for (int ch = 0; ch < g.C; ++ch) out[t * g.C + ch] = acc[ch];
}

__global__ void __launch_bounds__(kThreads)
zero_kernel(float* __restrict__ p, long long n, const int* tier, int serve) {
  if (tier != nullptr && *tier != serve) return;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t < n) p[t] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
warp_gather_bwd_kernel(const float* __restrict__ vol, const float* __restrict__ shift,
                       const float* __restrict__ gout, float* __restrict__ dvol,
                       float* __restrict__ dshift, Geometry g, long long total, bool wide,
                       const int* tier, int serve, int* worked) {
  if (!selected(tier, serve, worked)) return;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long b = t / g.V, v = t - b * g.V;
  const float* volb = vol + b * g.V * g.C;
  float* dvolb = dvol + b * g.V * g.C;
  const float* gv = gout + t * g.C;
  Cell c;
  make_cell(g, v, shift + t * 3, c);
  const int dims[3] = {g.D, g.H, g.W};
  float q[8][3];
  for (int bits = 0; bits < 8; ++bits) {
    const long long idx = corner_index(c, bits, g.V, wide);
    const float* p = volb + idx * g.C;
    const float wa = wsel(c, bits, 0), wb = wsel(c, bits, 1), wc = wsel(c, bits, 2);
    const float w = __fmul_rn(__fmul_rn(wa, wb), wc);
    // the weight's cotangent: the channel sum of g * vol at the corner, in
    // the order of torch's sum over the channels of (g * vol) (autograd's
    // reduction to the weight's shape) on the device that runs the plain
    // version; the wide-channel path sums channels first, in order
    float s;
    if (wide) {
      s = __fmul_rn(gv[0], p[0]);
      for (int ch = 1; ch < g.C; ++ch) s = __fadd_rn(s, __fmul_rn(gv[ch], p[ch]));
    } else {
      s = channel_sum(gv, p, g.C);
    }
    for (int ch = 0; ch < g.C; ++ch) atomicAdd(dvolb + idx * g.C + ch, __fmul_rn(gv[ch], w));
    if (wide) {
      // _LinearGatherWide's VJP: the product of the other two weights
      q[bits][0] = __fmul_rn(s, __fmul_rn(wb, wc));
      q[bits][1] = __fmul_rn(s, __fmul_rn(wa, wc));
      q[bits][2] = __fmul_rn(s, __fmul_rn(wa, wb));
    } else {
      // autograd of ((w_z * w_y) * w_x): the outer product first
      const float gp = __fmul_rn(s, wc);
      q[bits][2] = __fmul_rn(s, __fmul_rn(wa, wb));
      q[bits][0] = __fmul_rn(gp, wb);
      q[bits][1] = __fmul_rn(gp, wa);
    }
  }
  const float edge_grad = g.C == 1 ? 1.f : 0.5f;
  for (int d = 0; d < 3; ++d) {
    const float l = c.loc[d], m = (float)(dims[d] - 1);
    float r;
    if (wide) {
      r = 0.f;
      for (int bits = 0; bits < 8; ++bits)
        r = (bits >> d & 1) ? __fadd_rn(r, q[bits][d]) : __fadd_rn(r, -q[bits][d]);
      r = __fmul_rn(r, (l >= 0.f && l <= m) ? 1.f : 0.f);
    } else {
      // autograd adds the w1 uses in descending corner order, then the w0
      // uses (summed alike) through w0 = 1 - w1
      float up = 0.f, down = 0.f;
      bool up_set = false, down_set = false;
      for (int bits = 7; bits >= 0; --bits) {
        if (bits >> d & 1) {
          up = up_set ? __fadd_rn(up, q[bits][d]) : q[bits][d];
          up_set = true;
        } else {
          down = down_set ? __fadd_rn(down, q[bits][d]) : q[bits][d];
          down_set = true;
        }
      }
      const float slope = (l > 0.f && l < m) ? 1.f : ((l == 0.f || l == m) ? edge_grad : 0.f);
      r = __fmul_rn(__fadd_rn(up, -down), slope);
    }
    dshift[t * 3 + d] = r;
  }
}

bool bad_shape(int B, int D, int H, int W, int C) {
  return B < 1 || D < 1 || H < 1 || W < 1 || C < 1 || C > 4;
}

dim3 grid_of(long long total) { return dim3((unsigned)((total + kThreads - 1) / kThreads)); }

}  // namespace

// Plain C entry point for ctypes: out = the gather of vol by shift. `tier`
// (a device int, or null to run unconditionally) and `serve`: the kernel
// runs only where *tier == serve. `worked` (a device int, or null) counts
// the launches that ran. Launches on `stream` and does not synchronise;
// returns the CUDA error of the launch (0 on success).
extern "C" int vxm_warp_gather_fwd(const void* vol, const void* shift, void* out, int B, int D,
                                   int H, int W, int C, int wide, const void* tier, int serve,
                                   void* worked, void* stream_ptr) {
  if (bad_shape(B, D, H, W, C)) return (int)cudaErrorInvalidValue;
  const Geometry g{D, H, W, C, (long long)D * H * W};
  const long long total = (long long)B * g.V;
  if ((total + kThreads - 1) / kThreads > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(total), block(kThreads);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  warp_gather_fwd_kernel<<<grid, block, 0, stream>>>(
      static_cast<const float*>(vol), static_cast<const float*>(shift), static_cast<float*>(out),
      g, total, wide != 0, static_cast<const int*>(tier), serve, static_cast<int*>(worked));
  return (int)cudaGetLastError();
}

// Plain C entry point for ctypes: the VJP of vxm_warp_gather_fwd for the
// cotangent g (the shape of vol). dvol (the shape of vol) is zeroed and then
// scatter-added; dshift (the shape of shift) is written. Both kernels are
// predicated on the same tier word.
extern "C" int vxm_warp_gather_bwd(const void* vol, const void* shift, const void* g,
                                   void* dvol, void* dshift, int B, int D, int H, int W, int C,
                                   int wide, const void* tier, int serve, void* worked,
                                   void* stream_ptr) {
  if (bad_shape(B, D, H, W, C)) return (int)cudaErrorInvalidValue;
  const Geometry geo{D, H, W, C, (long long)D * H * W};
  const long long total = (long long)B * geo.V;
  if ((total * C + kThreads - 1) / kThreads > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tier);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  {
    const dim3 grid = grid_of(total * C), block(kThreads);
    zero_kernel<<<grid, block, 0, stream>>>(static_cast<float*>(dvol), total * C, t, serve);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of(total), block(kThreads);
  warp_gather_bwd_kernel<<<grid, block, 0, stream>>>(
      static_cast<const float*>(vol), static_cast<const float*>(shift),
      static_cast<const float*>(g), static_cast<float*>(dvol), static_cast<float*>(dshift), geo,
      total, wide != 0, t, serve, static_cast<int*>(worked));
  return (int)cudaGetLastError();
}
