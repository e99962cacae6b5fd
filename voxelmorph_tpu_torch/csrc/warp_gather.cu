// Trilinear warp by an unbounded displacement (the general gather), forward
// and backward, for Hopper (sm_90a).
//
// WHAT IT REPLACES. No Pallas kernel of the JAX package computes this
// function: there it is interpn (voxelmorph_tpu/ops/interp.py:301), the
// corner-table gather, left to XLA. The port's tiered warp (ops/warp.py)
// launches its branches in turn with the same device word, the tier index
// of JAX's lax.switch, and each kernel returns at once unless the word
// names it; this kernel is the gather branch, so that no branch needs the
// host to read the word.
//
// WHAT IT COMPUTES. The port's plain version (ops/warp_gather.py:
// warp_gather_plain, which is ops/interp.py:interpn on each sample), term
// for term:
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
// 1 GiB corner table), at the flat index clipped to the last voxel. Its
// value still decides the bits of the sum (-x * 0 is -0; inf or NaN times 0
// is NaN), so it is read.
//
// The backward is autograd's VJP of that plain version. dvol adds g * weight
// into each corner with atomic adds, so its sums run in another order than
// the plain version's (within a tolerance, as torch's own index_add_ on
// CUDA); the caller zeroes dvol, or passes null where no volume gradient is
// wanted. dshift follows the order in which autograd sums its terms, so it
// is bit-equal:
//   table path: per dimension d, the terms q_c = sum_ch(g * vol[corner_c])
//     (channels added in the order of torch's reduction: channel_sum)
//     times the other two weights, of the corners with bit d set summed in
//     descending c, minus the same sum over the corners with bit d clear,
//     times the clamp's slope (1 inside, 0 beyond, at exactly 0 or dim - 1
//     1 for one channel and 0.5 for more: JAX's gradient of its clamp);
//   wide path: the signed terms summed in ascending c from 0, times 1 where
//     0 <= loc_d <= dim_d - 1 and 0 beyond (_LinearGatherWide's VJP);
// then plus 0: autograd adds the three coordinates' gradients into one
// tensor of zeros, which makes a -0 +0.
//
// Layout: channels-last, vol (B, D, H, W, C) with 1 <= C <= 4, shift
// (B, D, H, W, 3), f32, contiguous; a sample's voxels times max(C, 3) below
// 2^31, so that every index inside a sample is an int.
//
// BOUND. The forward reads shift and vol and writes out, (2C + 3) * 4
// bytes a voxel: at (1, 80, 96, 112, 3) 31.0 MB, 0.00924 ms at 3.35 TB/s; at
// the serving warp's (1, 160, 192, 224, 1) 0.0411 ms. The backward reads
// vol, shift and g and writes dvol and dshift, (3C + 6) * 4 bytes a voxel:
// 0.0154 and 0.0739 ms. The arithmetic is far below the f32 rate.
//
// DESIGN. The first version of this kernel (one thread per voxel of the
// flat index) lost to grid_sample; of what held it back:
// 1. 64-bit division per voxel (the coordinates of the flat index, the
//    corner table's wrap). A block now owns 32 x 8 outputs of a plane over
//    TZ planes (a thread the TZ outputs of its column): the coordinates
//    and the sample come from the block's index (item 4), the sample's
//    offset is taken once in 64 bits, and every index inside a sample is
//    an int; the wrap is a subtraction, and only past the end.
// 2. Loads and stores. A warp's 32 outputs are consecutive voxels, so its
//    shift loads (three at a 12-byte stride), its corner loads (through
//    L1, neighbouring lanes on neighbouring voxels of a smooth field) and
//    its stores use every byte of the lines they touch. Staging the shift
//    rows and each tile's box of source voxels in shared memory, as the
//    bounded warp does, was measured and lost (PERF.md, section 6): a tile's
//    copies, barriers and box reduction run in turn, a few blocks to an SM,
//    where this kernel keeps the SM full of independent loads.
// 3. Two launches and 8 C global atomics per voxel in the backward. The
//    zeroing launch is gone: the caller's dvol comes zeroed, or is null.
//    The +x corner of lane l and the x corner of lane l + 1 are the same
//    voxel wherever the field is smooth (compared by flat index, so a
//    wrapped corner merges only with its own voxel): lane l passes its term
//    along the warp by a shuffle and lane l + 1 adds both with one atomic;
//    likewise a thread's z corners take the terms of the +z corners of the
//    output below in its column where they are the same voxels. On a
//    smooth field the two merges take about half of the terms. (Adding a
//    tile's dvol into a shared copy by shared atomics, then flushing it,
//    was measured and lost: PERF.md, section 6.) A build with
//    VXM_GATHER_COUNT counts the adds and the merged terms.
// 4. A grid of total / 256 blocks, each reading the tier word to return:
//    now a block a tile, (W / 32) (H / 8) (D / TZ) B blocks of 256
//    threads, numbered in a flat grid (x fastest, then y,
//    then the plane-runs of each sample: a 3-D grid's order, without its
//    65535 limit in y and z) and decoded once a block by multiplies and
//    shifts (FastDiv: with integer divisions the serving forward took 3%
//    more). A launch takes up to 2^31 - 1 blocks, beyond any volume that
//    fits the card.
// The column length TZ = 2 and the merges were chosen by timing builds of
// other lengths and without each merge on an H100 (PERF.md, section 6).
// nvcc -Xptxas -v (sm_90a, -O3): the forward 32-34 registers, the backward
// 64, 64, 78 and 79 at C = 1-4; no shared memory, barrier or spill: 48
// warps on an SM in the forward, 24 in the backward at C = 3.
// Measured on an H100 (chip_smoke.py; PERF.md, section 6, row 10): at
// (1, 80, 96, 112, 3) on a smooth field of up to 4 voxels, forward 0.0268
// ms (34% of the byte bound; grid_sample 0.0352) and backward 0.0916 ms
// with the fill of the dvol it adds into (0.0892 without; 17%;
// grid_sample's 0.1009), which merges half its dvol terms; at
// (1, 160, 192, 224, 1), forward 0.0756 ms (54%; grid_sample 0.1457) and
// backward 0.1894 (39%; grid_sample 0.2149).

#include <cuda_runtime.h>
#include <stdint.h>

// Counts of the backward's atomic adds and merged terms, for tests and
// diagnostics (a same-address atomic of every warp: off in the package).
#ifndef VXM_GATHER_COUNT
#define VXM_GATHER_COUNT 0
#endif

namespace {

constexpr int TX = 32;  // outputs of a block row: one warp
constexpr int TY = 8;   // rows of a block: a warp each
constexpr int TZ = 2;   // planes of a thread's column
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// The tier word: the kernel runs only where it names `serve` (or no word).
// One thread of the first block counts the launches that ran in worked[0].
__device__ __forceinline__ bool selected(const int* tier, int serve, int* worked) {
  if (tier != nullptr && *tier != serve) return false;
  if (worked != nullptr && (blockIdx.x | blockIdx.y | blockIdx.z) == 0 &&
      (threadIdx.x | threadIdx.y) == 0)
    atomicAdd(worked, 1);
  return true;
}

// sum_ch g[ch] * v[ch] over C <= 4 channels, added as torch's sum over the
// last axis of a (M, C) tensor adds them: in order on the CPU (the plain
// version that the CPU emulation of this kernel is held to); on the card,
// whose reduction pairs channel c with channel c + 2 first, (0 + 2) + 1 for
// three channels and (0 + 2) + (1 + 3) for four: the order of torch 2.11's
// CUDA reduction. chip_smoke.py (phase 2e) holds dshift to the plain version
// on the card bit for bit at 1 to 4 channels, so a torch that sums in
// another order fails there.
template <int C>
__device__ __forceinline__ float channel_sum(const float (&g)[C], const float (&v)[C]) {
  float t[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) t[ch] = __fmul_rn(g[ch], v[ch]);
#ifdef __CUDA_ARCH__
  if constexpr (C == 1) return t[0];
  if constexpr (C == 2) return __fadd_rn(t[0], t[1]);
  if constexpr (C == 3) return __fadd_rn(__fadd_rn(t[0], t[2]), t[1]);
  if constexpr (C == 4) return __fadd_rn(__fadd_rn(t[0], t[2]), __fadd_rn(t[1], t[3]));
#else
  float s = t[0];
#pragma unroll
  for (int ch = 1; ch < C; ++ch) s = __fadd_rn(s, t[ch]);
  return s;
#endif
}

// An output's coordinate, weights and the flat index of its floor corner.
struct Cell {
  float loc[3], w0[3], w1[3];
  int lin0;
};

__device__ __forceinline__ Cell make_cell(const float* s, int z, int y, int x, int D, int H,
                                          int W) {
  Cell c;
  const float pos[3] = {(float)z, (float)y, (float)x};
  const int dims[3] = {D, H, W};
  int i[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float l = __fadd_rn(pos[d], s[d]), m = (float)(dims[d] - 1);
    c.loc[d] = l;
    i[d] = (int)fminf(fmaxf(floorf(l), 0.f), m);
    c.w1[d] = __fadd_rn(fminf(fmaxf(l, 0.f), m), -(float)i[d]);
    c.w0[d] = __fadd_rn(1.f, -c.w1[d]);
  }
  c.lin0 = (i[0] * H + i[1]) * W + i[2];
  return c;
}

// The flat voxel index of corner `bits` of a cell: past the last voxel it
// wraps (the corner table) or is clipped to it (the wide-channel path).
__device__ __forceinline__ int corner(int lin0, int bits, int HW, int W, int V, bool wide) {
  int lin = lin0 + (bits & 1) * HW + (bits >> 1 & 1) * W + (bits >> 2 & 1);
  if (wide) return imin(lin, V - 1);
  while (lin >= V) lin -= V;
  return lin;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift, with d's magic
// numbers made on the host (the round-up method of Granlund and
// Montgomery): a block's index decoded without an integer division.
struct FastDiv {
  unsigned d, mul, shift;
  explicit FastDiv(int div) : d((unsigned)div), mul(0), shift(0) {
    while ((1ull << shift) < d) ++shift;
    mul = (unsigned)(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ int operator()(int n) const {
    return (int)((__umulhi((unsigned)n, mul) + (unsigned)n) >> shift);
  }
};

// The tiles of a launch, one a block in a flat grid: x fastest, then y,
// then each sample's runs of TZ planes (the order of a 3-D grid, without its
// limit of 65535 in y and z).
struct Tiles {
  FastDiv xtiles, xytiles, zruns;
  Tiles(int W, int H, int D)
      : xtiles((W + TX - 1) / TX), xytiles((W + TX - 1) / TX * ((H + TY - 1) / TY)),
        zruns((D + TZ - 1) / TZ) {}
  // this block's first output: column x, row y, plane z0 of sample b
  __device__ __forceinline__ void origin(int& x, int& y, int& b, int& z0) const {
    const int t = blockIdx.x, r = xytiles(t), xy = t - r * (int)xytiles.d;
    const int ty = xtiles(xy);
    x = (xy - ty * (int)xtiles.d) * TX + threadIdx.x;
    y = ty * TY + threadIdx.y;
    b = zruns(r);
    z0 = (r - b * (int)zruns.d) * TZ;
  }
};

template <int C>
__global__ void __launch_bounds__(TX * TY)
warp_gather_fwd_kernel(const float* __restrict__ vol, const float* __restrict__ shift,
                       float* __restrict__ out, int D, int H, int W, Tiles tiles, bool wide,
                       const int* tier, int serve, int* worked) {
  if (!selected(tier, serve, worked)) return;
  int x, y, b, z0;
  tiles.origin(x, y, b, z0);
  if (x >= W || y >= H) return;
  const int HW = H * W, V = D * HW;
  const float* const volb = vol + (long long)b * V * C;
  const float* const shiftb = shift + (long long)b * V * 3;
  float* const outb = out + (long long)b * V * C;
#pragma unroll
  for (int k = 0; k < TZ; ++k) {
    const int z = z0 + k;
    if (z >= D) break;
    const int v = (z * H + y) * W + x;
    const Cell cell = make_cell(shiftb + v * 3, z, y, x, D, H, W);
    float acc[C];
#pragma unroll
    for (int bits = 0; bits < 8; ++bits) {
      const float* p = volb + corner(cell.lin0, bits, HW, W, V, wide) * C;
      const float wt = __fmul_rn(__fmul_rn(bits & 1 ? cell.w1[0] : cell.w0[0],
                                           bits & 2 ? cell.w1[1] : cell.w0[1]),
                                 bits & 4 ? cell.w1[2] : cell.w0[2]);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float term = __fmul_rn(p[c], wt);
        acc[c] = bits == 0 ? term : __fadd_rn(acc[c], term);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) outb[v * C + c] = acc[c];
  }
}

// Add the terms dv of a pair of corners along x (flat indices `at`, -1 and
// -2 for none) into dvol: where the left lane's +x corner is this lane's x
// corner, this lane adds both terms and the left lane skips its own add.
// With VXM_GATHER_COUNT, `adds` counts the atomic adds (of C floats) and
// `merged` the terms added into another's add.
template <int C>
__device__ __forceinline__ void add_pair(float* dvolb, const int (&at)[2], float (&dv)[2][C],
                                         int lane, unsigned& adds, unsigned& merged) {
  const int left = __shfl_up_sync(kFull, at[1], 1);
  const bool take = lane > 0 && at[0] >= 0 && left == at[0];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float l = __shfl_up_sync(kFull, dv[1][c], 1);
    if (take) dv[0][c] = __fadd_rn(dv[0][c], l);
  }
  const bool given = __shfl_down_sync(kFull, (int)take, 1) != 0 && lane < TX - 1;
  if (at[0] >= 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(dvolb + at[0] * C + c, dv[0][c]);
    ++adds;
  }
  if (at[1] >= 0 && !given) {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(dvolb + at[1] * C + c, dv[1][c]);
    ++adds;
  }
  merged += take;
}

// The backward: dshift written, dvol (if not null) added into. With
// VXM_GATHER_COUNT, `worked` is null or [launches that ran, atomic adds of
// C floats into dvol, terms merged into another add]; else worked[0] only.
template <int C>
__global__ void __launch_bounds__(TX * TY)
warp_gather_bwd_kernel(const float* __restrict__ vol, const float* __restrict__ shift,
                       const float* __restrict__ gout, float* __restrict__ dvol,
                       float* __restrict__ dshift, int D, int H, int W, Tiles tiles, bool wide,
                       const int* tier, int serve, int* worked) {
  if (!selected(tier, serve, worked)) return;
  const int lane = threadIdx.x;
  int x, y, b, z0;
  tiles.origin(x, y, b, z0);
  const bool scatter = dvol != nullptr;
  // a warp is one row: past the last row it leaves whole; past the last
  // column its lanes stay for the shuffles of the scatter
  if (y >= H || (x >= W && !scatter)) return;
  const bool active = x < W;
  const int HW = H * W, V = D * HW;
  const long long boff = (long long)b * V;
  const float* const volb = vol + boff * C;
  const float* const shiftb = shift + boff * 3;
  const float* const gb = gout + boff * C;
  float* const dvolb = scatter ? dvol + boff * C : nullptr;
  float* const dshiftb = dshift + boff * 3;
  const float edge_grad = C == 1 ? 1.f : 0.5f;
  const int dims[3] = {D, H, W};
  unsigned adds = 0, merged = 0;
  // the +z corner pairs of the previous output of the column, by y, held
  // for the z corners of this one
  int held_at[2][2] = {{-1, -2}, {-1, -2}};
  float held_dv[2][2][C] = {};
#pragma unroll
  for (int k = 0; k < TZ; ++k) {
    const int z = z0 + k;
    if (z >= D) break;
    const int v = (z * H + y) * W + x;
    Cell cell{};
    float gv[C] = {};
    if (active) {
      cell = make_cell(shiftb + v * 3, z, y, x, D, H, W);
#pragma unroll
      for (int c = 0; c < C; ++c) gv[c] = gb[v * C + c];
    }
    float q[8][3];
    // The corners in pairs along x (bits = z + 2 y, and bits + 4): their
    // flat indices and dvol terms, and their terms q of dshift.
    auto pair = [&](int zy, int (&at)[2], float (&dv)[2][C]) {
#pragma unroll
      for (int bx = 0; bx < 2; ++bx) {
        const int bits = zy | bx << 2;
        at[bx] = -1 - bx;
#pragma unroll
        for (int c = 0; c < C; ++c) dv[bx][c] = 0.f;
        if (!active) continue;
        at[bx] = corner(cell.lin0, bits, HW, W, V, wide);
        float p[C];
#pragma unroll
        for (int c = 0; c < C; ++c) p[c] = volb[at[bx] * C + c];
        const float wa = bits & 1 ? cell.w1[0] : cell.w0[0];
        const float wb = bits & 2 ? cell.w1[1] : cell.w0[1];
        const float wc = bits & 4 ? cell.w1[2] : cell.w0[2];
        const float wt = __fmul_rn(__fmul_rn(wa, wb), wc);
#pragma unroll
        for (int c = 0; c < C; ++c) dv[bx][c] = __fmul_rn(gv[c], wt);
        // the weight's cotangent: the channel sum of g * vol at the
        // corner, in the order of torch's sum over the channels of
        // (g * vol) on the device that runs the plain version; the
        // wide-channel path sums channels first, in order
        float s;
        if (wide) {
          s = __fmul_rn(gv[0], p[0]);
#pragma unroll
          for (int c = 1; c < C; ++c) s = __fadd_rn(s, __fmul_rn(gv[c], p[c]));
        } else {
          s = channel_sum<C>(gv, p);
        }
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
    };
    // The z corners (y = 0, 1) take the held +z corners of the previous
    // output that are the same voxels, then are added; the held corners
    // left over are added; the +z corners are held for the next output of
    // the column where there is one, else added.
    const bool hold = k + 1 < TZ && z + 1 < D;
#pragma unroll
    for (int by = 0; by < 2; ++by) {
      int at[2];
      float dv[2][C];
      pair(by << 1, at, dv);
      if (!scatter) continue;
#pragma unroll
      for (int bx = 0; bx < 2; ++bx) {
        if (held_at[by][bx] >= 0 && held_at[by][bx] == at[bx]) {
#pragma unroll
          for (int c = 0; c < C; ++c) dv[bx][c] = __fadd_rn(dv[bx][c], held_dv[by][bx][c]);
          held_at[by][bx] = -1 - bx;
          ++merged;
        }
      }
      add_pair<C>(dvolb, at, dv, lane, adds, merged);
    }
    if (scatter && k > 0 &&
        __any_sync(kFull, held_at[0][0] >= 0 || held_at[0][1] >= 0 || held_at[1][0] >= 0 ||
                              held_at[1][1] >= 0)) {
#pragma unroll
      for (int by = 0; by < 2; ++by) {
        add_pair<C>(dvolb, held_at[by], held_dv[by], lane, adds, merged);
        held_at[by][0] = -1;
        held_at[by][1] = -2;
      }
    }
#pragma unroll
    for (int by = 0; by < 2; ++by) {
      int at[2];
      float dv[2][C];
      pair(1 | by << 1, at, dv);
      if (!scatter) continue;
      if (hold) {
#pragma unroll
        for (int bx = 0; bx < 2; ++bx) {
          held_at[by][bx] = at[bx];
#pragma unroll
          for (int c = 0; c < C; ++c) held_dv[by][bx][c] = dv[bx][c];
        }
      } else {
        add_pair<C>(dvolb, at, dv, lane, adds, merged);
      }
    }
    if (!active) continue;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float l = cell.loc[d], m = (float)(dims[d] - 1);
      float res;
      if (wide) {
        res = 0.f;
#pragma unroll
        for (int bits = 0; bits < 8; ++bits)
          res = (bits >> d & 1) ? __fadd_rn(res, q[bits][d]) : __fadd_rn(res, -q[bits][d]);
        res = __fmul_rn(res, (l >= 0.f && l <= m) ? 1.f : 0.f);
      } else {
        // autograd adds the w1 uses in descending corner order, then the w0
        // uses (summed alike) through w0 = 1 - w1
        float up = 0.f, down = 0.f;
        bool up_set = false, down_set = false;
#pragma unroll
        for (int bits = 7; bits >= 0; --bits) {
          if (bits >> d & 1) {
            up = up_set ? __fadd_rn(up, q[bits][d]) : q[bits][d];
            up_set = true;
          } else {
            down = down_set ? __fadd_rn(down, q[bits][d]) : q[bits][d];
            down_set = true;
          }
        }
        const float slope =
            (l > 0.f && l < m) ? 1.f : ((l == 0.f || l == m) ? edge_grad : 0.f);
        res = __fmul_rn(__fadd_rn(up, -down), slope);
      }
      dshiftb[v * 3 + d] = __fadd_rn(res, 0.f);
    }
  }
  if (VXM_GATHER_COUNT && scatter && worked != nullptr) {
    adds = __reduce_add_sync(kFull, adds);
    merged = __reduce_add_sync(kFull, merged);
    if (lane == 0) {
      atomicAdd(worked + 1, (int)adds);
      atomicAdd(worked + 2, (int)merged);
    }
  }
}

// The forward (dshift null) or the backward of C channels: a block a tile,
// (W / TX) (H / TY) (D / TZ) B blocks of TX x TY threads.
template <int C>
cudaError_t launch(const float* vol, const float* shift, const float* gout, float* out,
                   float* dshift, int B, int D, int H, int W, bool wide, const int* tier,
                   int serve, int* worked, cudaStream_t stream) {
  const Tiles tiles(W, H, D);
  const long long blocks = (long long)tiles.xytiles.d * tiles.zruns.d * B;
  if (blocks > kIntMax) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(TX, TY);
  if (dshift != nullptr)
    warp_gather_bwd_kernel<C><<<grid, block, 0, stream>>>(vol, shift, gout, out, dshift, D, H, W,
                                                          tiles, wide, tier, serve, worked);
  else
    warp_gather_fwd_kernel<C><<<grid, block, 0, stream>>>(vol, shift, out, D, H, W, tiles, wide,
                                                          tier, serve, worked);
  return cudaGetLastError();
}

cudaError_t dispatch(int C, const float* vol, const float* shift, const float* gout, float* out,
                     float* dshift, int B, int D, int H, int W, bool wide, const int* tier,
                     int serve, int* worked, cudaStream_t stream) {
  switch (C) {
    case 1: return launch<1>(vol, shift, gout, out, dshift, B, D, H, W, wide, tier, serve,
                             worked, stream);
    case 2: return launch<2>(vol, shift, gout, out, dshift, B, D, H, W, wide, tier, serve,
                             worked, stream);
    case 3: return launch<3>(vol, shift, gout, out, dshift, B, D, H, W, wide, tier, serve,
                             worked, stream);
    case 4: return launch<4>(vol, shift, gout, out, dshift, B, D, H, W, wide, tier, serve,
                             worked, stream);
    default: return cudaErrorInvalidValue;
  }
}

// A sample's indices are ints: its voxels times max(C, 3) below 2^31.
bool bad_shape(int B, int D, int H, int W, int C) {
  return B < 1 || D < 1 || H < 1 || W < 1 || C < 1 || C > 4 ||
         (long long)D * H * W * (C > 3 ? C : 3) > kIntMax;
}

}  // namespace

// Plain C entry point for ctypes: out = the gather of vol by shift. `tier`
// (a device int, or null to run unconditionally) and `serve`: the kernel
// runs only where *tier == serve. `worked` (a device int, or null) counts
// the launches that ran. Launches on `stream` and does not synchronise;
// returns the CUDA error of the launch (0 on success).
extern "C" int vxm_warp_gather_fwd(const void* vol, const void* shift, void* out, int B, int D,
                                   int H, int W, int C, int wide, const void* tier, int serve,
                                   void* worked, void* stream) {
  if (bad_shape(B, D, H, W, C)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(C, static_cast<const float*>(vol), static_cast<const float*>(shift),
                       nullptr, static_cast<float*>(out), nullptr, B, D, H, W, wide != 0,
                       static_cast<const int*>(tier), serve, static_cast<int*>(worked),
                       static_cast<cudaStream_t>(stream));
}

// Plain C entry point for ctypes: the VJP of vxm_warp_gather_fwd for the
// cotangent g (the shape of vol), in one launch predicated on the same tier
// word. dvol (the shape of vol, zeroed by the caller) is added into, or is
// null for no volume gradient; dshift (the shape of shift) is written.
// `worked` (null, or 3 device ints) counts the launches that ran, then the
// atomic adds into dvol (of C floats each) and the terms merged into a
// neighbouring lane's add.
extern "C" int vxm_warp_gather_bwd(const void* vol, const void* shift, const void* g,
                                   void* dvol, void* dshift, int B, int D, int H, int W, int C,
                                   int wide, const void* tier, int serve, void* worked,
                                   void* stream) {
  if (bad_shape(B, D, H, W, C) || dshift == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch(C, static_cast<const float*>(vol), static_cast<const float*>(shift),
                       static_cast<const float*>(g), static_cast<float*>(dvol),
                       static_cast<float*>(dshift), B, D, H, W, wide != 0,
                       static_cast<const int*>(tier), serve, static_cast<int*>(worked),
                       static_cast<cudaStream_t>(stream));
}
