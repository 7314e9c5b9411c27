// Shared pieces of the 3D constant-interior stencil kernels (const3d.cu,
// fused3d.cu): the stencil description passed by value, the interior box,
// the compile-time tap tables of the sorted 7- and 27-point stencils, the
// walk over a disjoint cover of six boxes, and the per-node tap loops.
//
// Operator convention (mgtpu_torch/ops/grid_stencil.py):
//   y[i] = sum_k coeff[k, i] * x[i + off_k]
// on a node grid (X, Y, Z), z contiguous, fields (m, X, Y, Z) row-major.
// coeff[k, i] is const[k] on the interior and the true band coefficient on
// the w-wide boundary band.  The band is covered by six disjoint boxes
// (two x-slabs full; two y-slabs trimmed to the x-interior; two z-slabs
// trimmed to the x- and y-interior); box b holds an (nd, nx, ny, nz)
// C-order block at element offset boff[b] of one packed band array.
// Taps that leave the grid read zero, which is where the true coefficient
// is zero as well.  Interior nodes lie at least w >= 1 nodes inside the
// grid, so their radius-1 taps need no bounds checks.
//
// Indices are 32-bit: the wrappers refuse fields of 2^31 elements or more.
#pragma once

#include <cuda_runtime.h>

#define MGT_MAX_TAPS 27

struct Stencil3D {
  int nd, X, Y, Z, w;
  int dx[MGT_MAX_TAPS], dy[MGT_MAX_TAPS], dz[MGT_MAX_TAPS];
  int bs[6][3];             // box start (x, y, z)
  int bn[6][3];             // box size  (x, y, z)
  int boff[6];              // element offset of box b in the packed band
};

// meta layout (host int32, built by mgtpu_torch/ops/cuda/const3d.py):
//   [nd, X, Y, Z, w, dx[nd], dy[nd], dz[nd], starts[6][3], sizes[6][3]]
// Returns 0 on success, -1 when the description is out of range.
static inline int mgt_stencil_from_meta(const int* meta, Stencil3D* s) {
  int nd = meta[0];
  if (nd < 1 || nd > MGT_MAX_TAPS || meta[4] < 1) return -1;
  s->nd = nd; s->X = meta[1]; s->Y = meta[2]; s->Z = meta[3]; s->w = meta[4];
  const int* p = meta + 5;
  for (int k = 0; k < MGT_MAX_TAPS; ++k) {
    s->dx[k] = k < nd ? p[k] : 0;
    s->dy[k] = k < nd ? p[nd + k] : 0;
    s->dz[k] = k < nd ? p[2 * nd + k] : 0;
    if (s->dx[k] < -1 || s->dx[k] > 1 || s->dy[k] < -1 || s->dy[k] > 1 ||
        s->dz[k] < -1 || s->dz[k] > 1)
      return -1;
  }
  p += 3 * nd;
  long long off = 0;
  for (int b = 0; b < 6; ++b) {
    for (int a = 0; a < 3; ++a) {
      s->bs[b][a] = p[3 * b + a];
      s->bn[b][a] = p[18 + 3 * b + a];
    }
    s->boff[b] = (int)off;
    off += (long long)nd * s->bn[b][0] * s->bn[b][1] * s->bn[b][2];
  }
  long long n = (long long)s->X * s->Y * s->Z;
  if (off >= (1LL << 31) || n >= (1LL << 31)) return -1;
  return 0;
}

// Interior box extents (0 when empty).
struct Interior {
  int X, Y, Z;
};
__host__ __device__ inline Interior interior_of(const Stencil3D& s) {
  Interior in;
  in.X = s.X - 2 * s.w > 0 ? s.X - 2 * s.w : 0;
  in.Y = s.Y - 2 * s.w > 0 ? s.Y - 2 * s.w : 0;
  in.Z = s.Z - 2 * s.w > 0 ? s.Z - 2 * s.w : 0;
  return in;
}

// Node counts of the band boxes.
static inline long long mgt_band_nodes(const Stencil3D& s) {
  long long n = 0;
  for (int b = 0; b < 6; ++b)
    n += (long long)s.bn[b][0] * s.bn[b][1] * s.bn[b][2];
  return n;
}

// The port's 7- and 27-point stencils list their offsets in sorted order
// (make_grid_stencil, structured_fw_rap); for those the tap loops take
// their offsets from these tables at compile time (one shared-memory load
// with an immediate offset per tap) instead of from the stencil
// description.
template <int NT>
struct StdTap;
template <>
struct StdTap<7> {   // (-1,0,0) (0,-1,0) (0,0,-1) (0,0,0) (0,0,1) (0,1,0) (1,0,0)
  __host__ __device__ static constexpr int dx(int k) { return k == 0 ? -1 : k == 6 ? 1 : 0; }
  __host__ __device__ static constexpr int dy(int k) { return k == 1 ? -1 : k == 5 ? 1 : 0; }
  __host__ __device__ static constexpr int dz(int k) { return k == 2 ? -1 : k == 4 ? 1 : 0; }
};
template <>
struct StdTap<27> {  // every offset of the cube, in sorted order
  __host__ __device__ static constexpr int dx(int k) { return k / 9 - 1; }
  __host__ __device__ static constexpr int dy(int k) { return k / 3 % 3 - 1; }
  __host__ __device__ static constexpr int dz(int k) { return k % 3 - 1; }
};

template <int NT>
static bool standard_taps(const Stencil3D& s) {
  if (s.nd != NT) return false;
  for (int k = 0; k < NT; ++k)
    if (s.dx[k] != StdTap<NT>::dx(k) || s.dy[k] != StdTap<NT>::dy(k) ||
        s.dz[k] != StdTap<NT>::dz(k))
      return false;
  return true;
}

// Node e of a disjoint cover of six boxes: box b holds
// bn[b][0] * bn[b][1] * bn[b][2] nodes, numbered in C order after the
// boxes before it.  Returns false past the last box.
__device__ __forceinline__ bool mgt_box_node(const int (&bs)[6][3],
                                             const int (&bn)[6][3], int e,
                                             int& ix, int& iy, int& iz) {
  ix = -1;
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    const int nz = bn[b][2], nyz = bn[b][1] * nz;
    const int cnt = bn[b][0] * nyz;
    if (ix < 0 && e < cnt) {
      const int lx = e / nyz, r = e - lx * nyz, ly = r / nz;
      ix = bs[b][0] + lx;
      iy = bs[b][1] + ly;
      iz = bs[b][2] + (r - ly * nz);
    }
    e -= cnt;
  }
  return ix >= 0;
}

// The tap loops run a compile-time count NT (7 or 27, the smallest that
// holds nd); taps past nd have offset 0 and coefficient 0.  With no
// run-time bound on the loop and no branch around a load, the compiler
// issues all of a node's loads together instead of one latency at a time.
static inline int mgt_tap_count(int nd) { return nd <= 7 ? 7 : 27; }

// Copy the interior constants (zero-padded to NT) to shared memory; call
// before any early exit, then synchronise.
template <int NT>
__device__ __forceinline__ void mgt_load_consts(const Stencil3D& s,
                                                const float* __restrict__ cst,
                                                float* sc, int tid) {
  if (tid < NT) sc[tid] = tid < s.nd ? __ldg(cst + tid) : 0.0f;
}

// sum_k coeff[k, node] * f(node + off_k) at node (ix, iy, iz), with
// f(.) = 0 outside the grid.  `load(dx, dy, dz)` returns the source value
// at the neighbour (ix+dx, iy+dy, iz+dz); `sc` holds the constants.
// CHECK: the source has no zero halo (global memory), so off-grid taps of
// band nodes are redirected to the node itself; without CHECK the source
// must read zero off the grid (the shared-memory tiles and rings of kernels
// A and B).  The true band coefficient of an off-grid tap is zero either
// way.
template <int NT, bool CHECK, typename Load>
__device__ __forceinline__ float mgt_apply_node(
    const Stencil3D& s, const float* sc, const float* __restrict__ band,
    int ix, int iy, int iz, const Load& load) {
  const int w = s.w;
  float acc = 0.0f;
  if (ix >= w && ix < s.X - w && iy >= w && iy < s.Y - w && iz >= w &&
      iz < s.Z - w) {
#pragma unroll
    for (int k = 0; k < NT; ++k)
      acc = fmaf(sc[k], load(s.dx[k], s.dy[k], s.dz[k]), acc);
    return acc;
  }
  // band node: find its box (the disjoint cover's order) and read the true
  // coefficients there; every struct index below is static after unrolling
  const int box = ix < w ? 0 : ix >= s.X - w ? 1 : iy < w ? 2
                : iy >= s.Y - w ? 3 : iz < w ? 4 : 5;
  const float* base = band;
  int kstride = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    if (b == box) {
      kstride = s.bn[b][0] * s.bn[b][1] * s.bn[b][2];
      base = band + s.boff[b] +
             ((ix - s.bs[b][0]) * s.bn[b][1] + (iy - s.bs[b][1])) *
                 s.bn[b][2] + (iz - s.bs[b][2]);
    }
  }
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    float a = __ldg(base + (k < s.nd ? k : 0) * kstride);
    a = k < s.nd ? a : 0.0f;
    int dx = s.dx[k], dy = s.dy[k], dz = s.dz[k];
    if (CHECK) {
      const int jx = ix + dx, jy = iy + dy, jz = iz + dz;
      dx = jx >= 0 && jx < s.X ? dx : 0;
      dy = jy >= 0 && jy < s.Y ? dy : 0;
      dz = jz >= 0 && jz < s.Z ? dz : 0;
    }
    acc = fmaf(a, load(dx, dy, dz), acc);
  }
  return acc;
}

// One band node e (numbered over the band boxes) of kernel A's modes, its
// taps and coefficients read from global memory:
//   0 out = A x, 1 out = b - A x, 2 out = x + d (b - A x),
//   3 out = s + d (b - A s) with s = x + p.
// Kernel B's band blocks run mode 2 (x' on the band).
template <int MODE, int NT>
__device__ __forceinline__ void mgt_band_node(
    const Stencil3D& s, const float* sc, int e,
    const float* __restrict__ band, const float* __restrict__ xm,
    const float* __restrict__ bm, const float* __restrict__ d,
    const float* __restrict__ pm, float* __restrict__ om) {
  int ix, iy, iz;
  if (!mgt_box_node(s.bs, s.bn, e, ix, iy, iz)) return;   // past the band
  const int plane = s.Y * s.Z;
  const int i = ix * plane + iy * s.Z + iz;
  const float* xc = xm + i;
  const float* pc = MODE == 3 ? pm + i : nullptr;          // s = x + p
  auto load = [&](int dx, int dy, int dz) {
    const int o = dx * plane + dy * s.Z + dz;
    float v = __ldg(xc + o);
    if constexpr (MODE == 3) v += __ldg(pc + o);
    return v;
  };
  const float ax = mgt_apply_node<NT, true>(s, sc, band, ix, iy, iz, load);
  if constexpr (MODE == 0) {
    om[i] = ax;
  } else if constexpr (MODE == 1) {
    om[i] = __ldg(bm + i) - ax;
  } else {
    float xi = __ldg(xc);
    if constexpr (MODE == 3) xi += __ldg(pc);
    om[i] = xi + __ldg(d + i) * (__ldg(bm + i) - ax);
  }
}
