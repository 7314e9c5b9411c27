// Kernel A: one-pass apply of a 3D constant-interior radius-1 stencil,
// exact on the whole grid, with the smoother arithmetic folded in.
//
// Replaces the Pallas TPU kernels
//   mgtpu/ops/pallas/const3d.py::_interior_kernel   (K1, y = A x)
//   mgtpu/ops/pallas/const3d.py::_xband_fix_kernel  (K2, exact x-band rows)
//   mgtpu/ops/pallas/fused3d.py::_fused_kernel      (K3-K5: residual,
//                                                     jacobi, jacobi_corr)
// Modes (compile-time):
//   0 matvec       out = A x
//   1 residual     out = b - A x
//   2 jacobi       out = x + d * (b - A x)
//   3 jacobi_corr  out = s + d * (b - A s),  s = x + p (p read with halo)
//
// What bounds it: device memory.  Per node it reads nd taps of x (p) and
// writes one value: about 2*nd flops against 8-20 bytes of fields, far
// below the card's flop:byte balance.  The least traffic is each field
// read once and the output written once; the w-wide band also reads its
// per-node coefficients (nd floats per band node).
//
// What the design does about it: one thread per output node, threads along
// the contiguous z axis (flattened over the (y, z) plane so a 129-wide row
// leaves no idle warp lanes), one block row per (x plane, right-hand side).
// Neighbour taps come from global memory through L1/L2, so x is fetched
// from device memory about once.  Interior nodes take the constants from
// shared memory with no bounds checks; band nodes read the coefficient of
// the disjoint box that holds them, with bounds-checked taps that read
// zero outside the grid.  Every node is exact in one launch: the TPU
// kernels' circular rolls and the separate x-band fix kernel (K2) are not
// needed.
#include "stencil3d.cuh"

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

template <int MODE, int NT>
__global__ void __launch_bounds__(256) stencil3d_apply_kernel(
    Stencil3D s, const float* __restrict__ cst,
    const float* __restrict__ band, const float* __restrict__ x,
    const float* __restrict__ b, const float* __restrict__ d,
    const float* __restrict__ p, float* __restrict__ out) {
  __shared__ float sc[MGT_MAX_TAPS];
  mgt_load_consts<NT>(s, cst, sc, threadIdx.x);
  __syncthreads();
  const int plane = s.Y * s.Z;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;   // node in the plane
  if (e >= plane) return;
  const int iy = e / s.Z;
  const int iz = e - iy * s.Z;
  const int ix = blockIdx.y;
  const int moff = blockIdx.z * plane * s.X;
  const int i = ix * plane + e;
  const float* xc = x + moff + i;                       // the node itself
  const float* pc = MODE == 3 ? p + moff + i : nullptr;  // s = x + p
  auto load = [&](int dx, int dy, int dz) {
    const int o = dx * plane + dy * s.Z + dz;
    float v = __ldg(xc + o);
    if constexpr (MODE == 3) v += __ldg(pc + o);
    return v;
  };
  const float ax = mgt_apply_node<NT, true>(s, sc, band, ix, iy, iz, load);
  if constexpr (MODE == 0) {
    out[moff + i] = ax;
  } else if constexpr (MODE == 1) {
    out[moff + i] = __ldg(b + moff + i) - ax;
  } else {
    float xi = __ldg(xc);
    if constexpr (MODE == 3) xi += __ldg(pc);
    out[moff + i] = xi + __ldg(d + i) * (__ldg(b + moff + i) - ax);
  }
}

template <int NT>
static void launch_apply(int mode, dim3 grid, cudaStream_t st,
                         const Stencil3D& s, const float* c, const float* bd,
                         const float* x, const float* b, const float* d,
                         const float* p, float* o) {
  switch (mode) {
    case 0: stencil3d_apply_kernel<0, NT><<<grid, 256, 0, st>>>(s, c, bd, x, b, d, p, o); break;
    case 1: stencil3d_apply_kernel<1, NT><<<grid, 256, 0, st>>>(s, c, bd, x, b, d, p, o); break;
    case 2: stencil3d_apply_kernel<2, NT><<<grid, 256, 0, st>>>(s, c, bd, x, b, d, p, o); break;
    default: stencil3d_apply_kernel<3, NT><<<grid, 256, 0, st>>>(s, c, bd, x, b, d, p, o); break;
  }
}

// meta: host int32 stencil description (see stencil3d.cuh); m: number of
// right-hand sides; d is shared across them.  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a bad description).
extern "C" int mgt_stencil3d_apply(int mode, const int* meta, int m,
                                   const void* cst, const void* band,
                                   const void* x, const void* b,
                                   const void* d, const void* p, void* out,
                                   void* stream) {
  Stencil3D s;
  if (mgt_stencil_from_meta(meta, &s) != 0 || m < 1 || m > 65535 ||
      s.X < 1 || s.X > 65535 || mode < 0 || mode > 3 ||
      (long long)m * s.X * s.Y * s.Z >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)s.Y * s.Z;
  dim3 grid((unsigned)((plane + 255) / 256), (unsigned)s.X, (unsigned)m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch) {
    launch(mode, grid, st, s, static_cast<const float*>(cst),
           static_cast<const float*>(band), static_cast<const float*>(x),
           static_cast<const float*>(b), static_cast<const float*>(d),
           static_cast<const float*>(p), static_cast<float*>(out));
  };
  if (mgt_tap_count(s.nd) == 7)
    args(launch_apply<7>);
  else
    args(launch_apply<27>);
  return (int)cudaGetLastError();
}
