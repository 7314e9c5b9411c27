// Kernel D: variable-coefficient stencil apply y = A x, float32 or float64,
// for any stencil of up to kMaxTaps taps with any shift along each axis.
//
// Replaces the Pallas TPU kernel
//   mgtpu/ops/pallas/stencil_kernel.py::_stencil_kernel  (K8)
// launched by stencil_matvec_pallas on the slab form G[j, i] = x[i + j NI]
// with coefficients (nd, NJ, NI), |dj| <= 1 and the in-plane shift di done
// as a circular lane roll.  This kernel computes what K8 computes, not its
// schedule: no rolls and no row blocks with halo planes.
//
// The field is addressed as a box (Z, Y, X), X contiguous, with taps
// (dz, dy, dx).  The grid stencil's 3D grid maps onto it as it is, a 2D grid
// as (1, Y, X), K8's slab form as (NJ, 1, NI) with taps (dj, 0, di), and a
// DIA matrix (diagonal offsets off_d) as (1, 1, n) with taps (0, 0, off_d).
// Smoothed-aggregation levels reach 97 taps in 2D and 179 in 3D, and the
// stride-2 transfers of those hierarchies run here as stencils too.
//   y[r, z, y, x] = sum_k coeff[k, z, y, x] * x[r, z + dz_k, y + dy_k, x + dx_k]
// for every right-hand side r < m.  A tap whose neighbour lies outside the
// box on any axis reads zero: it is masked, not multiplied by a zero
// coefficient, so a non-finite value elsewhere in x cannot leak in.
//
// What bounds it: device memory.  Per node it reads nd coefficients and the
// node's x (neighbour taps hit L1/L2) and writes one output, 2 nd flops
// against (nd + 2) * sizeof(T) bytes: far below the card's flop:byte
// balance in either precision.  The least traffic is the coefficients and
// x read once and y written once.
//
// What the design does about it: one thread per node, threads along the
// contiguous X axis (coalesced), the tap offsets in the kernel's parameter
// space (constant bank).  Each thread keeps the sums of up to MB right-hand
// sides in registers, so each coefficient is read once for every MB of
// them (MB = 1, 2, 4 or 8, the smallest that covers m; larger m loop over
// chunks of 8).  Making it faster (x tiles in shared memory, TMA, the
// residual folded in) is later work.
#include <cuda_runtime.h>

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// The offsets travel in the kernel's parameter space (constant bank):
// 4 + 3 * 256 * 4 = 3076 bytes, under the 4 KB of a classic launch.
constexpr int kMaxTaps = 256;
constexpr int kThreads = 256;

struct Taps {
  int nd;
  int dz[kMaxTaps];
  int dy[kMaxTaps];
  int dx[kMaxTaps];
};

template <typename T, int MB>
__global__ void __launch_bounds__(kThreads) stencil_kernel(
    Taps t, int Z, int Y, int X, int m, const T* __restrict__ coeff,
    const T* __restrict__ x, T* __restrict__ y) {
  const int plane = Y * X;
  const int n = Z * plane;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int iz = e / plane;
  const int rem = e - iz * plane;
  const int iy = rem / X;
  const int ix = rem - iy * X;
  for (int m0 = 0; m0 < m; m0 += MB) {
    const int mc = min(MB, m - m0);
    const T* xm = x + (size_t)m0 * n;
    T acc[MB];
#pragma unroll
    for (int r = 0; r < MB; ++r) acc[r] = T(0);
    for (int k = 0; k < t.nd; ++k) {
      const int jz = iz + t.dz[k], jy = iy + t.dy[k], jx = ix + t.dx[k];
      if (jz < 0 || jz >= Z || jy < 0 || jy >= Y || jx < 0 || jx >= X)
        continue;
      const T c = __ldg(coeff + (size_t)k * n + e);
      const int o = e + (t.dz[k] * Y + t.dy[k]) * X + t.dx[k];
#pragma unroll
      for (int r = 0; r < MB; ++r)
        if (r < mc) acc[r] = fma(c, __ldg(xm + (size_t)r * n + o), acc[r]);
    }
#pragma unroll
    for (int r = 0; r < MB; ++r)
      if (r < mc) y[(size_t)(m0 + r) * n + e] = acc[r];
  }
}

template <typename T>
static void launch(const Taps& t, int Z, int Y, int X, int m, const T* c,
                   const T* x, T* y, cudaStream_t st) {
  const int n = Z * Y * X;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (m == 1)
    stencil_kernel<T, 1><<<blocks, kThreads, 0, st>>>(t, Z, Y, X, m, c, x, y);
  else if (m == 2)
    stencil_kernel<T, 2><<<blocks, kThreads, 0, st>>>(t, Z, Y, X, m, c, x, y);
  else if (m <= 4)
    stencil_kernel<T, 4><<<blocks, kThreads, 0, st>>>(t, Z, Y, X, m, c, x, y);
  else
    stencil_kernel<T, 8><<<blocks, kThreads, 0, st>>>(t, Z, Y, X, m, c, x, y);
}

// dtype: 0 float32, 1 float64.  offs: nd rows of (dz, dy, dx).  coeff is
// (nd, Z, Y, X), x and y are (m, Z, Y, X), all contiguous.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a bad
// description).
extern "C" int mgt_stencil(int dtype, int nd, const int* offs, int Z, int Y,
                           int X, int m, const void* coeff, const void* x,
                           void* y, void* stream) {
  if (dtype < 0 || dtype > 1 || nd < 1 || nd > kMaxTaps || Z < 1 || Y < 1 ||
      X < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)Z * Y * X;
  if (n * m >= (1LL << 31) || n * nd >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Taps t;
  t.nd = nd;
  for (int k = 0; k < nd; ++k) {
    t.dz[k] = offs[3 * k];
    t.dy[k] = offs[3 * k + 1];
    t.dx[k] = offs[3 * k + 2];
    // any shift is taken (one longer than its axis is always masked); the
    // bound only keeps i + d inside int
    const int big = 1 << 30;
    if (t.dz[k] <= -big || t.dz[k] >= big || t.dy[k] <= -big ||
        t.dy[k] >= big || t.dx[k] <= -big || t.dx[k] >= big)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(t, Z, Y, X, m, static_cast<const float*>(coeff),
                  static_cast<const float*>(x), static_cast<float*>(y), st);
  else
    launch<double>(t, Z, Y, X, m, static_cast<const double*>(coeff),
                   static_cast<const double*>(x), static_cast<double*>(y), st);
  return (int)cudaGetLastError();
}
