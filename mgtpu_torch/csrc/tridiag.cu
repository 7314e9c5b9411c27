// Kernel C: the tridiagonal line solve of line Jacobi, both Thomas
// recurrences in one launch, along any grid axis of a contiguous field.
//
// Replaces the Pallas TPU kernels
//   mgtpu/ops/pallas/tridiag.py::_fwd_kernel  (K7, forward recurrence)
//   mgtpu/ops/pallas/tridiag.py::_bwd_kernel  (K7, backward + damped add)
// which were two pallas_calls with y written to device memory between them.
//
//   forward   y_i = alpha_i y_{i-1} + pivot_i r_i
//   backward  s_i = -cprime_i s_{i+1} + y_i
//   out       = omega s            (solve: no x; omega = 1 gives T^-1 r)
//             = x + omega s        (correct)
//
// The field is addressed as (outer, n, inner): n is the line length, inner
// the product of the later grid extents, outer the right-hand sides times
// the earlier extents.  The coefficients are (outer_c, n, inner) with
// outer_c dividing outer: they repeat over the right-hand sides.
// alpha is zero at line starts and cprime at line ends (line_prec), so no
// line reads past its ends.
//
// What bounds it: device memory.  Per node it reads r, alpha, pivot,
// cprime (and x) and writes out, with a handful of flops.  y goes through
// the output buffer (written in the forward pass, read back by the same
// thread in the backward pass), so the design moves 2 field passes more
// than the least traffic; at the main path's sizes y mostly stays in L2.
//
// What the design does about it:
//  * strided lines (inner > 1): neighbouring threads take neighbouring
//    lines (coalesced along inner).  A block owns a tile of `tl` lines and
//    splits each line into `nchunk` chunks, one thread per (line, chunk),
//    so a few long lines (1025 at 1025^2) still fill the card.  Each pass
//    walks its chunk once to get the chunk's affine map (A = prod a, B),
//    composes the maps of the earlier chunks from shared memory into its
//    carry, and walks again with the carry applied.
//  * contiguous lines (inner == 1): one warp per line, 32 consecutive nodes
//    per step (coalesced), a warp-shuffle scan of the affine maps in each
//    segment and the carry passed from segment to segment; the next
//    segment's loads start before the current one is scanned.
// Both are templated on float and double.
#include <cuda_runtime.h>

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

constexpr int kThreads = 256;

template <typename T, bool HAS_X>
__global__ void __launch_bounds__(kThreads) tridiag_strided(
    int n, int inner, int outer_c, int tl, int nchunk, int ntiles,
    const T* __restrict__ alpha, const T* __restrict__ pivot,
    const T* __restrict__ cprime, const T* __restrict__ r,
    const T* __restrict__ x, T omega, T* __restrict__ out) {
  __shared__ T sA[kThreads];
  __shared__ T sB[kThreads];
  const int tid = threadIdx.x;
  const int lane = tid % tl;
  const int c = tid / tl;
  const int o = blockIdx.x / ntiles;
  const int j = (blockIdx.x - o * ntiles) * tl + lane;
  const bool valid = j < inner;
  const int fb = o * n * inner + j;                  // field: node (o, 0, j)
  const int cb = (o % outer_c) * n * inner + j;      // coefficients
  const int len = (n + nchunk - 1) / nchunk;
  const int i0 = min(n, c * len);
  const int i1 = valid ? min(n, i0 + len) : i0;      // empty when invalid

  // forward, walk 1: the chunk's affine map y_end = A * y_in + B
  T a = T(1), y = T(0);
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const int k = i * inner;
    const T al = __ldg(alpha + cb + k);
    y = al * y + __ldg(pivot + cb + k) * __ldg(r + fb + k);
    a *= al;
  }
  sA[tid] = a;
  sB[tid] = y;
  __syncthreads();
  T carry = T(0);
  for (int q = 0; q < c; ++q)
    carry = sA[q * tl + lane] * carry + sB[q * tl + lane];
  __syncthreads();                                   // sA/sB reused below
  // forward, walk 2: y with the carry, kept in out
  y = carry;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const int k = i * inner;
    y = __ldg(alpha + cb + k) * y + __ldg(pivot + cb + k) * __ldg(r + fb + k);
    out[fb + k] = y;
  }

  // backward, walk 1: s_start = A * s_in + B over the chunk, high to low
  a = T(1);
  T s = T(0);
#pragma unroll 4
  for (int i = i1 - 1; i >= i0; --i) {
    const int k = i * inner;
    const T cm = -__ldg(cprime + cb + k);
    s = cm * s + out[fb + k];
    a *= cm;
  }
  sA[tid] = a;
  sB[tid] = s;
  __syncthreads();
  carry = T(0);
  for (int q = nchunk - 1; q > c; --q)
    carry = sA[q * tl + lane] * carry + sB[q * tl + lane];
  // backward, walk 2: the solution, damped, onto x
  s = carry;
#pragma unroll 4
  for (int i = i1 - 1; i >= i0; --i) {
    const int k = i * inner;
    s = -__ldg(cprime + cb + k) * s + out[fb + k];
    if constexpr (HAS_X)
      out[fb + k] = __ldg(x + fb + k) + omega * s;
    else
      out[fb + k] = omega * s;
  }
}

template <typename T, bool HAS_X>
__global__ void __launch_bounds__(kThreads) tridiag_contiguous(
    int n, int outer, int outer_c, const T* __restrict__ alpha,
    const T* __restrict__ pivot, const T* __restrict__ cprime,
    const T* __restrict__ r, const T* __restrict__ x, T omega,
    T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (line >= outer) return;                         // whole warp leaves
  const unsigned full = 0xffffffffu;
  const T* al = alpha + (line % outer_c) * n;
  const T* pv = pivot + (line % outer_c) * n;
  const T* cp = cprime + (line % outer_c) * n;
  const T* rl = r + line * n;
  T* ol = out + line * n;
  const int nseg = (n + 31) / 32;

  // forward: segments low to high; lanes past the end carry the identity
  T carry = T(0);
  int i = lane;
  T a_nx = i < n ? __ldg(al + i) : T(1);
  T b_nx = i < n ? __ldg(pv + i) * __ldg(rl + i) : T(0);
  for (int seg = 0; seg < nseg; ++seg, i += 32) {
    T a = a_nx, b = b_nx;
    const int in = i + 32;
    a_nx = in < n ? __ldg(al + in) : T(1);
    b_nx = in < n ? __ldg(pv + in) * __ldg(rl + in) : T(0);
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const T ap = __shfl_up_sync(full, a, d);
      const T bp = __shfl_up_sync(full, b, d);
      if (lane >= d) {
        b = a * bp + b;
        a = a * ap;
      }
    }
    const T y = a * carry + b;
    if (i < n) ol[i] = y;
    carry = __shfl_sync(full, y, 31);
  }

  // backward: segments high to low, y read back from out (same lane)
  carry = T(0);
  i = (nseg - 1) * 32 + lane;
  a_nx = i < n ? -__ldg(cp + i) : T(1);
  b_nx = i < n ? ol[i] : T(0);
  for (int seg = nseg - 1; seg >= 0; --seg, i -= 32) {
    T a = a_nx, b = b_nx;
    const int in = i - 32;
    if (seg > 0) {
      a_nx = -__ldg(cp + in);
      b_nx = ol[in];
    }
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const T an = __shfl_down_sync(full, a, d);
      const T bn = __shfl_down_sync(full, b, d);
      if (lane + d < 32) {
        b = a * bn + b;
        a = a * an;
      }
    }
    const T s = a * carry + b;
    if (i < n) {
      if constexpr (HAS_X)
        ol[i] = __ldg(x + line * n + i) + omega * s;
      else
        ol[i] = omega * s;
    }
    carry = __shfl_sync(full, s, 0);
  }
}

template <typename T, bool HAS_X>
static void launch(int outer, int outer_c, int n, int inner,
                   const void* alpha, const void* pivot, const void* cprime,
                   const void* r, const void* x, double omega, void* out,
                   cudaStream_t st) {
  const T* a = static_cast<const T*>(alpha);
  const T* p = static_cast<const T*>(pivot);
  const T* c = static_cast<const T*>(cprime);
  const T* rr = static_cast<const T*>(r);
  const T* xx = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (inner == 1) {
    const int blocks = (outer + kThreads / 32 - 1) / (kThreads / 32);
    tridiag_contiguous<T, HAS_X><<<blocks, kThreads, 0, st>>>(
        n, outer, outer_c, a, p, c, rr, xx, static_cast<T>(omega), o);
    return;
  }
  // wide tiles (32 lines) when there are enough of them to fill the card,
  // else narrow tiles (8 lines, still whole 32-byte sectors) and more chunks
  int tl = 32;
  if ((long long)outer * ((inner + 31) / 32) < 264) tl = 8;
  const int ntiles = (inner + tl - 1) / tl;
  const int nchunk = kThreads / tl;
  tridiag_strided<T, HAS_X><<<outer * ntiles, kThreads, 0, st>>>(
      n, inner, outer_c, tl, nchunk, ntiles, a, p, c, rr, xx,
      static_cast<T>(omega), o);
}

// dtype: 0 float32, 1 float64.  has_x: correct mode (x + omega s) when
// nonzero, else solve mode (omega s).  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for bad sizes).
extern "C" int mgt_tridiag(int dtype, int has_x, int outer, int outer_c,
                           int n, int inner, const void* alpha,
                           const void* pivot, const void* cprime,
                           const void* r, const void* x, double omega,
                           void* out, void* stream) {
  if (dtype < 0 || dtype > 1 || outer < 1 || outer_c < 1 ||
      outer % outer_c != 0 || n < 1 || inner < 1 || (has_x && !x) ||
      (long long)outer * n * inner >= (1LL << 31) ||
      (long long)outer * ((inner + 7) / 8) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (has_x)
      launch<float, true>(outer, outer_c, n, inner, alpha, pivot, cprime, r,
                          x, omega, out, st);
    else
      launch<float, false>(outer, outer_c, n, inner, alpha, pivot, cprime, r,
                           x, omega, out, st);
  } else {
    if (has_x)
      launch<double, true>(outer, outer_c, n, inner, alpha, pivot, cprime,
                           r, x, omega, out, st);
    else
      launch<double, false>(outer, outer_c, n, inner, alpha, pivot, cprime,
                            r, x, omega, out, st);
  }
  return (int)cudaGetLastError();
}
