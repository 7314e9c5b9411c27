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
// cprime (and x) and writes out, with a handful of flops: the least
// traffic is 5 field passes in solve mode and 6 in correct mode.
//
// The design (two variants, chosen by the host from the shape alone; the
// launch plan is computed in mgtpu_torch/ops/cuda/tridiag.py::line_plan and
// checked here):
//  * staged (every line whose tile fits in shared memory; every line of the
//    main path): a block stages a tile of lines -- alpha, pivot, cprime, r
//    -- in shared memory with every load in flight at once (cp.async, 4 or
//    8 bytes each: rows of the odd grid widths are not 16-byte aligned),
//    and in correct mode x as a second group that arrives meanwhile.
//    One warp per strided line, one to four per contiguous line (about 8
//    nodes a lane), then run both
//    recurrences out of shared memory: each lane walks a chunk of odd
//    length (so the 32 lanes hit 32 banks), the chunks' affine maps
//    (A = prod a, B) are composed by a warp-shuffle scan and across the
//    line's warps, and a second walk applies the carry.  y overwrites r's
//    slot and s overwrites y's, so y never leaves the chip.  The block then
//    writes out once, coalesced.  Tiles:
//      - contiguous lines (inner == 1): `tile` consecutive lines, one after
//        the other in shared memory;
//      - strided lines: `32 / sizeof(T)` lines neighbouring along inner, so
//        each row of the tile is one whole 32-byte sector; rows are padded
//        by one element so a warp's chunk starts fall in distinct banks.
//    Above 48 KB a block needs the opt-in to (nearly) 227 KB of dynamic
//    shared memory, set once per instantiation.
//  * streamed (lines too long for a tile): the PR 2 kernels.  On a strided
//    axis a block owns `tl` lines split into chunks, one thread each, and
//    walks each chunk twice per recurrence from device memory; on the
//    contiguous axis one warp walks a line 32 nodes at a time with a
//    shuffle scan.  y goes through the output buffer (two extra passes).
// Both are templated on the value type: float, double, and float2 /
// double2 (torch's complex64 / complex128 layout).  mgtpu computes its
// complex lines with its XLA doubling scan (cycle/relax.py::_scan_linear;
// its Pallas kernel is float32 only): the same two recurrences with complex
// alpha, pivot and cprime, no conjugate.  A complex value goes through the
// overloaded operators below (a complex product is four real multiplies),
// so the real instantiations compile to the instructions they had; omega
// stays real.  A strided staged tile holds 4 complex64 or 2 complex128
// lines (one 32-byte sector a row).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// complex arithmetic on float2 / double2 (.x the real part, .y the
// imaginary part)
__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 operator+(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator*(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 operator*(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 operator*(float w, float2 a) {
  return make_float2(w * a.x, w * a.y);
}
__device__ __forceinline__ double2 operator*(double w, double2 a) {
  return make_double2(w * a.x, w * a.y);
}
__device__ __forceinline__ float2 operator-(float2 a) {
  return make_float2(-a.x, -a.y);
}
__device__ __forceinline__ double2 operator-(double2 a) {
  return make_double2(-a.x, -a.y);
}
__device__ __forceinline__ float2& operator*=(float2& a, float2 b) {
  return a = a * b;
}
__device__ __forceinline__ double2& operator*=(double2& a, double2 b) {
  return a = a * b;
}

// the real type of a value type (omega's), and 0 and 1 of the value type
template <typename T>
struct Real {
  using type = T;
};
template <>
struct Real<float2> {
  using type = float;
};
template <>
struct Real<double2> {
  using type = double;
};
template <typename T>
__device__ __forceinline__ T zero() {
  return T{};
}
template <typename T>
__device__ __forceinline__ T one() {
  return T(1);
}
template <>
__device__ __forceinline__ float2 one<float2>() {
  return make_float2(1.f, 0.f);
}
template <>
__device__ __forceinline__ double2 one<double2>() {
  return make_double2(1.0, 0.0);
}

// warp shuffles of a value (a complex one part by part)
__device__ __forceinline__ float shfl_up(float v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}
__device__ __forceinline__ double shfl_up(double v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}
__device__ __forceinline__ float shfl_down(float v, int d) {
  return __shfl_down_sync(0xffffffffu, v, d);
}
__device__ __forceinline__ double shfl_down(double v, int d) {
  return __shfl_down_sync(0xffffffffu, v, d);
}
__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ double shfl(double v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
template <typename V>
__device__ __forceinline__ V shfl_up(V v, int d) {
  v.x = shfl_up(v.x, d);
  v.y = shfl_up(v.y, d);
  return v;
}
template <typename V>
__device__ __forceinline__ V shfl_down(V v, int d) {
  v.x = shfl_down(v.x, d);
  v.y = shfl_down(v.y, d);
  return v;
}
template <typename V>
__device__ __forceinline__ V shfl(V v, int src) {
  v.x = shfl(v.x, src);
  v.y = shfl(v.y, src);
  return v;
}

constexpr int kThreads = 256;        // streamed variant
// shared memory a block may opt into, less the staged kernel's static
// cross-warp slots (ta, ty: 2 x 32 values of at least 8 bytes)
__host__ __device__ constexpr int max_smem(int itemsize) {
  return 232448 - 2 * 32 * (itemsize > 8 ? itemsize : 8);
}
constexpr int kStaged = 0, kStreamed = 1;

// lines of a strided staged tile: one 32-byte sector per row
template <typename T>
__host__ __device__ constexpr int strided_tile() {
  return 32 / static_cast<int>(sizeof(T));
}

// warps that share one staged line: on a contiguous axis enough that a
// lane walks about 8 nodes; on a strided axis one (four did not pay on an
// H100: 1025^2 axis 0 went from 16.0 to 17.1 us in solve mode)
__host__ __device__ inline int staged_warps(int n, bool strided) {
  return strided ? 1 : n >= 1024 ? 4 : n >= 512 ? 2 : 1;
}

// chunk length of a staged line of W warps: odd, so the chunk starts of
// the 32 lanes of a warp fall in 32 distinct banks
__host__ __device__ inline int staged_chunk(int n, int W) {
  const int chunks = 32 * W;
  return ((n + chunks - 1) / chunks) | 1;
}

// Both recurrences of one line held in shared memory, by the W warps of
// the line (wl: this warp's rank among them).  Element i of the line is at
// i * st in sa (alpha), sp (pivot), sc (cprime) and sy (r on entry, s on
// exit).  Lane chunks are walked once for their affine map, the maps
// composed by a warp-shuffle scan and, across the W warps, through ta/ty
// (this line's W slots), and walked again with the carry.  n = 0 (a warp
// of a line past the tile's end) walks nothing but takes part in the
// barriers, which every thread of the block reaches (W is the block's).
template <typename T>
__device__ __forceinline__ void line_in_smem(int n, int st, const T* sa,
                                             const T* sp, const T* sc, T* sy,
                                             int W, int wl, int lane, T* ta,
                                             T* ty) {
  const int len = staged_chunk(n, W);
  const int i0 = min(n, (wl * 32 + lane) * len);
  const int i1 = min(n, i0 + len);
  // forward, walk 1: the chunk's map y_end = a * y_in + y
  T a = one<T>(), y = zero<T>();
#pragma unroll 8
  for (int i = i0; i < i1; ++i) {
    const T al = sa[i * st];
    y = al * y + sp[i * st] * sy[i * st];
    a *= al;
  }
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const T ap = shfl_up(a, d);
    const T yp = shfl_up(y, d);
    if (lane >= d) {
      y = a * yp + y;
      a = a * ap;
    }
  }
  T carry = zero<T>();                               // y before this warp
  if (W > 1) {                                       // block-uniform
    if (lane == 31) {
      ta[wl] = a;
      ty[wl] = y;
    }
    __syncthreads();
    for (int q = 0; q < wl; ++q) carry = ta[q] * carry + ty[q];
    __syncthreads();                                 // ta/ty reused below
  }
  T ap = shfl_up(a, 1);
  T yp = shfl_up(y, 1);
  // forward, walk 2: y with the carry, over r's slot (each lane touches
  // only its own chunk, so no barrier is needed between the walks)
  y = lane == 0 ? carry : ap * carry + yp;
#pragma unroll 8
  for (int i = i0; i < i1; ++i) {
    y = sa[i * st] * y + sp[i * st] * sy[i * st];
    sy[i * st] = y;
  }
  // backward, walk 1: s_start = a * s_in + s over the chunk, high to low
  a = one<T>();
  T s = zero<T>();
#pragma unroll 8
  for (int i = i1 - 1; i >= i0; --i) {
    const T cm = -sc[i * st];
    s = cm * s + sy[i * st];
    a *= cm;
  }
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const T an = shfl_down(a, d);
    const T sn = shfl_down(s, d);
    if (lane + d < 32) {
      s = a * sn + s;
      a = a * an;
    }
  }
  carry = zero<T>();                                 // s after this warp
  if (W > 1) {
    if (lane == 0) {
      ta[wl] = a;
      ty[wl] = s;
    }
    __syncthreads();
    for (int q = W - 1; q > wl; --q) carry = ta[q] * carry + ty[q];
  }
  ap = shfl_down(a, 1);
  yp = shfl_down(s, 1);
  // backward, walk 2: the solution, over y's slot
  s = lane == 31 ? carry : ap * carry + yp;
#pragma unroll 8
  for (int i = i1 - 1; i >= i0; --i) {
    s = -sc[i * st] * s + sy[i * st];
    sy[i * st] = s;
  }
}

// Staged variant.  STRIDED: block = (o, tile of strided_tile<T>() lines
// from j0 along inner); else block = `tile` consecutive lines from line0.
// staged_warps warps per line; blockDim.x = 32 * that * tile.  Shared
// memory: alpha, pivot, cprime, r (then y, then s) and, with HAS_X, x.
template <typename T, bool HAS_X, bool STRIDED>
__global__ void __launch_bounds__(1024) tridiag_staged(
    int n, int inner, int outer, int outer_c, int tile, int ntiles,
    const T* __restrict__ alpha, const T* __restrict__ pivot,
    const T* __restrict__ cprime, const T* __restrict__ r,
    const T* __restrict__ x, typename Real<T>::type omega,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int TL = strided_tile<T>();
  const int ld = TL + 1;                               // strided row stride
  const int per = STRIDED ? n * ld : tile * n;         // elements per array
  T* sa = sm;
  T* sp = sm + per;
  T* sc = sm + 2 * per;
  T* sy = sm + 3 * per;
  T* sx = sm + 4 * per;                                // correct mode
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  // the tile: nl valid lines; element (l, i) of the tile lies at field
  // index fb + f(l, i), coefficient index cb + f(l, i) (strided) and at
  // shared index g(l, i)
  int nl, fb, cb, line0 = 0;
  if constexpr (STRIDED) {
    const int o = blockIdx.x / ntiles;
    const int j0 = (blockIdx.x - o * ntiles) * TL;
    nl = min(TL, inner - j0);
    fb = o * n * inner + j0;
    cb = (o % outer_c) * n * inner + j0;
  } else {
    line0 = blockIdx.x * tile;
    nl = min(tile, outer - line0);
    fb = line0 * n;
    cb = 0;
  }
  const int nel = STRIDED ? n * TL : nl * n;

  // stage: every load of the tile in flight together
  for (int e = tid; e < nel; e += nth) {
    int gf, gc, s;
    if constexpr (STRIDED) {
      const int i = e / TL, l = e - i * TL;
      if (l >= nl) continue;
      gf = fb + i * inner + l;
      gc = cb + i * inner + l;
      s = i * ld + l;
    } else {
      const int l = e / n, i = e - l * n;
      gf = fb + e;
      gc = ((line0 + l) % outer_c) * n + i;
      s = e;
    }
    __pipeline_memcpy_async(sa + s, alpha + gc, sizeof(T));
    __pipeline_memcpy_async(sp + s, pivot + gc, sizeof(T));
    __pipeline_memcpy_async(sc + s, cprime + gc, sizeof(T));
    __pipeline_memcpy_async(sy + s, r + gf, sizeof(T));
  }
  __pipeline_commit();
  if constexpr (HAS_X) {                               // arrives meanwhile
    for (int e = tid; e < nel; e += nth) {
      int gf, s;
      if constexpr (STRIDED) {
        const int i = e / TL, l = e - i * TL;
        if (l >= nl) continue;
        gf = fb + i * inner + l;
        s = i * ld + l;
      } else {
        gf = fb + e;
        s = e;
      }
      __pipeline_memcpy_async(sx + s, x + gf, sizeof(T));
    }
    __pipeline_commit();
  }
  __pipeline_wait_prior(HAS_X ? 1 : 0);
  __syncthreads();

  // W warps per line; every warp runs the line code (a line past the
  // tile's end with n = 0) so that all reach its barriers
  __shared__ T ta[32], ty[32];
  const int W = staged_warps(n, STRIDED);
  const int warp = tid >> 5;
  const int line = warp / W, wl = warp - line * W;
  const int nn = line < nl ? n : 0;
  if constexpr (STRIDED)
    line_in_smem<T>(nn, ld, sa + line, sp + line, sc + line, sy + line, W,
                    wl, tid & 31, ta + line * W, ty + line * W);
  else
    line_in_smem<T>(nn, 1, sa + line * n, sp + line * n, sc + line * n,
                    sy + line * n, W, wl, tid & 31, ta + line * W,
                    ty + line * W);
  __pipeline_wait_prior(0);
  __syncthreads();

  // write out once, coalesced
  for (int e = tid; e < nel; e += nth) {
    int gf, s;
    if constexpr (STRIDED) {
      const int i = e / TL, l = e - i * TL;
      if (l >= nl) continue;
      gf = fb + i * inner + l;
      s = i * ld + l;
    } else {
      gf = fb + e;
      s = e;
    }
    if constexpr (HAS_X)
      out[gf] = sx[s] + omega * sy[s];
    else
      out[gf] = omega * sy[s];
  }
}

template <typename T, bool HAS_X>
__global__ void __launch_bounds__(kThreads) tridiag_strided(
    int n, int inner, int outer_c, int tl, int nchunk, int ntiles,
    const T* __restrict__ alpha, const T* __restrict__ pivot,
    const T* __restrict__ cprime, const T* __restrict__ r,
    const T* __restrict__ x, typename Real<T>::type omega,
    T* __restrict__ out) {
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
  T a = one<T>(), y = zero<T>();
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
  T carry = zero<T>();
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
  a = one<T>();
  T s = zero<T>();
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
  carry = zero<T>();
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
    const T* __restrict__ r, const T* __restrict__ x,
    typename Real<T>::type omega, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (line >= outer) return;                         // whole warp leaves
  const T* al = alpha + (line % outer_c) * n;
  const T* pv = pivot + (line % outer_c) * n;
  const T* cp = cprime + (line % outer_c) * n;
  const T* rl = r + line * n;
  T* ol = out + line * n;
  const int nseg = (n + 31) / 32;

  // forward: segments low to high; lanes past the end carry the identity
  T carry = zero<T>();
  int i = lane;
  T a_nx = i < n ? __ldg(al + i) : one<T>();
  T b_nx = i < n ? __ldg(pv + i) * __ldg(rl + i) : zero<T>();
  for (int seg = 0; seg < nseg; ++seg, i += 32) {
    T a = a_nx, b = b_nx;
    const int in = i + 32;
    a_nx = in < n ? __ldg(al + in) : one<T>();
    b_nx = in < n ? __ldg(pv + in) * __ldg(rl + in) : zero<T>();
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const T ap = shfl_up(a, d);
      const T bp = shfl_up(b, d);
      if (lane >= d) {
        b = a * bp + b;
        a = a * ap;
      }
    }
    const T y = a * carry + b;
    if (i < n) ol[i] = y;
    carry = shfl(y, 31);
  }

  // backward: segments high to low, y read back from out (same lane)
  carry = zero<T>();
  i = (nseg - 1) * 32 + lane;
  a_nx = i < n ? -__ldg(cp + i) : one<T>();
  b_nx = i < n ? ol[i] : zero<T>();
  for (int seg = nseg - 1; seg >= 0; --seg, i -= 32) {
    T a = a_nx, b = b_nx;
    const int in = i - 32;
    if (seg > 0) {
      a_nx = -__ldg(cp + in);
      b_nx = ol[in];
    }
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const T an = shfl_down(a, d);
      const T bn = shfl_down(b, d);
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
    carry = shfl(s, 0);
  }
}

// The launch plan (line_plan in ops/cuda/tridiag.py):
//   plan = [variant, tile, nchunk, threads, blocks, smem]
// Returns true when it is the plan of this shape: the derived numbers are
// recomputed here, so a plan that disagrees is refused, not launched.
static bool plan_ok(const int* plan, int itemsize, int has_x, int outer,
                    int n, int inner) {
  const int arrays = has_x ? 5 : 4;                    // + x in correct mode
  const int variant = plan[0], tile = plan[1], nchunk = plan[2];
  const int threads = plan[3], blocks = plan[4], smem = plan[5];
  long long want_blocks, want_smem, want_threads;
  int want_nchunk;
  if (variant == kStaged) {
    if (inner > 1) {
      if (tile != 32 / itemsize) return false;
      want_blocks = (long long)outer * ((inner + tile - 1) / tile);
      want_smem = (long long)arrays * n * (tile + 1) * itemsize;
    } else {
      if (tile < 1 || tile > 32) return false;
      want_blocks = ((long long)outer + tile - 1) / tile;
      want_smem = (long long)arrays * tile * n * itemsize;
    }
    want_nchunk = 32 * staged_warps(n, inner > 1);
    want_threads = (long long)want_nchunk * tile;
    if (want_smem > max_smem(itemsize) || want_threads > 1024) return false;
  } else if (variant == kStreamed) {
    if (inner > 1) {
      if (tile != 8 && tile != 32) return false;
      want_blocks = (long long)outer * ((inner + tile - 1) / tile);
      want_nchunk = kThreads / tile;
    } else {
      if (tile != kThreads / 32) return false;
      want_blocks = ((long long)outer + tile - 1) / tile;
      want_nchunk = 32;
    }
    want_threads = kThreads;
    want_smem = 0;
  } else {
    return false;
  }
  return nchunk == want_nchunk && threads == want_threads &&
         blocks == want_blocks && smem == want_smem &&
         want_blocks < (1LL << 31);
}

template <typename T, typename K>
static cudaError_t allow_smem(K* kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              max_smem(static_cast<int>(sizeof(T))));
}

template <typename T, bool HAS_X, bool STRIDED>
static cudaError_t launch_staged(const int* plan, int outer, int outer_c,
                                 int n, int inner, const T* a, const T* p,
                                 const T* c, const T* rr, const T* xx,
                                 typename Real<T>::type omega, T* o,
                                 cudaStream_t st) {
  auto* kernel = tridiag_staged<T, HAS_X, STRIDED>;
  static const cudaError_t opt_in = allow_smem<T>(kernel);  // once a kernel
  if (opt_in != cudaSuccess) return opt_in;
  const int ntiles = STRIDED ? (inner + plan[1] - 1) / plan[1] : 0;
  kernel<<<plan[4], plan[3], plan[5], st>>>(n, inner, outer, outer_c,
                                            plan[1], ntiles, a, p, c, rr, xx,
                                            omega, o);
  return cudaSuccess;
}

template <typename T, bool HAS_X>
static cudaError_t launch(const int* plan, int outer, int outer_c, int n,
                          int inner, const void* alpha, const void* pivot,
                          const void* cprime, const void* r, const void* x,
                          double omega, void* out, cudaStream_t st) {
  const T* a = static_cast<const T*>(alpha);
  const T* p = static_cast<const T*>(pivot);
  const T* c = static_cast<const T*>(cprime);
  const T* rr = static_cast<const T*>(r);
  const T* xx = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const auto w = static_cast<typename Real<T>::type>(omega);
  if (plan[0] == kStaged) {
    if (inner > 1)
      return launch_staged<T, HAS_X, true>(plan, outer, outer_c, n, inner, a,
                                           p, c, rr, xx, w, o, st);
    return launch_staged<T, HAS_X, false>(plan, outer, outer_c, n, inner, a,
                                          p, c, rr, xx, w, o, st);
  }
  if (inner == 1) {
    tridiag_contiguous<T, HAS_X><<<plan[4], kThreads, 0, st>>>(
        n, outer, outer_c, a, p, c, rr, xx, w, o);
    return cudaSuccess;
  }
  const int tl = plan[1];
  tridiag_strided<T, HAS_X><<<plan[4], kThreads, 0, st>>>(
      n, inner, outer_c, tl, plan[2], (inner + tl - 1) / tl, a, p, c, rr, xx,
      w, o);
  return cudaSuccess;
}

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128 (interleaved
// real and imaginary parts; omega real).  has_x: correct mode (x + omega s) when
// nonzero, else solve mode (omega s).  plan: the host's launch plan (see
// plan_ok).  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for bad sizes or a plan that does not fit them).
extern "C" int mgt_tridiag(int dtype, int has_x, int outer, int outer_c,
                           int n, int inner, const void* alpha,
                           const void* pivot, const void* cprime,
                           const void* r, const void* x, double omega,
                           void* out, void* stream, const int* plan) {
  const int itemsize = dtype == 0 ? 4 : dtype == 3 ? 16 : 8;
  if (dtype < 0 || dtype > 3 || outer < 1 || outer_c < 1 ||
      outer % outer_c != 0 || n < 1 || inner < 1 || (has_x && !x) ||
      !plan || (long long)outer * n * inner >= (1LL << 31) ||
      !plan_ok(plan, itemsize, has_x, outer, n, inner))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return has_x ? launch<T, true>(plan, outer, outer_c, n, inner, alpha,
                                   pivot, cprime, r, x, omega, out, st)
                 : launch<T, false>(plan, outer, outer_c, n, inner, alpha,
                                    pivot, cprime, r, x, omega, out, st);
  };
  const cudaError_t e =
      dtype == 0   ? go(static_cast<float*>(nullptr))
      : dtype == 1 ? go(static_cast<double*>(nullptr))
      : dtype == 2 ? go(static_cast<float2*>(nullptr))
                   : go(static_cast<double2*>(nullptr));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
