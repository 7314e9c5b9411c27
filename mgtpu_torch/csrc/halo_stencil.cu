// Kernel D's halo form: y = A x, the residual r = b - A x, or the damped
// Jacobi update x' = x + d (b - A x) of a rank's block of a sharded grid
// operator, reading its neighbours' halo planes where they arrived.
// float32, float64, complex64 or complex128 (the Jacobi update: float32 and
// float64, the slab GMG's types).
//
// Replaces, on the multi-device paths, the extended block (torch.cat of
// the left planes, the block and the right planes, zero planes at the
// ends of the axis), one launch of kernel D's cross form on it (halo_apply)
// and torch's subtraction from b or Jacobi update after it
// (parallel/stencil.py, parallel/sharded.py, parallel/grid_sharded.py).
// mgtpu computes the same in XLA around the Pallas kernel K8
// (mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel):
// mgtpu/parallel/stencil.py:97 stencil_matvec_local on the halo-extended
// slab (its :110 overlapped form, :151 exchange_halo), the slab
// relaxation and V-cycle residuals of mgtpu/parallel/sharded.py:109-123,
// and the GSPMD-sharded grid levels of mgtpu/parallel/grid_sharded.py:95.
//
// The source: along the halo axis h, three segments, each with its own
// pointer and box: the left planes (wl of them), the owned block (the
// input box I) and the right planes (wr).  A tap's source s = r + d (d in
// the owned block's frame) with s_h < 0 reads the left planes at s_h + wl,
// s_h >= I_h the right planes at s_h - I_h; a missing neighbour is a null
// pointer, its taps predicated off, as a tap off the box is: nothing is
// read and nothing added.  Along the other axes the source lies in I (the
// pencil's second phase: I is the block extended along the first axis,
// the taps shifted by that axis's halo).
//
// Arithmetic: each node sums the same taps in the same order with the same
// multiply-add (stencil_math.cuh) as the cross form on the extended block,
// under the same tap slicing (the split of stencil_plan of the whole block,
// slice sums added in slice order); the epilogue rounds as torch does:
// b - y one rounding, x + d * (b - y) three (no contraction into an FMA).
// So each form is bit for bit the old path (a zero's sign aside, where a
// predicated tap replaces c * 0).
//
// The output rows: a launch writes the rows [r0, r1) and [r2, r3) of the
// halo axis into y, the rest left alone: the overlapped slab apply writes
// the interior rows while the exchange is in flight, then both edge rows
// in one launch into the same tensor.
//
// Launch shape: one thread a node and slice, 256 threads a CUDA block, as
// the cross form.  A warp takes one of two loop nests, by a warp vote:
// every source in the owned block (no test), or each source's segment
// found and tested.  In float32 the register cap is 40 (6 blocks an SM)
// where the other forms take 32: the segment test spilled at 32, and that
// cost more than the occupancy gave.  Measured slower and not kept: two
// nodes a thread (fewer CUDA blocks, MS-2d's slab in one wave), and a
// third loop nest with the cross form's box test for warps whose rows
// read the owned block alone.
//
// What bounds it: device memory.  Per node the coefficients, x (its
// neighbour taps hit L1/L2), b and for the Jacobi update x and d once
// more, one output: 2 flops a tap against a byte or more a flop.  What the
// form saves over the old path is the passes around the launch: the cat
// (x read and written), the zero planes, the subtraction or the update
// (two or four more passes over the block) and their launches.
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "stencil_math.cuh"

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

constexpr int kMaxTaps = 256;
constexpr int kMaxShift = 1 << 15;       // taps' shifts travel as int16
enum Form { kApply = 0, kResidual = 1, kJacobi = 2 };

// Taps as (lin, dz, dy, dx): lin the offset in the owned block's box, the
// shifts in its frame; 256 taps take 2560 bytes, under a classic launch's
// 4 KB of parameters with the rest.
struct HaloArgs {
  int lin[kMaxTaps];
  short dz[kMaxTaps];
  short dy[kMaxTaps];
  short dx[kMaxTaps];
  const void* left;      // (m, box with wl planes along h), or null
  const void* own;       // (m, I)
  const void* right;     // (m, box with wr planes along h), or null
  const void* coeff;     // (nd, O)
  const void* b;         // (m, O): residual and jacobi
  const void* d;         // (O): jacobi
  void* y;               // (m, O)
  int o[3], i[3];        // output and owned boxes, (Z, Y, X)
  int lo[3], hi[3];      // output nodes whose taps all land in the owned block
  int rows[4];           // output rows along h: [r0, r1) and [r2, r3)
  int h, wl, wr, nd, m, lg_split, per_slice;
};
static_assert(sizeof(HaloArgs) <= 4000, "halo arguments over 4 KB");

// Blocks an SM the register budget must allow: 6 for one right-hand side
// in float32 (40 registers), else the other forms' min_blocks.
template <typename T, int MB>
constexpr int halo_min_blocks() {
  return sizeof(T) == 4 && MB == 1 ? 6 : min_blocks<T, MB>();
}

__device__ __forceinline__ float jacobi(float x, float d, float b, float y) {
  return __fadd_rn(x, __fmul_rn(d, __fsub_rn(b, y)));
}
__device__ __forceinline__ double jacobi(double x, double d, double b,
                                         double y) {
  return __dadd_rn(x, __dmul_rn(d, __dsub_rn(b, y)));
}

// One tap's loads at one node: the coefficient and x of mc right-hand
// sides, zero (and nothing read) where the source is missing.  CHECK:
// find the source's segment and test it (else it lies in the owned block
// at base + lin).
template <typename T, int MB, bool CHECK>
__device__ __forceinline__ void load_tap(const HaloArgs& a, int k, int n,
                                         int ni, int eo, int iz, int iy,
                                         int ix, int base, int m0, int mc,
                                         T& c, T (&v)[MB]) {
  const T* src = static_cast<const T*>(a.own);
  int off = base + a.lin[k];
  int sn = ni;
  bool ok = true;
  if (CHECK) {
    const int h = a.h;
    const int sz = iz + a.dz[k], sy = iy + a.dy[k], sx = ix + a.dx[k];
    ok = (h == 0 || (unsigned)sz < (unsigned)a.i[0]) &&
         (h == 1 || (unsigned)sy < (unsigned)a.i[1]) &&
         (h == 2 || (unsigned)sx < (unsigned)a.i[2]);
    const int sh = h == 0 ? sz : h == 1 ? sy : sx;
    const int ih = h == 0 ? a.i[0] : h == 1 ? a.i[1] : a.i[2];
    int ch = sh, eh = ih;
    if (sh < 0) {
      src = static_cast<const T*>(a.left);
      ch = sh + a.wl;
      eh = a.wl;
    } else if (sh >= ih) {
      src = static_cast<const T*>(a.right);
      ch = sh - ih;
      eh = a.wr;
    }
    ok = ok && src != nullptr && ch >= 0 && ch < eh;
    const int bz = h == 0 ? eh : a.i[0], by = h == 1 ? eh : a.i[1],
              bx = h == 2 ? eh : a.i[2];
    const int cz = h == 0 ? ch : sz, cy = h == 1 ? ch : sy,
              cx = h == 2 ? ch : sx;
    off = ok ? (cz * by + cy) * bx + cx : 0;
    sn = bz * by * bx;
  }
  if (ok) {
    c = __ldg(static_cast<const T*>(a.coeff) + k * n + eo);
    const T* xm = src + (size_t)m0 * sn;
#pragma unroll
    for (int r = 0; r < MB; ++r)
      if (r < mc) v[r] = __ldg(xm + r * sn + off);
  }
}

// acc += the taps [k0, k1) of one output node, in groups of G: the
// group's loads first, then its multiply-adds in tap order; CHECK as
// load_tap's.
template <typename T, int MB, bool CHECK>
__device__ __forceinline__ void sum_taps(T (&acc)[MB], const HaloArgs& a,
                                         int k0, int k1, int n, int ni,
                                         int eo, int iz, int iy, int ix,
                                         int base, int m0, int mc) {
  constexpr int G = group_of(MB);
  for (int kb = k0; kb < k1; kb += G) {
    const int nt = k1 - kb;
    T c[G];
    T v[G][MB];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      c[q] = zero<T>();
#pragma unroll
      for (int r = 0; r < MB; ++r) v[q][r] = zero<T>();
      if (q < nt)
        load_tap<T, MB, CHECK>(a, kb + q, n, ni, eo, iz, iy, ix, base, m0,
                               mc, c[q], v[q]);
    }
#pragma unroll
    for (int q = 0; q < G; ++q)
      if (q < nt) {
#pragma unroll
        for (int r = 0; r < MB; ++r) acc[r] = mad(c[q], v[q][r], acc[r]);
      }
  }
}

template <typename T, int MB, int FORM>
__global__ void __launch_bounds__(kThreads, (halo_min_blocks<T, MB>()))
    halo_kernel(const HaloArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);
  const int lg_nb = kLgThreads - a.lg_split;
  const int nb = 1 << lg_nb;                 // nodes of a CUDA block
  const int slot = threadIdx.x & (nb - 1);
  const int slice = threadIdx.x >> lg_nb;
  const int h = a.h;
  const int n1 = a.rows[1] - a.rows[0];
  const int nr = n1 + a.rows[3] - a.rows[2];
  // the launch's nodes: the output box with the halo axis cut to its rows
  const int ey = h == 1 ? nr : a.o[1], ex = h == 2 ? nr : a.o[2];
  const int ez = h == 0 ? nr : a.o[0];
  const int n = a.o[0] * a.o[1] * a.o[2];
  const int ni = a.i[0] * a.i[1] * a.i[2];
  const int e = blockIdx.x * nb + slot;
  const bool live = e < ez * ey * ex;
  int iz = 0, iy = 0, ix = 0;
  if (live) {
    iz = e / (ey * ex);
    const int rem = e - iz * (ey * ex);
    iy = rem / ex;
    ix = rem - iy * ex;
    const int c = h == 0 ? iz : h == 1 ? iy : ix;
    const int row = c < n1 ? a.rows[0] + c : a.rows[2] + c - n1;
    iz = h == 0 ? row : iz;
    iy = h == 1 ? row : iy;
    ix = h == 2 ? row : ix;
  }
  const int eo = (iz * a.o[1] + iy) * a.o[2] + ix;
  const int base = (iz * a.i[1] + iy) * a.i[2] + ix;
  // a warp whose nodes all read the owned block alone skips the tests
  const bool fast = __all_sync(
      0xffffffffu, live && iz >= a.lo[0] && iz <= a.hi[0] && iy >= a.lo[1] &&
                       iy <= a.hi[1] && ix >= a.lo[2] && ix <= a.hi[2]);
  const int k0 = min(a.nd, slice * a.per_slice);
  const int k1 = min(a.nd, k0 + a.per_slice);
  T* yv = static_cast<T*>(a.y);
  for (int m0 = 0; m0 < a.m; m0 += MB) {
    const int mc = min(MB, a.m - m0);
    T acc[MB];
#pragma unroll
    for (int r = 0; r < MB; ++r) acc[r] = zero<T>();
    if (fast)
      sum_taps<T, MB, false>(acc, a, k0, k1, n, ni, eo, iz, iy, ix, base,
                             m0, mc);
    else if (live)
      sum_taps<T, MB, true>(acc, a, k0, k1, n, ni, eo, iz, iy, ix, base, m0,
                            mc);
    if (a.lg_split > 0) {
      // slices 1..S-1 hand their partial sums to slice 0, which adds them
      // in slice order
      if (slice > 0) {
#pragma unroll
        for (int r = 0; r < MB; ++r)
          red[((slice - 1) * nb + slot) * MB + r] = acc[r];
      }
      __syncthreads();
      if (slice == 0) {
        for (int s = 1; s < (1 << a.lg_split); ++s)
#pragma unroll
          for (int r = 0; r < MB; ++r)
            acc[r] = add(acc[r], red[((s - 1) * nb + slot) * MB + r]);
      }
      __syncthreads();             // red is written again by the next chunk
    }
    if (live && slice == 0) {
#pragma unroll
      for (int r = 0; r < MB; ++r)
        if (r < mc) {
          const size_t idx = (size_t)(m0 + r) * n + eo;
          if constexpr (FORM == kApply) {
            yv[idx] = acc[r];
          } else if constexpr (FORM == kResidual) {
            yv[idx] = sub(static_cast<const T*>(a.b)[idx], acc[r]);
          } else {
            // the Jacobi update (real types): the output box is the owned
            // one
            yv[idx] = jacobi(static_cast<const T*>(a.own)[idx],
                             static_cast<const T*>(a.d)[eo],
                             static_cast<const T*>(a.b)[idx], acc[r]);
          }
        }
    }
  }
}

// The launch plan (ops/cuda/stencil.py::halo_plan):
//   plan = [split, group, mb, threads, blocks, per_slice, smem]
enum { kPSplit, kPGroup, kPMb, kPThreads, kPBlocks, kPPerSlice, kPSmem,
       kPlanLen };

static int lg2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// True when `plan` is the host's plan for ns nodes: a power-of-two split
// up to kMaxSplit and every number derived from it as the host derives
// it.
static bool plan_ok(const int* p, long long ns, int nd, int m,
                    int itemsize) {
  const int split = p[kPSplit];
  if (split < 1 || split > kMaxSplit || (split & (split - 1)) ||
      p[kPThreads] != kThreads)
    return false;
  const int mb = mb_of(m);
  const int nb = kThreads / split;
  const int smem = split > 1 ? (split - 1) * nb * mb * itemsize : 0;
  return p[kPMb] == mb && p[kPGroup] == group_of(mb) &&
         p[kPPerSlice] == (nd + split - 1) / split &&
         (long long)p[kPBlocks] == (ns + nb - 1) / nb && p[kPSmem] == smem;
}

template <typename T, int MB, int FORM>
static void launch_one(const int* p, const HaloArgs& a, cudaStream_t st) {
  if (p[kPSmem] > 48 * 1024)
    cudaFuncSetAttribute(halo_kernel<T, MB, FORM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         p[kPSmem]);
  halo_kernel<T, MB, FORM><<<p[kPBlocks], kThreads, p[kPSmem], st>>>(a);
}

template <typename T, int FORM>
static void launch_form(const int* p, const HaloArgs& a, cudaStream_t st) {
  switch (p[kPMb]) {
    case 1: launch_one<T, 1, FORM>(p, a, st); break;
    case 2: launch_one<T, 2, FORM>(p, a, st); break;
    case 4: launch_one<T, 4, FORM>(p, a, st); break;
    default: launch_one<T, 8, FORM>(p, a, st);
  }
}

// complex values take no Jacobi update (the C entry refuses it)
template <typename T>
static void launch(int form, const int* p, const HaloArgs& a,
                   cudaStream_t st) {
  if (form == kApply)
    launch_form<T, kApply>(p, a, st);
  else if (form == kResidual)
    launch_form<T, kResidual>(p, a, st);
  else if constexpr (std::is_floating_point<T>::value)
    launch_form<T, kJacobi>(p, a, st);
}

// The taps in kernel form and the output nodes whose taps all land in the
// owned block.  False for a shift past int16 or a box too large for 32-bit
// offsets.
static bool make_taps(const int* offs, HaloArgs& a) {
  const long long lim = (1LL << 31) - 1;
  for (int x = 0; x < 3; ++x) {
    a.lo[x] = 0;
    a.hi[x] = a.o[x] - 1;
  }
  for (int k = 0; k < a.nd; ++k) {
    long long d[3];
    for (int x = 0; x < 3; ++x) {
      d[x] = offs[3 * k + x];
      if (d[x] >= kMaxShift || d[x] <= -kMaxShift) return false;
      // output nodes whose source o + d lies in the owned block
      const long long lo = d[x] < 0 ? -d[x] : 0;
      const long long hi = a.i[x] - 1 - d[x];
      a.lo[x] = (int)std::max<long long>(a.lo[x], lo);
      a.hi[x] = (int)std::min<long long>(a.hi[x], std::max(hi, -1LL));
    }
    const long long lin = (d[0] * a.i[1] + d[1]) * a.i[2] + d[2];
    if (lin >= lim || lin <= -lim) return false;
    a.lin[k] = (int)lin;
    a.dz[k] = (short)d[0];
    a.dy[k] = (short)d[1];
    a.dx[k] = (short)d[2];
  }
  return true;
}

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128.  form: 0 apply
// (y = A x), 1 residual (b - A x), 2 jacobi (x + d (b - A x); real types,
// the output box the owned one).  nd taps, offs nd rows of (dz, dy, dx)
// in the owned block's frame.  oZ..oX: the output box; iZ..iX: the owned
// block's; h: the halo axis (0 Z, 1 Y, 2 X); wl, wr: the left and right
// planes' widths along h (their boxes the owned one with wl / wr along h);
// rows: [r0, r1, r2, r3], the output rows along h this launch writes.
// coeff (nd, O), own (m, I), left / right (m, ...) or null, b (m, O) or
// null, d (O) or null, y (m, O): contiguous, of the dtype.  plan: see
// plan_ok.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a description or plan it does not take).
extern "C" int mgt_halo_stencil(int dtype, int form, int nd, const int* offs,
                                int oZ, int oY, int oX, int iZ, int iY,
                                int iX, int h, int wl, int wr,
                                const int* rows, int m, const void* coeff,
                                const void* own, const void* left,
                                const void* right, const void* b,
                                const void* d, void* y, const int* plan,
                                void* stream) {
  if (dtype < 0 || dtype > 3 || form < kApply || form > kJacobi || nd < 1 ||
      nd > kMaxTaps || !offs || !rows || !plan || m < 1 || h < 0 || h > 2 ||
      wl < 0 || wr < 0 || !coeff || !own || !y)
    return (int)cudaErrorInvalidValue;
  if ((form != kApply && !b) || (form == kJacobi && (!d || dtype > 1)))
    return (int)cudaErrorInvalidValue;
  HaloArgs a{};
  const int ob[3] = {oZ, oY, oX}, ib[3] = {iZ, iY, iX};
  const int big = 1 << 29;
  long long n = 1, ni = 1;
  for (int x = 0; x < 3; ++x) {
    if (ob[x] < 1 || ib[x] < 1 || ob[x] >= big || ib[x] >= big)
      return (int)cudaErrorInvalidValue;
    a.o[x] = ob[x];
    a.i[x] = ib[x];
    n *= ob[x];
    ni *= ib[x];
  }
  if (form == kJacobi && (oZ != iZ || oY != iY || oX != iX))
    return (int)cudaErrorInvalidValue;
  // a segment's planes: at least one where the pointer is given, at most
  // the owned block's extent
  if ((left ? wl < 1 : wl != 0) || (right ? wr < 1 : wr != 0) ||
      wl > ib[h] || wr > ib[h])
    return (int)cudaErrorInvalidValue;
  const long long lim = 1LL << 31;
  // (the halo planes' boxes are no larger than the owned one's)
  if (n * m >= lim || ni * m >= lim || n * nd >= lim)
    return (int)cudaErrorInvalidValue;
  for (int x = 0; x < 4; ++x) a.rows[x] = rows[x];
  if (rows[0] < 0 || rows[0] > rows[1] || rows[1] > rows[2] ||
      rows[2] > rows[3] || rows[3] > ob[h] ||
      rows[1] - rows[0] + rows[3] - rows[2] < 1)
    return (int)cudaErrorInvalidValue;
  const long long ns = n / ob[h] * (rows[1] - rows[0] + rows[3] - rows[2]);
  const int itemsize = dtype == 0 ? 4 : dtype == 3 ? 16 : 8;
  if (!plan_ok(plan, ns, nd, m, itemsize) || plan[kPSmem] > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  a.h = h;
  a.wl = wl;
  a.wr = wr;
  a.nd = nd;
  a.m = m;
  a.lg_split = lg2(plan[kPSplit]);
  a.per_slice = plan[kPPerSlice];
  if (!make_taps(offs, a)) return (int)cudaErrorInvalidValue;
  a.left = left;
  a.own = own;
  a.right = right;
  a.coeff = coeff;
  a.b = b;
  a.d = d;
  a.y = y;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(form, plan, a, st);
  else if (dtype == 1)
    launch<double>(form, plan, a, st);
  else if (dtype == 2)
    launch<float2>(form, plan, a, st);
  else
    launch<double2>(form, plan, a, st);
  return (int)cudaGetLastError();
}
