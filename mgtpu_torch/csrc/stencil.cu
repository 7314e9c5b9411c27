// Kernel D: variable-coefficient stencil apply y = A x, float32, float64,
// complex64 or complex128, for any stencil of up to kMaxTaps taps with any
// shift along each axis, and the stride-2 transfers of smoothed aggregation
// in parity form.
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
// Four forms share one kernel body, one thread slot per output node i:
//   apply     y[i]  = sum_k coeff[k, i] x[i + d_k]            (K8)
//   cross     the same with x on another box than y's: a block of a
//             staggered system between two component grids; i's
//             coordinates index x's box, off it a tap reads nothing (its
//             own instantiation, so that the square apply's code and
//             registers stay as they were)
//   restrict  rc[c] = sum_k coeff[k, c] r[2c + d_k]           (P^T r)
//   prolong   y[f]  = sum_t coeff[t, f] xc[(f - d_{q(f),t}) / 2]   (P xc)
// for every right-hand side.  A tap whose source lies outside its box on
// any axis reads nothing: its loads are predicated off, not multiplied by
// zero, so a non-finite value elsewhere in x cannot leak in.
//
// The stride-2 transfers (mgtpu computes them in XLA, grid_stencil.py
// Stride2Transfer) are packed at setup (ops/grid_stencil.py,
// pack_stride2).  A prolongation entry P[f, c] has f = 2c + d, so d has
// the parity of f on every axis: each fine node's parity class q (bit 2 z,
// bit 1 y, bit 0 x) keeps only its own taps, at most T of them, with
// coefficients (T, fine) and per-class offsets (T, 8, 3) in a small device
// buffer (up to 24 KB in 3D, more than a classic launch's 4 KB of
// parameters) that each block stages in shared memory: lanes of one warp
// fall in two x-parity classes, and shared memory serves their two table
// entries in one access where the constant bank would serialize them.
// Short classes are padded with an offset that is always masked.  The
// restriction keeps the even-node slice of the shifted coefficients,
// (nd, coarse), and writes the coarse field directly.
//
// What bounds it: device memory.  Per node it reads its coefficients and
// x (neighbour taps hit L1/L2) and writes one output, 2 nd flops against
// (nd + 2) * sizeof(T) bytes: far below the card's flop:byte balance in
// either precision.  A transfer's least traffic is P's own:
// (nnz + nc + nf) * sizeof(T).
//
// What held the first version back was latency, not bytes: its tap loop
// ran to a runtime nd, one tap at a time, so a thread issued tap k+1's
// loads only after tap k's FMA had its operands: about one memory latency
// per tap, two loads in flight.  The design now:
//  * taps in groups of G (8, fewer for 4 and 8 right-hand sides so that
//    registers do not spill): a group's masks and addresses first, then
//    all its coefficient and x loads, predicated, then its FMAs, so a
//    thread has up to G * (1 + MB) loads in flight.  One code path with a
//    short last group serves every nd <= 256.
//  * schedule "stream" (split 1): one thread per node, for grids with
//    blocks enough to fill the card.
//  * schedule "split" (split S = 2..16): S threads share a node, each
//    taking a contiguous slice of ceil(nd / S) taps; slice 0 adds the
//    others' partial sums from shared memory in slice order, so results do
//    not change from run to run and each node sums the same taps.  A block
//    is (256 / S nodes) x S slices with nodes fastest, so a warp's
//    coefficient loads of one tap stay contiguous along X.
// The host picks the schedule (ops/cuda/stencil.py::stencil_plan): it
// doubles S while nodes x S threads stay under FILL (half of the card's
// resident threads) and each slice keeps four taps or more.  The sums of up to MB right-hand sides live in
// registers, so each coefficient is read once for every MB of them (MB =
// 1, 2, 4 or 8; larger m loops over chunks of 8).  No vector loads: a
// coefficient plane of an odd-sized grid is not 16-byte aligned.
//
// Complex values (mgtpu runs its complex levels through the same
// shift-multiply-add in XLA, grid_stencil_matvec) are float2 / double2,
// torch's complex64 / complex128 layout: each tap is one complex
// multiply-add, four real FMAs into the accumulator in the plain version's
// tap order, in the value's own precision.  A transfer's restriction is
// P^H: the host conjugates its coefficient table (pack_stride2), so every
// form computes the same multiply-add.  The cross form takes them too: a
// complex staggered system's blocks (mgtpu's cross_stencil_matvec in XLA,
// complex coefficients and fields).  A complex128 value is four words
// of register, so its register cap is lower (min_blocks).
#include <cuda_runtime.h>

#include <algorithm>

#include "stencil_math.cuh"

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// The taps travel in the kernel's parameter space (constant bank) as
// (dz, dy, lin), lin = (dz Yi + dy) Xi + dx the tap's offset in x's box
// (dx = lin - (dz Yi + dy) Xi): 3 * 256 * 4 = 3072 bytes, under a classic
// launch's 4 KB with the other arguments.
constexpr int kMaxTaps = 256;
constexpr int kClasses = 8;         // parity classes of a (Z, Y, X) box
constexpr int kNoLin = -2147483647 - 1;   // a class table's padding
enum Form { kApply = 0, kRestrict = 1, kProlong = 2, kCross = 3 };

struct Taps {
  int dz[kMaxTaps];
  int dy[kMaxTaps];
  int lin[kMaxTaps];
};

struct Box {
  int Z, Y, X;
};

// The output box, x's box, and the output nodes [lo, hi] per axis whose
// taps all land inside x's box (empty where lo > hi).
struct Geom {
  Box o, i;
  int lo[3], hi[3];
};

// bytes of the staged prolongation table: (dz, dy, dx, lin) per tap and
// class
__host__ __device__ constexpr int table_bytes(int nd) {
  return nd * kClasses * 16;
}

// acc += the taps [k0, k1) of one output node, in groups of G: the group's
// addresses first, then all of its loads, then its FMAs in tap order.
// CHECK: test each tap's source against x's box (else every tap of the
// node lands inside it, and only a prolong's class padding is skipped).
// base: the node's source origin in x's box (apply and cross: i;
// restrict: 2i; prolong: i / 2, where the class table's lin is
// subtracted).
template <typename T, int MB, int FORM, bool CHECK>
__device__ __forceinline__ void sum_taps(
    T (&acc)[MB], const Taps& t, const Geom& g, const int4* tab, int k0,
    int k1, int n, int ni, int e, int iz, int iy, int ix, int cls, int base,
    int mc, const T* __restrict__ coeff, const T* __restrict__ xm) {
  constexpr int G = group_of(MB);
  for (int kb = k0; kb < k1; kb += G) {
    const int nt = k1 - kb;
    T c[G];
    T v[G][MB];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      c[j] = zero<T>();
#pragma unroll
      for (int r = 0; r < MB; ++r) v[j][r] = zero<T>();
      if (j < nt) {
        const int k = kb + j;
        bool ok = true;
        int o;
        if (FORM == kProlong) {       // f - d is even for the class's taps
          const int4 d = tab[k * kClasses + cls];
          if (CHECK) {
            const int jz = (iz - d.x) >> 1, jy = (iy - d.y) >> 1,
                      jx = (ix - d.z) >> 1;
            ok = (unsigned)jz < (unsigned)g.i.Z &&
                 (unsigned)jy < (unsigned)g.i.Y &&
                 (unsigned)jx < (unsigned)g.i.X;
            o = ok ? (jz * g.i.Y + jy) * g.i.X + jx : 0;
          } else {
            ok = d.w != kNoLin;
            o = ok ? base - d.w : 0;
          }
        } else {
          const int lin = t.lin[k];
          if (CHECK) {
            const int s = FORM == kRestrict ? 2 : 1;
            const int dz = t.dz[k], dy = t.dy[k];
            const int dx = lin - (dz * g.i.Y + dy) * g.i.X;
            ok = (unsigned)(s * iz + dz) < (unsigned)g.i.Z &&
                 (unsigned)(s * iy + dy) < (unsigned)g.i.Y &&
                 (unsigned)(s * ix + dx) < (unsigned)g.i.X;
          }
          o = ok ? base + lin : 0;
        }
        if (ok) {
          c[j] = __ldg(coeff + k * n + e);
#pragma unroll
          for (int r = 0; r < MB; ++r)
            if (r < mc) v[j][r] = __ldg(xm + r * ni + o);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < nt) {
#pragma unroll
        for (int r = 0; r < MB; ++r) acc[r] = mad(c[j], v[j][r], acc[r]);
      }
  }
}

template <typename T, int MB, int FORM>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, MB>()))
    stencil_kernel(
    const Taps t, const Geom g, int nd, int m, int lg_split, int per_slice,
    const T* __restrict__ coeff, const T* __restrict__ x,
    T* __restrict__ y, const int4* __restrict__ ptab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int4* tab = reinterpret_cast<const int4*>(smem);
  T* red = reinterpret_cast<T*>(smem + (FORM == kProlong ? table_bytes(nd)
                                                         : 0));
  const int lg_nb = kLgThreads - lg_split;
  const int nb = 1 << lg_nb;                 // nodes of a block
  const int slot = threadIdx.x & (nb - 1);
  const int slice = threadIdx.x >> lg_nb;
  const int n = g.o.Z * g.o.Y * g.o.X;
  const int ni = g.i.Z * g.i.Y * g.i.X;
  const int e = blockIdx.x * nb + slot;
  const bool live = e < n;
  if (FORM == kProlong) {
    int4* st = reinterpret_cast<int4*>(smem);
    for (int i = threadIdx.x; i < nd * kClasses; i += kThreads)
      st[i] = ptab[i];
    __syncthreads();
  }
  int iz = 0, iy = 0, ix = 0;
  if (live) {
    const int plane = g.o.Y * g.o.X;
    iz = e / plane;
    const int rem = e - iz * plane;
    iy = rem / g.o.X;
    ix = rem - iy * g.o.X;
  }
  const int cls = ((iz & 1) << 2) | ((iy & 1) << 1) | (ix & 1);
  const int base =
      FORM == kApply ? e
      : FORM == kCross ? (iz * g.i.Y + iy) * g.i.X + ix
      : FORM == kRestrict
          ? ((2 * iz) * g.i.Y + 2 * iy) * g.i.X + 2 * ix
          : ((iz >> 1) * g.i.Y + (iy >> 1)) * g.i.X + (ix >> 1);
  // a warp whose nodes are all inside [lo, hi] skips the per-tap tests
  const bool inner = live && iz >= g.lo[0] && iz <= g.hi[0] &&
                     iy >= g.lo[1] && iy <= g.hi[1] && ix >= g.lo[2] &&
                     ix <= g.hi[2];
  const bool fast = __all_sync(0xffffffffu, inner);
  const int k0 = min(nd, slice * per_slice);
  const int k1 = min(nd, k0 + per_slice);
  for (int m0 = 0; m0 < m; m0 += MB) {
    const int mc = min(MB, m - m0);
    const T* xm = x + (size_t)m0 * ni;
    T acc[MB];
#pragma unroll
    for (int r = 0; r < MB; ++r) acc[r] = zero<T>();
    if (fast)
      sum_taps<T, MB, FORM, false>(acc, t, g, tab, k0, k1, n, ni, e, iz, iy,
                                   ix, cls, base, mc, coeff, xm);
    else if (live)
      sum_taps<T, MB, FORM, true>(acc, t, g, tab, k0, k1, n, ni, e, iz, iy,
                                  ix, cls, base, mc, coeff, xm);
    if (lg_split > 0) {
      // slices 1..S-1 hand their partial sums to slice 0, which adds them
      // in slice order
      if (slice > 0) {
#pragma unroll
        for (int r = 0; r < MB; ++r)
          red[((slice - 1) * nb + slot) * MB + r] = acc[r];
      }
      __syncthreads();
      if (slice == 0) {
        for (int s = 1; s < (1 << lg_split); ++s)
#pragma unroll
          for (int r = 0; r < MB; ++r)
            acc[r] = add(acc[r], red[((s - 1) * nb + slot) * MB + r]);
      }
      __syncthreads();             // red is written again by the next chunk
    }
    if (live && slice == 0) {
#pragma unroll
      for (int r = 0; r < MB; ++r)
        if (r < mc) y[(size_t)(m0 + r) * n + e] = acc[r];
    }
  }
}

// The launch plan (ops/cuda/stencil.py::stencil_plan):
//   plan = [form, split, group, mb, threads, blocks, per_slice, smem]
enum { kPForm, kPSplit, kPGroup, kPMb, kPThreads, kPBlocks, kPPerSlice,
       kPSmem, kPlanLen };

static int smem_of(int form, int split, int mb, int nd, int itemsize) {
  return (form == kProlong ? table_bytes(nd) : 0) +
         (split > 1 ? (split - 1) * (kThreads / split) * mb * itemsize : 0);
}

// True when `plan` is a plan for this form, output size, tap count and
// right-hand sides: any power-of-two split up to kMaxSplit, and every
// number derived from it as the host derives it.
static bool plan_ok(const int* p, int form, long long n, int nd, int m,
                    int itemsize) {
  const int split = p[kPSplit];
  if (p[kPForm] != form || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) || p[kPThreads] != kThreads)
    return false;
  const int mb = mb_of(m);
  const int nb = kThreads / split;
  return p[kPMb] == mb && p[kPGroup] == group_of(mb) &&
         p[kPPerSlice] == (nd + split - 1) / split &&
         (long long)p[kPBlocks] == (n + nb - 1) / nb &&
         p[kPSmem] == smem_of(form, split, mb, nd, itemsize);
}

static int lg2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <typename T, int FORM, int MB>
static void launch_mb(const int* p, const Taps& t, const Geom& g, int nd,
                      int m, const T* c, const T* x, T* y, const int4* ptab,
                      cudaStream_t st) {
  if (p[kPSmem] > 48 * 1024)      // above the default dynamic limit
    cudaFuncSetAttribute(stencil_kernel<T, MB, FORM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         p[kPSmem]);
  stencil_kernel<T, MB, FORM><<<p[kPBlocks], kThreads, p[kPSmem], st>>>(
      t, g, nd, m, lg2(p[kPSplit]), p[kPPerSlice], c, x, y, ptab);
}

template <typename T, int FORM>
static void launch_form(const int* p, const Taps& t, const Geom& g, int nd,
                        int m, const T* c, const T* x, T* y,
                        const int4* ptab, cudaStream_t st) {
  switch (p[kPMb]) {
    case 1: launch_mb<T, FORM, 1>(p, t, g, nd, m, c, x, y, ptab, st); break;
    case 2: launch_mb<T, FORM, 2>(p, t, g, nd, m, c, x, y, ptab, st); break;
    case 4: launch_mb<T, FORM, 4>(p, t, g, nd, m, c, x, y, ptab, st); break;
    default: launch_mb<T, FORM, 8>(p, t, g, nd, m, c, x, y, ptab, st);
  }
}

template <typename T>
static void launch(int form, const int* p, const Taps& t, const Geom& g,
                   int nd, int m, const void* c, const void* x, void* y,
                   const int4* ptab, cudaStream_t st) {
  const T* cc = static_cast<const T*>(c);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (form == kApply)
    launch_form<T, kApply>(p, t, g, nd, m, cc, xx, yy, ptab, st);
  else if (form == kCross)
    launch_form<T, kCross>(p, t, g, nd, m, cc, xx, yy, ptab, st);
  else if (form == kRestrict)
    launch_form<T, kRestrict>(p, t, g, nd, m, cc, xx, yy, ptab, st);
  else
    launch_form<T, kProlong>(p, t, g, nd, m, cc, xx, yy, ptab, st);
}

// The taps in kernel form, and the output nodes whose taps all land inside
// x's box.  A source is s i + d (apply s = 1, restrict s = 2) or (i - d) / 2
// (prolong).  A tap that no output node can reach is always masked: it
// becomes (Zi, 0, 0), which lands past x's box in z, and empties the inner
// range.  Returns false for a shift too large for 32-bit indices.
static bool make_taps(int form, int ntaps, const int* offs, Geom& g,
                      Taps& t) {
  const int eo[3] = {g.o.Z, g.o.Y, g.o.X}, ei[3] = {g.i.Z, g.i.Y, g.i.X};
  const long long lim = (1LL << 31) - 1, big = 1LL << 29;
  for (int a = 0; a < 3; ++a) {
    g.lo[a] = 0;
    g.hi[a] = eo[a] - 1;
  }
  for (int k = 0; k < ntaps; ++k) {
    long long d[3];
    bool reach = true;
    for (int a = 0; a < 3; ++a) {
      d[a] = offs[3 * k + a];
      if ((d[a] < 0 ? -d[a] : d[a]) >= big) return false;
      long long lo, hi;                 // output nodes whose source is in
      if (form == kProlong) {
        lo = d[a];
        hi = 2LL * (ei[a] - 1) + d[a];
      } else {
        const int s = form == kRestrict ? 2 : 1;
        lo = d[a] < 0 ? (-d[a] + s - 1) / s : 0;
        hi = (ei[a] - 1 - d[a]) >= 0 ? (ei[a] - 1 - d[a]) / s : -1;
      }
      reach = reach && lo <= hi && lo <= eo[a] - 1 && hi >= 0;
      g.lo[a] = (int)std::max<long long>(g.lo[a], lo);
      g.hi[a] = (int)std::min<long long>(g.hi[a], std::max(hi, -1LL));
    }
    if (form == kProlong) continue;     // the kernel reads its class table
    if (!reach) {
      d[0] = ei[0];
      d[1] = d[2] = 0;
    }
    const long long zy = d[0] * ei[1] + d[1];
    if (zy >= lim || zy <= -lim || zy * ei[2] >= lim || zy * ei[2] <= -lim ||
        zy * ei[2] + d[2] >= lim || zy * ei[2] + d[2] <= -lim)
      return false;
    t.dz[k] = (int)d[0];
    t.dy[k] = (int)d[1];
    t.lin[k] = (int)(zy * ei[2] + d[2]);
  }
  return true;
}

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128 (interleaved
// real and imaginary parts).  form: 0 apply, 1 restrict, 2 prolong,
// 3 cross.
// nd: coefficient planes (for a prolong, its widest class).  offs: ntaps
// rows of (dz, dy, dx) (for a prolong, every offset of the transfer).
// oZ..oX / iZ..iX: the (Z, Y, X) boxes of y and x (equal for an apply,
// any two for a cross apply; coarse and fine for a restrict; fine and
// coarse for a prolong).  coeff is
// (nd, obox), x (m, ibox), y (m, obox), all contiguous.  ptab: a prolong's
// (nd, 8, 4) class table on the device (dz, dy, dx, lin per tap and class,
// padding (.., .., .., INT_MIN) with offsets past the box), else unused.
// plan: the host's launch plan (see plan_ok).  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a bad description
// or plan).
extern "C" int mgt_stencil(int dtype, int form, int nd, int ntaps,
                           const int* offs, int oZ, int oY, int oX, int iZ,
                           int iY, int iX, int m, const void* coeff,
                           const void* x, void* y, const void* ptab,
                           const int* plan, void* stream) {
  Geom g{{oZ, oY, oX}, {iZ, iY, iX}, {0, 0, 0}, {0, 0, 0}};
  if (dtype < 0 || dtype > 3 || form < kApply || form > kCross || nd < 1 ||
      nd > kMaxTaps || ntaps < 1 || ntaps > kMaxTaps || !offs || oZ < 1 ||
      oY < 1 || oX < 1 || iZ < 1 || iY < 1 || iX < 1 || m < 1 || !plan)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)oZ * oY * oX, ni = (long long)iZ * iY * iX;
  // extents under 2^29 and shifts under 2^29 keep every source coordinate
  // (s i + d, i - d with the padding's -2^30) inside int
  const int big = 1 << 29;
  if (n * m >= (1LL << 31) || ni * m >= (1LL << 31) ||
      n * nd >= (1LL << 31) || oZ >= big || oY >= big || oX >= big ||
      iZ >= big || iY >= big || iX >= big)
    return (int)cudaErrorInvalidValue;
  if (form == kApply && (oZ != iZ || oY != iY || oX != iX))
    return (int)cudaErrorInvalidValue;
  if (form == kProlong ? !ptab : ntaps != nd)
    return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : dtype == 3 ? 16 : 8;
  if (!plan_ok(plan, form, n, nd, m, itemsize) ||
      plan[kPSmem] > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  Taps t{};
  if (!make_taps(form, ntaps, offs, g, t)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* pt = static_cast<const int4*>(ptab);
  if (dtype == 0)
    launch<float>(form, plan, t, g, nd, m, coeff, x, y, pt, st);
  else if (dtype == 1)
    launch<double>(form, plan, t, g, nd, m, coeff, x, y, pt, st);
  else if (dtype == 2)
    launch<float2>(form, plan, t, g, nd, m, coeff, x, y, pt, st);
  else
    launch<double2>(form, plan, t, g, nd, m, coeff, x, y, pt, st);
  return (int)cudaGetLastError();
}
