// Kernel D's block-operator form: y = A x, or the residual r = b - A x, for
// a whole block operator of a staggered system in one launch, float32,
// float64, complex64 or complex128.
//
// Replaces, on the systems engine's path, one launch of kernel D's cross
// (or apply) form per block, torch's adds of the blocks of an output
// component and the subtraction from b (cycle/systems_grid.py
// BlockGridOperator, parallel/systems_sharded.py ShardedBlockOperator).
// mgtpu computes the same in XLA: mgtpu/cycle/systems_grid.py:114-121
// BlockGridOperator.matvec, each block mgtpu/ops/cross_stencil.py:123
// cross_stencil_matvec, the job of the Pallas kernel K8
// (mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel) between grids.
//
// The operator: components c = 0..C-1, each on its own (Z, Y, X) box; a
// block (ci, cj) reads component cj's input box at r + d_k for every
// output node r of component ci's box and every tap k, a source off the
// input box reading nothing (predicated off, not multiplied by zero).
// For each output component
//   y_ci = sum over its blocks, in block order, of sum_k coeff_b[k] x_cj
// and the residual form writes b_ci - y_ci.
//
// Arithmetic: each block's taps are summed from zero with the same
// multiply-add (stencil_math.cuh) and the same tap slicing as the launch
// of kernel D's cross form that the block had on its own (its split:
// stencil_plan of the block's output box); slice partial sums are added
// in slice order, block sums in block order, then subtracted from b: the
// bits of the per-block launches, torch's adds and torch's subtraction.
//
// Layout of a launch: the grid covers the output components' nodes, one
// component after another; a CUDA block belongs to one component and
// holds 256 / S nodes x S slices, S the largest split of the component's
// blocks (a block of split s < S leaves slices s..S-1 idle).  Each thread
// walks its node's blocks: per block its taps in groups (loads of a group
// issued together, as stencil.cu's sum_taps), the split's partial sums
// through shared memory, the block sum added to the node's running sum in
// registers; the node's output is written once.  Right-hand sides in
// chunks of MB (1, 2, 4 or 8), as the other forms.
//
// The static table (ops/cuda/stencil.py::block_table, made once per
// operator on the host): per component its output and input boxes, its
// blocks and its first CUDA block; per block its input component, tap
// range, split and the output nodes whose taps all land inside the input
// box; per tap (dz, dy, dx, lin).  It holds no pointer, so a cast copy of
// a hierarchy shares nothing that points at another copy's tensors.  The
// per-call pointers (each block's coefficients, each component's x, b and
// output) come with the call; the C entry checks the table (the boxes,
// the splits, the tap geometry recomputed) and copies both into the
// kernel's parameters: under 4 KB, a classic launch's limit.
//
// What bounds it: device memory.  Per output node it reads each block's
// coefficients, each input component once (neighbour taps hit L1/L2), b
// for a residual, and writes one output: 2 flops a tap (8 complex) against
// a byte or more a flop.  What the form saves over the per-block path is
// the passes over an output component: k block outputs written and read
// back, k - 1 adds and the subtraction (12 passes for k = 3), and k + k
// host launches (each with its Python and ctypes round trip) become one.
#include <cuda_runtime.h>

#include <algorithm>

#include "stencil_math.cuh"

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

constexpr int kMaxComps = 4;
constexpr int kMaxBlocks = 16;
constexpr int kMaxBlockTaps = 320;

// The host table (int32), its sections one after another:
//   header  [ncomp, nblocks, ntaps, ctas]
//   comps   ncomp rows of [oZ, oY, oX, iZ, iY, iX, b0, nb, split, cta0]
//   blocks  nblocks rows of [src, ci, cj, t0, nd, split, per_slice,
//           lo_z, lo_y, lo_x, hi_z, hi_y, hi_x]   (grouped by ci)
//   taps    ntaps rows of [dz, dy, dx, lin]
enum { kHead = 4, kCompLen = 10, kBlockLen = 13, kTapLen = 4 };

struct Comp {
  const void* x;
  const void* b;
  void* y;
  int o[3], i[3];        // output and input boxes, (Z, Y, X)
  int b0, nb;            // its blocks
  int lg_split;          // log2 of the largest split of its blocks
  int cta0;              // its first CUDA block
};

struct Blk {
  const void* coeff;     // (nd, output box)
  int cj, t0, nd, lg_split, per_slice;
  int lo[3], hi[3];      // output nodes whose taps all land inside
};

// Taps as (lin, dz, dy): lin the offset in the input box, dz and dy 16-bit
// (the C entry refuses boxes and shifts past that), so that 320 taps, 16
// blocks and 4 components stay under a classic launch's 4 KB.
struct BlockArgs {
  int lin[kMaxBlockTaps];
  short dz[kMaxBlockTaps];
  short dy[kMaxBlockTaps];
  Blk blk[kMaxBlocks];
  Comp comp[kMaxComps];
  int ncomp, m, residual;
};
static_assert(sizeof(BlockArgs) <= 4000, "block table over 4 KB");

// acc += the taps [k0, k1) of block bk at one output node, in groups of G:
// the group's addresses first, then all of its loads, then its FMAs in tap
// order (stencil.cu's sum_taps, cross form).  CHECK: test each tap's
// source against the input box.
template <typename T, int MB, bool CHECK>
__device__ __forceinline__ void sum_block(
    T (&acc)[MB], const BlockArgs& a, const Blk& bk, const Comp& xc, int k0,
    int k1, int n, int ni, int e, int iz, int iy, int ix, int base, int mc,
    const T* __restrict__ coeff, const T* __restrict__ xm) {
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
        const int lin = a.lin[bk.t0 + k];
        bool ok = true;
        if (CHECK) {
          const int dz = a.dz[bk.t0 + k], dy = a.dy[bk.t0 + k];
          const int dx = lin - (dz * xc.i[1] + dy) * xc.i[2];
          ok = (unsigned)(iz + dz) < (unsigned)xc.i[0] &&
               (unsigned)(iy + dy) < (unsigned)xc.i[1] &&
               (unsigned)(ix + dx) < (unsigned)xc.i[2];
        }
        const int o = ok ? base + lin : 0;
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

template <typename T, int MB>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, MB>()))
    block_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);
  int c = 0;
  while (c + 1 < a.ncomp && (int)blockIdx.x >= a.comp[c + 1].cta0) ++c;
  const Comp& oc = a.comp[c];
  const int lg_nb = kLgThreads - oc.lg_split;
  const int nb = 1 << lg_nb;                 // nodes of a CUDA block
  const int slot = threadIdx.x & (nb - 1);
  const int slice = threadIdx.x >> lg_nb;
  const int n = oc.o[0] * oc.o[1] * oc.o[2];
  const int e = ((int)blockIdx.x - oc.cta0) * nb + slot;
  const bool live = e < n;
  int iz = 0, iy = 0, ix = 0;
  if (live) {
    const int plane = oc.o[1] * oc.o[2];
    iz = e / plane;
    const int rem = e - iz * plane;
    iy = rem / oc.o[2];
    ix = rem - iy * oc.o[2];
  }
  const T* bv = static_cast<const T*>(oc.b);
  T* y = static_cast<T*>(oc.y);
  for (int m0 = 0; m0 < a.m; m0 += MB) {
    const int mc = min(MB, a.m - m0);
    T tot[MB];
#pragma unroll
    for (int r = 0; r < MB; ++r) tot[r] = zero<T>();
    for (int q = 0; q < oc.nb; ++q) {
      const Blk& bk = a.blk[oc.b0 + q];
      const Comp& xc = a.comp[bk.cj];
      const int ni = xc.i[0] * xc.i[1] * xc.i[2];
      const int base = (iz * xc.i[1] + iy) * xc.i[2] + ix;
      // a warp whose nodes are all inside the block's [lo, hi] skips the
      // per-tap tests
      const bool inner = live && iz >= bk.lo[0] && iz <= bk.hi[0] &&
                         iy >= bk.lo[1] && iy <= bk.hi[1] &&
                         ix >= bk.lo[2] && ix <= bk.hi[2];
      const bool fast = __all_sync(0xffffffffu, inner);
      const int split = 1 << bk.lg_split;
      const int k0 = slice < split ? min(bk.nd, slice * bk.per_slice) : bk.nd;
      const int k1 = slice < split ? min(bk.nd, k0 + bk.per_slice) : bk.nd;
      const T* xm = static_cast<const T*>(xc.x) + (size_t)m0 * ni;
      const T* cf = static_cast<const T*>(bk.coeff);
      T acc[MB];
#pragma unroll
      for (int r = 0; r < MB; ++r) acc[r] = zero<T>();
      if (fast)
        sum_block<T, MB, false>(acc, a, bk, xc, k0, k1, n, ni, e, iz, iy, ix,
                                base, mc, cf, xm);
      else if (live)
        sum_block<T, MB, true>(acc, a, bk, xc, k0, k1, n, ni, e, iz, iy, ix,
                               base, mc, cf, xm);
      if (bk.lg_split > 0) {
        // slices 1..s-1 hand their partial sums to slice 0, which adds
        // them in slice order (uniform: the CUDA block is one component)
        if (slice > 0 && slice < split) {
#pragma unroll
          for (int r = 0; r < MB; ++r)
            red[((slice - 1) * nb + slot) * MB + r] = acc[r];
        }
        __syncthreads();
        if (slice == 0) {
          for (int s = 1; s < split; ++s)
#pragma unroll
            for (int r = 0; r < MB; ++r)
              acc[r] = add(acc[r], red[((s - 1) * nb + slot) * MB + r]);
        }
        __syncthreads();           // red is written again by the next block
      }
#pragma unroll
      for (int r = 0; r < MB; ++r) tot[r] = q == 0 ? acc[r] : add(tot[r], acc[r]);
    }
    if (live && slice == 0) {
#pragma unroll
      for (int r = 0; r < MB; ++r)
        if (r < mc) {
          const size_t idx = (size_t)(m0 + r) * n + e;
          y[idx] = a.residual ? sub(bv[idx], tot[r]) : tot[r];
        }
    }
  }
}

static int lg2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// The output nodes [lo, hi] of each axis whose source r + d lies in the
// input box, and lin, for one tap of a block (stencil.cu's make_taps,
// cross form): a tap that no output node reaches becomes (iZ, 0, 0),
// always masked, and empties the range.  False for a shift too large.
static bool tap_geometry(const int* eo, const int* ei, const int* d3,
                         int* lo, int* hi, int* tap) {
  const long long lim = (1LL << 31) - 1, big = 1LL << 29;
  long long d[3];
  bool reach = true;
  for (int a = 0; a < 3; ++a) {
    d[a] = d3[a];
    if ((d[a] < 0 ? -d[a] : d[a]) >= big) return false;
    const long long l = d[a] < 0 ? -d[a] : 0;
    const long long h = (ei[a] - 1 - d[a]) >= 0 ? (ei[a] - 1 - d[a]) : -1;
    reach = reach && l <= h && l <= eo[a] - 1 && h >= 0;
    lo[a] = (int)std::max<long long>(lo[a], l);
    hi[a] = (int)std::min<long long>(hi[a], std::max(h, -1LL));
  }
  if (!reach) {
    d[0] = ei[0];
    d[1] = d[2] = 0;
  }
  const long long zy = d[0] * ei[1] + d[1];
  if (zy >= lim || zy <= -lim || zy * ei[2] >= lim || zy * ei[2] <= -lim ||
      zy * ei[2] + d[2] >= lim || zy * ei[2] + d[2] <= -lim)
    return false;
  tap[0] = (int)d[0];
  tap[1] = (int)d[1];
  tap[2] = (int)(zy * ei[2] + d[2]);
  return true;
}

// Checks the host table against the rules ops/cuda/stencil.py derives it
// by and fills the kernel's parameters; false for anything it does not
// take.  smem: the launch's dynamic shared memory.
static bool load_table(const int* tab, int len, int m, int itemsize,
                       BlockArgs& a, int& ctas, int& smem) {
  if (!tab || len < kHead) return false;
  const int nc = tab[0], nbk = tab[1], nt = tab[2];
  ctas = tab[3];
  if (nc < 1 || nc > kMaxComps || nbk < 0 || nbk > kMaxBlocks || nt < 0 ||
      nt > kMaxBlockTaps ||
      len != kHead + nc * kCompLen + nbk * kBlockLen + nt * kTapLen)
    return false;
  const int* ct = tab + kHead;
  const int* bt = ct + nc * kCompLen;
  const int* tt = bt + nbk * kBlockLen;
  const long long lim = 1LL << 31;
  const int small = 1 << 15;
  a.ncomp = nc;
  a.m = m;
  int cta = 0, next = 0;
  smem = 0;
  for (int c = 0; c < nc; ++c) {
    const int* r = ct + c * kCompLen;
    Comp& k = a.comp[c];
    long long no = 1, ni = 1;
    for (int x = 0; x < 3; ++x) {
      k.o[x] = r[x];
      k.i[x] = r[3 + x];
      if (k.o[x] < 1 || k.i[x] < 1 || k.o[x] >= (1 << 29) ||
          k.i[x] >= (1 << 29))
        return false;
      no *= k.o[x];
      ni *= k.i[x];
    }
    if (k.i[0] >= small || k.i[1] >= small || no * m >= lim ||
        ni * m >= lim)
      return false;
    k.b0 = r[6];
    k.nb = r[7];
    const int split = r[8];
    if (k.b0 != next || k.nb < 0 || k.b0 + k.nb > nbk || split < 1 ||
        split > kMaxSplit || (split & (split - 1)) || r[9] != cta)
      return false;
    next += k.nb;
    k.lg_split = lg2(split);
    k.cta0 = cta;
    const int nodes = kThreads / split;
    cta += (int)((no + nodes - 1) / nodes);
    if (split > 1)
      smem = std::max(smem, (split - 1) * nodes * mb_of(m) * itemsize);
    int widest = 1;
    for (int q = k.b0; q < k.b0 + k.nb; ++q) {
      const int* s = bt + q * kBlockLen;
      widest = std::max(widest, s[5]);
    }
    if (widest != split) return false;
  }
  if (next != nbk || cta != ctas || ctas < 1) return false;
  int tnext = 0;
  for (int q = 0; q < nbk; ++q) {
    const int* s = bt + q * kBlockLen;
    Blk& b = a.blk[q];
    const int ci = s[1];
    b.cj = s[2];
    b.t0 = s[3];
    b.nd = s[4];
    const int split = s[5];
    if (ci < 0 || ci >= nc || q < a.comp[ci].b0 ||
        q >= a.comp[ci].b0 + a.comp[ci].nb || b.cj < 0 || b.cj >= nc ||
        b.t0 != tnext || b.nd < 1 || b.t0 + b.nd > nt || split < 1 ||
        split > kMaxSplit || (split & (split - 1)) ||
        s[6] != (b.nd + split - 1) / split)
      return false;
    tnext += b.nd;
    b.lg_split = lg2(split);
    b.per_slice = s[6];
    const Comp& oc = a.comp[ci];
    if ((long long)oc.o[0] * oc.o[1] * oc.o[2] * b.nd >= lim) return false;
    int lo[3] = {0, 0, 0}, hi[3] = {oc.o[0] - 1, oc.o[1] - 1, oc.o[2] - 1};
    for (int k = b.t0; k < b.t0 + b.nd; ++k) {
      const int* t = tt + k * kTapLen;
      int tap[3];
      if (!tap_geometry(oc.o, a.comp[b.cj].i, t, lo, hi, tap)) return false;
      if (tap[0] >= small || tap[0] < -small || tap[1] >= small ||
          tap[1] < -small || tap[2] != t[3])
        return false;
      a.lin[k] = tap[2];
      a.dz[k] = (short)tap[0];
      a.dy[k] = (short)tap[1];
    }
    for (int x = 0; x < 3; ++x) {
      if (lo[x] != s[7 + x] || hi[x] != s[10 + x]) return false;
      b.lo[x] = lo[x];
      b.hi[x] = hi[x];
    }
  }
  return tnext == nt;
}

template <typename T, int MB>
static void launch_mb(const BlockArgs& a, int ctas, int smem,
                      cudaStream_t st) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(block_kernel<T, MB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  block_kernel<T, MB><<<ctas, kThreads, smem, st>>>(a);
}

template <typename T>
static void launch(const BlockArgs& a, int ctas, int smem, cudaStream_t st) {
  switch (mb_of(a.m)) {
    case 1: launch_mb<T, 1>(a, ctas, smem, st); break;
    case 2: launch_mb<T, 2>(a, ctas, smem, st); break;
    case 4: launch_mb<T, 4>(a, ctas, smem, st); break;
    default: launch_mb<T, 8>(a, ctas, smem, st);
  }
}

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128.  table: the
// host table (see load_table), len its int32 count.  coeffs: one pointer
// per block in table order, each (nd, output box); xs, ys: one per
// component, x (m, input box), y (m, output box); bs: one per component
// (m, output box) for the residual r = b - A x, or null for y = A x.  All
// contiguous, of the dtype.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a table it does not take).
extern "C" int mgt_block_stencil(int dtype, const int* table, int len,
                                 const void* const* coeffs,
                                 const void* const* xs,
                                 const void* const* bs, void* const* ys,
                                 int m, void* stream) {
  if (dtype < 0 || dtype > 3 || m < 1 || !coeffs || !xs || !ys)
    return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : dtype == 3 ? 16 : 8;
  BlockArgs a{};
  int ctas = 0, smem = 0;
  if (!load_table(table, len, m, itemsize, a, ctas, smem) ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  a.residual = bs != nullptr;
  for (int c = 0; c < a.ncomp; ++c) {
    a.comp[c].x = xs[c];
    a.comp[c].y = ys[c];
    a.comp[c].b = bs ? bs[c] : nullptr;
    if (!xs[c] || !ys[c] || (bs && !bs[c])) return (int)cudaErrorInvalidValue;
  }
  for (int q = 0; q < table[1]; ++q) {
    a.blk[q].coeff = coeffs[q];
    if (!coeffs[q]) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(a, ctas, smem, st);
  else if (dtype == 1)
    launch<double>(a, ctas, smem, st);
  else if (dtype == 2)
    launch<float2>(a, ctas, smem, st);
  else
    launch<double2>(a, ctas, smem, st);
  return (int)cudaGetLastError();
}
