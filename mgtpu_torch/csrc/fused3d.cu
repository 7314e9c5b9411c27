// Kernel B: double apply of a 3D constant-interior radius-1 stencil — the
// pre-smoothing Jacobi sweep and the residual that restriction needs:
//   x' = x + d * (b - A x),   r' = b - A x'.
//
// Replaces the Pallas TPU kernel
//   mgtpu/ops/pallas/fused3d.py::_jacres_kernel  (K6, jacobi_residual3d)
// together with the two x-band fixes that followed it
//   (mgtpu/ops/pallas/const3d.py::_xband_fix_kernel, K2).
//
// What bounds it: device memory.  The least traffic is x, b, d read once
// and x', r' written once (5 fields); the second apply is what makes it
// worth fusing, since r' needs x' on the neighbours of every node.
//
// What the design does about it (the x-march of kernel A, const3d.cu, with
// a second stage):
//  * Interior blocks.  The interior box [w, X-w) x [w, Y-w) x [w, Z-w) is
//    cut into (TY, TZ) tiles of the (y, z) plane and its x range into
//    balanced runs; a block owns one tile and walks one run.  Planes of x
//    with a two-node (y, z) halo, and of b and d with a one-node halo, come
//    through cp.async rings in shared memory, DEPTH planes ahead (4-byte
//    copies: rows of odd widths break the 16-byte rule of TMA and of
//    16-byte cp.async).  Step t, after one barrier, computes x'(t) on the
//    tile and its one-node halo from x planes t-1..t+1 (stage 1) into a
//    four-plane x' ring, and r'(t-2) on the tile from x' planes t-3..t-1
//    (stage 2): stage 2 trails stage 1 by two planes, so one barrier a
//    step orders both.  A thread owns a few cells of the tile with its
//    halo for both stages and keeps the values of their own column (x at
//    t-1 and t, x' at t-3..t-1, b at t-2) in registers: of the 7 taps of a
//    7-point node only the 4 in its plane come from shared memory, which
//    is where the march spends its time.  x' never leaves the chip between
//    the two applies:
//    each halo cell of x' is recomputed by the neighbouring tile (1.2x the
//    first apply's arithmetic on a 16 x 32 tile) instead of making a trip
//    through device memory, and x, b, d leave device memory about once.
//    An interior block writes x' on its interior nodes and r' on the core
//    [w+1, N-w-1).
//  * The band.  Band nodes read per-node coefficients, and r' next to the
//    band needs x' on band nodes; coefficient loads inside the march's
//    barriers made kernel A 2x slower.  So the band stays out of the
//    march: band blocks of the first launch compute x' on the band, one
//    thread per node (kernel A's band blocks in jacobi mode), and a second
//    launch computes r' on the shell (the band plus the interior's first
//    layer) from the x' just written, which is still in L2.  The second
//    launch is a programmatic dependent launch: its blocks are placed
//    while the first launch drains and wait for it in griddepcontrol.wait.
//    (One launch whose shell threads recompute the x' of their neighbours,
//    nd x nd taps a node, was 1.4-5x slower at every shape on an H100.)
// Every node sums the same fmaf chain over k = 0..NT-1 as kernel A
// (constants on the interior, band coefficients on the band), and forms
// x + d (b - ax) and b - ax as kernel A's jacobi and residual do, so the
// outputs are bitwise kernel A's jacobi followed by its residual.  For the
// sorted 7- and 27-point stencils the tap offsets are compile-time
// constants; other tap orders take them from the stencil description.
// The launch plan (tile, x-run, blocks, shared memory) comes from
// ops/cuda/fused3d.py::jacres_plan.
#include <cuda_pipeline.h>

#include "stencil3d.cuh"

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace {
constexpr int NTH = 256;                  // threads of every block
constexpr int DEPTH = 2;                  // planes in flight ahead
// Ring slots.  A thread issues step t+1's loads while others may still be
// in step t (stage 1 reads x t-1..t+1, b and d t, and writes x' t; stage 2
// reads x' t-3..t-1).
constexpr int NSX = DEPTH + 4;            // x: t-1 .. t+DEPTH+2
constexpr int NSB = DEPTH + 2;            // b: t .. t+DEPTH+1
constexpr int NSD = DEPTH + 2;            // d: t .. t+DEPTH+1
constexpr int NSY = 4;                    // x': t-3 .. t

// The interior tile: TY x TZ nodes of the (y, z) plane (a 4 x 128 tile,
// kernel A's best at 129^3, was 1.1-1.25x slower here: its halo is larger).
constexpr int TY = 16, TZ = 32;
constexpr int QZ = TZ + 4, QY = TY + 4;
constexpr int QN = QY * QZ;               // x plane, two-node halo
constexpr int EZ = TZ + 2, EY = TY + 2;
constexpr int EN = EY * EZ;               // b, d, x' plane, one-node halo
// bytes of dynamic shared memory (the plan's `smem`)
constexpr int SMEM = static_cast<int>(sizeof(float)) *
                     (NSX * QN + (NSB + NSD + NSY) * EN);
}  // namespace

// Six boxes (start, size) of a disjoint cover.
struct Boxes6 {
  int bs[6][3];
  int bn[6][3];
};

// The interior's first layer (the interior less the core [w+1, N-w-1)),
// covered like the band: two x-slabs of the full interior, two y-slabs
// trimmed to the core's x range, two z-slabs trimmed to the core's x and y
// ranges.  A side of one node has one slab, of none no slab.
static Boxes6 layer_of(const Stencil3D& s) {
  const Interior in = interior_of(s);
  const int n[3] = {in.X, in.Y, in.Z};
  const int N[3] = {s.X, s.Y, s.Z};
  int core[3];
  for (int a = 0; a < 3; ++a) core[a] = n[a] > 2 ? n[a] - 2 : 0;
  Boxes6 l;
  for (int a = 0; a < 3; ++a) {
    for (int hi = 0; hi < 2; ++hi) {
      int* st = l.bs[2 * a + hi];
      int* sz = l.bn[2 * a + hi];
      for (int p = 0; p < 3; ++p) {
        st[p] = p < a ? s.w + 1 : s.w;
        sz[p] = p < a ? core[p] : n[p];
      }
      st[a] = hi ? N[a] - s.w - 1 : s.w;
      sz[a] = hi ? (n[a] >= 2 ? 1 : 0) : (n[a] >= 1 ? 1 : 0);
    }
  }
  return l;
}

static long long box_nodes(const Boxes6& b) {
  long long n = 0;
  for (int k = 0; k < 6; ++k) n += (long long)b.bn[k][0] * b.bn[k][1] * b.bn[k][2];
  return n;
}

// sum_k cr[k] * v_k, v_k the source at tap k of the node at offset c of
// three ring planes pl[0..2] (planes t-1, t, t+1) whose rows are RZ floats
// apart.  With STD the taps of the node's own column, (-1,0,0), (0,0,0) and
// (1,0,0), come from the registers col[0..2] instead of shared memory.
template <int NT, bool STD, int RZ>
__device__ __forceinline__ float tap_sum(const Stencil3D& s,
                                         const float (&cr)[NT],
                                         const float* const (&pl)[3], int c,
                                         const float (&col)[3]) {
  float ax = 0.0f;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if constexpr (STD) {
      const int dx = StdTap<NT>::dx(k), dy = StdTap<NT>::dy(k),
                dz = StdTap<NT>::dz(k);           // constants once unrolled
      const float v = dy == 0 && dz == 0 ? col[dx + 1]
                                         : pl[dx + 1][c + dy * RZ + dz];
      ax = fmaf(cr[k], v, ax);
    } else {
      const int dx = s.dx[k];
      const float* p = dx < 0 ? pl[0] : dx > 0 ? pl[2] : pl[1];
      ax = fmaf(cr[k], p[c + s.dy[k] * RZ + s.dz[k]], ax);
    }
  }
  return ax;
}

template <int NT, bool STD>
__device__ __forceinline__ void interior_block(
    const Stencil3D& s, const float* sc, int tile, int run, int ntz,
    int xrun, const float* __restrict__ xm, const float* __restrict__ bm,
    const float* __restrict__ d, float* __restrict__ x1m,
    float* __restrict__ r1m, float* ring) {
  constexpr int NXL = (QN + NTH - 1) / NTH;  // x cells a thread loads
  constexpr int NEL = (EN + NTH - 1) / NTH;  // cells a thread owns
  float* xr = ring;                          // NSX x planes
  float* br = xr + NSX * QN;                 // NSB b planes
  float* dr = br + NSB * EN;                 // NSD d planes
  float* yr = dr + NSD * EN;                 // NSY x' planes
  const int tid = threadIdx.x;
  const int w = s.w;
  const int ty = tile / ntz;
  const int y0 = w + ty * TY, z0 = w + (tile - ty * ntz) * TZ;
  const int xa = w + run * xrun;
  const int xb = min(s.X - w, xa + xrun);
  const int pa = max(xa - 1, w), pb = min(xb + 1, s.X - w);   // x' planes
  const int qa = max(xa, w + 1), qb = min(xb, s.X - w - 1);   // r' planes
  const int plane = s.Y * s.Z;
  float cr[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) cr[k] = sc[k];
  // this thread's x cells of a plane (offsets within the plane; -1 off the
  // grid, where no interior node reads)
  int xo[NXL];
#pragma unroll
  for (int j = 0; j < NXL; ++j) {
    const int e = tid + j * NTH;
    const int qy = e / QZ, qz = e - qy * QZ;
    const int gy = y0 - 2 + qy, gz = z0 - 2 + qz;
    xo[j] = e < QN && gy >= 0 && gy < s.Y && gz >= 0 && gz < s.Z
                ? gy * s.Z + gz : -1;
  }
  // The cells this thread owns, of the tile with its one-node halo: it
  // loads their b and d, computes their x' (stage 1) and, where they are
  // core nodes of the tile, their r' (stage 2), keeping the values of their
  // own column (x at t-1, t; x' at t-3..t-1; b at t-2, t-1) in registers.
  // inner: bit j set when cell j is an interior node; own: and in the
  // tile; core: and in the core.
  int eo[NEL], xc[NEL];
  unsigned inner = 0, own = 0, core = 0;
#pragma unroll
  for (int j = 0; j < NEL; ++j) {
    const int e = tid + j * NTH;
    const int ey = e / EZ, ez = e - ey * EZ;
    const int gy = y0 - 1 + ey, gz = z0 - 1 + ez;   // >= w - 1 >= 0
    const bool on = e < EN && gy < s.Y && gz < s.Z;
    eo[j] = on ? gy * s.Z + gz : -1;
    xc[j] = (ey + 1) * QZ + ez + 1;
    if (on && gy >= w && gy < s.Y - w && gz >= w && gz < s.Z - w) {
      inner |= 1u << j;
      if (ey >= 1 && ey <= TY && ez >= 1 && ez <= TZ) {
        own |= 1u << j;
        if (gy > w && gy < s.Y - w - 1 && gz > w && gz < s.Z - w - 1)
          core |= 1u << j;
      }
    }
  }
  float xm1[NEL], x0[NEL];                   // x at t-1, t
  float y1[NEL], y2[NEL], y3[NEL];           // x' at t-1, t-2, t-3
  float b1[NEL], b2[NEL];                    // b at t-1, t-2
  // ring slots by plane, counted from pa - 1
  const int base = pa - 1;
  auto xs = [&](int gx) { return xr + ((gx - base) % NSX) * QN; };
  auto bs = [&](int gx) { return br + ((gx - base) % NSB) * EN; };
  auto ds = [&](int gx) { return dr + ((gx - base) % NSD) * EN; };
  auto ys = [&](int gx) { return yr + ((gx - base) % NSY) * EN; };
  auto issue_x = [&](int gx) {
    const float* src = xm + gx * plane;
    float* dst = xs(gx);
#pragma unroll
    for (int j = 0; j < NXL; ++j)
      if (xo[j] >= 0)
        __pipeline_memcpy_async(dst + tid + j * NTH, src + xo[j],
                                sizeof(float));
  };
  // group t: x plane t+1, b and d planes t (empty past the last x' plane)
  auto issue = [&](int t) {
    if (t < pb) {
      issue_x(t + 1);
      const int o = t * plane;
      float* bd = bs(t);
      float* dd = ds(t);
#pragma unroll
      for (int j = 0; j < NEL; ++j) {
        if (eo[j] < 0) continue;
        __pipeline_memcpy_async(bd + tid + j * NTH, bm + o + eo[j],
                                sizeof(float));
        __pipeline_memcpy_async(dd + tid + j * NTH, d + o + eo[j],
                                sizeof(float));
      }
    }
    __pipeline_commit();
  };

  issue_x(pa - 1);                                    // prologue
  issue_x(pa);
  __pipeline_commit();
  for (int q = 0; q < DEPTH; ++q) issue(pa + q);
  for (int t = pa; t <= pb; ++t) {
    issue(t + DEPTH);
    __pipeline_wait_prior(DEPTH);                     // group t is here
    __syncthreads();
    if (t == pa) {                                    // the first column
#pragma unroll
      for (int j = 0; j < NEL; ++j) {
        if (!(inner >> j & 1u)) continue;
        xm1[j] = xs(pa - 1)[xc[j]];
        x0[j] = xs(pa)[xc[j]];
      }
    }
    // stage 2: r'(t-2) on the core cells, from x' planes t-3..t-1 (written
    // before this step's barrier); first in program order, so that its
    // loads and chains interleave with stage 1's
    const int q = t - 2;
    if (q >= qa && q < qb) {
      const float* const yl[3] = {ys(q - 1), ys(q), ys(q + 1)};
      const int o = q * plane;
#pragma unroll
      for (int j = 0; j < NEL; ++j) {
        if (!(core >> j & 1u)) continue;
        const float col[3] = {y3[j], y2[j], y1[j]};
        const float ax =
            tap_sum<NT, STD, EZ>(s, cr, yl, tid + j * NTH, col);
        r1m[o + eo[j]] = b2[j] - ax;
      }
    }
    // stage 1: x'(t) on the inner cells, from x planes t-1..t+1
    if (t < pb) {
      const float* const pl[3] = {xs(t - 1), xs(t), xs(t + 1)};
      const float* bp = bs(t);
      const float* dp = ds(t);
      float* yp = ys(t);
      const bool write = t >= xa && t < xb;
      const int o = t * plane;
#pragma unroll
      for (int j = 0; j < NEL; ++j) {
        const int e = tid + j * NTH;
        float v = 0.0f, bv = 0.0f, xp = 0.0f;
        if (inner >> j & 1u) {
          xp = pl[2][xc[j]];
          const float col[3] = {xm1[j], x0[j], xp};
          const float ax = tap_sum<NT, STD, QZ>(s, cr, pl, xc[j], col);
          bv = bp[e];
          v = x0[j] + dp[e] * (bv - ax);
          yp[e] = v;
          if (write && (own >> j & 1u)) x1m[o + eo[j]] = v;
        }
        xm1[j] = x0[j];
        x0[j] = xp;
        y3[j] = y2[j];
        y2[j] = y1[j];
        y1[j] = v;
        b2[j] = b1[j];
        b1[j] = bv;
      }
    }
  }
}

// First launch.  blockIdx.x < nint: interior block (tile, run); else a
// band block (x' on the band).  blockIdx.y: right-hand side.  STD: the
// taps are StdTap<NT>'s.
template <int NT, bool STD>
__global__ void __launch_bounds__(NTH, 3) jacres_kernel(
    Stencil3D s, int ntz, int nruns, int xrun, int nint,
    const float* __restrict__ cst, const float* __restrict__ band,
    const float* __restrict__ x, const float* __restrict__ b,
    const float* __restrict__ d, float* __restrict__ x1,
    float* __restrict__ r1) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float sc[MGT_MAX_TAPS];
  const int tid = threadIdx.x;
  mgt_load_consts<NT>(s, cst, sc, tid);
  __syncthreads();
  // the shell launch may place its blocks from here on
  asm volatile("griddepcontrol.launch_dependents;");
  const int moff = blockIdx.y * s.X * s.Y * s.Z;
  const float* xm = x + moff;
  const float* bm = b + moff;
  float* x1m = x1 + moff;
  const int blk = blockIdx.x;
  if (blk < nint)                                     // block-uniform
    interior_block<NT, STD>(s, sc, blk / nruns, blk % nruns, ntz, xrun,
                                xm, bm, d, x1m, r1 + moff, ring);
  else
    mgt_band_node<2, NT>(s, sc, (blk - nint) * NTH + tid, band, xm, bm, d,
                         nullptr, x1m);
}

// Second launch: r' = b - A x' on the shell (the band boxes, then the
// layer boxes), one thread a node.  x' is read through L1 (ld.global.ca):
// the first launch wrote it, and this one reads it only after
// griddepcontrol.wait, which makes those writes visible; no block of this
// launch touched it before.
template <int NT>
__global__ void __launch_bounds__(NTH) shell_residual_kernel(
    Stencil3D s, Boxes6 layer, int nband_nodes,
    const float* __restrict__ cst, const float* __restrict__ band,
    const float* __restrict__ x1, const float* __restrict__ b,
    float* __restrict__ r1) {
  __shared__ float sc[MGT_MAX_TAPS];
  mgt_load_consts<NT>(s, cst, sc, threadIdx.x);
  __syncthreads();
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the first launch
  const int e = blockIdx.x * NTH + threadIdx.x;
  int ix, iy, iz;
  if (!(e < nband_nodes
            ? mgt_box_node(s.bs, s.bn, e, ix, iy, iz)
            : mgt_box_node(layer.bs, layer.bn, e - nband_nodes, ix, iy, iz)))
    return;
  const int moff = blockIdx.y * s.X * s.Y * s.Z;
  const int plane = s.Y * s.Z;
  const int i = ix * plane + iy * s.Z + iz;
  const float* yc = x1 + moff + i;
  auto load = [&](int dx, int dy, int dz) {
    return __ldca(yc + dx * plane + dy * s.Z + dz);
  };
  const float ax = mgt_apply_node<NT, true>(s, sc, band, ix, iy, iz, load);
  r1[moff + i] = __ldg(b + moff + i) - ax;
}

// The launch plan (jacres_plan in ops/cuda/fused3d.py):
//   plan = [ty, tz, threads, xrun, nruns, ntiles, nband, nshell, smem]
// ntiles x nruns interior blocks and nband band blocks make the first
// launch, nshell shell blocks the second.
namespace {
struct Plan {
  int ty, tz, threads, xrun, nruns, ntiles, nband, nshell, smem;
};
}  // namespace

// True when `plan` is the plan of this grid: the derived numbers are
// recomputed here, so a plan that disagrees is refused.
static bool plan_ok(const Plan& p, const Stencil3D& s, const Boxes6& layer) {
  if (p.ty != TY || p.tz != TZ || p.threads != NTH || p.smem != SMEM)
    return false;
  const Interior in = interior_of(s);
  const long long band_nodes = mgt_band_nodes(s);
  const long long inner = (long long)in.X * in.Y * in.Z;
  // the boxes and the interior cover the grid once; the layer and the
  // core cover the interior once
  if (band_nodes + inner != (long long)s.X * s.Y * s.Z) return false;
  const long long core = (long long)(in.X > 2 ? in.X - 2 : 0) *
                         (in.Y > 2 ? in.Y - 2 : 0) * (in.Z > 2 ? in.Z - 2 : 0);
  if (box_nodes(layer) + core != inner) return false;
  if (p.nband != (band_nodes + NTH - 1) / NTH ||
      p.nshell != (band_nodes + box_nodes(layer) + NTH - 1) / NTH)
    return false;
  if (inner == 0)
    return p.xrun == 0 && p.nruns == 0 && p.ntiles == 0;
  const long long want_tiles = (long long)((in.Y + p.ty - 1) / p.ty) *
                               ((in.Z + p.tz - 1) / p.tz);
  // the runs cover [w, X-w) once, balanced: every run holds a plane and
  // xrun is the least length for nruns runs
  return p.xrun >= 1 && p.nruns >= 1 &&
         p.nruns == (in.X + p.xrun - 1) / p.xrun &&
         p.xrun == (in.X + p.nruns - 1) / p.nruns && p.ntiles == want_tiles &&
         want_tiles * p.nruns + p.nband < (1LL << 31);
}

template <int NT, bool STD>
static cudaError_t launch_first(const Plan& p, int m, cudaStream_t st,
                                const Stencil3D& s, const float* c,
                                const float* bd, const float* x,
                                const float* b, const float* d, float* x1,
                                float* r1) {
  auto* kernel = jacres_kernel<NT, STD>;
  // the rings need more than the default 48 KB of shared memory
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (opt_in != cudaSuccess) return opt_in;
  const int ntz = (interior_of(s).Z + TZ - 1) / TZ;
  const int nint = p.ntiles * p.nruns;
  dim3 grid((unsigned)(nint + p.nband), (unsigned)m);
  kernel<<<grid, NTH, p.smem, st>>>(s, ntz, p.nruns, p.xrun, nint, c, bd, x,
                                    b, d, x1, r1);
  return cudaGetLastError();
}

template <int NT>
static cudaError_t launch_all(const Plan& p, int m, cudaStream_t st,
                              const Stencil3D& s, const float* c,
                              const float* bd, const float* x,
                              const float* b, const float* d, float* x1,
                              float* r1) {
  const cudaError_t e =
      standard_taps<NT>(s)
          ? launch_first<NT, true>(p, m, st, s, c, bd, x, b, d, x1, r1)
          : launch_first<NT, false>(p, m, st, s, c, bd, x, b, d, x1, r1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.nshell, (unsigned)m);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, shell_residual_kernel<NT>, s, layer_of(s),
                            (int)mgt_band_nodes(s), c, bd, (const float*)x1,
                            b, r1);
}

// meta: host int32 stencil description (see stencil3d.cuh); m right-hand
// sides share d; plan: the host's launch plan (see plan_ok).  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a bad
// description or plan).
extern "C" int mgt_jacobi_residual3d(const int* meta, int m, const void* cst,
                                     const void* band, const void* x,
                                     const void* b, const void* d, void* x1,
                                     void* r1, void* stream,
                                     const int* plan) {
  Stencil3D s;
  if (mgt_stencil_from_meta(meta, &s) != 0 || m < 1 || m > 65535 ||
      s.X < 1 || s.Y < 1 || s.Z < 1 || !plan ||
      (long long)m * s.X * s.Y * s.Z >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Plan p = {plan[0], plan[1], plan[2], plan[3], plan[4],
                  plan[5], plan[6], plan[7], plan[8]};
  if (!plan_ok(p, s, layer_of(s))) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch) {
    return launch(p, m, st, s, static_cast<const float*>(cst),
                  static_cast<const float*>(band),
                  static_cast<const float*>(x), static_cast<const float*>(b),
                  static_cast<const float*>(d), static_cast<float*>(x1),
                  static_cast<float*>(r1));
  };
  const cudaError_t e = mgt_tap_count(s.nd) == 7 ? args(launch_all<7>)
                                                 : args(launch_all<27>);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
