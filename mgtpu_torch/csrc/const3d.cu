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
// What the design does about it: one launch, two kinds of block.
//  * Interior blocks (2.5D blocking, marching along x).  The interior box
//    [w, X-w) x [w, Y-w) x [w, Z-w) is cut into tiles of the (y, z) plane,
//    (TY, TZ) = (16, 32), or (4, 128) where the interior z extent fills at
//    least 3/4 of that (at 129^3 jacobi_corr is 1.3x faster so on an H100),
//    and its x range into runs; a block owns one tile and walks one run of
//    x-planes.  256 threads, each computing two nodes of the tile, with no
//    integer division.  The planes of x with a one-node (y, z) halo live in
//    a ring of NSLOT shared-memory slots, the tile's planes of b and d in
//    rings of NBD; the planes up to DEPTH ahead of the one being computed
//    are in flight (cp.async of 4 bytes: a 129-wide row is 516 bytes and a
//    plane 66 564, neither a multiple of the 16 bytes that a TMA tensor map
//    or a 16-byte cp.async needs).  So each byte of x leaves device memory
//    about once (the halo's share, (TY+2)(TZ+2)/(TY TZ) plus two planes per
//    run, comes mostly from L2), and no iteration waits on a load issued in
//    the same iteration.  Interior halos lie inside the grid (w >= 1), so
//    the ring needs no zero cells and the taps no checks.  In jacobi_corr p
//    comes through a ring of its own, and each thread forms s = x + p in
//    place on the cells it loaded, as they arrive.
//  * Band blocks: one thread per node of the six band boxes (PR 3's
//    one-thread-per-node form, mgt_apply_node<NT, true>): each band node
//    reads its box's coefficients and its taps from global memory.  At
//    129^3 with w = 2 the band is 9 % of the nodes.  Keeping it out of the
//    march keeps every coefficient load (a round trip to memory) out of the
//    interior blocks' barriers.
// Each node sums the same fmaf chain over k = 0..NT-1 as PR 3's kernel, so
// the outputs are bitwise the same; for the port's own 7- and 27-point
// stencils, whose offsets come in sorted order, the tap offsets are
// compile-time constants.  The launch plan (tile, x-run, band blocks,
// shared memory) comes from const3d.py::apply_plan; the x-runs are sized so
// that about 264 interior blocks (two per SM) are in flight.
#include <cuda_pipeline.h>

#include "stencil3d.cuh"

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace {
constexpr int NTH = 256;                  // threads of every block
constexpr int DEPTH = 2;                  // planes in flight ahead
constexpr int NSLOT = DEPTH + 4;          // x (p) ring: x-1, x, x+1, ahead,
                                          // and the plane read last
constexpr int NBD = DEPTH + 3;            // b (d) ring
constexpr int kSmemDefault = 48 * 1024;
}  // namespace

// An interior tile of TY x TZ nodes of the (y, z) plane: blockDim is
// (TZ, BY), each thread computing TY / BY rows.
template <int TY_, int TZ_>
struct Tile {
  static constexpr int TY = TY_, TZ = TZ_;
  static constexpr int BY = NTH / TZ;
  static constexpr int EZ = TZ + 2, EY = TY + 2;
  static constexpr int EN = EY * EZ;      // x (p) plane of a tile with halo
  static constexpr int TN = TY * TZ;      // b (d) plane of a tile
  // bytes of dynamic shared memory of a mode (the plan's `smem`)
  __host__ __device__ static constexpr int bytes(int mode) {
    return static_cast<int>(sizeof(float)) *
           (NSLOT * EN * (mode == 3 ? 2 : 1) + NBD * TN * (mode >= 2 ? 2 : mode));
  }
};
using Narrow = Tile<16, 32>;              // any grid
using Wide = Tile<4, 128>;                // interior z of 96 .. 128 nodes

template <int MODE, int NT, bool STD, typename TL>
__device__ __forceinline__ void interior_block(
    const Stencil3D& s, const float* sc, int tile, int run, int ntz,
    int xrun, const float* __restrict__ xm, const float* __restrict__ bm,
    const float* __restrict__ d, const float* __restrict__ pm,
    float* __restrict__ om, float* ring) {
  constexpr int TY = TL::TY, TZ = TL::TZ, BY = TL::BY;
  constexpr int EZ = TL::EZ, EN = TL::EN, TN = TL::TN;
  constexpr int NXL = (EN + NTH - 1) / NTH;          // x (p) cells a thread loads
  constexpr int NBL = TN / NTH;                      // b (d) cells a thread loads
  float* xr = ring;                                  // NSLOT x (s) planes
  float* pr = xr + NSLOT * EN;                       // NSLOT p planes
  float* br = MODE == 3 ? pr + NSLOT * EN : pr;      // NBD b planes
  float* dr = br + NBD * TN;                         // NBD d planes
  const int tid = threadIdx.y * TZ + threadIdx.x;
  const int w = s.w;
  const int ty = tile / ntz;
  const int y0 = w + ty * TY, z0 = w + (tile - ty * ntz) * TZ;
  const int xa = w + run * xrun;
  const int xb = min(s.X - w, xa + xrun);
  const int plane = s.Y * s.Z;
  float cr[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) cr[k] = sc[k];
  // this thread's cells of a plane, as offsets within the plane (-1: past
  // the grid's end, where no valid node reads)
  int xo[NXL], bo[NBL];
#pragma unroll
  for (int j = 0; j < NXL; ++j) {
    const int e = tid + j * NTH;
    const int ey = e / EZ, ez = e - ey * EZ;
    const int gy = y0 - 1 + ey, gz = z0 - 1 + ez;
    xo[j] = e < EN && gy < s.Y && gz < s.Z ? gy * s.Z + gz : -1;
  }
#pragma unroll
  for (int j = 0; j < NBL; ++j) {
    const int e = tid + j * NTH;
    const int gy = y0 + e / TZ, gz = z0 + (e & (TZ - 1));
    bo[j] = gy < s.Y && gz < s.Z ? gy * s.Z + gz : -1;
  }
  // ring slots by plane, counted from xa-1
  auto xs = [&](int gx) { return xr + ((gx - xa + 1) % NSLOT) * EN; };
  auto ps = [&](int gx) { return pr + ((gx - xa + 1) % NSLOT) * EN; };
  auto bs = [&](int gx) { return br + ((gx - xa + 1) % NBD) * TN; };
  auto ds = [&](int gx) { return dr + ((gx - xa + 1) % NBD) * TN; };
  // issue the loads of plane gx: x (and p) with halo, b (and d) on the tile
  auto issue = [&](int gx) {
    if (gx <= xb) {
      const int base = gx * plane;
      float* xd = xs(gx);
      float* pd = ps(gx);
#pragma unroll
      for (int j = 0; j < NXL; ++j) {
        if (xo[j] < 0) continue;
        __pipeline_memcpy_async(xd + tid + j * NTH, xm + base + xo[j],
                                sizeof(float));
        if constexpr (MODE == 3)
          __pipeline_memcpy_async(pd + tid + j * NTH, pm + base + xo[j],
                                  sizeof(float));
      }
      if constexpr (MODE >= 1) {
        float* bd = bs(gx);
        float* dd = ds(gx);
#pragma unroll
        for (int j = 0; j < NBL; ++j) {
          if (bo[j] < 0) continue;
          __pipeline_memcpy_async(bd + tid + j * NTH, bm + base + bo[j],
                                  sizeof(float));
          if constexpr (MODE >= 2)
            __pipeline_memcpy_async(dd + tid + j * NTH, d + base + bo[j],
                                    sizeof(float));
        }
      }
    }
    __pipeline_commit();                              // one group per plane
  };
  // s = x + p over this thread's cells of plane gx
  auto form_s = [&](int gx) {
    float* sd = xs(gx);
    const float* pd = ps(gx);
#pragma unroll
    for (int j = 0; j < NXL; ++j)
      if (xo[j] >= 0) sd[tid + j * NTH] += pd[tid + j * NTH];
  };

  for (int q = -1; q <= DEPTH; ++q) issue(xa + q);    // prologue
  __pipeline_wait_prior(DEPTH);                       // planes xa-1, xa
  if constexpr (MODE == 3) {                          // own cells: no barrier
    form_s(xa - 1);
    form_s(xa);
  }
  const int gz = z0 + threadIdx.x;
  for (int ix = xa; ix < xb; ++ix) {
    // the slot of plane ix+DEPTH+1 was last read in iteration ix-2, before
    // the barrier of iteration ix-1
    issue(ix + DEPTH + 1);
    __pipeline_wait_prior(DEPTH);                     // plane ix+1 is here
    if constexpr (MODE == 3) form_s(ix + 1);          // own cells only
    __syncthreads();
    const float* pl[3] = {xs(ix - 1), xs(ix), xs(ix + 1)};
    const float* bp = bs(ix);
    const float* dp = ds(ix);
#pragma unroll
    for (int h = 0; h < TY / BY; ++h) {
      const int ly = threadIdx.y + h * BY;
      const int gy = y0 + ly;
      if (gy >= s.Y - w || gz >= s.Z - w) continue;
      const int c = (ly + 1) * EZ + threadIdx.x + 1;
      // the interior branch of mgt_apply_node: constants, no checks
      float ax = 0.0f;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        if constexpr (STD) {
          const float* p = pl[StdTap<NT>::dx(k) + 1];
          ax = fmaf(cr[k], p[c + StdTap<NT>::dy(k) * EZ + StdTap<NT>::dz(k)],
                    ax);
        } else {
          const int dx = s.dx[k];
          const float* p = dx < 0 ? pl[0] : dx > 0 ? pl[2] : pl[1];
          ax = fmaf(cr[k], p[c + s.dy[k] * EZ + s.dz[k]], ax);
        }
      }
      const int i = ix * plane + gy * s.Z + gz;
      const int t = ly * TZ + threadIdx.x;
      if constexpr (MODE == 0) {
        om[i] = ax;
      } else if constexpr (MODE == 1) {
        om[i] = bp[t] - ax;
      } else {
        om[i] = pl[1][c] + dp[t] * (bp[t] - ax);
      }
    }
  }
}

// blockIdx.x < nint: interior block (tile, run); else band block.
// blockIdx.y: right-hand side.  STD: the taps are StdTap<NT>'s.
template <int MODE, int NT, bool STD, typename TL>
__global__ void __launch_bounds__(NTH, 3) stencil3d_apply_kernel(
    Stencil3D s, int ntz, int nruns, int xrun, int nint,
    const float* __restrict__ cst, const float* __restrict__ band,
    const float* __restrict__ x, const float* __restrict__ b,
    const float* __restrict__ d, const float* __restrict__ p,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float sc[MGT_MAX_TAPS];
  mgt_load_consts<NT>(s, cst, sc, threadIdx.y * TL::TZ + threadIdx.x);
  __syncthreads();
  const int moff = blockIdx.y * s.X * s.Y * s.Z;
  const float* xm = x + moff;
  const float* bm = MODE >= 1 ? b + moff : nullptr;
  const float* pm = MODE == 3 ? p + moff : nullptr;
  float* om = out + moff;
  const int blk = blockIdx.x;
  if (blk < nint)                                     // block-uniform
    interior_block<MODE, NT, STD, TL>(s, sc, blk / nruns, blk % nruns, ntz,
                                      xrun, xm, bm, d, pm, om, ring);
  else
    mgt_band_node<MODE, NT>(
        s, sc, (blk - nint) * NTH + threadIdx.y * blockDim.x + threadIdx.x,
        band, xm, bm, d, pm, om);
}

template <int MODE, int NT, bool STD, typename TL>
static cudaError_t launch_mode(const int* plan, int m, cudaStream_t st,
                               const Stencil3D& s, const float* c,
                               const float* bd, const float* x,
                               const float* b, const float* d,
                               const float* p, float* o) {
  auto* kernel = stencil3d_apply_kernel<MODE, NT, STD, TL>;
  if (TL::bytes(MODE) > kSmemDefault) {
    // what this mode needs: the block also holds static shared memory
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TL::bytes(MODE));
    if (opt_in != cudaSuccess) return opt_in;
  }
  const int ntz = (interior_of(s).Z + TL::TZ - 1) / TL::TZ;
  const int nint = plan[5] * plan[4];
  dim3 grid((unsigned)(nint + plan[6]), (unsigned)m);
  kernel<<<grid, dim3(TL::TZ, TL::BY), plan[7], st>>>(
      s, ntz, plan[4], plan[3], nint, c, bd, x, b, d, p, o);
  return cudaSuccess;
}

template <int MODE, int NT>
static cudaError_t launch_taps(const int* plan, int m, cudaStream_t st,
                               const Stencil3D& s, const float* c,
                               const float* bd, const float* x,
                               const float* b, const float* d,
                               const float* p, float* o) {
  const bool std_taps = standard_taps<NT>(s);
  if (plan[1] == Wide::TZ)
    return std_taps
        ? launch_mode<MODE, NT, true, Wide>(plan, m, st, s, c, bd, x, b, d, p, o)
        : launch_mode<MODE, NT, false, Wide>(plan, m, st, s, c, bd, x, b, d, p, o);
  return std_taps
      ? launch_mode<MODE, NT, true, Narrow>(plan, m, st, s, c, bd, x, b, d, p, o)
      : launch_mode<MODE, NT, false, Narrow>(plan, m, st, s, c, bd, x, b, d, p, o);
}

template <int NT>
static cudaError_t launch_apply(int mode, const int* plan, int m,
                                cudaStream_t st, const Stencil3D& s,
                                const float* c, const float* bd,
                                const float* x, const float* b,
                                const float* d, const float* p, float* o) {
  switch (mode) {
    case 0: return launch_taps<0, NT>(plan, m, st, s, c, bd, x, b, d, p, o);
    case 1: return launch_taps<1, NT>(plan, m, st, s, c, bd, x, b, d, p, o);
    case 2: return launch_taps<2, NT>(plan, m, st, s, c, bd, x, b, d, p, o);
    default: return launch_taps<3, NT>(plan, m, st, s, c, bd, x, b, d, p, o);
  }
}

// The launch plan (apply_plan in ops/cuda/const3d.py):
//   plan = [ty, tz, threads, xrun, nruns, ntiles, nband, smem]
// ntiles x nruns interior blocks, nband band blocks.  Returns true when it
// is the plan of this grid and mode: the derived numbers are recomputed
// here, so a plan that disagrees is refused.
static bool plan_ok(const int* plan, int mode, const Stencil3D& s) {
  const int ty = plan[0], tz = plan[1], threads = plan[2], xrun = plan[3];
  const int nruns = plan[4], ntiles = plan[5], nband = plan[6];
  const int smem = plan[7];
  const bool wide = ty == Wide::TY && tz == Wide::TZ;
  if (!(wide || (ty == Narrow::TY && tz == Narrow::TZ)) || threads != NTH ||
      smem != (wide ? Wide::bytes(mode) : Narrow::bytes(mode)))
    return false;
  const Interior in = interior_of(s);
  const long long band_nodes = mgt_band_nodes(s);
  // the boxes and the interior cover the grid once
  if (band_nodes + (long long)in.X * in.Y * in.Z !=
      (long long)s.X * s.Y * s.Z)
    return false;
  if (nband != (band_nodes + NTH - 1) / NTH) return false;
  if (in.X == 0 || in.Y == 0 || in.Z == 0)
    return xrun == 0 && nruns == 0 && ntiles == 0;
  const long long want_tiles =
      (long long)((in.Y + ty - 1) / ty) * ((in.Z + tz - 1) / tz);
  // the runs cover [w, X-w) once, balanced: every run holds a plane and
  // xrun is the least length for nruns runs
  return xrun >= 1 && nruns >= 1 && nruns == (in.X + xrun - 1) / xrun &&
         xrun == (in.X + nruns - 1) / nruns && ntiles == want_tiles &&
         want_tiles * nruns + nband < (1LL << 31);
}

// meta: host int32 stencil description (see stencil3d.cuh); m: number of
// right-hand sides; d is shared across them; plan: the host's launch plan
// (see plan_ok).  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a bad description or plan).
extern "C" int mgt_stencil3d_apply(int mode, const int* meta, int m,
                                   const void* cst, const void* band,
                                   const void* x, const void* b,
                                   const void* d, const void* p, void* out,
                                   void* stream, const int* plan) {
  Stencil3D s;
  if (mgt_stencil_from_meta(meta, &s) != 0 || m < 1 || m > 65535 ||
      s.X < 1 || s.Y < 1 || s.Z < 1 || mode < 0 || mode > 3 || !plan ||
      (long long)m * s.X * s.Y * s.Z >= (1LL << 31) || !plan_ok(plan, mode, s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch) {
    return launch(mode, plan, m, st, s, static_cast<const float*>(cst),
                  static_cast<const float*>(band),
                  static_cast<const float*>(x), static_cast<const float*>(b),
                  static_cast<const float*>(d), static_cast<const float*>(p),
                  static_cast<float*>(out));
  };
  const cudaError_t e = mgt_tap_count(s.nd) == 7 ? args(launch_apply<7>)
                                                 : args(launch_apply<27>);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
