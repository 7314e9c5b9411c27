// Kernel B: double apply of a 3D constant-interior radius-1 stencil — the
// pre-smoothing Jacobi sweep and the residual that restriction needs, in
// one pass over the fields:
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
// What the design does about it: each block owns a (TX, TY, TZ) tile of
// outputs.  One load stage brings x with a two-node halo, and b and d with
// a one-node halo, into shared memory, every load issued together (zero
// off the grid).  The first apply computes x' on the tile plus a one-node
// halo from shared memory; the second writes the tile's x' and
// r' = b - A x', again from shared memory, so x' never makes a round trip
// through device memory.  Each block has two barriers and no chain of
// dependent steps, which keeps the latency of a block to about one round
// trip to memory.  The halos are recomputed by neighbouring blocks (about
// 2x the first apply's arithmetic, extra reads served by L2, no extra
// device-memory bytes).  Interior nodes take the constants from shared
// memory; band nodes read their box's coefficients (zero for off-grid
// taps), so every node is exact and no separate band-row pass is needed.
#include "stencil3d.cuh"

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace {
constexpr int TZ = 32, TY = 8, TX = 4;    // output tile (z, y, x)
constexpr int NTH = TZ * TY;
constexpr int EZ = TZ + 2, EY = TY + 2, EX = TX + 2;
constexpr int EN = EX * EY * EZ;          // x' tile, one-node halo
constexpr int QZ = TZ + 4, QY = TY + 4, QX = TX + 4;
constexpr int QN = QX * QY * QZ;          // x tile, two-node halo
}  // namespace

template <int NT>
__global__ void __launch_bounds__(NTH, 4) jacobi_residual3d_kernel(
    Stencil3D s, const float* __restrict__ cst,
    const float* __restrict__ band, const float* __restrict__ x,
    const float* __restrict__ b, const float* __restrict__ d,
    float* __restrict__ x1, float* __restrict__ r1) {
  __shared__ float sc[MGT_MAX_TAPS];
  __shared__ float xs[QN];
  __shared__ float ys[EN];
  __shared__ float bs[EN];
  __shared__ float ds[EN];
  const int tid = threadIdx.y * TZ + threadIdx.x;
  mgt_load_consts<NT>(s, cst, sc, tid);
  const int ntx = (s.X + TX - 1) / TX;
  const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY;
  const int x0 = (blockIdx.z % ntx) * TX;
  const int plane = s.Y * s.Z;
  const int moff = (blockIdx.z / ntx) * plane * s.X;
  const float* xm = x + moff;
  const float* bm = b + moff;
#pragma unroll
  for (int j = 0; j < (QN + NTH - 1) / NTH; ++j) {
    const int e = tid + j * NTH;
    const int qz = e % QZ, qy = (e / QZ) % QY, qx = e / (QZ * QY);
    const int gx = x0 - 2 + qx, gy = y0 - 2 + qy, gz = z0 - 2 + qz;
    const bool in = e < QN && gx >= 0 && gx < s.X && gy >= 0 && gy < s.Y &&
                    gz >= 0 && gz < s.Z;
    const float v = in ? __ldg(xm + gx * plane + gy * s.Z + gz) : 0.0f;
    if (e < QN) xs[e] = v;
  }
#pragma unroll
  for (int j = 0; j < (EN + NTH - 1) / NTH; ++j) {
    const int e = tid + j * NTH;
    const int ez = e % EZ, ey = (e / EZ) % EY, ex = e / (EZ * EY);
    const int gx = x0 - 1 + ex, gy = y0 - 1 + ey, gz = z0 - 1 + ez;
    const bool in = e < EN && gx >= 0 && gx < s.X && gy >= 0 && gy < s.Y &&
                    gz >= 0 && gz < s.Z;
    const int i = gx * plane + gy * s.Z + gz;
    const float bv = in ? __ldg(bm + i) : 0.0f;
    const float dv = in ? __ldg(d + i) : 0.0f;
    if (e < EN) {
      bs[e] = bv;
      ds[e] = dv;
    }
  }
  __syncthreads();
  for (int e = tid; e < EN; e += NTH) {
    const int ez = e % EZ, ey = (e / EZ) % EY, ex = e / (EZ * EY);
    const int gx = x0 - 1 + ex, gy = y0 - 1 + ey, gz = z0 - 1 + ez;
    float v = 0.0f;
    if (gx >= 0 && gx < s.X && gy >= 0 && gy < s.Y && gz >= 0 && gz < s.Z) {
      const int c = ((ex + 1) * QY + ey + 1) * QZ + ez + 1;
      auto xload = [&](int dx, int dy, int dz) {
        return xs[c + (dx * QY + dy) * QZ + dz];
      };
      const float ax = mgt_apply_node<NT, false>(s, sc, band, gx, gy, gz,
                                                 xload);
      v = xs[c] + ds[e] * (bs[e] - ax);
    }
    ys[e] = v;
  }
  __syncthreads();
  const int gz = z0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gz >= s.Z || gy >= s.Y) return;
  for (int lx = 0; lx < TX; ++lx) {
    const int gx = x0 + lx;
    if (gx >= s.X) break;
    const int c = ((lx + 1) * EY + threadIdx.y + 1) * EZ + threadIdx.x + 1;
    auto yload = [&](int dx, int dy, int dz) {
      return ys[c + (dx * EY + dy) * EZ + dz];
    };
    const float ax = mgt_apply_node<NT, false>(s, sc, band, gx, gy, gz, yload);
    const int i = gx * plane + gy * s.Z + gz;
    x1[moff + i] = ys[c];
    r1[moff + i] = bs[c] - ax;
  }
}

// meta: host int32 stencil description (see stencil3d.cuh); m right-hand
// sides share d.  Launches on `stream`; returns cudaGetLastError().
extern "C" int mgt_jacobi_residual3d(const int* meta, int m, const void* cst,
                                     const void* band, const void* x,
                                     const void* b, const void* d, void* x1,
                                     void* r1, void* stream) {
  Stencil3D s;
  if (mgt_stencil_from_meta(meta, &s) != 0 || m < 1 ||
      (long long)m * s.X * s.Y * s.Z >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long nz = ((long long)s.X + TX - 1) / TX * m;
  const long long ny = ((long long)s.Y + TY - 1) / TY;
  if (nz > 65535 || ny > 65535) return (int)cudaErrorInvalidValue;
  dim3 block(TZ, TY);
  dim3 grid((unsigned)((s.Z + TZ - 1) / TZ), (unsigned)ny, (unsigned)nz);
  auto kernel = mgt_tap_count(s.nd) == 7 ? jacobi_residual3d_kernel<7>
                                         : jacobi_residual3d_kernel<27>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const float*>(cst), static_cast<const float*>(band),
      static_cast<const float*>(x), static_cast<const float*>(b),
      static_cast<const float*>(d), static_cast<float*>(x1),
      static_cast<float*>(r1));
  return (int)cudaGetLastError();
}
