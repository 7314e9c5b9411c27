// Kernel E: the lexicographic Vanka sweep (vanka-lex), float32, float64,
// complex64 or complex128, num_it sweeps over every cell in one launch.
//
// mgtpu runs it as a lax.fori_loop over the cells inside one device program
// (mgtpu/cycle/vanka.py::_lex_sweep); it has no Pallas kernel.  Cell l
// after cell l - 1, in order, for every right-hand side:
//   r   = b[idx[l]] - A[idx[l], :] x      (bs rows of K ELL entries)
//   x[idx[l]] += dinv[l] r                (dinv single precision, promoted)
// A cell's update changes the residual of the next, so the cells cannot
// run side by side.
//
// What bounds it: the chain of cells.  A sweep costs cells x (one
// dependent round of shared-memory loads, a K-long fma chain, bs shuffles,
// one __syncwarp) at best; its bytes are a few MB.  The schedule keeps the
// rest off that chain:
//  * One warp walks the cells; lane (i, r) of bs * m <= 32 takes row i of
//    the cell for right-hand side r (ops/cuda/vanka.py launches more
//    right-hand sides in chunks of 32 // bs): its K products (fma in tap
//    order), then u = sum_j dinv[i, j] r_j with r_j from lane (j, r) by
//    __shfl_sync (j in order), then x[idx[i]] += u; one __syncwarp a cell
//    orders the writes of cell l before the reads of cell l + 1.
//  * x in shared memory for the launch where n * m values fit beside the
//    rings (the 64^2 mixed fine level, 12,416 unknowns, in every type),
//    read once and written back once (xsmem 1), and b beside it where
//    both fit (xsmem 2: float32, float64, complex64 there); else x stays
//    in global memory (xsmem 0).
//  * The cell tables are streamed ahead as one record a cell (idx,
//    rows_idx, rows_val, dinv; ops/cuda/vanka.py `pack_cells`, built once
//    per state): the TMA's bulk copy brings cell l + 2A's record into a
//    ring in shared memory (stream.cuh), and, unless b is staged,
//    cp.async brings b at the ids of cell l + A's landed record; A =
//    kAhead.  A cell issues one bulk copy (and one cp.async), and its only
//    dependent reads are shared-memory reads.
//  * The orders of the first port's real and complex kernels are kept
//    (ax, then b - ax, then the dinv product over j in order, then x + u),
//    so the outputs are bitwise theirs.
//
// Complex values are float2 / double2 (torch's complex64 / complex128
// layout).  The block inverses are stored in the single variant of the
// value type, complex64 for both (mgtpu/setup/smoothers.py setup_vanka),
// and raised to x's type before the product, as mgtpu's
// `dinv.astype(x.dtype)`; a complex multiply-add is four real FMAs.  The
// rows are not conjugated (mgtpu's einsum of rows_val and x).
#include <cuda_runtime.h>

#include "stream.cuh"

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

constexpr int kAhead = 8;                    // cells of b in flight
constexpr int kRecRing = 2 * kAhead + 2;     // records l - 1 .. l + 2A
constexpr int kBRing = kAhead + 2;           // b of cells l .. l + A
constexpr int kMaxShared = 232448;           // 227 KB a block on sm_90

// y = a * b + c, real or complex
__device__ __forceinline__ float mad(float a, float b, float c) {
  return fma(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float2 mad(float2 a, float2 b, float2 c) {
  return make_float2(fma(-a.y, b.y, fma(a.x, b.x, c.x)),
                     fma(a.y, b.x, fma(a.x, b.y, c.y)));
}
__device__ __forceinline__ double2 mad(double2 a, double2 b, double2 c) {
  return make_double2(fma(-a.y, b.y, fma(a.x, b.x, c.x)),
                      fma(a.y, b.x, fma(a.x, b.y, c.y)));
}
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ double sub(double a, double b) { return a - b; }
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 sub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ double shfl(double v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ float2 shfl(float2 v, int src) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, src),
                     __shfl_sync(0xffffffffu, v.y, src));
}
__device__ __forceinline__ double2 shfl(double2 v, int src) {
  return make_double2(__shfl_sync(0xffffffffu, v.x, src),
                      __shfl_sync(0xffffffffu, v.y, src));
}
// a single-precision block-inverse entry raised to the value type
template <typename T, typename D>
__device__ __forceinline__ T widen(D d) {
  return T(d);
}
template <>
__device__ __forceinline__ float2 widen<float2, float2>(float2 d) {
  return d;
}
template <>
__device__ __forceinline__ double2 widen<double2, float2>(float2 d) {
  return make_double2(d.x, d.y);
}

struct Params {
  int L, bs, K, m, n, num_it, xsmem;
  int ro_val, ro_dinv, RB;                 // record: offsets, bytes
  int so_ring, so_b, so_x, so_bs;          // shared memory, bytes
};

// A cell's record (RB bytes, 16-byte aligned parts): idx[bs] |
// rows_idx[bs * K] (int32) | rows_val[bs * K] (T) | dinv[bs * bs] (D).
// BS, KK and MM fix bs, K and m at compile time (0: read from p), so the
// main path's cells (2D mixed: bs 5, K 7 on the fine level and 21 on its
// Galerkin levels, m 1) unroll: a cell's loads and shuffles issue
// together.
template <typename T, typename D, int BS, int KK, int MM>
__global__ void __launch_bounds__(32, 1) vanka_lex_kernel(
    const Params p, const unsigned char* __restrict__ cells,
    const T* __restrict__ b, T* x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int bs = BS > 0 ? BS : p.bs, K = KK > 0 ? KK : p.K;
  const int m = MM > 0 ? MM : p.m;
  const int RB = p.RB, bsm = bs * m;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // ring slots, x
  unsigned char* ring = smem + p.so_ring;
  T* bring = reinterpret_cast<T*>(smem + p.so_b);
  T* xs = p.xsmem ? reinterpret_cast<T*>(smem + p.so_x) : x;
  T* bs_ = reinterpret_cast<T*>(smem + p.so_bs);        // b, xsmem 2
  const int i = lane / m, r = lane - (lane / m) * m;   // row, rhs
  const bool act = lane < bsm;
  const int cells_n = p.num_it * p.L;
  if (lane == 0) {
    for (int q = 0; q < kRecRing + 2; ++q) mbar_init(bars + q);
    mbar_init_fence();
  }
  __syncwarp();
  // stage x (and b): the 16-byte part by one bulk copy, the tail by
  // cp.async
  const uint32_t xbytes = (uint32_t)p.n * m * sizeof(T);
  const uint32_t xbulk = xbytes / 16 * 16;
  if (p.xsmem) {
    if (lane == 0 && xbulk) bulk_load(xs, x, xbulk, bars + kRecRing);
    for (int e = xbulk / sizeof(T) + lane; e < p.n * m; e += 32)
      cp_async<sizeof(T)>(xs + e, x + e);
  }
  if (p.xsmem == 2) {
    if (lane == 0 && xbulk) bulk_load(bs_, b, xbulk, bars + kRecRing + 1);
    for (int e = xbulk / sizeof(T) + lane; e < p.n * m; e += 32)
      cp_async<sizeof(T)>(bs_ + e, b + e);
  }
  cp_commit();

  auto issue_rec = [&](int l, int slot) {
    if (lane == 0)
      bulk_load(ring + slot * RB, cells + (size_t)l * RB, RB, bars + slot);
  };
  auto issue_b = [&](const Slot<kRecRing>& rs, int bslot) {
    if (p.xsmem == 2) return;              // b is staged
    mbar_wait(bars + rs.v, rs.phase);
    const int* id = reinterpret_cast<const int*>(ring + rs.v * RB);
    if (act)
      cp_async<sizeof(T)>(bring + bslot * bsm + lane,
                          b + (size_t)id[i] * m + r);
  };

  int lr = 0;                              // cell of the next record
  for (int s = 0; s < 2 * kAhead && s < cells_n; ++s) {
    issue_rec(lr, s % kRecRing);
    if (++lr == p.L) lr = 0;
  }
  {
    Slot<kRecRing> rs(0);
    for (int s = 0; s < kAhead; ++s, rs.next()) {
      if (s < cells_n) issue_b(rs, s);
      cp_commit();
    }
  }
  if (p.xsmem && xbulk) mbar_wait(bars + kRecRing, 0);
  if (p.xsmem == 2 && xbulk) mbar_wait(bars + kRecRing + 1, 0);
  // ring slots of cells s, s + A, s + 2A; b of cells s, s + A
  Slot<kRecRing> rc(0), ra(kAhead), r2(2 * kAhead);
  Slot<kBRing> bc(0), ba(kAhead);
  for (int s = 0; s < cells_n; ++s) {
    cp_wait<kAhead - 1>();
    mbar_wait(bars + rc.v, rc.phase);
    __syncwarp();
    if (s + 2 * kAhead < cells_n) issue_rec(lr, r2.v);
    if (++lr == p.L) lr = 0;
    if (s + kAhead < cells_n) issue_b(ra, ba.v);
    cp_commit();
    const unsigned char* rec = ring + rc.v * RB;
    const int* id = reinterpret_cast<const int*>(rec);
    const T* rv = reinterpret_cast<const T*>(rec + p.ro_val);
    const D* dv = reinterpret_cast<const D*>(rec + p.ro_dinv);
    const T* bv = bring + bc.v * bsm;
    T res = T{};
    if (act) {
      const int* ri = id + bs + i * K;
      const T* av = rv + i * K;
      T ax = T{};
#pragma unroll
      for (int k = 0; k < K; ++k)
        ax = mad(av[k], xs[(size_t)ri[k] * m + r], ax);
      res = sub(p.xsmem == 2 ? bs_[(size_t)id[i] * m + r] : bv[lane], ax);
    }
    T u = T{};
#pragma unroll
    for (int j = 0; j < bs; ++j) {
      const T rj = shfl(res, j * m + r);
      if (act) u = mad(widen<T, D>(dv[i * bs + j]), rj, u);
    }
    if (act) {
      const size_t o = (size_t)id[i] * m + r;
      xs[o] = add(xs[o], u);
    }
    rc.next(); ra.next(); r2.next();
    bc.next(); ba.next();
  }
  cp_wait<0>();
  __syncwarp();
  if (p.xsmem) {
    if (lane == 0 && xbulk) bulk_store_wait(x, xs, xbulk);
    for (int e = xbulk / sizeof(T) + lane; e < p.n * m; e += 32)
      x[e] = xs[e];
  }
}

static int align16(long long v) { return static_cast<int>((v + 15) / 16 * 16); }

// The shared memory of a launch, and its offsets
static long long plan_smem(Params& p, int it) {
  const long long nm = (long long)p.n * p.m * it;
  p.so_ring = align16(8LL * (kRecRing + 2));
  p.so_b = p.so_ring + kRecRing * p.RB;
  p.so_x = p.so_b + align16((long long)kBRing * p.bs * p.m * it);
  p.so_bs = p.so_x + align16(p.xsmem ? nm : 0);
  return p.so_bs + (p.xsmem == 2 ? nm : 0);
}

template <typename T, typename D, int BS, int KK, int MM>
static int launch_as(Params p, const void* cells, const void* b, void* x,
                     cudaStream_t st) {
  const long long smem = plan_smem(p, sizeof(T));
  if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
  auto kern = vanka_lex_kernel<T, D, BS, KK, MM>;
  static bool set = false;                 // per instantiation
  if (smem > 48 * 1024 && !set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (e != cudaSuccess) return (int)e;
    set = true;
  }
  kern<<<1, 32, smem, st>>>(p, static_cast<const unsigned char*>(cells),
                            static_cast<const T*>(b), static_cast<T*>(x));
  return (int)cudaGetLastError();
}

template <typename T, typename D>
static int launch(const Params& p, const void* cells, const void* b,
                  void* x, cudaStream_t st) {
  if (p.bs == 5 && p.K == 7 && p.m == 1)   // 2D mixed cells, one rhs
    return launch_as<T, D, 5, 7, 1>(p, cells, b, x, st);
  if (p.bs == 5 && p.K == 21 && p.m == 1)  // their Galerkin coarse levels
    return launch_as<T, D, 5, 21, 1>(p, cells, b, x, st);
  return launch_as<T, D, 0, 0, 0>(p, cells, b, x, st);
}

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128 (interleaved real
// and imaginary parts).  cells (L, RB) bytes: each cell's record (idx[bs],
// rows_idx[bs * K] int32 at 0, rows_val[bs * K] of dtype at ro_val,
// dinv[bs * bs] float32 / complex64 at ro_dinv; ops/cuda/vanka.py
// `pack_cells`), 16-byte aligned, RB a multiple of 16; b and x (n, m) of
// dtype, row-major; x is updated in place, staged in shared memory when
// xsmem is 1, x and b when xsmem is 2.  bs * m <= 32.  Launches one warp on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a bad description or
// shared memory that does not fit).
extern "C" int mgt_vanka_lex(int dtype, int L, int bs, int K, int m, int n,
                             int num_it, int xsmem, int ro_val, int ro_dinv,
                             int RB, const void* cells, const void* b,
                             void* x, void* stream) {
  const int it = dtype == 0 ? 4 : dtype == 3 ? 16 : 8;
  const int dt = dtype >= 2 ? 8 : 4;
  if (dtype < 0 || dtype > 3 || L < 1 || bs < 1 || K < 1 || m < 1 ||
      bs * m > 32 || n < 1 || num_it < 0 || xsmem < 0 || xsmem > 2 ||
      RB % 16 != 0 || ro_val % 16 != 0 || ro_dinv % 16 != 0 ||
      ro_val < (bs + bs * K) * 4 || ro_dinv < ro_val + bs * K * it ||
      RB < ro_dinv + bs * bs * dt || !cells || !b || !x ||
      reinterpret_cast<uintptr_t>(cells) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (xsmem == 2 && reinterpret_cast<uintptr_t>(b) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if ((long long)n * m >= (1LL << 31) || (long long)L * RB >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  if (num_it == 0) return (int)cudaSuccess;
  Params p{};
  p.L = L; p.bs = bs; p.K = K; p.m = m; p.n = n; p.num_it = num_it;
  p.xsmem = xsmem; p.ro_val = ro_val; p.ro_dinv = ro_dinv; p.RB = RB;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, float>(p, cells, b, x, st);
  if (dtype == 1) return launch<double, float>(p, cells, b, x, st);
  if (dtype == 2) return launch<float2, float2>(p, cells, b, x, st);
  return launch<double2, float2>(p, cells, b, x, st);
}
