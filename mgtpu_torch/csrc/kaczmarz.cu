// Kernel F: the hybrid (domain-decomposed) row Kaczmarz sweep, float32,
// float64, complex64 or complex128, 1 <= m <= 4 right-hand sides, num_it
// sweeps in one launch.
//
// mgtpu runs it as a lax.fori_loop over the rows of a domain inside one
// device program (mgtpu/cycle/kaczmarz.py:70 kaczmarz_sweep, its row_step
// at :78-91); it has no Pallas kernel.  Step i takes row arr[i, d] of every
// domain d at once, for every right-hand side r:
//   inner[d, r] = (b[row, r] - a_row . x[:, r]) * invd[row] * mask[i, d]
//   x[col, r]  += conj(a_row[col]) * inner[d, r]     for the row's columns
// all from the x of before the step; where two domains touch one column in
// the same step their adds are summed in (domain, tap) order, and the sum
// is added once (the link table, ops/cuda/kaczmarz.py `kaczmarz_links`).
//
// What bounds it: the chain of steps.  Each step needs the x its
// predecessor wrote, so a launch costs steps x (one dependent round of
// loads, a K-long fma chain, one barrier) at best; the bytes are a few MB.
// One warp walks the steps and the schedule keeps the rest off that
// chain:
//  * x stays in global memory, where the L1 keeps the few columns a step
//    touches: on an H100, x staged whole in shared memory ran no faster
//    (K-mg's level 1, PERF.md).
//  * Tables streamed ahead.  The plan (ops/cuda/kaczmarz.py
//    `kaczmarz_plan`, built at setup) holds per step one record: an int32
//    chunk (every domain's row id, -1 when padded; the rows' tap slots;
//    for each tap that owns its column's chain, the chain's terms domain
//    << 8 | tap) and the values those read (the rows' ELL values, the
//    terms' coefficients, invd), baked once per state
//    (`kaczmarz_records`).  The TMA's bulk copy brings step s + 2A's
//    record into a ring in shared memory, and cp.async brings b at the
//    rows of step s + A's landed record; A = kAhead (stream.cuh).
//  * x read once a step.  The lane of a row keeps its taps' x in
//    registers from the residual to the step's adds: a tap that owns its
//    column's chain adds the chain onto that register and stores.  The
//    adds load everything before their first store, so the taps do not
//    serialise.
//  * One barrier a step.  inner is double-buffered by step parity: step
//    s's phase applies step s - 1's adds, __syncwarp, then computes step
//    s's inner, and one __syncwarp separates it from step s + 1's phase.
//  * The orders of the first port's kernel are kept: ax by fma over the
//    taps in order, inner = ((b - ax) * invd) (mask 1 where live), acc
//    from the owner's term and then its chain, x + acc once; only taps
//    past the longest live row (ELL padding, values 0) are left out of
//    ax.  With no contraction left to the compiler (the helpers below),
//    every instantiation rounds them the same way.
//
// Complex values are float2 / double2 (torch's complex layout); the row
// norms behind invd and the mask stay real (mgtpu/cycle/kaczmarz.py:55),
// so inner is (b - a.x) times a real scale, and the update adds
// conj(a) * inner.
#include <cuda_runtime.h>

#include "stream.cuh"

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

constexpr int kMaxRhs = 4;
constexpr int kAhead = 8;                    // steps of b in flight
constexpr int kRecRing = 2 * kAhead + 2;     // records s - 1 .. s + 2A
constexpr int kBRing = kAhead + 2;           // b of steps s .. s + A
constexpr int kMaxShared = 232448;           // 227 KB a block on sm_90

// a * b + c, conj(a) * b, conj(a) * b + c, a - b, a * s (s real), a + b.
// The lone products, sums and differences are the _rn intrinsics, which
// the compiler never contracts into an fma: every instantiation rounds a
// step's adds (x + conj(a) * inner) the same way.
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
__device__ __forceinline__ float conj_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double conj_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float2 conj_mul(float2 a, float2 b) {
  return make_float2(fma(a.y, b.y, __fmul_rn(a.x, b.x)),
                     fma(-a.y, b.x, __fmul_rn(a.x, b.y)));
}
__device__ __forceinline__ double2 conj_mul(double2 a, double2 b) {
  return make_double2(fma(a.y, b.y, __dmul_rn(a.x, b.x)),
                      fma(-a.y, b.x, __dmul_rn(a.x, b.y)));
}
__device__ __forceinline__ float conj_mad(float a, float b, float c) {
  return fma(a, b, c);
}
__device__ __forceinline__ double conj_mad(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float2 conj_mad(float2 a, float2 b, float2 c) {
  return make_float2(fma(a.y, b.y, fma(a.x, b.x, c.x)),
                     fma(-a.y, b.x, fma(a.x, b.y, c.y)));
}
__device__ __forceinline__ double2 conj_mad(double2 a, double2 b,
                                            double2 c) {
  return make_double2(fma(a.y, b.y, fma(a.x, b.x, c.x)),
                      fma(-a.y, b.x, fma(a.x, b.y, c.y)));
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
__device__ __forceinline__ double2 sub(double2 a, double2 b) {
  return make_double2(__dsub_rn(a.x, b.x), __dsub_rn(a.y, b.y));
}
__device__ __forceinline__ float scale(float a, float s) {
  return __fmul_rn(a, s);
}
__device__ __forceinline__ double scale(double a, double s) {
  return __dmul_rn(a, s);
}
__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(__fmul_rn(a.x, s), __fmul_rn(a.y, s));
}
__device__ __forceinline__ double2 scale(double2 a, double s) {
  return make_double2(__dmul_rn(a.x, s), __dmul_rn(a.y, s));
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}

// (q, r) = divmod(u, d) kept up to date as u grows by 32, without dividing
struct Walk {
  int q, r, dq, dr, d;
  __device__ Walk(int u, int d_) : d(d_) {
    q = u / d;
    r = u - q * d;
    dq = 32 / d;
    dr = 32 - dq * d;
  }
  __device__ __forceinline__ void next() {
    q += dq;
    r += dr;
    if (r >= d) {
      r -= d;
      ++q;
    }
  }
};

struct Params {
  int L, nd, Kr, T, S, m, n, num_it;
  int ro_vals, ro_coef, ro_invd, RB;     // record: offsets, bytes
  int so_inner, so_ring, so_b;           // shared memory, bytes
};

// A step's record (RB bytes, 16-byte aligned parts): ints rows[nd] |
// slot[nd * Kr] | own[nd * Kr * T] (S int32 at 0), vals[nd * Kr] (T) at
// ro_vals, coef[nd * Kr * T] (T) at ro_coef, invd[nd] (R) at ro_invd.  A
// tap that owns its column's chain adds the chain onto the x its residual
// read.  KR and MM fix Kr and m at compile time (0: read from p), so the
// main path's rows (Kr 5 or 9, m 1) unroll and keep their taps' x in
// registers from the residual to the adds: a step reads x once.
template <typename T, typename R, int KR, int MM>
__global__ void __launch_bounds__(32, 1) kaczmarz_kernel(
    const Params p, const unsigned char* __restrict__ rec,
    const T* __restrict__ b, T* x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int Kr = KR > 0 ? KR : p.Kr;
  const int m = MM > 0 ? MM : p.m;
  const int T_ = p.T, nd = p.nd, RB = p.RB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // ring slots
  T* inner = reinterpret_cast<T*>(smem + p.so_inner);   // [2][nd][m]
  unsigned char* ring = smem + p.so_ring;
  T* bring = reinterpret_cast<T*>(smem + p.so_b);       // [kBRing][nd * m]
  const int obase = nd + nd * Kr;                        // own[0]
  const int items = nd * m;                              // inner values
  // the unrolled rows: lane d < nd holds its row's taps' x in xk
  const bool reg = KR > 0 && MM == 1 && nd <= 32;
  T xk[KR > 0 ? KR : 1];
  // each lane's first (item, rhs): the same every step
  const Walk wm0(lane, m);
  const int steps = p.num_it * p.L;
  if (lane == 0) {
    for (int q = 0; q < kRecRing; ++q) mbar_init(bars + q);
    mbar_init_fence();
  }
  __syncwarp();

  auto issue_rec = [&](int i, int slot) {
    if (lane == 0)
      bulk_load(ring + slot * RB, rec + (size_t)i * RB, RB, bars + slot);
  };
  auto issue_b = [&](const Slot<kRecRing>& rs, int bslot) {
    mbar_wait(bars + rs.v, rs.phase);
    const int* it = reinterpret_cast<const int*>(ring + rs.v * RB);
    if (reg) {
      const int row = lane < nd ? it[lane] : -1;
      if (row >= 0) cp_async<sizeof(T)>(bring + bslot * items + lane, b + row);
      return;
    }
    Walk w = wm0;
    for (int u = lane; u < items; u += 32, w.next()) {
      const int row = it[w.q];
      if (row >= 0)
        cp_async<sizeof(T)>(bring + bslot * items + u,
                            b + (size_t)row * m + w.r);
    }
  };
  // a step's chain sum: the first term's product, then the rest in order
  auto chain = [&](const int* tm, const T* cf, const T* in, int r) {
    T acc = conj_mul(cf[0], in[(tm[0] >> 8) * m + r]);
    for (int t = 1; t < T_ && tm[t] >= 0; ++t)
      acc = conj_mad(cf[t], in[(tm[t] >> 8) * m + r], acc);
    return acc;
  };
  // a step's adds (inner of its parity) into x: the chains its taps own
  auto update = [&](int slot, int parity) {
    const unsigned char* r0 = ring + slot * RB;
    const int* it = reinterpret_cast<const int*>(r0);
    const int* sls = it + nd;
    const int* own = it + obase;
    const T* coef = reinterpret_cast<const T*>(r0 + p.ro_coef);
    const T* in = inner + (size_t)parity * nd * m;
    if (reg) {
      // every load before the first store: the stores to x could alias
      // the record's and inner's reads, which would serialise the taps
      if (lane < nd && it[lane] >= 0) {
        int tm0[KR > 0 ? KR : 1], sl[KR > 0 ? KR : 1];
        T acc[KR > 0 ? KR : 1];
#pragma unroll
        for (int k = 0; k < Kr; ++k) {
          const int q = (lane * Kr + k) * T_;
          tm0[k] = own[q];
          sl[k] = sls[lane * Kr + k];
          acc[k] = conj_mul(coef[q], in[max(tm0[k], 0) >> 8]);
        }
        if (T_ > 1) {
#pragma unroll
          for (int k = 0; k < Kr; ++k) {
            const int q = (lane * Kr + k) * T_;
            for (int t = 1; t < T_ && tm0[k] >= 0 && own[q + t] >= 0; ++t)
              acc[k] = conj_mad(coef[q + t], in[own[q + t] >> 8], acc[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < Kr; ++k)
          if (tm0[k] >= 0) x[sl[k]] = add(xk[k], acc[k]);
      }
      return;
    }
    Walk w = wm0;
    for (int u = lane; u < items; u += 32, w.next()) {
      const int d = w.q, r = w.r;
      if (it[d] < 0) continue;
      for (int k = 0; k < Kr; ++k) {
        const int* tm = own + (d * Kr + k) * T_;
        if (tm[0] < 0) continue;
        const size_t o = (size_t)sls[d * Kr + k] * m + r;
        x[o] = add(x[o], chain(tm, coef + (d * Kr + k) * T_, in, r));
      }
    }
  };
  // a step's inner of every domain
  auto residual = [&](int slot, int bslot, int parity) {
    const unsigned char* r0 = ring + slot * RB;
    const int* it = reinterpret_cast<const int*>(r0);
    const int* sls = it + nd;
    const T* vals = reinterpret_cast<const T*>(r0 + p.ro_vals);
    const R* iv = reinterpret_cast<const R*>(r0 + p.ro_invd);
    const T* bv = bring + bslot * items;
    T* in = inner + (size_t)parity * nd * m;
    if (reg) {
      if (lane < nd && it[lane] >= 0) {
        const int* sl = sls + lane * Kr;
        const T* av = vals + lane * Kr;
#pragma unroll
        for (int k = 0; k < Kr; ++k) xk[k] = x[sl[k]];
        T ax = T{};
#pragma unroll
        for (int k = 0; k < Kr; ++k) ax = mad(av[k], xk[k], ax);
        in[lane] = scale(sub(bv[lane], ax), iv[lane]);
      }
      return;
    }
    Walk w = wm0;
    for (int u = lane; u < items; u += 32, w.next()) {
      const int d = w.q, r = w.r;
      if (it[d] < 0) continue;
      const int* sl = sls + d * Kr;
      const T* av = vals + d * Kr;
      T ax = T{};
      for (int k = 0; k < Kr; ++k)
        ax = mad(av[k], x[(size_t)sl[k] * m + r], ax);
      in[d * m + r] = scale(sub(bv[u], ax), iv[d]);
    }
  };

  int ir = 0;                                  // stream step of the records
  for (int s = 0; s < 2 * kAhead && s < steps; ++s) {
    issue_rec(ir, s % kRecRing);
    if (++ir == p.L) ir = 0;
  }
  {
    Slot<kRecRing> rs(0);
    for (int s = 0; s < kAhead; ++s, rs.next()) {
      if (s < steps) issue_b(rs, s);
      cp_commit();
    }
  }
  // ring slots of steps s - 1, s, s + A, s + 2A; b of steps s, s + A
  Slot<kRecRing> rp(kRecRing - 1), rc(0), ra(kAhead), r2(2 * kAhead);
  Slot<kBRing> bc(0), ba(kAhead);
  for (int s = 0; s < steps; ++s) {
    cp_wait<kAhead - 1>();
    mbar_wait(bars + rc.v, rc.phase);
    __syncwarp();
    if (s + 2 * kAhead < steps) issue_rec(ir, r2.v);
    if (++ir == p.L) ir = 0;
    if (s + kAhead < steps) issue_b(ra, ba.v);
    cp_commit();
    if (s > 0) update(rp.v, (s - 1) & 1);
    __syncwarp();
    residual(rc.v, bc.v, s & 1);
    rp.next(); rc.next(); ra.next(); r2.next();
    bc.next(); ba.next();
  }
  cp_wait<0>();
  __syncwarp();
  if (steps > 0) update(rp.v, (steps - 1) & 1);
}

static int align16(long long v) { return static_cast<int>((v + 15) / 16 * 16); }

// The shared memory of a launch, and its offsets
static long long plan_smem(Params& p, int it) {
  p.so_inner = align16(8LL * kRecRing);
  p.so_ring = p.so_inner + align16(2LL * p.nd * p.m * it);
  p.so_b = p.so_ring + (long long)kRecRing * p.RB;
  return p.so_b + align16((long long)kBRing * p.nd * p.m * it);
}

template <typename T, typename R, int KR, int MM>
static int launch_as(Params p, const void* rec, const void* b, void* x,
                     cudaStream_t st) {
  const long long smem = plan_smem(p, sizeof(T));
  if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
  auto kern = kaczmarz_kernel<T, R, KR, MM>;
  static bool big = false;                     // per instantiation
  if (smem > 48 * 1024 && !big) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (e != cudaSuccess) return (int)e;
    big = true;
  }
  kern<<<1, 32, smem, st>>>(p, static_cast<const unsigned char*>(rec),
                            static_cast<const T*>(b), static_cast<T*>(x));
  return (int)cudaGetLastError();
}

template <typename T, typename R>
static int launch(const Params& p, const void* rec, const void* b, void* x,
                  cudaStream_t st) {
  if (p.Kr == 5 && p.m == 1)           // 2D 5-point rows, one rhs
    return launch_as<T, R, 5, 1>(p, rec, b, x, st);
  if (p.Kr == 9 && p.m == 1)           // 2D 9-point (Galerkin) rows
    return launch_as<T, R, 9, 1>(p, rec, b, x, st);
  return launch_as<T, R, 0, 0>(p, rec, b, x, st);
}

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128.  dims: L (steps
// a sweep), nd, Kr, T, S (ints a record), m, n, num_it, ro_vals,
// ro_coef, ro_invd, RB (the record's value offsets and its bytes, 16-byte
// multiples).  rec
// (L, RB) bytes (ops/cuda/kaczmarz.py `kaczmarz_records`), b and x (n, m)
// row-major; x is updated in place.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a bad description or a launch whose shared
// memory does not fit).
extern "C" int mgt_kaczmarz(int dtype, const int* dims, const void* rec,
                            const void* b, void* x, void* stream) {
  Params p{};
  p.L = dims[0]; p.nd = dims[1]; p.Kr = dims[2]; p.T = dims[3];
  p.S = dims[4]; p.m = dims[5]; p.n = dims[6]; p.num_it = dims[7];
  p.ro_vals = dims[8]; p.ro_coef = dims[9]; p.ro_invd = dims[10];
  p.RB = dims[11];
  const int it = dtype == 0 ? 4 : dtype == 3 ? 16 : 8;
  const int rt = dtype == 0 || dtype == 2 ? 4 : 8;
  if (dtype < 0 || dtype > 3 || p.L < 1 || p.nd < 1 || p.Kr < 1 ||
      p.T < 1 || p.S % 4 != 0 || p.S < p.nd + p.nd * p.Kr * (1 + p.T) ||
      p.m < 1 || p.m > kMaxRhs || p.n < 1 || p.num_it < 0 ||
      p.ro_vals % 16 != 0 ||
      p.ro_coef % 16 != 0 || p.ro_invd % 16 != 0 || p.RB % 16 != 0 ||
      p.ro_vals < 4 * p.S || p.ro_coef < p.ro_vals + p.nd * p.Kr * it ||
      p.ro_invd < p.ro_coef + p.nd * p.Kr * p.T * it ||
      p.RB < p.ro_invd + p.nd * rt || !rec || !b || !x ||
      reinterpret_cast<uintptr_t>(rec) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)p.n * p.m >= (1LL << 31) || p.nd >= (1 << 23))
    return (int)cudaErrorInvalidValue;
  if (p.num_it == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, float>(p, rec, b, x, st);
  if (dtype == 1) return launch<double, double>(p, rec, b, x, st);
  if (dtype == 2) return launch<float2, float>(p, rec, b, x, st);
  return launch<double2, double>(p, rec, b, x, st);
}
