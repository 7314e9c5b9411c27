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
// the same step their adds are summed.  Steps depend on each other, so one
// thread block walks them: its threads take the (domain, right-hand side)
// pairs and put inner in shared memory (barrier), then the (tap, right-hand
// side) pairs add to x (barrier) — two barriers a step, and __syncthreads
// orders the global writes of step i before the reads of step i + 1.
//
// No atomics: the link table made at setup (ops/cuda/kaczmarz.py,
// `kaczmarz_links`) names for each tap of a step the next tap of that step
// with the same column, in (domain, tap) order.  Only the first tap of a
// column (its owner) adds: it sums its chain in that fixed order and writes
// x once, so the result does not depend on the schedule (a recorded sweep
// is bitwise its eager run).  Codes, per tap: c >= 0 owner with next c;
// -1 owner, chain ends; -2 not an owner (a later tap of a chain that ends
// there, a padded ELL tap, a tap of a padded domain); c <= -3 not an owner,
// next -c - 3.  A padded domain (mask 0, row 0) neither reads invd nor
// adds: its inner is 0 and none of its taps is in a chain.
//
// Complex values are float2 / double2 (torch's complex layout); the row
// norms behind invd and the mask stay real (mgtpu/cycle/kaczmarz.py:55),
// so inner is (b - a.x) times a real scale, and the update adds
// conj(a) * inner.  A real instantiation computes what it did before: the
// helpers below are fma, *, + and - for float and double.
//
// What bounds it: latency.  A step is two dependent rounds of global loads
// (the row's column ids, then x at them) and two barriers; whatever the
// size, a step costs microseconds.  Speed is not this kernel's point: it is
// right, one launch a call, on the device where mgtpu's loop is.
#include <cuda_runtime.h>

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

constexpr int kMaxThreads = 1024;
constexpr int kMaxRhs = 4;

// a * b + c, conj(a) * b, conj(a) * b + c, a - b, a * s (s real), a + b
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
__device__ __forceinline__ float conj_mul(float a, float b) { return a * b; }
__device__ __forceinline__ double conj_mul(double a, double b) {
  return a * b;
}
__device__ __forceinline__ float2 conj_mul(float2 a, float2 b) {
  return make_float2(fma(a.y, b.y, a.x * b.x), fma(-a.y, b.x, a.x * b.y));
}
__device__ __forceinline__ double2 conj_mul(double2 a, double2 b) {
  return make_double2(fma(a.y, b.y, a.x * b.x), fma(-a.y, b.x, a.x * b.y));
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
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ double sub(double a, double b) { return a - b; }
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 sub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float scale(float a, float s) { return a * s; }
__device__ __forceinline__ double scale(double a, double s) { return a * s; }
__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
__device__ __forceinline__ double2 scale(double2 a, double s) {
  return make_double2(a.x * s, a.y * s);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

// T the value type, R its real type (the mask's and invd's)
template <typename T, typename R>
__global__ void __launch_bounds__(kMaxThreads) kaczmarz_kernel(
    int max_len, int ndom, int K, int m, int num_it,
    const int* __restrict__ arr, const R* __restrict__ mask,
    const R* __restrict__ invd, const int* __restrict__ ell_idx,
    const T* __restrict__ ell_val, const int* __restrict__ link,
    const T* __restrict__ b, T* x) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* inner = reinterpret_cast<T*>(smem);        // (ndom, m)
  const int taps = ndom * K;
  for (int it = 0; it < num_it; ++it) {
    for (int i = 0; i < max_len; ++i) {
      const int* rows = arr + (size_t)i * ndom;
      const R* msk = mask + (size_t)i * ndom;
      for (int t = threadIdx.x; t < ndom * m; t += blockDim.x) {
        const int d = t / m, r = t - d * m;
        T v = T{};
        if (msk[d] != R(0)) {
          const size_t row = (size_t)rows[d];
          const int* ci = ell_idx + row * K;
          const T* cv = ell_val + row * K;
          T ax = T{};
          for (int k = 0; k < K; ++k)
            ax = mad(cv[k], x[(size_t)ci[k] * m + r], ax);
          v = scale(scale(sub(b[row * m + r], ax), invd[row]), msk[d]);
        }
        inner[t] = v;
      }
      __syncthreads();
      const int* lk = link + (size_t)i * taps;
      for (int t = threadIdx.x; t < taps * m; t += blockDim.x) {
        const int tap = t / m, r = t - tap * m;
        const int code = lk[tap];
        if (code <= -2) continue;           // not the owner of its column
        const int d = tap / K;
        const size_t at = (size_t)rows[d] * K + (tap - d * K);
        const int col = ell_idx[at];
        T acc = conj_mul(ell_val[at], inner[d * m + r]);
        for (int nx = code; nx >= 0;) {
          const int d2 = nx / K;
          acc = conj_mad(ell_val[(size_t)rows[d2] * K + (nx - d2 * K)],
                         inner[d2 * m + r], acc);
          const int c2 = lk[nx];
          nx = c2 <= -3 ? -c2 - 3 : -1;
        }
        x[(size_t)col * m + r] = add(x[(size_t)col * m + r], acc);
      }
      __syncthreads();
    }
  }
}

template <typename T, typename R>
static void launch(int max_len, int ndom, int K, int m, int num_it,
                   int threads, size_t smem, const void* arr,
                   const void* mask, const void* invd, const void* ell_idx,
                   const void* ell_val, const void* link, const void* b,
                   void* x, cudaStream_t st) {
  kaczmarz_kernel<T, R><<<1, threads, smem, st>>>(
      max_len, ndom, K, m, num_it, static_cast<const int*>(arr),
      static_cast<const R*>(mask), static_cast<const R*>(invd),
      static_cast<const int*>(ell_idx), static_cast<const T*>(ell_val),
      static_cast<const int*>(link), static_cast<const T*>(b),
      static_cast<T*>(x));
}

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128.  arr (max_len,
// ndom) int32 row ids (0 where padded), mask (max_len, ndom) in {0, 1} and
// invd (n), both of dtype's real type, ell_idx (n, K) int32 and ell_val
// (n, K) of dtype (the operator's ELL rows), link (max_len, ndom * K)
// int32 (see above), b and x (n, m) of dtype, row-major; x is updated in
// place.  Launches one block of `threads` threads on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a bad description).
extern "C" int mgt_kaczmarz(int dtype, int max_len, int ndom, int K, int m,
                            int n, int num_it, int threads, const void* arr,
                            const void* mask, const void* invd,
                            const void* ell_idx, const void* ell_val,
                            const void* link, const void* b, void* x,
                            void* stream) {
  const int itemsize = dtype == 0 ? 4 : dtype == 3 ? 16 : 8;
  if (dtype < 0 || dtype > 3 || max_len < 1 || ndom < 1 || K < 1 || m < 1 ||
      m > kMaxRhs || n < 1 || num_it < 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || !arr || !mask || !invd ||
      !ell_idx || !ell_val || !link || !b || !x)
    return (int)cudaErrorInvalidValue;
  if ((long long)n * m >= (1LL << 31) || (long long)n * K >= (1LL << 31) ||
      (long long)max_len * ndom * K >= (1LL << 31) ||
      (long long)ndom * m * itemsize > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (num_it == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)ndom * m * itemsize;
  if (dtype == 0)
    launch<float, float>(max_len, ndom, K, m, num_it, threads, smem, arr,
                         mask, invd, ell_idx, ell_val, link, b, x, st);
  else if (dtype == 1)
    launch<double, double>(max_len, ndom, K, m, num_it, threads, smem, arr,
                           mask, invd, ell_idx, ell_val, link, b, x, st);
  else if (dtype == 2)
    launch<float2, float>(max_len, ndom, K, m, num_it, threads, smem, arr,
                          mask, invd, ell_idx, ell_val, link, b, x, st);
  else
    launch<double2, double>(max_len, ndom, K, m, num_it, threads, smem, arr,
                            mask, invd, ell_idx, ell_val, link, b, x, st);
  return (int)cudaGetLastError();
}
