// Kernel F: the hybrid (domain-decomposed) row Kaczmarz sweep, float32 or
// float64, 1 <= m <= 4 right-hand sides, num_it sweeps in one launch.
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

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) kaczmarz_kernel(
    int max_len, int ndom, int K, int m, int num_it,
    const int* __restrict__ arr, const T* __restrict__ mask,
    const T* __restrict__ invd, const int* __restrict__ ell_idx,
    const T* __restrict__ ell_val, const int* __restrict__ link,
    const T* __restrict__ b, T* x) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* inner = reinterpret_cast<T*>(smem);        // (ndom, m)
  const int taps = ndom * K;
  for (int it = 0; it < num_it; ++it) {
    for (int i = 0; i < max_len; ++i) {
      const int* rows = arr + (size_t)i * ndom;
      const T* msk = mask + (size_t)i * ndom;
      for (int t = threadIdx.x; t < ndom * m; t += blockDim.x) {
        const int d = t / m, r = t - d * m;
        T v = T(0);
        if (msk[d] != T(0)) {
          const size_t row = (size_t)rows[d];
          const int* ci = ell_idx + row * K;
          const T* cv = ell_val + row * K;
          T ax = T(0);
          for (int k = 0; k < K; ++k)
            ax = fma(cv[k], x[(size_t)ci[k] * m + r], ax);
          v = (b[row * m + r] - ax) * invd[row] * msk[d];
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
        T acc = ell_val[at] * inner[d * m + r];
        for (int nx = code; nx >= 0;) {
          const int d2 = nx / K;
          acc = fma(ell_val[(size_t)rows[d2] * K + (nx - d2 * K)],
                    inner[d2 * m + r], acc);
          const int c2 = lk[nx];
          nx = c2 <= -3 ? -c2 - 3 : -1;
        }
        x[(size_t)col * m + r] += acc;
      }
      __syncthreads();
    }
  }
}

// dtype: 0 float32, 1 float64.  arr (max_len, ndom) int32 row ids (0 where
// padded), mask (max_len, ndom) of dtype in {0, 1}, invd (n) of dtype,
// ell_idx (n, K) int32 and ell_val (n, K) of dtype (the operator's ELL
// rows), link (max_len, ndom * K) int32 (see above), b and x (n, m) of
// dtype, row-major; x is updated in place.  Launches one block of `threads`
// threads on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a bad description).
extern "C" int mgt_kaczmarz(int dtype, int max_len, int ndom, int K, int m,
                            int n, int num_it, int threads, const void* arr,
                            const void* mask, const void* invd,
                            const void* ell_idx, const void* ell_val,
                            const void* link, const void* b, void* x,
                            void* stream) {
  const int itemsize = dtype == 0 ? 4 : 8;
  if (dtype < 0 || dtype > 1 || max_len < 1 || ndom < 1 || K < 1 || m < 1 ||
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
    kaczmarz_kernel<float><<<1, threads, smem, st>>>(
        max_len, ndom, K, m, num_it, static_cast<const int*>(arr),
        static_cast<const float*>(mask), static_cast<const float*>(invd),
        static_cast<const int*>(ell_idx), static_cast<const float*>(ell_val),
        static_cast<const int*>(link), static_cast<const float*>(b),
        static_cast<float*>(x));
  else
    kaczmarz_kernel<double><<<1, threads, smem, st>>>(
        max_len, ndom, K, m, num_it, static_cast<const int*>(arr),
        static_cast<const double*>(mask), static_cast<const double*>(invd),
        static_cast<const int*>(ell_idx), static_cast<const double*>(ell_val),
        static_cast<const int*>(link), static_cast<const double*>(b),
        static_cast<double*>(x));
  return (int)cudaGetLastError();
}
