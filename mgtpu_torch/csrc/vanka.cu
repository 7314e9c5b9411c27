// Kernel E: the lexicographic Vanka sweep (vanka-lex), float32 or float64,
// num_it sweeps over every cell in one launch.
//
// mgtpu runs it as a lax.fori_loop over the cells inside one device program
// (mgtpu/cycle/vanka.py::_lex_sweep); it has no Pallas kernel.  Cell l
// after cell l - 1, in order, for every right-hand side:
//   r   = b[idx[l]] - A[idx[l], :] x      (bs rows of K ELL entries)
//   x[idx[l]] += dinv[l] r                (dinv single precision, promoted)
// A cell's update changes the residual of the next, so the cells cannot
// run side by side.  One thread block walks them: its threads take the
// (row, right-hand side) pairs of a cell, each summing its row's K
// products, put the block residual in shared memory, then apply the
// bs x bs inverse and add the update; a barrier after each phase makes the
// writes of cell l visible to cell l + 1 (__syncthreads orders global
// memory within a block).  A cell's variables are distinct, so its adds do
// not collide.
//
// What bounds it: latency.  Each cell costs two dependent rounds of
// loads (the row's column ids, then x at them) and two barriers; the card
// does a few microseconds a cell whatever its size.  Speed is not this
// kernel's point: it is right, one launch a call, and on the device where
// mgtpu's loop is.
#include <cuda_runtime.h>

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

constexpr int kThreads = 128;
constexpr int kMaxShared = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads) vanka_lex_kernel(
    int L, int bs, int K, int m, int num_it, const int* __restrict__ idx,
    const float* __restrict__ dinv, const int* __restrict__ rows_idx,
    const T* __restrict__ rows_val, const T* __restrict__ b, T* x) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* res = reinterpret_cast<T*>(smem);          // (bs, m) block residual
  const int work = bs * m;
  for (int it = 0; it < num_it; ++it) {
    for (int l = 0; l < L; ++l) {
      for (int t = threadIdx.x; t < work; t += blockDim.x) {
        const int i = t / m, r = t - i * m;
        const size_t row = (size_t)l * bs + i;
        const int* ri = rows_idx + row * K;
        const T* rv = rows_val + row * K;
        T ax = T(0);
        for (int k = 0; k < K; ++k)
          ax = fma(rv[k], x[(size_t)ri[k] * m + r], ax);
        res[t] = b[(size_t)idx[row] * m + r] - ax;
      }
      __syncthreads();
      for (int t = threadIdx.x; t < work; t += blockDim.x) {
        const int i = t / m, r = t - i * m;
        const size_t row = (size_t)l * bs + i;
        const float* di = dinv + row * bs;
        T u = T(0);
        for (int j = 0; j < bs; ++j) u = fma(T(di[j]), res[j * m + r], u);
        x[(size_t)idx[row] * m + r] += u;
      }
      __syncthreads();
    }
  }
}

// dtype: 0 float32, 1 float64.  idx (L, bs) and rows_idx (L, bs, K) int32
// row and column ids into x's n rows; dinv (L, bs, bs) float32; rows_val
// (L, bs, K) of dtype; b and x (n, m) of dtype, row-major; x is updated in
// place.  Launches one block on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a bad description).
extern "C" int mgt_vanka_lex(int dtype, int L, int bs, int K, int m, int n,
                             int num_it, const void* idx, const void* dinv,
                             const void* rows_idx, const void* rows_val,
                             const void* b, void* x, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 8;
  if (dtype < 0 || dtype > 1 || L < 1 || bs < 1 || K < 1 || m < 1 ||
      n < 1 || num_it < 0 || !idx || !dinv || !rows_idx || !rows_val || !b ||
      !x)
    return (int)cudaErrorInvalidValue;
  if ((long long)bs * m * itemsize > kMaxShared ||
      (long long)n * m >= (1LL << 31) || (long long)L * bs * K >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (num_it == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)bs * m * itemsize;
  if (dtype == 0)
    vanka_lex_kernel<float><<<1, kThreads, smem, st>>>(
        L, bs, K, m, num_it, static_cast<const int*>(idx),
        static_cast<const float*>(dinv), static_cast<const int*>(rows_idx),
        static_cast<const float*>(rows_val), static_cast<const float*>(b),
        static_cast<float*>(x));
  else
    vanka_lex_kernel<double><<<1, kThreads, smem, st>>>(
        L, bs, K, m, num_it, static_cast<const int*>(idx),
        static_cast<const float*>(dinv), static_cast<const int*>(rows_idx),
        static_cast<const double*>(rows_val), static_cast<const double*>(b),
        static_cast<double*>(x));
  return (int)cudaGetLastError();
}
