// Kernel E: the lexicographic Vanka sweep (vanka-lex), float32, float64,
// complex64 or complex128, num_it sweeps over every cell in one launch.
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
// Complex values are float2 / double2 (torch's complex64 / complex128
// layout).  The block inverses are stored in the single variant of the
// value type, complex64 for both (mgtpu/setup/smoothers.py setup_vanka),
// and raised to x's type before the product, as mgtpu's
// `dinv.astype(x.dtype)`; a complex multiply-add is four real FMAs.  The
// rows are not conjugated (mgtpu's einsum of rows_val and x).
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

// T: the value type; D: its single variant (float, or float2 for complex)
template <typename T, typename D>
__global__ void __launch_bounds__(kThreads) vanka_lex_kernel(
    int L, int bs, int K, int m, int num_it, const int* __restrict__ idx,
    const D* __restrict__ dinv, const int* __restrict__ rows_idx,
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
        T ax = T{};
        for (int k = 0; k < K; ++k)
          ax = mad(rv[k], x[(size_t)ri[k] * m + r], ax);
        res[t] = sub(b[(size_t)idx[row] * m + r], ax);
      }
      __syncthreads();
      for (int t = threadIdx.x; t < work; t += blockDim.x) {
        const int i = t / m, r = t - i * m;
        const size_t row = (size_t)l * bs + i;
        const D* di = dinv + row * bs;
        T u = T{};
        for (int j = 0; j < bs; ++j)
          u = mad(widen<T, D>(di[j]), res[j * m + r], u);
        const size_t o = (size_t)idx[row] * m + r;
        x[o] = add(x[o], u);
      }
      __syncthreads();
    }
  }
}

template <typename T, typename D>
static void launch(int L, int bs, int K, int m, int num_it, const void* idx,
                   const void* dinv, const void* rows_idx,
                   const void* rows_val, const void* b, void* x, size_t smem,
                   cudaStream_t st) {
  vanka_lex_kernel<T, D><<<1, kThreads, smem, st>>>(
      L, bs, K, m, num_it, static_cast<const int*>(idx),
      static_cast<const D*>(dinv), static_cast<const int*>(rows_idx),
      static_cast<const T*>(rows_val), static_cast<const T*>(b),
      static_cast<T*>(x));
}

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128 (interleaved real
// and imaginary parts).  idx (L, bs) and rows_idx (L, bs, K) int32 row and
// column ids into x's n rows; dinv (L, bs, bs) float32 (complex64 for a
// complex dtype); rows_val (L, bs, K) of dtype; b and x (n, m) of dtype,
// row-major; x is updated in place.  Launches one block on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a bad
// description).
extern "C" int mgt_vanka_lex(int dtype, int L, int bs, int K, int m, int n,
                             int num_it, const void* idx, const void* dinv,
                             const void* rows_idx, const void* rows_val,
                             const void* b, void* x, void* stream) {
  const int itemsize = dtype == 0 ? 4 : dtype == 3 ? 16 : 8;
  if (dtype < 0 || dtype > 3 || L < 1 || bs < 1 || K < 1 || m < 1 ||
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
    launch<float, float>(L, bs, K, m, num_it, idx, dinv, rows_idx, rows_val,
                         b, x, smem, st);
  else if (dtype == 1)
    launch<double, float>(L, bs, K, m, num_it, idx, dinv, rows_idx,
                          rows_val, b, x, smem, st);
  else if (dtype == 2)
    launch<float2, float2>(L, bs, K, m, num_it, idx, dinv, rows_idx,
                           rows_val, b, x, smem, st);
  else
    launch<double2, float2>(L, bs, K, m, num_it, idx, dinv, rows_idx,
                            rows_val, b, x, smem, st);
  return (int)cudaGetLastError();
}
