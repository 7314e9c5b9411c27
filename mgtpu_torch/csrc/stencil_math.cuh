// Shared pieces of kernel D's forms (stencil.cu: apply, cross, restrict,
// prolong; block_stencil.cu: a whole block operator in one launch): the
// launch shape, the multiply-add and the adds in the order every form
// uses, so that the forms give the same bits for the same taps.
#pragma once

#include <cuda_runtime.h>

constexpr int kThreads = 256;
constexpr int kLgThreads = 8;
constexpr int kMaxSplit = 16;

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
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
template <typename T>
__device__ __forceinline__ T zero() {
  return T{};
}
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ double sub(double a, double b) { return a - b; }
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 sub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

// taps per group for MB right-hand sides: 8, 8, 4, 2 x loads per tap
__host__ __device__ constexpr int group_of(int mb) {
  return mb <= 2 ? 8 : 16 / mb;
}

static int mb_of(int m) { return m == 1 ? 1 : m == 2 ? 2 : m <= 4 ? 4 : 8; }

// Blocks per SM the register budget must allow (ptxas caps registers at
// 65536 / (256 * this)): one right-hand side in float32 at 8 (32
// registers: the SM full of threads) and in float64 or complex64 at 5
// (51).  ptxas then spills a few words to L1 in the transfer forms and in
// float64, and the streamed fine levels still run faster than uncapped,
// where 58 / 72 registers left room for 4 / 3 blocks (PERF.md, kernel D).
// Several right-hand sides: 3.  complex128 (four words a value): 2.
template <typename T, int MB>
constexpr int min_blocks() {
  return sizeof(T) == 16 ? 2 : MB > 1 ? 3 : sizeof(T) == 4 ? 8 : 5;
}
