// A latency probe: the cost of one dependent shared-memory round under each
// barrier kernels E and F step by.  Every round, each thread loads a value
// whose address depends on the value it loaded the round before, stores
// value + 1 where a neighbouring thread (or, in a cluster, the next block,
// through distributed shared memory) loads it the next round, and the
// threads meet at the barrier — so rounds cannot overlap, and a launch of
// `iters` rounds takes iters x (load + store + barrier).  Timed on the card
// by ops/cuda/probe.py (the slope between two round counts, launch cost
// cancelled); chip_smoke.py prints it and computes E's and F's
// dependency-chain bounds from it.
//
// kind 0: one warp, __syncwarp; 1: one block of `threads` threads,
// __syncthreads; 2: a cluster of `ctas` blocks of 32 threads, the store to
// the next block's shared memory and barrier.cluster (cg's cluster.sync).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

extern "C" const char* mgt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

template <int Kind>
__global__ void __launch_bounds__(1024) probe_kernel(int iters, int* out) {
  __shared__ int buf[2][1024];
  const int t = threadIdx.x, nt = blockDim.x;
  buf[0][t] = t;
  buf[1][t] = t;
  if constexpr (Kind == 2)
    cg::this_cluster().sync();
  else
    __syncthreads();
  const int mask = nt - 1;                 // nt a power of two
  int* rbuf = &buf[0][0];                  // where the stores go
  if constexpr (Kind == 2) {
    cg::cluster_group cl = cg::this_cluster();
    rbuf = cl.map_shared_rank(rbuf, (cl.block_rank() + 1) % cl.num_blocks());
  }
  int v = 0, a = 0;
  for (int it = 0; it < iters; ++it) {
    const int p = it & 1;
    a = buf[p][(t + v) & mask];
    v = a >> 30;                           // 0, but only the load knows
    rbuf[(p ^ 1) * 1024 + ((t + 1) & mask)] = a + 1;
    if constexpr (Kind == 2)
      cg::this_cluster().sync();
    else if constexpr (Kind == 1)
      __syncthreads();
    else
      __syncwarp();
  }
  if constexpr (Kind == 2) cg::this_cluster().sync();
  out[blockIdx.x * nt + t] = a + v;
}

// Launches `iters` rounds on `stream`; out holds ctas * threads ints.
extern "C" int mgt_probe(int kind, int ctas, int threads, int iters,
                         void* out, void* stream) {
  if (kind < 0 || kind > 2 || iters < 1 || !out || threads < 32 ||
      threads > 1024 || (threads & (threads - 1)) != 0 || (kind == 0 && threads != 32) ||
      (kind == 2 && (threads != 32 || ctas < 2 || ctas > 16)) ||
      (kind != 2 && ctas != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (kind == 0) {
    probe_kernel<0><<<1, 32, 0, st>>>(iters, o);
    return (int)cudaGetLastError();
  }
  if (kind == 1) {
    probe_kernel<1><<<1, threads, 0, st>>>(iters, o);
    return (int)cudaGetLastError();
  }
  auto kern = probe_kernel<2>;
  cudaError_t e;
  if (ctas > 8) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(32);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, iters, o);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
