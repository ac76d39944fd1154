// Shared pieces of the DSTD-GC kernels (dstd_spatial.cu, dstd_temporal.cu,
// dstd_chain.cu and, through dstd_bwd_common.cuh, the backward kernels):
// launch constants, the argument block of one op, the rounding policies,
// a shared-memory alignment helper and the clustered launch.  The forward op body, which the one-op kernels
// run once and the chain kernels once per op of every layer, is
// dstd_fwd_mma.cuh.  Each kernel source is built into its own shared
// library with a plain C interface (dstdgcn_tpu_torch/kernels/build.py).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace dstd {

constexpr int kThreads = 512;
// output frames (spatial) or output joints (temporal) one block owns
constexpr int kMaxTile = 8;
// blocks of one sample that run as one thread-block cluster: at most the
// portable cluster size
constexpr int kMaxCluster = 8;

// Pointers and sizes of one op call (x, weights and out are contiguous
// float32 in the layouts of dstdgcn_tpu_torch/ops/dstd.py).
struct OpArgs {
  const float* x;
  const float* base;
  const float* alpha;
  const float* wf;
  const float* bf;
  const float* wm1;
  const float* bm1;
  const float* wm2;
  const float* bm2;
  const float* wrm;
  const float* brm;
  float* out;
  int T, V, Ci, Co, K, R, agg_left;
};

// Rounding policies of the contraction operands, the TPU kernels' compute
// dtype (dstdgcn_tpu/kernels/fused.py::_dot_fn).  Exact keeps float32 (the
// float32 kernels).  Bf16 rounds an operand to the nearest bfloat16 (ties to
// even) and widens it back: the product of two bf16 values is exact in
// float32, so float32 FMAs over rounded operands compute the bf16 kernels'
// function, bf16 inputs with float32 products and sums.  The backward
// bodies (dstd_bwd_common.cuh) apply the policy where an operand is loaded
// into a product, or once where it is stored for products alone.
struct Exact {
  __device__ static float r(float v) { return v; }
};
struct Bf16 {
  __device__ static float r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// shared-memory sub-buffers start at multiples of 4 floats (float4 access)
__host__ __device__ inline long long round4(long long n) {
  return (n + 3) & ~3LL;
}

// Launches `kernel` with the blocks along x (one sample's tiles) as one
// thread-block cluster and one grid row per sample.
template <typename Kernel, typename Args>
cudaError_t launch_clustered(Kernel kernel, const Args& a, int nblk, int N,
                             size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk, N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dstd
