// Shared pieces of the DSTD-GC forward kernels (dstd_spatial.cu,
// dstd_temporal.cu): launch constants, the argument block, the stacked q/k
// projection and float4 helpers.  Each kernel source includes this header
// and is built into its own shared library with a plain C interface
// (dstdgcn_tpu_torch/kernels/build.py).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace dstd {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
// output frames (spatial) or output joints (temporal) one block owns
constexpr int kMaxTile = 8;

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

// shared-memory sub-buffers start at multiples of 4 floats (float4 access)
__host__ __device__ inline long long round4(long long n) {
  return (n + 3) & ~3LL;
}

__device__ inline void fma4(float s, const float4& v, float4& acc) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// q/k projection weights staged as wqk[ci][j] and biases as bqk[j], column
// j = k*2R + r for the query side and k*2R + R + r for the key side.
__device__ inline void stage_qk_weights(float* wqk, float* bqk,
                                        const OpArgs& a) {
  const int Ci = a.Ci, R = a.R, J = a.K * 2 * a.R;
  for (int i = threadIdx.x; i < Ci * J; i += blockDim.x) {
    const int ci = i / J, j = i - ci * J;
    const int k = j / (2 * R), jr = j - k * 2 * R;
    wqk[i] = jr < R ? a.wm1[(k * Ci + ci) * R + jr]
                    : a.wm2[(k * Ci + ci) * R + jr - R];
  }
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const int k = j / (2 * R), jr = j - k * 2 * R;
    bqk[j] = jr < R ? a.bm1[k * R + jr] : a.bm2[k * R + jr - R];
  }
}

// q/k projections of every (t, v) row of one sample into shared memory.
// Row t*V + v is stored at qk[j][t][v] (frames major) or qk[j][v][t]
// (joints major).  When the blocks of one sample form a thread-block
// cluster (the spatial launch), each projects its share of the rows, one
// thread per (row, column) with the column fastest (the threads of a row
// share each x load), then copies the other shares from the other blocks'
// shared memory; the barrier after the copy keeps every block's rows alive
// until all have read them.  Launched without a cluster (one block per
// cluster) a block projects every row.
__device__ inline void project_qk(const OpArgs& a, const float* xn,
                                  const float* wqk, const float* bqk,
                                  float* qk, bool joints_major) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = a.T, V = a.V, Ci = a.Ci, J = a.K * 2 * a.R;
  const int rows = T * V;
  const int share = (rows + nblk - 1) / nblk;
  const int r0 = min(rows, rank * share), r1 = min(rows, r0 + share);
  for (int i = threadIdx.x; i < (r1 - r0) * J; i += blockDim.x) {
    const int row = r0 + i / J, j = i % J;
    const float* xr = xn + (size_t)row * Ci;
    float acc = 0.f;
    for (int ci = 0; ci < Ci; ++ci)
      acc = fmaf(__ldg(xr + ci), wqk[ci * J + j], acc);
    const int slot = joints_major ? (row % V) * T + row / V : row;
    qk[j * rows + slot] = acc + bqk[j];
  }
  cluster.sync();
  for (int b = 0; b < nblk; ++b) {
    if (b == rank) continue;
    const float* remote = cluster.map_shared_rank(qk, b);
    const int b0 = min(rows, b * share), b1 = min(rows, b0 + share);
    for (int i = threadIdx.x; i < (b1 - b0) * J; i += blockDim.x) {
      const int row = b0 + i / J, j = i % J;
      const int slot = joints_major ? (row % V) * T + row / V : row;
      qk[j * rows + slot] = remote[j * rows + slot];
    }
  }
  cluster.sync();
}

// Feature projection of `rows` input rows: xf[k][dst(row)][c] =
// x_row @ wf[k] + bf[k], rows read from device memory (L1/L2).  src(row)
// and dst(row) give a row's offset in x (in rows) and in xf (in rows).
// With Co % 4 == 0 each thread produces 4 channels from float4 weights.
template <typename SrcRow, typename DstRow>
__device__ inline void project_features(const OpArgs& a, const float* xn,
                                        float* xf, int rows, int xf_kstride,
                                        SrcRow src, DstRow dst) {
  const int Ci = a.Ci, Co = a.Co;
  if ((Co & 3) == 0) {
    const int C4 = Co >> 2;
    for (int i = threadIdx.x; i < a.K * rows * C4; i += blockDim.x) {
      const int k = i / (rows * C4), rc = i - k * rows * C4;
      const int row = rc / C4, c4 = rc - row * C4;
      const float* xr = xn + (size_t)src(row) * Ci;
      const float4* wk =
          reinterpret_cast<const float4*>(a.wf + (size_t)k * Ci * Co) + c4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int ci = 0; ci < Ci; ++ci)
        fma4(__ldg(xr + ci), __ldg(wk + (size_t)ci * C4), acc);
      const float4 b = __ldg(reinterpret_cast<const float4*>(a.bf + k * Co) +
                             c4);
      acc.x += b.x;
      acc.y += b.y;
      acc.z += b.z;
      acc.w += b.w;
      reinterpret_cast<float4*>(xf + (size_t)k * xf_kstride +
                                (size_t)dst(row) * Co)[c4] = acc;
    }
  } else {
    for (int i = threadIdx.x; i < a.K * rows * Co; i += blockDim.x) {
      const int k = i / (rows * Co), rc = i - k * rows * Co;
      const int row = rc / Co, c = rc - row * Co;
      const float* xr = xn + (size_t)src(row) * Ci;
      const float* wk = a.wf + (size_t)k * Ci * Co + c;
      float acc = 0.f;
      for (int ci = 0; ci < Ci; ++ci)
        acc = fmaf(__ldg(xr + ci), __ldg(wk + (size_t)ci * Co), acc);
      xf[(size_t)k * xf_kstride + (size_t)dst(row) * Co + c] =
          acc + __ldg(a.bf + k * Co + c);
    }
  }
}

}  // namespace dstd
