// Shared pieces of the DSTD-GC forward kernels (dstd_spatial.cu,
// dstd_temporal.cu, dstd_chain.cu): launch constants, the argument block,
// the rounding policies, the stacked q/k projection, float4 helpers and the
// body of each op, which the one-op kernels run once and the chain kernels
// once per layer.  Each kernel source includes this header and is built into
// its own shared library with a plain C interface
// (dstdgcn_tpu_torch/kernels/build.py).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace dstd {

namespace cg = cooperative_groups;

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

__device__ inline void fma4(float s, const float4& v, float4& acc) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// Shared-memory layout of one spatial block (offsets in floats, each a
// multiple of 4): wqk [Ci][J], bqk [J], wmix [K][R][T][round4(tile)],
// qk [J][T][V], adj [K][tile][V][V], xf [K][tile*V][Co].
struct SpatialLayout {
  long long wqk, bqk, wmix, qk, adj, xf, total;
  __host__ __device__ SpatialLayout(int T, int V, int Ci, int Co, int K,
                                    int R, int tile) {
    const long long J = (long long)K * 2 * R;
    wqk = 0;
    bqk = wqk + round4(J * Ci);
    wmix = bqk + round4(J);
    qk = wmix + round4((long long)K * R * T * round4(tile));
    adj = qk + round4(J * T * V);
    xf = adj + round4((long long)K * tile * V * V);
    total = xf + round4((long long)K * tile * V * Co);
  }
};

// Shared-memory layout of one temporal block: wqk [Ci][J], bqk [J],
// wmix [K][R][V][round4(tile)], qk [J][V][T], adj [K][tile][T][T],
// xf [K][T][tile][Co].
struct TemporalLayout {
  long long wqk, bqk, wmix, qk, adj, xf, total;
  __host__ __device__ TemporalLayout(int T, int V, int Ci, int Co, int K,
                                     int R, int tile) {
    const long long J = (long long)K * 2 * R;
    wqk = 0;
    bqk = wqk + round4(J * Ci);
    wmix = bqk + round4(J);
    qk = wmix + round4((long long)K * R * V * round4(tile));
    adj = qk + round4(J * T * V);
    xf = adj + round4((long long)K * tile * T * T);
    total = xf + round4((long long)K * T * tile * Co);
  }
};

// Writes an op's output rows as they are.  `out` is the sample's (T*V, Co)
// block; row = t*V + v.
struct PlainStore {
  float* out;
  int Co;
  __device__ void put4(int row, int v, int c4, const float4& acc) const {
    reinterpret_cast<float4*>(out + (size_t)row * Co)[c4] = acc;
  }
  __device__ void put(int row, int v, int c, float acc) const {
    out[(size_t)row * Co + c] = acc;
  }
};

// q/k projection weights staged as wqk[ci][j] and biases as bqk[j],
// column j = k*2R + r for the query side and k*2R + R + r for the key side.
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
// cluster (the spatial and chain launches), each projects its share of the
// rows, one thread per (row, column) with the column fastest (the threads
// of a row share each x load), then copies the other shares from the other
// blocks' shared memory; the barrier after the copy keeps every block's
// rows alive until all have read them.  x is the chain's activation, which
// other blocks of the launch wrote: it is read at L2 (__ldcg, past the
// SM's own L1, which is not coherent with other SMs' writes).
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
      acc = fmaf(__ldcg(xr + ci), wqk[ci * J + j], acc);
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
// With Co % 4 == 0 each thread produces 4 channels from float4 weights.  x
// is read at L2, as in project_qk.
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
        fma4(__ldcg(xr + ci), __ldg(wk + (size_t)ci * C4), acc);
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
        acc = fmaf(__ldcg(xr + ci), __ldg(wk + (size_t)ci * Co), acc);
      xf[(size_t)k * xf_kstride + (size_t)dst(row) * Co + c] =
          acc + __ldg(a.bf + k * Co + c);
    }
  }
}

// One block's share of a spatial op (contract in dstd_spatial.cu): output
// frames [t0, t0 + tn) of sample n, through `store`.  A block with tn == 0
// still projects its share of q/k for the cluster.  The adjacency of an
// output frame mixes the scores of all T source frames, so the block needs
// the whole sample's q/k (project_qk).  Then it builds the tile's adjacency
// in shared memory, one thread per (k, v, w) pair with the tile's output
// frames in registers (tanh scores recomputed per tile, mixing weights read
// as float4), projects the tile's features and aggregates: plain float32
// FMA, the body of the float32 chain kernel (dstd_chain.cu).
template <int TILE, typename Store>
__device__ void spatial_op(const OpArgs& a, float* smem, int n, int t0,
                           int tn, const Store& store) {
  constexpr int TP = (TILE + 3) & ~3;  // wmix row stride (float4 loads)
  const int T = a.T, V = a.V, K = a.K, R = a.R, Co = a.Co;
  const int TV = T * V, VV = V * V;
  const SpatialLayout L(T, V, a.Ci, Co, K, R, TILE);
  float* wqk = smem + L.wqk;
  float* bqk = smem + L.bqk;
  float* wmix = smem + L.wmix;
  float* qk = smem + L.qk;
  float* adj = smem + L.adj;
  float* xf = smem + L.xf;
  const float alpha = __ldg(a.alpha);
  const float* xn = a.x + (size_t)n * TV * a.Ci;

  // stage the q/k weights and the tile's columns of the mixing weights
  stage_qk_weights(wqk, bqk, a);
  for (int i = threadIdx.x; i < K * R * T * TP; i += blockDim.x) {
    const int tt = i % TP, krs = i / TP;  // krs = (k*R + r)*T + s
    wmix[i] = tt < tn ? a.wrm[(size_t)krs * T + t0 + tt] : 0.f;
  }
  __syncthreads();

  // q/k of every source frame of the sample
  project_qk(a, xn, wqk, bqk, qk, false);
  __syncthreads();

  // dynamic adjacency of the tile's output frames: one thread per (k, v, w)
  for (int p = threadIdx.x; tn > 0 && p < K * VV; p += blockDim.x) {
    const int k = p / VV, vw = p - k * VV, v = vw / V, w = vw - v * V;
    float acc[TILE];
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt) acc[tt] = 0.f;
    for (int r = 0; r < R; ++r) {
      const float* qr = qk + (k * 2 * R + r) * TV + v;
      const float* kr = qk + (k * 2 * R + R + r) * TV + w;
      const float4* wm =
          reinterpret_cast<const float4*>(wmix + (k * R + r) * T * TP);
#pragma unroll 4
      for (int s = 0; s < T; ++s) {
        const float sc = tanhf(qr[s * V] - kr[s * V]);
#pragma unroll
        for (int q = 0; q < TP / 4; ++q) {
          const float4 m = wm[s * (TP / 4) + q];
          if (4 * q + 0 < TILE) acc[4 * q + 0] = fmaf(sc, m.x, acc[4 * q + 0]);
          if (4 * q + 1 < TILE) acc[4 * q + 1] = fmaf(sc, m.y, acc[4 * q + 1]);
          if (4 * q + 2 < TILE) acc[4 * q + 2] = fmaf(sc, m.z, acc[4 * q + 2]);
          if (4 * q + 3 < TILE) acc[4 * q + 3] = fmaf(sc, m.w, acc[4 * q + 3]);
        }
      }
    }
    const float b = __ldg(a.base + p);  // base[k][v][w]
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt)
      if (tt < tn)
        adj[(k * TILE + tt) * VV + vw] =
            (acc[tt] + __ldg(a.brm + k * T + t0 + tt)) * alpha + b;
  }

  // feature projection of the tile's rows (contiguous in x)
  const int rows = tn * V;
  project_features(
      a, xn, xf, rows, TILE * V * Co,
      [t0, V](int row) { return t0 * V + row; }, [](int row) { return row; });
  __syncthreads();

  // per-frame aggregation over joints, summed over the K kernels
  if ((Co & 3) == 0) {
    const int C4 = Co >> 2;
    for (int i = threadIdx.x; i < rows * C4; i += blockDim.x) {
      const int row = i / C4, c4 = i - row * C4;
      const int tt = row / V, av = row - tt * V;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < K; ++k) {
        const float* ak = adj + (k * TILE + tt) * VV;
        const float4* fk =
            reinterpret_cast<const float4*>(xf + (k * TILE + tt) * V * Co) +
            c4;
        if (a.agg_left) {
          for (int b = 0; b < V; ++b) fma4(ak[av * V + b], fk[b * C4], acc);
        } else {
          for (int b = 0; b < V; ++b) fma4(ak[b * V + av], fk[b * C4], acc);
        }
      }
      store.put4(t0 * V + row, av, c4, acc);
    }
  } else {
    for (int i = threadIdx.x; i < rows * Co; i += blockDim.x) {
      const int row = i / Co, c = i - row * Co;
      const int tt = row / V, av = row - tt * V;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        const float* ak = adj + (k * TILE + tt) * VV;
        const float* fk = xf + (k * TILE + tt) * V * Co + c;
        if (a.agg_left) {
          for (int b = 0; b < V; ++b)
            acc = fmaf(ak[av * V + b], fk[b * Co], acc);
        } else {
          for (int b = 0; b < V; ++b)
            acc = fmaf(fk[b * Co], ak[b * V + av], acc);
        }
      }
      store.put(t0 * V + row, av, c, acc);
    }
  }
}

// One block's share of a temporal op (contract in dstd_temporal.cu): output
// joints [w0, w0 + wn) of sample n over all frames, through `store`.  A
// block with wn == 0 still projects its share of q/k for the cluster.  The
// adjacency of an output joint mixes the frame-pair scores of all V source
// joints, so the block needs the whole sample's q/k.  Then it builds the
// tile's (T, T) adjacencies in shared memory, one thread per (k, t, u) pair
// with the tile's joints in registers, projects the features of the tile's
// joints over all frames and aggregates over frames, as spatial_op.
template <int TILE, typename Store>
__device__ void temporal_op(const OpArgs& a, float* smem, int n, int w0,
                            int wn, const Store& store) {
  constexpr int TP = (TILE + 3) & ~3;  // wmix row stride (float4 loads)
  const int T = a.T, V = a.V, K = a.K, R = a.R, Co = a.Co;
  const int TV = T * V, TT = T * T;
  const TemporalLayout L(T, V, a.Ci, Co, K, R, TILE);
  float* wqk = smem + L.wqk;
  float* bqk = smem + L.bqk;
  float* wmix = smem + L.wmix;
  float* qk = smem + L.qk;
  float* adj = smem + L.adj;
  float* xf = smem + L.xf;
  const float alpha = __ldg(a.alpha);
  const float* xn = a.x + (size_t)n * TV * a.Ci;

  // stage the q/k weights and the tile's columns of the mixing weights
  stage_qk_weights(wqk, bqk, a);
  for (int i = threadIdx.x; i < K * R * V * TP; i += blockDim.x) {
    const int j = i % TP, krv = i / TP;  // krv = (k*R + r)*V + v
    wmix[i] = j < wn ? a.wrm[(size_t)krv * V + w0 + j] : 0.f;
  }
  __syncthreads();

  // q/k of every (frame, joint) of the sample, stored joints-major
  project_qk(a, xn, wqk, bqk, qk, true);
  __syncthreads();

  // dynamic adjacency of the tile's output joints: one thread per (k, t, u)
  for (int p = threadIdx.x; wn > 0 && p < K * TT; p += blockDim.x) {
    const int k = p / TT, tu = p - k * TT, t = tu / T, u = tu - t * T;
    float acc[TILE];
#pragma unroll
    for (int j = 0; j < TILE; ++j) acc[j] = 0.f;
    for (int r = 0; r < R; ++r) {
      const float* qr = qk + (k * 2 * R + r) * TV + t;
      const float* kr = qk + (k * 2 * R + R + r) * TV + u;
      const float4* wm =
          reinterpret_cast<const float4*>(wmix + (k * R + r) * V * TP);
#pragma unroll 4
      for (int v = 0; v < V; ++v) {
        const float sc = tanhf(qr[v * T] - kr[v * T]);
#pragma unroll
        for (int q = 0; q < TP / 4; ++q) {
          const float4 m = wm[v * (TP / 4) + q];
          if (4 * q + 0 < TILE) acc[4 * q + 0] = fmaf(sc, m.x, acc[4 * q + 0]);
          if (4 * q + 1 < TILE) acc[4 * q + 1] = fmaf(sc, m.y, acc[4 * q + 1]);
          if (4 * q + 2 < TILE) acc[4 * q + 2] = fmaf(sc, m.z, acc[4 * q + 2]);
          if (4 * q + 3 < TILE) acc[4 * q + 3] = fmaf(sc, m.w, acc[4 * q + 3]);
        }
      }
    }
    const float b = __ldg(a.base + p);  // base[k][t][u]
#pragma unroll
    for (int j = 0; j < TILE; ++j)
      if (j < wn)
        adj[(k * TILE + j) * TT + tu] =
            (acc[j] + __ldg(a.brm + k * V + w0 + j)) * alpha + b;
  }

  // feature projection of the tile's joints over all frames; row = t*wn+j
  const int rows = T * wn;
  project_features(
      a, xn, xf, rows, T * TILE * Co,
      [w0, wn, V](int row) { return (row / wn) * V + w0 + row % wn; },
      [wn](int row) { return (row / wn) * TILE + row % wn; });
  __syncthreads();

  // per-joint aggregation over frames, summed over the K kernels
  if ((Co & 3) == 0) {
    const int C4 = Co >> 2;
    const int fstride = TILE * C4;  // xf step from one frame to the next
    for (int i = threadIdx.x; i < rows * C4; i += blockDim.x) {
      const int row = i / C4, c4 = i - row * C4;
      const int at = row / wn, j = row - at * wn;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < K; ++k) {
        const float* ak = adj + (k * TILE + j) * TT;
        const float4* fk =
            reinterpret_cast<const float4*>(xf + (k * T * TILE + j) * Co) +
            c4;
        if (a.agg_left) {
          for (int b = 0; b < T; ++b)
            fma4(ak[at * T + b], fk[b * fstride], acc);
        } else {
          for (int b = 0; b < T; ++b)
            fma4(ak[b * T + at], fk[b * fstride], acc);
        }
      }
      store.put4(at * V + w0 + j, w0 + j, c4, acc);
    }
  } else {
    const int fstride = TILE * Co;
    for (int i = threadIdx.x; i < rows * Co; i += blockDim.x) {
      const int row = i / Co, c = i - row * Co;
      const int at = row / wn, j = row - at * wn;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        const float* ak = adj + (k * TILE + j) * TT;
        const float* fk = xf + (k * T * TILE + j) * Co + c;
        if (a.agg_left) {
          for (int b = 0; b < T; ++b)
            acc = fmaf(ak[at * T + b], fk[b * fstride], acc);
        } else {
          for (int b = 0; b < T; ++b)
            acc = fmaf(fk[b * fstride], ak[b * T + at], acc);
        }
      }
      store.put(at * V + w0 + j, w0 + j, c, acc);
    }
  }
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
