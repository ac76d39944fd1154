// Spatial DSTD-GC forward, whole op in one kernel (float32).
//
// Replaces the TPU kernel dstdgcn_tpu/kernels/fused.py::_spatial_kernel
// (entry dstd_spatial).  Same contract as the plain op
// dstdgcn_tpu_torch/ops/dstd.py::dstd_spatial with mask=None:
//   xf[k,t,v,:]  = x[t,v,:] @ wf[k] + bf[k]
//   q/k[k,r,s,v] = x[s,v,:] @ wm1/wm2[k,:,r] + bm1/bm2[k,r]
//   adj[k,t,v,w] = (sum_{r,s} tanh(q[k,r,s,v] - k[k,r,s,w]) wrm[k,r,s,t]
//                   + brm[k,t]) * alpha + base[k,v,w]
//   right: out[t,w,c] = sum_{k,v} xf[k,t,v,c] adj[k,t,v,w]
//   left:  out[t,v,c] = sum_{k,w} adj[k,t,v,w] xf[k,t,w,c]
//
// Bound on an H100 SXM: at N=32, T=35, V=22, 64->64 channels, K=2, R=2 the
// op does about 0.72 GFLOP (projections 0.40, mixing 0.15, aggregation
// 0.14) against 12.7 MB of activations, so it is bound by float32 CUDA-core
// operations (about 11 us at 67 TFLOP/s) rather than memory (about 3.8 us
// at 3.35 TB/s); the 2*35*484 tanh per output frame also run on the
// CUDA cores.
//
// Design: one block of 512 threads per (sample, tile of output frames), the
// tile a template parameter.  The adjacency of an output frame mixes the
// scores of all T source frames, so each block needs the whole sample's
// q/k: the T/tile blocks of a sample run as one thread-block cluster, each
// projects its share of the rows and copies the others' from their shared
// memory (DSMEM).  Then each block builds the tile's adjacency in shared
// memory, one thread per (k, v, w) pair with the tile's
// output frames in registers (tanh scores recomputed per tile, mixing
// weights read as float4), projects the tile's features (float4 register
// tiles, x read through L1) and aggregates.  The scores and the adjacency
// never touch device memory.  Everything is plain float32 FMA on the CUDA
// cores; no tensor cores yet (the projections and the aggregation are
// small GEMMs that would fit mma/wgmma tiles, in a later step).
#include "dstd_common.cuh"

namespace {

using dstd::fma4;
using dstd::kMaxTile;
using dstd::kThreads;
using dstd::OpArgs;
using dstd::round4;

// Shared-memory layout of one block (offsets in floats, each a multiple
// of 4): wqk [Ci][J], bqk [J], wmix [K][R][T][round4(tile)], qk [J][T][V],
// adj [K][tile][V][V], xf [K][tile*V][Co].
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

template <int TILE>
__global__ void __launch_bounds__(kThreads) spatial_kernel(const OpArgs a) {
  constexpr int TP = (TILE + 3) & ~3;  // wmix row stride (float4 loads)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = a.T, V = a.V, K = a.K, R = a.R, Co = a.Co;
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int tn = min(TILE, T - t0);
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
  dstd::stage_qk_weights(wqk, bqk, a);
  for (int i = threadIdx.x; i < K * R * T * TP; i += blockDim.x) {
    const int tt = i % TP, krs = i / TP;  // krs = (k*R + r)*T + s
    wmix[i] = tt < tn ? a.wrm[(size_t)krs * T + t0 + tt] : 0.f;
  }
  __syncthreads();

  // q/k of every source frame of the sample
  dstd::project_qk(a, xn, wqk, bqk, qk, false);
  __syncthreads();

  // dynamic adjacency of the tile's output frames: one thread per (k, v, w)
  for (int p = threadIdx.x; p < K * VV; p += blockDim.x) {
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
  dstd::project_features(
      a, xn, xf, rows, TILE * V * Co,
      [t0, V](int row) { return t0 * V + row; }, [](int row) { return row; });
  __syncthreads();

  // per-frame aggregation over joints, summed over the K kernels
  float* on = a.out + ((size_t)n * T + t0) * V * Co;
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
      reinterpret_cast<float4*>(on)[i] = acc;
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
      on[i] = acc;
    }
  }
}

// the blocks of one sample form one thread-block cluster, at most the
// portable cluster size
constexpr int kMaxCluster = 8;

// Launches `kernel` with the blocks along x (one sample's tiles) as one
// thread-block cluster.
template <typename Kernel>
cudaError_t launch_clustered(Kernel kernel, const OpArgs& a, int nblk,
                             int N, size_t bytes, cudaStream_t stream) {
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

template <int TILE>
cudaError_t launch(const OpArgs& a, int N, size_t bytes,
                   cudaStream_t stream) {
  const int nblk = (a.T + TILE - 1) / TILE;
  if (nblk > kMaxCluster) return cudaErrorInvalidValue;
  return launch_clustered(spatial_kernel<TILE>, a, nblk, N, bytes, stream);
}

}  // namespace

extern "C" {

long long dstd_spatial_smem_bytes(int T, int V, int Ci, int Co, int K, int R,
                                  int tile) {
  return SpatialLayout(T, V, Ci, Co, K, R, tile).total *
         (long long)sizeof(float);
}

const char* dstd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int dstd_spatial_f32(const float* x, const float* base, const float* alpha,
                     const float* wf, const float* bf, const float* wm1,
                     const float* bm1, const float* wm2, const float* bm2,
                     const float* wrm, const float* brm, float* out, int N,
                     int T, int V, int Ci, int Co, int K, int R, int agg_left,
                     int tile, int device, void* stream) {
  if (N == 0) return 0;
  if (tile < 1 || tile > kMaxTile)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const OpArgs a{x,   base, alpha, wf, bf, wm1, bm1, wm2,     bm2,
                 wrm, brm,  out,   T,  V,  Ci,  Co,  K,   R, agg_left};
  const size_t bytes =
      (size_t)dstd_spatial_smem_bytes(T, V, Ci, Co, K, R, tile);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 1: return (int)launch<1>(a, N, bytes, st);
    case 2: return (int)launch<2>(a, N, bytes, st);
    case 3: return (int)launch<3>(a, N, bytes, st);
    case 4: return (int)launch<4>(a, N, bytes, st);
    case 5: return (int)launch<5>(a, N, bytes, st);
    case 6: return (int)launch<6>(a, N, bytes, st);
    case 7: return (int)launch<7>(a, N, bytes, st);
    default: return (int)launch<8>(a, N, bytes, st);
  }
}

}  // extern "C"
