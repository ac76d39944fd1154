// Temporal DSTD-GC forward, whole op in one kernel (float32).
//
// Replaces the TPU kernel dstdgcn_tpu/kernels/fused.py::_temporal_kernel
// (entry dstd_temporal).  Same contract as the plain op
// dstdgcn_tpu_torch/ops/dstd.py::dstd_temporal with mask=None:
//   xf[k,t,v,:]  = x[t,v,:] @ wf[k] + bf[k]
//   q/k[k,r,v,t] = x[t,v,:] @ wm1/wm2[k,:,r] + bm1/bm2[k,r]
//   adj[k,w,t,u] = (sum_{r,v} tanh(q[k,r,v,t] - k[k,r,v,u]) wrm[k,r,v,w]
//                   + brm[k,w]) * alpha + base[k,t,u]
//   right: out[u,v,c] = sum_{k,t} xf[k,t,v,c] adj[k,v,t,u]
//   left:  out[t,v,c] = sum_{k,u} adj[k,v,t,u] xf[k,u,v,c]
//
// Bound on an H100 SXM: at N=32, T=35, V=22, 64->64 channels, K=1, R=2 the
// op does about 0.40 GFLOP against 12.7 MB of activations: about 6 us of
// float32 CUDA-core operations at 67 TFLOP/s against about 3.8 us of
// memory at 3.35 TB/s, so it is operation-bound; its 2*22*1225 tanh per
// output joint also run on the CUDA cores.
//
// Design: one block of 512 threads per (sample, tile of output joints), the
// tile a template parameter.  The adjacency of an output joint mixes the
// frame-pair scores of all V source joints, so each block projects q/k for
// the whole sample into shared memory (the V/tile blocks of a sample each
// recompute it: with K = 1 the projection is cheap, and sharing it through
// a cluster measured slower here, unlike the spatial op).  Then each block
// builds the tile's (T, T) adjacencies in shared memory, one thread per (k, t, u) pair with
// the tile's joints in registers (tanh scores recomputed per tile, mixing
// weights read as float4), projects the features of the tile's joints over
// all frames (float4 register tiles, x read through L1) and aggregates over
// frames.  The scores and the adjacency never touch device memory.  Plain
// float32 FMA on the CUDA cores.
#include "dstd_common.cuh"

namespace {

using dstd::fma4;
using dstd::kMaxTile;
using dstd::kThreads;
using dstd::OpArgs;
using dstd::round4;

// Shared-memory layout of one block (offsets in floats, each a multiple
// of 4): wqk [Ci][J], bqk [J], wmix [K][R][V][round4(tile)], qk [J][V][T],
// adj [K][tile][T][T], xf [K][T][tile][Co].
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

template <int TILE>
__global__ void __launch_bounds__(kThreads) temporal_kernel(const OpArgs a) {
  constexpr int TP = (TILE + 3) & ~3;  // wmix row stride (float4 loads)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = a.T, V = a.V, K = a.K, R = a.R, Co = a.Co;
  const int n = blockIdx.y;
  const int w0 = blockIdx.x * TILE;
  const int wn = min(TILE, V - w0);
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
  dstd::stage_qk_weights(wqk, bqk, a);
  for (int i = threadIdx.x; i < K * R * V * TP; i += blockDim.x) {
    const int j = i % TP, krv = i / TP;  // krv = (k*R + r)*V + v
    wmix[i] = j < wn ? a.wrm[(size_t)krv * V + w0 + j] : 0.f;
  }
  __syncthreads();

  // q/k of every (frame, joint) of the sample, stored joints-major
  dstd::project_qk(a, xn, wqk, bqk, qk, true);
  __syncthreads();

  // dynamic adjacency of the tile's output joints: one thread per (k, t, u)
  for (int p = threadIdx.x; p < K * TT; p += blockDim.x) {
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
  dstd::project_features(
      a, xn, xf, rows, T * TILE * Co,
      [w0, wn, V](int row) { return (row / wn) * V + w0 + row % wn; },
      [wn](int row) { return (row / wn) * TILE + row % wn; });
  __syncthreads();

  // per-joint aggregation over frames, summed over the K kernels
  float* on = a.out + (size_t)n * TV * Co;
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
      reinterpret_cast<float4*>(on + ((size_t)at * V + w0 + j) * Co)[c4] =
          acc;
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
      on[((size_t)at * V + w0 + j) * Co + c] = acc;
    }
  }
}

template <int TILE>
cudaError_t launch(const OpArgs& a, int N, size_t bytes,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      temporal_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.V + TILE - 1) / TILE, N);
  temporal_kernel<TILE><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

long long dstd_temporal_smem_bytes(int T, int V, int Ci, int Co, int K,
                                   int R, int tile) {
  return TemporalLayout(T, V, Ci, Co, K, R, tile).total *
         (long long)sizeof(float);
}

const char* dstd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int dstd_temporal_f32(const float* x, const float* base, const float* alpha,
                      const float* wf, const float* bf, const float* wm1,
                      const float* bm1, const float* wm2, const float* bm2,
                      const float* wrm, const float* brm, float* out, int N,
                      int T, int V, int Ci, int Co, int K, int R,
                      int agg_left, int tile, int device, void* stream) {
  if (N == 0) return 0;
  if (tile < 1 || tile > kMaxTile)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const OpArgs a{x,   base, alpha, wf, bf, wm1, bm1, wm2,     bm2,
                 wrm, brm,  out,   T,  V,  Ci,  Co,  K,   R, agg_left};
  const size_t bytes =
      (size_t)dstd_temporal_smem_bytes(T, V, Ci, Co, K, R, tile);
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
