// Spatial DSTD-GC forward, whole op in one kernel (float32, and bf16
// contraction operands).
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
// 0.14) against 12.7 MB of activations: about 4.4 us of contractions at
// the 3xTF32 rate (the dense TF32 rate over 3) beside about 3.8 us of
// memory at 3.35 TB/s, so it is bound by operations; the 2*35*484 tanh of
// a sample run on the CUDA cores.
//
// Design (both variants): the body dstd_fwd::op_mma (dstd_fwd_mma.cuh),
// one block of 512 threads per (sample, tile of output frames), the tile a
// template parameter.  The adjacency of an output frame mixes the scores
// of all T source frames, so the T/tile blocks of a sample run as one
// thread-block cluster: each projects q/k of its own rows on the CUDA cores
// and copies the others' through distributed shared memory (DSMEM), forms
// its share of the sample's scores once (the pair rows split over the
// cluster), mixes them on the tensor cores and exchanges the adjacency
// through DSMEM; the feature projection, the mixing and the aggregation
// run on the tensor cores from operands staged once in shared memory.  The
// scores and the adjacency never touch device memory.
//
// Float32 (dstd_spatial_f32): the products run in float64 on the tensor
// cores (dstd_fwd::F64Mma: each m16n8k8 step as four mma.sync m8n8k4 .f64,
// float64 sums, one rounding to float32 at the store) on operands staged
// as float32, in a layout that holds fewer regions at once (the scores
// formed in the mixing's fragments, the features projected one group of
// 16 output channels at a time after the adjacency is gathered), so that
// two blocks share an SM and a batch-32 call runs in one wave; q/k stay
// float32 CUDA-core sums in the order of the backward's q/k launch.  On 3xTF32 products (dstd_mma::Tf32x3Mma) it ran
// 9% faster, but with the temporal kernel on 3xTF32 beside it the float32
// chain gradient lay past its rule; with both on float64 products it holds
// (PERF.md).  Its CUDA-core predecessor (a body of per-thread float32
// FMAs, retired) ran 25.7x its bound over the 7 calls of a forward at N=32
// on an H100.
//
// bf16 variant (dstd_spatial_bf16): the TPU kernel's compute dtype, which
// rounds the operands of its four contractions (x wqk, x wf, s wrm,
// adj xf) to bf16 and accumulates in float32: bf16 mma.sync on operands
// staged once as bf16 (x read as bf16).  Measured over the 7 calls of a
// forward at N=128 on an H100, the CUDA-core body spent 53% of its time in
// the feature projection (PERF.md).
#include <type_traits>

#include "dstd_common.cuh"
#include "dstd_fwd_mma.cuh"

namespace {

using dstd::kMaxTile;
using dstd::kThreads;
using dstd::OpArgs;

// two blocks an SM (at most 64 registers): both layouts leave room for
// two at T = 35, V = 22, 64->64, tile 5 (101 KB at float32, 105 KB at
// bf16)
template <int TILE, typename Rnd>
__global__ void __launch_bounds__(kThreads, 2)
    spatial_kernel(const OpArgs a) {
  extern __shared__ float4 smem4[];
  const int n = blockIdx.y, t0 = blockIdx.x * TILE;
  using Mma = std::conditional_t<std::is_same_v<Rnd, dstd::Bf16>,
                                 dstd_mma::Bf16Mma, dstd_fwd::F64Mma>;
  dstd_fwd::op_mma<true, Mma>(
      a, reinterpret_cast<char*>(smem4), n, t0, min(TILE, a.T - t0), TILE,
      (a.T + TILE - 1) / TILE,
      dstd_fwd::PairStore{a.out + (size_t)n * a.T * a.V * a.Co, a.Co});
}

template <int TILE, typename Rnd>
cudaError_t launch(const OpArgs& a, int N, size_t bytes,
                   cudaStream_t stream) {
  const int nblk = (a.T + TILE - 1) / TILE;
  if (nblk > dstd::kMaxCluster) return cudaErrorInvalidValue;
  return dstd::launch_clustered(spatial_kernel<TILE, Rnd>, a, nblk, N, bytes,
                                stream);
}

// One launch of the op on `stream` with rounding policy Rnd; returns the
// cudaError_t of the launch (0 = success).
template <typename Rnd>
int run(const float* x, const float* base, const float* alpha,
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
  const size_t bytes = dstd_fwd::op_layout(true, T, V, Ci, Co, K, R, tile,
                                           !std::is_same_v<Rnd, dstd::Bf16>)
                           .total;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 1: return (int)launch<1, Rnd>(a, N, bytes, st);
    case 2: return (int)launch<2, Rnd>(a, N, bytes, st);
    case 3: return (int)launch<3, Rnd>(a, N, bytes, st);
    case 4: return (int)launch<4, Rnd>(a, N, bytes, st);
    case 5: return (int)launch<5, Rnd>(a, N, bytes, st);
    case 6: return (int)launch<6, Rnd>(a, N, bytes, st);
    case 7: return (int)launch<7, Rnd>(a, N, bytes, st);
    default: return (int)launch<8, Rnd>(a, N, bytes, st);
  }
}

}  // namespace

extern "C" {

// Shared memory of one block, in bytes: the float32 variant's, then the
// bf16 one's (the same body in other elements).
long long dstd_spatial_smem_bytes(int T, int V, int Ci, int Co, int K, int R,
                                  int tile) {
  return dstd_fwd::op_layout(true, T, V, Ci, Co, K, R, tile, true).total;
}

long long dstd_spatial_bf16_smem_bytes(int T, int V, int Ci, int Co, int K,
                                       int R, int tile) {
  return dstd_fwd::op_layout(true, T, V, Ci, Co, K, R, tile, false).total;
}

const char* dstd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream` and return the cudaError_t of the launch (0 =
// success).  Float32:
int dstd_spatial_f32(const float* x, const float* base, const float* alpha,
                     const float* wf, const float* bf, const float* wm1,
                     const float* bm1, const float* wm2, const float* bm2,
                     const float* wrm, const float* brm, float* out, int N,
                     int T, int V, int Ci, int Co, int K, int R, int agg_left,
                     int tile, int device, void* stream) {
  return run<dstd::Exact>(x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm,
                          brm, out, N, T, V, Ci, Co, K, R, agg_left, tile,
                          device, stream);
}

// bf16 contraction operands, float32 sums (the TPU kernel's bf16 dtype);
// x is bf16, the contract's rounding of it:
int dstd_spatial_bf16(const __nv_bfloat16* x, const float* base,
                      const float* alpha, const float* wf, const float* bf,
                      const float* wm1, const float* bm1, const float* wm2,
                      const float* bm2, const float* wrm, const float* brm,
                      float* out, int N, int T, int V, int Ci, int Co, int K,
                      int R, int agg_left, int tile, int device, void* stream) {
  // the shared argument block carries x as a float pointer; the bf16 body
  // reads it as bf16
  return run<dstd::Bf16>(reinterpret_cast<const float*>(x), base, alpha, wf,
                         bf, wm1, bm1, wm2, bm2, wrm, brm, out, N, T, V, Ci,
                         Co, K, R, agg_left, tile, device, stream);
}

}  // extern "C"
