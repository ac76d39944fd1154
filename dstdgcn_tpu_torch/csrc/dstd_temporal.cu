// Temporal DSTD-GC forward, whole op in one kernel (float32, and bf16
// contraction operands).
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
// op does about 0.40 GFLOP, mostly contractions, against 12.7 MB of
// activations: at the 3xTF32 rate (the dense TF32 rate over 3) the
// contractions take less than the about 3.8 us of memory at 3.35 TB/s, so
// the bound is the bytes (chip_smoke.py::op_cost); its 2*22*1225 tanh per
// output joint run on the CUDA cores.
//
// Design (both variants): the body dstd_fwd::op_mma (dstd_fwd_mma.cuh),
// the spatial op's with frames and joints swapped: one block of 512
// threads per (sample, tile of output joints), the tile a template
// parameter, and the ceil(V / tile) blocks of a sample run as one
// thread-block cluster (at most 8, so the tile is at least ceil(V / 8)).
// The adjacency of an output joint mixes the frame-pair scores of all V
// source joints: each block projects q/k of its own joints' rows on the
// CUDA cores and copies the others' through distributed shared memory,
// forms its share of the sample's scores once, and the feature
// projection, the mixing and the aggregation run on the tensor cores.
// The scores and the adjacency never touch device memory.
//
// Float32 (dstd_temporal_f32): the products run in float64 on the tensor
// cores (dstd_fwd::F64Mma, as the float32 spatial kernel) in the body's
// float32 order and layout (the scores formed in the mixing's fragments,
// the features projected one group of 16 output channels at a time after
// the gather); q/k stay float32 CUDA-core sums in the order of the
// backward's q/k launch.  On 3xTF32 products it
// ran 1.1x faster, but the float32 chain gradient then lay past its rule,
// and with float64 products here and 3xTF32 in the spatial kernel too
// (PERF.md).  At T = 35, V = 22, 64->64 and the wrapper's tile 4 a block
// takes 97,088 B: a cluster of 6, two blocks an SM, a batch-32 call in
// one wave (at 3xTF32, tile 6, 143,936 B and one block an SM, measured
// 1.77x slower).  Its CUDA-core predecessor (a body of per-thread float32
// FMAs, retired) projected q/k of the whole sample in each of a sample's
// blocks and ran 25x its bound (PERF.md).
//
// bf16 variant (dstd_temporal_bf16): the TPU kernel's compute dtype, bf16
// operands of the four contractions with float32 sums, on bf16 mma.sync
// from operands staged once as bf16 (x read as bf16).
#include <type_traits>

#include "dstd_common.cuh"
#include "dstd_fwd_mma.cuh"

namespace {

using dstd::kMaxTile;
using dstd::kThreads;
using dstd::OpArgs;

// two blocks an SM (at most 64 registers): both layouts leave room for
// two at T = 35, V = 22, 64->64 (97,088 B at float32, tile 4; 99,920 B
// at bf16, tile 6)
template <int TILE, typename Rnd>
__global__ void __launch_bounds__(kThreads, 2)
    temporal_kernel(const OpArgs a) {
  extern __shared__ float4 smem4[];
  const int n = blockIdx.y, w0 = blockIdx.x * TILE;
  using Mma = std::conditional_t<std::is_same_v<Rnd, dstd::Bf16>,
                                 dstd_mma::Bf16Mma, dstd_fwd::F64Mma>;
  dstd_fwd::op_mma<false, Mma>(
      a, reinterpret_cast<char*>(smem4), n, w0, min(TILE, a.V - w0), TILE,
      (a.V + TILE - 1) / TILE,
      dstd_fwd::PairStore{a.out + (size_t)n * a.T * a.V * a.Co, a.Co});
}

template <int TILE, typename Rnd>
cudaError_t launch(const OpArgs& a, int N, size_t bytes,
                   cudaStream_t stream) {
  const int nblk = (a.V + TILE - 1) / TILE;
  if (nblk > dstd::kMaxCluster) return cudaErrorInvalidValue;
  return dstd::launch_clustered(temporal_kernel<TILE, Rnd>, a, nblk, N,
                                bytes, stream);
}

// One launch of the op on `stream` with rounding policy Rnd; returns the
// cudaError_t of the launch (0 = success).
template <typename Rnd>
int run(const float* x, const float* base, const float* alpha,
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
  const size_t bytes = dstd_fwd::op_layout(false, T, V, Ci, Co, K, R, tile,
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
long long dstd_temporal_smem_bytes(int T, int V, int Ci, int Co, int K,
                                   int R, int tile) {
  return dstd_fwd::op_layout(false, T, V, Ci, Co, K, R, tile, true).total;
}

long long dstd_temporal_bf16_smem_bytes(int T, int V, int Ci, int Co, int K,
                                        int R, int tile) {
  return dstd_fwd::op_layout(false, T, V, Ci, Co, K, R, tile, false).total;
}

const char* dstd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch on `stream` and return the cudaError_t of the launch (0 =
// success).  Float32:
int dstd_temporal_f32(const float* x, const float* base, const float* alpha,
                      const float* wf, const float* bf, const float* wm1,
                      const float* bm1, const float* wm2, const float* bm2,
                      const float* wrm, const float* brm, float* out, int N,
                      int T, int V, int Ci, int Co, int K, int R,
                      int agg_left, int tile, int device, void* stream) {
  return run<dstd::Exact>(x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm,
                          brm, out, N, T, V, Ci, Co, K, R, agg_left, tile,
                          device, stream);
}

// bf16 contraction operands, float32 sums (the TPU kernel's bf16 dtype);
// x is bf16, the contract's rounding of it:
int dstd_temporal_bf16(const __nv_bfloat16* x, const float* base,
                       const float* alpha, const float* wf, const float* bf,
                       const float* wm1, const float* bm1, const float* wm2,
                       const float* bm2, const float* wrm, const float* brm,
                       float* out, int N, int T, int V, int Ci, int Co, int K,
                       int R, int agg_left, int tile, int device,
                       void* stream) {
  // the shared argument block carries x as a float pointer; the bf16 body
  // reads it as bf16
  return run<dstd::Bf16>(reinterpret_cast<const float*>(x), base, alpha, wf,
                         bf, wm1, bm1, wm2, bm2, wrm, brm, out, N, T, V, Ci,
                         Co, K, R, agg_left, tile, device, stream);
}

}  // extern "C"
