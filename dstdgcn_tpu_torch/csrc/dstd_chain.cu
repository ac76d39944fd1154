// Chains of DSTD-GC ops in one launch: the whole-chain kernel (entries
// dstd_chain_f32 and dstd_chain_bf16) and the whole-encoder kernel (entries
// dstd_encoder_chain_f32 and dstd_encoder_chain_bf16), one template with a
// compile-time switch and the rounding policy of dstd_common.cuh.  The bf16
// variants are the TPU kernels' `dtype` (dstdgcn_tpu/kernels/fused.py::
// _spatial_body / _temporal_body through _dot_fn): the operands of the four
// contractions of each op rounded to bf16, products and sums in float32;
// the activation between ops, the tanh, the mixing sums, the adjacency's
// affine and the encoder's epilogue stay float32, as x and out do.
//
// Replaces the TPU kernels dstdgcn_tpu/kernels/fused.py::_chain_grid_kernel
// (entry dstd_chain) and ::_encoder_grid_kernel (entry dstd_encoder_chain).
// Same contract as the plain versions in
// dstdgcn_tpu_torch/kernels/fused.py, with C channels throughout:
//   chain, per block b:    x = temporal_b(spatial_b(x))
//   encoder, per layer l:  y = prelu(spatial_l(x) * sc1 + sh1 + x, a1)
//                          x = prelu((temporal_l(y) + x) * sc2 + sh2, a2)
// where sc/sh are the folded eval-BatchNorm affines (V, C) of the layer and
// a1/a2 its two PReLU slopes.  Each op is the one of dstd_spatial.cu /
// dstd_temporal.cu.
//
// Bound on an H100 SXM: the encoder of the H36M model (N=32, T=35, V=22,
// C=64, L=5 layers) does about 5 x 1.13 GFLOP, mostly contractions
// (float32: 0.036 ms at the 3xTF32 rate beside the tanh and affines on
// the CUDA cores; PERF.md), against 12.6 MB of activation bytes (x in and
// out once, about 3.8 us at 3.35 TB/s): it is bound by operations.
// The one-op kernels move the activation through device memory 4 times per
// layer and pay a launch per op; here it is read once and written once.
//
// Design: one thread-block cluster per sample runs every op of the chain,
// one block of 512 threads per cluster rank.  The cluster size is
// ceil(max(T, V) / TILE) <= 8 (7 at T=35, V=22, TILE=5); in a spatial op
// rank r owns output frames [r*ts, r*ts + ts), in a temporal op output
// joints [r*tt, r*tt + tt), ts = ceil(T / size) and tt = ceil(V / size)
// both <= TILE (at V=22, tt=4: rank 6 owns no joint, yet forms its share
// of the scores and meets every barrier).  All four entries run each op
// through the tensor-core body dstd_fwd::op_mma (dstd_fwd_mma.cuh, the
// body of the one-op forward kernels, at the chain's cluster), each score
// formed once per sample: the bf16 entries on bf16 mma.sync, the layer's
// float32 activation rounded to bf16 where it is staged (the contract's
// rounding point); the float32 entries on 3xTF32 (float32-accurate, each
// depth step summed in a zeroed accumulator) in the body's float32 order
// and layout.  The encoder stores through its epilogue below, the chain
// through a plain store into `mid` and the layer output.  The q/k
// projections are split over the cluster and exchanged through
// distributed shared memory.
//
// Where the activation lives between ops.  Every op couples the whole
// sample (the spatial op mixes all frames' scores, the temporal op all
// joints'), so each block reads rows that the other blocks of its cluster
// wrote.  A sample's activation is T*V*C*4 = 197,120 bytes, about 28 KB per
// block if spread over the cluster's distributed shared memory, next to the
// 107 KB the spatial op already needs; and a block would read most of its
// rows remotely.  So the activation stays in a per-sample global scratch
// instead, which the 50 MB L2 holds (3 buffers of 6.3 MB at N=32; at
// N=128 they are 25.2 MB each and do not fit, yet on an H100 a batch-128
// call takes 0.93-0.99x four batch-32 calls: the kernel is bound by its
// operations, not by these reads): the block's shared memory stays free
// for the op.  Buffers: the layer input
// (the caller's x for layer 0), `mid` (the spatial op's output) and the
// layer output, which alternates between `out` and `ping` so that the last
// layer writes `out`.  No op writes a buffer that any block still reads in
// that op: the spatial op reads the layer input and writes `mid`; the
// temporal op reads `mid` and the layer input (the residual) and writes the
// layer output, which is the input of two layers back.
//
// Visibility.  After each op every thread fences its global writes
// (__threadfence, device scope) and the cluster meets at cluster.sync()
// (barrier.cluster.arrive.release / wait.acquire); after it, a block reads
// the other blocks' rows with ld.global.cg (at L2, never a stale L1 line).
// The barrier also orders the reuse of each block's shared memory.
//
// Occupancy: at T=35, V=22, C=64 the tensor-core layouts take about 106 KB
// of shared memory per block at bf16 and 101 KB at float32, and a thread
// at most 64 registers (__launch_bounds__(512, 2); left free the compiler
// takes 128, one block per SM, and a batch-32 call then runs in two
// waves), so two blocks per SM: a batch-32 call is 32 clusters of 7 blocks
// (224 blocks on 132 SMs), a batch-1 call one cluster.  Every variant
// spills under the cap (ptxas -v, PERF.md).
#include <type_traits>

#include "dstd_common.cuh"
#include "dstd_fwd_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using dstd::kMaxTile;
using dstd::kThreads;
using dstd::OpArgs;

// One op's weights, each stacked over the chain's layers (blocks) in the
// layout of dstd_spatial / dstd_temporal with a leading layer axis.
struct Stack {
  const float *base, *alpha, *wf, *bf, *wm1, *bm1, *wm2, *bm2, *wrm, *brm;
};

struct ChainArgs {
  const float* x;
  float* out;
  float* mid;
  float* ping;
  Stack s, t;
  // encoder only: aff1, aff2 (L, 2, V, C) scale and shift, prelu (L, 2)
  const float *aff1, *aff2, *prelu;
  int T, V, C, L, Ks, Kt, R, agg_left, ts, tt;
};

// OpArgs of layer l of a stacked op whose mixing runs over `ref` and whose
// base adjacency is (pair, pair): spatial ref = T, pair = V; temporal the
// other way round.
__device__ OpArgs layer_op(const ChainArgs& c, const Stack& w, int l, int K,
                           int ref, int pair, const float* in, float* out) {
  const size_t C = c.C, R = c.R, Kl = (size_t)l * K;
  return OpArgs{in,
                w.base + Kl * pair * pair,
                w.alpha + l,
                w.wf + Kl * C * C,
                w.bf + Kl * C,
                w.wm1 + Kl * C * R,
                w.bm1 + Kl * R,
                w.wm2 + Kl * C * R,
                w.bm2 + Kl * R,
                w.wrm + Kl * R * ref * ref,
                w.brm + Kl * ref,
                out,
                c.T,
                c.V,
                c.C,
                c.C,
                K,
                c.R,
                c.agg_left};
}

// The encoder's epilogues: after the spatial op (kAffineFirst)
// y = prelu(acc * scale + shift + res), after the temporal op
// z = prelu((acc + res) * scale + shift); res is the layer input.  `out` and
// `res` are the sample's (T*V, C) rows, scale and shift (V, C).
template <bool kAffineFirst>
struct LayerStore {
  float* out;
  const float* res;
  const float* scale;
  const float* shift;
  float slope;
  int Co;
  __device__ float act(float acc, float r, float s, float h) const {
    const float y = kAffineFirst ? acc * s + h + r : (acc + r) * s + h;
    return y >= 0.f ? y : slope * y;
  }
  __device__ void put(int row, int v, int c, float acc) const {
    const size_t o = (size_t)row * Co + c;
    out[o] = act(acc, __ldcg(res + o), __ldg(scale + v * Co + c),
                 __ldg(shift + v * Co + c));
  }
  // channels c and c + 1 (c even; c + 1 may lie past Co), the tensor-core
  // body's store
  __device__ void put2(int row, int v, int c, float a0, float a1) const {
    if ((Co & 1) == 0) {
      const size_t o = (size_t)row * Co + c;
      const float2 r = __ldcg(reinterpret_cast<const float2*>(res + o));
      const float2 s = __ldg(reinterpret_cast<const float2*>(scale + v * Co + c));
      const float2 h = __ldg(reinterpret_cast<const float2*>(shift + v * Co + c));
      *reinterpret_cast<float2*>(out + o) =
          make_float2(act(a0, r.x, s.x, h.x), act(a1, r.y, s.y, h.y));
    } else {
      put(row, v, c, a0);
      if (c + 1 < Co) put(row, v, c + 1, a1);
    }
  }
};

// Makes this block's global writes visible to the cluster and waits for
// every block of it (see "Visibility" above).
__device__ inline void publish() {
  __threadfence();
  cg::this_cluster().sync();
}

// The tensor-core products of the ops of every chain instantiation: bf16
// mma.sync at Bf16, 3xTF32 at Exact.
template <typename Rnd>
using MmaOf = std::conditional_t<std::is_same_v<Rnd, dstd::Bf16>,
                                 dstd_mma::Bf16Mma, dstd_mma::Tf32x3Mma>;

template <int TILE, bool kEncoder, typename Rnd>
__global__ void __launch_bounds__(kThreads, 2)
    chain_kernel(const ChainArgs c) {
  extern __shared__ float4 smem4[];
  char* bytes = reinterpret_cast<char*>(smem4);
  const int rank = (int)cg::this_cluster().block_rank();
  const int nblk = (int)cg::this_cluster().num_blocks();
  const int n = blockIdx.y;
  const int t0 = rank * c.ts, tn = max(0, min(c.ts, c.T - t0));
  const int w0 = rank * c.tt, wn = max(0, min(c.tt, c.V - w0));
  const size_t sample = (size_t)n * c.T * c.V * c.C;
  const float* in = c.x;
  for (int l = 0; l < c.L; ++l) {
    float* out = ((c.L - 1 - l) & 1) ? c.ping : c.out;
    const OpArgs sa = layer_op(c, c.s, l, c.Ks, c.T, c.V, in, c.mid);
    const OpArgs ta = layer_op(c, c.t, l, c.Kt, c.V, c.T, c.mid, out);
    if constexpr (kEncoder) {
      const size_t VC = (size_t)c.V * c.C;
      const float* a1 = c.aff1 + 2 * l * VC;
      const float* a2 = c.aff2 + 2 * l * VC;
      dstd_fwd::op_mma<true, MmaOf<Rnd>, true>(
          sa, bytes, n, t0, tn, c.ts, nblk,
          LayerStore<true>{c.mid + sample, in + sample, a1, a1 + VC,
                           __ldg(c.prelu + 2 * l), c.C});
      publish();
      dstd_fwd::op_mma<false, MmaOf<Rnd>, true>(
          ta, bytes, n, w0, wn, c.tt, nblk,
          LayerStore<false>{out + sample, in + sample, a2, a2 + VC,
                            __ldg(c.prelu + 2 * l + 1), c.C});
    } else {
      // the chain: the same body, a plain store
      dstd_fwd::op_mma<true, MmaOf<Rnd>, true>(
          sa, bytes, n, t0, tn, c.ts, nblk,
          dstd_fwd::PairStore{c.mid + sample, c.C});
      publish();
      dstd_fwd::op_mma<false, MmaOf<Rnd>, true>(
          ta, bytes, n, w0, wn, c.tt, nblk,
          dstd_fwd::PairStore{out + sample, c.C});
    }
    publish();
    in = out;
  }
}

// The tensor-core body's shared memory, in bytes, for the chain's cluster
// of ceil(max(T, V) / tile) blocks in the element kind's layout (f32:
// 3xTF32): the larger of its two ops' layouts, each at the share of output
// indices one rank owns.
long long mma_smem_bytes(int T, int V, int C, int Ks, int Kt, int R,
                         int tile, bool f32) {
  const int nblk = ((T > V ? T : V) + tile - 1) / tile;
  const int ts = (T + nblk - 1) / nblk, tt = (V + nblk - 1) / nblk;
  const long long s =
      dstd_fwd::FwdLayout(true, T, V, C, C, Ks, R, ts, nblk, f32).total;
  const long long t =
      dstd_fwd::FwdLayout(false, T, V, C, C, Kt, R, tt, nblk, f32).total;
  return s > t ? s : t;
}

template <bool kEncoder, typename Rnd>
cudaError_t launch(ChainArgs c, int N, int tile, int device,
                   cudaStream_t stream) {
  if (N == 0 || c.L == 0) return cudaSuccess;
  if (tile < 1 || tile > kMaxTile) return cudaErrorInvalidValue;
  const int ext = c.T > c.V ? c.T : c.V;
  const int nblk = (ext + tile - 1) / tile;
  if (nblk > dstd::kMaxCluster) return cudaErrorInvalidValue;
  c.ts = (c.T + nblk - 1) / nblk;
  c.tt = (c.V + nblk - 1) / nblk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t bytes = (size_t)mma_smem_bytes(
      c.T, c.V, c.C, c.Ks, c.Kt, c.R, tile,
      !std::is_same_v<Rnd, dstd::Bf16>);
  switch (tile) {
#define DSTD_CHAIN_CASE(TL)                                                 \
  case TL:                                                                  \
    return dstd::launch_clustered(chain_kernel<TL, kEncoder, Rnd>, c, nblk, \
                                  N, bytes, stream);
    DSTD_CHAIN_CASE(1)
    DSTD_CHAIN_CASE(2)
    DSTD_CHAIN_CASE(3)
    DSTD_CHAIN_CASE(4)
    DSTD_CHAIN_CASE(5)
    DSTD_CHAIN_CASE(6)
    DSTD_CHAIN_CASE(7)
    DSTD_CHAIN_CASE(8)
#undef DSTD_CHAIN_CASE
  }
  return cudaErrorInvalidValue;
}

// One launch of the chain (kEncoder false: aff1, aff2 and prelu unused) or
// of the encoder, with contraction operands rounded by Rnd.
template <bool kEncoder, typename Rnd>
int run_chain(const float* x, const float* const* w, const float* aff1,
              const float* aff2, const float* prelu, float* out,
              float* scratch, int N, int T, int V, int C, int L, int Ks,
              int Kt, int R, int agg_left, int tile, int device,
              void* stream) {
  const size_t act = (size_t)N * T * V * C;
  ChainArgs c = {};
  c.x = x;
  c.out = out;
  c.mid = scratch;
  c.ping = scratch + act;
  c.s = Stack{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9]};
  c.t = Stack{w[10], w[11], w[12], w[13], w[14],
              w[15], w[16], w[17], w[18], w[19]};
  c.aff1 = aff1;
  c.aff2 = aff2;
  c.prelu = prelu;
  c.T = T;
  c.V = V;
  c.C = C;
  c.L = L;
  c.Ks = Ks;
  c.Kt = Kt;
  c.R = R;
  c.agg_left = agg_left;
  return (int)launch<kEncoder, Rnd>(c, N, tile, device, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Shared memory of one block at (T, V, C, Ks, Kt, R, tile), in bytes: the
// tensor-core body of the float32 and the bf16 chain kernel, then of the
// float32 and the bf16 encoder (the chain and the encoder of one element
// kind share a layout).
long long dstd_chain_smem_bytes(int T, int V, int C, int Ks, int Kt, int R,
                                int tile) {
  return mma_smem_bytes(T, V, C, Ks, Kt, R, tile, true);
}

long long dstd_chain_bf16_smem_bytes(int T, int V, int C, int Ks, int Kt,
                                     int R, int tile) {
  return mma_smem_bytes(T, V, C, Ks, Kt, R, tile, false);
}

long long dstd_encoder_chain_f32_smem_bytes(int T, int V, int C, int Ks,
                                            int Kt, int R, int tile) {
  return mma_smem_bytes(T, V, C, Ks, Kt, R, tile, true);
}

long long dstd_encoder_chain_bf16_smem_bytes(int T, int V, int C, int Ks,
                                             int Kt, int R, int tile) {
  return mma_smem_bytes(T, V, C, Ks, Kt, R, tile, false);
}

const char* dstd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// `w` holds the 20 stacked weights: the spatial op's (base, alpha, wf, bf,
// wm1, bm1, wm2, bm2, wrm, brm), then the temporal op's.  `scratch` holds
// 2 * N*T*V*C floats.  Launches on `stream`; returns the cudaError_t of the
// launch (0 = success).  x and out are float32 in every variant: _f32
// computes in float32, _bf16 rounds the operands of the four contractions
// of each op (x wqk, x wf, s wrm, adj xf) to bf16 and keeps everything else,
// the activation between ops included, in float32.
int dstd_chain_f32(const float* x, const float* const* w, float* out,
                   float* scratch, int N, int T, int V, int C, int L, int Ks,
                   int Kt, int R, int agg_left, int tile, int device,
                   void* stream) {
  return run_chain<false, dstd::Exact>(x, w, nullptr, nullptr, nullptr, out,
                                       scratch, N, T, V, C, L, Ks, Kt, R,
                                       agg_left, tile, device, stream);
}

int dstd_chain_bf16(const float* x, const float* const* w, float* out,
                    float* scratch, int N, int T, int V, int C, int L, int Ks,
                    int Kt, int R, int agg_left, int tile, int device,
                    void* stream) {
  return run_chain<false, dstd::Bf16>(x, w, nullptr, nullptr, nullptr, out,
                                      scratch, N, T, V, C, L, Ks, Kt, R,
                                      agg_left, tile, device, stream);
}

// As dstd_chain_f32, with each layer's two folded BatchNorm affines
// aff1, aff2 (L, 2, V, C) and PReLU slopes prelu (L, 2); the epilogues
// (affine, residual, PReLU) are float32 in both variants.
int dstd_encoder_chain_f32(const float* x, const float* const* w,
                           const float* aff1, const float* aff2,
                           const float* prelu, float* out, float* scratch,
                           int N, int T, int V, int C, int L, int Ks, int Kt,
                           int R, int agg_left, int tile, int device,
                           void* stream) {
  return run_chain<true, dstd::Exact>(x, w, aff1, aff2, prelu, out, scratch,
                                      N, T, V, C, L, Ks, Kt, R, agg_left,
                                      tile, device, stream);
}

int dstd_encoder_chain_bf16(const float* x, const float* const* w,
                            const float* aff1, const float* aff2,
                            const float* prelu, float* out, float* scratch,
                            int N, int T, int V, int C, int L, int Ks, int Kt,
                            int R, int agg_left, int tile, int device,
                            void* stream) {
  return run_chain<true, dstd::Bf16>(x, w, aff1, aff2, prelu, out, scratch,
                                     N, T, V, C, L, Ks, Kt, R, agg_left, tile,
                                     device, stream);
}

}  // extern "C"
