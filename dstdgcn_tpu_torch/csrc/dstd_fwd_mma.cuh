// The bf16 one-op DSTD-GC forward on Hopper's tensor cores: the body of
// dstd_spatial_bf16 and dstd_temporal_bf16 (the float32 kernels and the
// chain kernels keep the CUDA-core bodies of dstd_common.cuh).
//
// Contract: dstdgcn_tpu_torch/ops/dstd.py::kernel_spatial / kernel_temporal
// at bf16, the TPU kernels' compute dtype: the operands of the four
// contractions (x wqk, x wf, the scores s wrm, adj xf) rounded to bf16,
// products and sums in float32; q/k, the tanh, the mixing sums, the
// adjacency's affine and the output stay float32.
//
// The two ops are one body in the names of the mixing: for output "ref"
// index o (spatial: the frame t; temporal: the joint), source ref index s
// and pair indices i, j (spatial: joints v, w; temporal: frames t, u),
//   q/k[k,r,s,i] = x[row(s,i)] wqk[k,r] + bqk[k,r]
//   adj[k,o,i,j] = (sum_{r,s} tanh(q[k,r,s,i] - k[k,r,s,j]) wrm[k,r,s,o]
//                   + brm[k,o]) alpha + base[k,i,j]
//   right: out[row(o,j)] = sum_{k,i} adj[k,o,i,j] xf[k,row(o,i)]
//   left:  out[row(o,i)] = sum_{k,j} adj[k,o,i,j] xf[k,row(o,j)]
// with row(o,i) = o*V + i (spatial) or i*V + o (temporal), P the pair
// extent (V or T) and Q the ref extent (T or V).
//
// Design.  One block of 512 threads per (sample, tile of TILE output ref
// indices); the ceil(Q / TILE) blocks of a sample run as one thread-block
// cluster, two blocks to an SM (about 105 KB of shared memory and at most
// 64 registers each; one block to an SM measured 1.5x slower).  Every
// operand of a product is staged once in shared memory as bf16, the
// rounding the contract puts on it, and the feature projection, the
// mixing and the aggregation are mma.sync.m16n8k16 (bf16 in, float32
// accumulators) on fragments that ldmatrix reads: no conversion or edge
// test in a fragment, zeros in the padding of each operand instead.  Per
// block:
//  1. stage the tile's rows of x (the rows row(o, i) of its output ref
//     indices, all i; x comes as bf16, the wrapper's cast of a float32 x
//     being the contract's rounding), wqk and wf as bf16;
//  2. the q/k projection of those rows on the CUDA cores, each sum in the
//     order of the CUDA-core body and of the backward's q/k launch, and
//     the feature projection xf (batch K, N = Co) on the tensor cores,
//     both from the one staged x tile;
//  3. stage wrm (the mixing's B operand), base and brm, their loads in
//     flight while the cluster meets (barrier 1), then copy the other
//     blocks' q/k through distributed shared memory (DSMEM); the scores
//     once per sample: the pair rows (k, i, j) of the sample are split
//     over the cluster in 16-row tiles, and each block forms
//     bf16(tanh(q - k)) for its pair rows at every depth (r, s), one warp
//     a row (about 1/7 of the sample's scores at T = 35, tile 5, where the
//     CUDA-core body formed all of them in each block);
//  4. the mixing as a product: for its pair rows, all Q outputs o, depth
//     (r, s); the epilogue adds brm, scales by alpha, adds base and stores
//     the bf16 adjacency of its pair rows at every o;
//  5. after cluster barrier 2 each block gathers the adjacency of its own
//     output ref indices, all pairs, from the blocks that own them (DSMEM,
//     16 bytes a load), laid out as the A operand of its aggregation
//     (transposed for agg right), and arrives at cluster barrier 3;
//  6. the aggregation as a product per output ref index (batch), summed
//     over k: M = the P output pair indices, N = Co, depth the P source
//     pair indices; the float32 sums go to device memory; then the block
//     waits at barrier 3, so no block leaves while another reads its
//     shared memory.
// The order of every sum is fixed (no atomics): two calls give the same
// bits.  Row strides are multiples of 8 bf16 with an odd number of 16-byte
// chunks (ldm_stride), so the 8 rows of one ldmatrix phase hit 8 distinct
// bank groups.  Indices are split by a float reciprocal (Div), not by
// integer division, which cost the first version 2x in its elementwise
// loops.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dstd_common.cuh"
#include "dstd_mma.cuh"

namespace dstd_fwd {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using dstd::OpArgs;

// row stride (bf16 elements) of a staged operand with n columns: a multiple
// of 8 with an odd number of 16-byte chunks
__host__ __device__ constexpr int ldm_stride(int n) {
  return (((n + 7) >> 3) | 1) << 3;
}
__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr long long align16(long long bytes) {
  return (bytes + 15) & ~15LL;
}

// Sizes and shared-memory layout (byte offsets, 16-byte aligned) of one
// block of the bf16 forward of either op.  Regions: qk (float32, the whole
// sample's q/k, [K*2R][Q][P]), xf (bf16, [K][TILE*P rows + a zero row]
// [fs]), adjl (bf16, the block's pair rows' adjacency, [Q][lrows]) and one
// region `u` reused in turn by (x tile, wqk, wf) for step 2, (scores, wrm,
// base and brm) for steps 3-4 and the gathered adjacency ag for steps 5-6.
struct FwdLayout {
  int P, Q, K, R, J, Ci, Co, tile, nblk;
  int ci16, xs, j8, qs, co8, fs;          // projections
  int pp, mtk, mt, per, lrows, rq, rq16, ss, q8, ws;  // scores and mixing
  int p16, as;                            // aggregation
  long long qk, xf, adjl, u, x, wq, wf, s, w, ab, ag, total;
  __host__ __device__ FwdLayout(bool spatial, int T, int V, int Ci_, int Co_,
                                int K_, int R_, int tile_) {
    P = spatial ? V : T;
    Q = spatial ? T : V;
    K = K_;
    R = R_;
    J = K * 2 * R;
    Ci = Ci_;
    Co = Co_;
    tile = tile_;
    nblk = (Q + tile - 1) / tile;
    ci16 = pad16(Ci);
    xs = ldm_stride(ci16);
    j8 = pad8(J);
    qs = ldm_stride(j8);
    co8 = pad8(Co);
    fs = ldm_stride(co8);
    pp = P * P;
    mtk = (pp + 15) / 16;
    mt = K * mtk;
    per = (mt + nblk - 1) / nblk;
    lrows = per * 16;
    rq = R * Q;
    rq16 = pad16(rq);
    ss = ldm_stride(rq16);
    q8 = pad8(Q);
    ws = ldm_stride(q8);
    p16 = pad16(P);
    as = ldm_stride(p16);
    const long long rows = (long long)tile * P;  // + 1 zero row each
    qk = 0;
    xf = qk + align16(4LL * J * Q * P);
    adjl = xf + align16(2LL * (K * rows + 1) * fs);
    u = adjl + align16(2LL * Q * lrows);
    // step 2
    x = u;
    wq = x + align16(2LL * (rows + 1) * xs);
    wf = wq + align16(2LL * ci16 * qs);
    const long long end2 = wf + align16(2LL * K * ci16 * fs);
    // steps 3-4
    s = u;
    w = s + align16(2LL * lrows * ss);
    ab = w + align16(2LL * K * rq16 * ws);  // base, then brm (float32)
    const long long end3 = ab + align16(4LL * K * (pp + Q));
    // steps 5-6
    ag = u;
    const long long end5 = ag + align16(2LL * (K * rows + 1) * as);
    total = end2 > end3 ? end2 : end3;
    total = total > end5 ? total : end5;
  }
};

// n / d for 0 <= n < 2^22 in four instructions (the elementwise loops
// would otherwise spend most of their time in integer divisions): the
// quotient (n + 1/2) / d lies at least 1/(2d) from an integer, and the
// float product errs by less than that below 2^22
struct Div {
  int d;
  float inv;
  __device__ explicit Div(int d_) : d(d_), inv(1.f / d_) {}
  __device__ int operator()(int n) const {
    return __float2int_rz(((float)n + 0.5f) * inv);
  }
};

// four floats as bf16 at p (8-byte aligned)
__device__ inline void store_bf16x4(bf16* p, const float4& v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ldmatrix: four 8x8 bf16 matrices (lanes 8m..8m+7 give the rows of matrix
// m), as the A fragment of m16n8k16 from a row-major 16x16 tile
__device__ inline void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same transposed: B fragments of two n8 tiles from a row-major
// (depth x n) 16x16 tile
__device__ inline void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two transposed matrices (lanes 0-15 give the rows): the B fragment of
// one n8 tile
__device__ inline void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ inline void barrier_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ inline void barrier_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// C[b] (+)= sum_{s < S, depth < 16 ksteps} A[b,s] B[b,s] on the tensor
// cores, the warps of the block walking over (b, 16-row tile, group of NT
// n8 tiles).  a_row(b, s, m) points at row m of A[b,s] (bf16, depth
// contiguous, zeros past its depth; a row past M points at a zero row);
// b_row(b, s, d) at row d of B[b,s] (bf16, n contiguous); st(b, m, n, v0,
// v1) stores columns n and n + 1 of row m (m may lie past M, n + 1 past
// N).  n8: the n8 tiles of N.
template <int NT, typename ARow, typename BRow, typename Store>
__device__ inline void block_mma(int batch, int mtiles, int n8, int S,
                                 int ksteps, ARow a_row, BRow b_row,
                                 Store st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int groups = (n8 + NT - 1) / NT, per = mtiles * groups;
  const int lrow = lane & 15, lcol = (lane >> 4) << 3;
  for (int task = warp; task < batch * per; task += warps) {
    const int b = task / per, rem = task - b * per;
    const int mt = rem / groups, m0 = mt << 4;
    const int n0 = (rem - mt * groups) * NT * 8;
    const int live = min(NT, n8 - (n0 >> 3));
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int s = 0; s < S; ++s) {
      const bf16* arow = a_row(b, s, m0 + lrow) + lcol;
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, arow + ks * 16);
        const bf16* brow = b_row(b, s, ks * 16 + lrow) + n0;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          if (j + 1 < live) {
            uint32_t bq[4];
            ldsm_x4_t(bq, brow + 8 * j + lcol);
            const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
            dstd_mma::mma_bf16(acc[j], af, b0);
            dstd_mma::mma_bf16(acc[j + 1], af, b1);
          } else if (j < live) {
            uint32_t bq[2];
            ldsm_x2_t(bq, brow + 8 * j);
            dstd_mma::mma_bf16(acc[j], af, bq);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < live) {
        const int c = n0 + 8 * j + 2 * t;
        st(b, m0 + g, c, acc[j][0], acc[j][1]);
        st(b, m0 + g + 8, c, acc[j][2], acc[j][3]);
      }
    }
  }
}

// One block's share of the bf16 op (spatial: kSpatial, the output frames
// [o0, o0 + on) of sample n; temporal: its output joints), as the file
// header describes.  Every thread of every block of the cluster runs every
// barrier.
template <bool kSpatial, int TILE>
__device__ void op_bf16(const OpArgs& a, char* smem, int n, int o0, int on) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int T = a.T, V = a.V;
  const FwdLayout L(kSpatial, T, V, a.Ci, a.Co, a.K, a.R, TILE);
  const int P = L.P, Q = L.Q, K = L.K, R = L.R, J = L.J, Ci = L.Ci,
            Co = L.Co;
  float* qk = reinterpret_cast<float*>(smem + L.qk);
  bf16* xf = reinterpret_cast<bf16*>(smem + L.xf);
  bf16* adjl = reinterpret_cast<bf16*>(smem + L.adjl);
  bf16* xt = reinterpret_cast<bf16*>(smem + L.x);
  bf16* wq = reinterpret_cast<bf16*>(smem + L.wq);
  bf16* wf = reinterpret_cast<bf16*>(smem + L.wf);
  bf16* sc = reinterpret_cast<bf16*>(smem + L.s);
  bf16* wm = reinterpret_cast<bf16*>(smem + L.w);
  float* base = reinterpret_cast<float*>(smem + L.ab);  // then brm
  bf16* ag = reinterpret_cast<bf16*>(smem + L.ag);
  const int rows = on * P;           // the tile's rows of x
  const int zx = TILE * P;           // the zero row of the x tile
  const int zf = K * TILE * P;       // the zero row of xf (and of ag)
  // x comes as bf16 (the rounding the contract puts on it)
  const bf16* xn = reinterpret_cast<const bf16*>(a.x) + (size_t)n * T * V * Ci;
  const bf16 zero = __float2bfloat16_rn(0.f);
  // device row of x (and of out) of output ref index o, pair index i
  auto grow = [V](int o, int i) { return kSpatial ? o * V + i : i * V + o; };

  // 1. stage the x tile, wqk and wf as bf16, zeros in the padding
  const Div div_p(P);
  if ((Ci & 3) == 0) {  // 8-byte loads of 4 channels
    const int c4 = L.ci16 >> 2;
    const Div div_c4(c4);
#pragma unroll 4
    for (int e = threadIdx.x; e < (rows + 1) * c4; e += blockDim.x) {
      const int lr = div_c4(e), c = (e - lr * c4) << 2;
      uint2 v = make_uint2(0u, 0u);
      if (lr < rows && c < Ci) {
        const int ol = div_p(lr);
        v = __ldg(reinterpret_cast<const uint2*>(
            xn + (size_t)grow(o0 + ol, lr - ol * P) * Ci + c));
      }
      *reinterpret_cast<uint2*>(xt + (lr < rows ? lr : zx) * L.xs + c) = v;
    }
  } else {
    const Div div_c(L.ci16);
    for (int e = threadIdx.x; e < (rows + 1) * L.ci16; e += blockDim.x) {
      const int lr = div_c(e), c = e - lr * L.ci16;
      bf16 v = zero;
      if (lr < rows && c < Ci) {
        const int ol = div_p(lr);
        v = xn[(size_t)grow(o0 + ol, lr - ol * P) * Ci + c];
      }
      xt[(lr < rows ? lr : zx) * L.xs + c] = v;
    }
  }
  for (int e = threadIdx.x; e < L.ci16 * L.j8; e += blockDim.x) {
    const int ci = e / L.j8, jj = e - ci * L.j8;
    float v = 0.f;
    if (ci < Ci && jj < J) {
      const int k = jj / (2 * R), jr = jj - k * 2 * R;
      v = jr < R ? __ldg(a.wm1 + (k * Ci + ci) * R + jr)
                 : __ldg(a.wm2 + (k * Ci + ci) * R + jr - R);
    }
    wq[ci * L.qs + jj] = __float2bfloat16_rn(v);
  }
  const Div div_ci(L.ci16);
  if ((Co & 3) == 0) {  // float4 loads
    const int c4 = L.co8 >> 2;
    const Div div_c4(c4);
#pragma unroll 4
    for (int e = threadIdx.x; e < K * L.ci16 * c4; e += blockDim.x) {
      const int kc = div_c4(e), c = (e - kc * c4) << 2;
      const int k = div_ci(kc), ci = kc - k * L.ci16;
      const float4 v =
          ci < Ci && c < Co
              ? __ldg(reinterpret_cast<const float4*>(
                    a.wf + ((size_t)k * Ci + ci) * Co + c))
              : make_float4(0.f, 0.f, 0.f, 0.f);
      store_bf16x4(wf + kc * L.fs + c, v);
    }
  } else {
    const Div div_c(L.co8);
    for (int e = threadIdx.x; e < K * L.ci16 * L.co8; e += blockDim.x) {
      const int kc = div_c(e), c = e - kc * L.co8;
      const int k = div_ci(kc), ci = kc - k * L.ci16;
      const float v = ci < Ci && c < Co
                          ? __ldg(a.wf + ((size_t)k * Ci + ci) * Co + c)
                          : 0.f;
      wf[kc * L.fs + c] = __float2bfloat16_rn(v);
    }
  }
  for (int c = threadIdx.x; c < L.fs; c += blockDim.x) xf[zf * L.fs + c] = zero;
  __syncthreads();

  // 2. q/k of the tile's rows (float32, into the sample's q/k at slot
  // (s = o, i)) and the tile's features (bf16), from the one x tile
  const int mrows = (rows + 15) >> 4, ksx = L.ci16 >> 4;
  auto x_row = [&](int, int, int m) {
    return xt + (m < rows ? m : zx) * L.xs;
  };
  // q/k on the CUDA cores, each sum over ci in order, as the CUDA-core
  // body (and the backward's q/k launch) forms it: q/k feed the tanh, and
  // a score whose bf16 rounding flips moves the adjacency; summed on the
  // tensor cores they lay one card test's forward 1.8e-3 from the float64
  // run of the contract, where the plain contract lies 5e-8 (PERF.md)
  {
    const Div div_j(J);
    for (int e = threadIdx.x; e < rows * J; e += blockDim.x) {
      const int m = div_j(e), j = e - m * J;
      const int k = j / (2 * R), jr = j - k * 2 * R;
      const bf16* xr = xt + m * L.xs;
      float acc = 0.f;
      for (int ci = 0; ci < Ci; ++ci)
        acc = fmaf(__bfloat162float(xr[ci]),
                   __bfloat162float(wq[ci * L.qs + j]), acc);
      qk[j * Q * P + o0 * P + m] =
          acc + (jr < R ? __ldg(a.bm1 + k * R + jr)
                        : __ldg(a.bm2 + k * R + jr - R));
    }
  }
  block_mma<4>(
      K, mrows, L.co8 >> 3, 1, ksx, x_row,
      [&](int k, int, int d) { return wf + (k * L.ci16 + d) * L.fs; },
      [&](int k, int m, int c, float v0, float v1) {
        if (m >= rows) return;
        const float b0 = c < Co ? __ldg(a.bf + k * Co + c) : 0.f;
        const float b1 = c + 1 < Co ? __ldg(a.bf + k * Co + c + 1) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(xf + (k * TILE * P + m) * L.fs +
                                           c) =
            __floats2bfloat162_rn(c < Co ? v0 + b0 : 0.f,
                                  c + 1 < Co ? v1 + b1 : 0.f);
      });
  __syncthreads();  // the x tile and the weights are dead (u is reused)

  // 3. wrm as the mixing's B operand [k][(r, s)][o], base and brm (their
  // loads in flight while the cluster meets); the sample's q/k; the
  // block's pair rows of the scores, bf16(tanh(q - k)) at every depth
  // (r, s)
  const Div div_rq16(L.rq16), div_mtk16(L.mtk * 16);
  {
    const Div div_q8(L.q8);
#pragma unroll 4
    for (int e = threadIdx.x; e < K * L.rq16 * L.q8; e += blockDim.x) {
      const int kd = div_q8(e), o = e - kd * L.q8;
      const int k = div_rq16(kd), d = kd - k * L.rq16;
      const float v =
          d < L.rq && o < Q ? __ldg(a.wrm + ((size_t)k * L.rq + d) * Q + o)
                            : 0.f;
      wm[kd * L.ws + o] = __float2bfloat16_rn(v);
    }
#pragma unroll 4
    for (int e = threadIdx.x; e < K * (L.pp + Q); e += blockDim.x)
      base[e] = e < K * L.pp ? __ldg(a.base + e) : __ldg(a.brm + e - K * L.pp);
  }
  cluster.sync();  // every block's q/k share is written
  {
    // every slot of the other blocks' shares, all loads of a thread in
    // flight together
    const Div div_qp(Q * P), div_tp(TILE * P);
#pragma unroll 4
    for (int e = threadIdx.x; e < J * Q * P; e += blockDim.x) {
      const int j = div_qp(e), owner = div_tp(e - j * Q * P);
      if (owner != rank) qk[e] = cluster.map_shared_rank(qk, owner)[e];
    }
  }
  __syncthreads();
  // one warp per pair row (k, i, j), the lanes over the depth d = r Q + s:
  // q[k, r, s, i] is qk[(k 2R Q + d) P + i], k[k, r, s, j] is
  // qk[((k 2R + R) Q + d) P + j]
  const int mt0 = rank * L.per;
  const int mine = max(0, min(L.per, L.mt - mt0));  // the block's m tiles
  {
    const int lane = threadIdx.x & 31;
    for (int lr = threadIdx.x >> 5; lr < mine * 16; lr += blockDim.x >> 5) {
      const int prow = mt0 * 16 + lr;
      const int k = div_mtk16(prow), p = prow - k * L.mtk * 16;
      const int i = div_p(p), j = p - i * P;
      const float* q = qk + k * 2 * R * Q * P + i;
      const float* kk = qk + (k * 2 * R + R) * Q * P + j;
      for (int d = lane; d < L.rq16; d += 32) {
        const float v =
            p < L.pp && d < L.rq ? tanhf(q[d * P] - kk[d * P]) : 0.f;
        sc[lr * L.ss + d] = __float2bfloat16_rn(v);
      }
    }
  }
  __syncthreads();

  // 4. the mixing: per 16-row tile of pair rows (batch), all outputs o,
  // depth (r, s); the epilogue stores bf16((dyn + brm) alpha + base)
  const float alpha = __ldg(a.alpha);
  auto mixed = [&](int lr, int o, float dyn) {
    const int prow = mt0 * 16 + lr;
    const int k = div_mtk16(prow), p = prow - k * L.mtk * 16;
    if (p < L.pp && o < Q)
      adjl[o * L.lrows + lr] = __float2bfloat16_rn(
          (dyn + base[K * L.pp + k * Q + o]) * alpha + base[k * L.pp + p]);
  };
  block_mma<1>(
      mine, 1, L.q8 >> 3, 1, L.rq16 >> 4,
      [&](int b, int, int m) { return sc + (b * 16 + m) * L.ss; },
      [&](int b, int, int d) {
        const int k = (mt0 + b) / L.mtk;
        return wm + (k * L.rq16 + d) * L.ws;
      },
      [&](int b, int m, int o, float v0, float v1) {
        mixed(b * 16 + m, o, v0);
        mixed(b * 16 + m, o + 1, v1);
      });
  // every block's adjacency rows are written (and no block reads q/k of
  // another any more)
  cluster.sync();

  // 5. gather the adjacency of the tile's outputs as the aggregation's A
  // operand: ag[k][o - o0][m][d] = adj[k, o, d, m] (right) or
  // adj[k, o, m, d] (left), zeros past P in d and a zero row
  // (8 pair rows of one owner, one k, a 16-byte load a thread)
  const bool left = a.agg_left != 0;
  {
    const int chunks = K * L.mtk * 2;
    const Div div_chunks(chunks), div_per(L.per);
#pragma unroll 2
    for (int e = threadIdx.x; e < on * chunks; e += blockDim.x) {
      const int ol = div_chunks(e), prow0 = (e - ol * chunks) << 3;
      const int owner = div_per(prow0 >> 4);
      const uint4 raw = *reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(adjl, owner) + (o0 + ol) * L.lrows + prow0 -
          owner * L.lrows);
      const bf16* val = reinterpret_cast<const bf16*>(&raw);
      const int k = div_mtk16(prow0), p0 = prow0 - k * L.mtk * 16;
      bf16* dst = ag + (k * TILE + ol) * P * L.as;
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int p = p0 + h;
        if (p < L.pp) {
          const int i = div_p(p), j = p - i * P;
          dst[(left ? i * L.as + j : j * L.as + i)] = val[h];
        }
      }
    }
  }
  // zeros past P in d (every row), and the zero row
  for (int e = threadIdx.x; e < K * TILE * P * (L.p16 - P); e += blockDim.x) {
    const int row = e / (L.p16 - P);
    ag[row * L.as + P + e - row * (L.p16 - P)] = zero;
  }
  for (int d = threadIdx.x; d < L.as; d += blockDim.x) ag[zf * L.as + d] = zero;
  barrier_arrive();  // done reading the other blocks' shared memory
  __syncthreads();

  // 6. the aggregation per output ref index (batch), summed over k
  float* outn = a.out + (size_t)n * T * V * Co;
  const bool pairs = (Co & 1) == 0;
  block_mma<4>(
      on, (P + 15) >> 4, L.co8 >> 3, K, L.p16 >> 4,
      [&](int ol, int k, int m) {
        return ag + (m < P ? (k * TILE + ol) * P + m : zf) * L.as;
      },
      [&](int ol, int k, int d) {
        return xf + (d < P ? k * TILE * P + ol * P + d : zf) * L.fs;
      },
      [&](int ol, int m, int c, float v0, float v1) {
        if (m >= P || c >= Co) return;
        float* dst = outn + (size_t)grow(o0 + ol, m) * Co + c;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (c + 1 < Co) dst[1] = v1;
        }
      });
  barrier_wait();
}

}  // namespace dstd_fwd
