// The DSTD-GC forward op on Hopper's tensor cores, one body templated on
// the element kind of its products: float64 (F64Mma, below) for the
// float32 one-op kernels dstd_spatial_f32 and dstd_temporal_f32, 3xTF32
// (dstd_mma::Tf32x3Mma) for the ten ops of dstd_encoder_chain_f32 and of
// dstd_chain_f32 (dstd_chain.cu), bf16 (dstd_mma::Bf16Mma) for
// dstd_spatial_bf16, dstd_temporal_bf16 and the ten ops of
// dstd_encoder_chain_bf16 and of dstd_chain_bf16.
//
// Contract: dstdgcn_tpu_torch/ops/dstd.py::kernel_spatial / kernel_temporal
// with the kernel's dtype.  At bf16, the TPU kernels' compute dtype, the
// operands of the four contractions (x wqk, x wf, the scores s wrm, adj xf)
// are rounded to bf16, products and sums in float32; q/k, the tanh, the
// mixing sums, the adjacency's affine and the output stay float32.  At
// float32 nothing is rounded: the products run in float64 or as 3xTF32,
// float32-accurate (tests/test_torch_tf32x3.py), in another order than the
// plain op's sums.
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
// Design.  One block of 512 threads per (sample, tile of `tile` output ref
// indices); the blocks of a sample run as one thread-block cluster of
// nblk blocks (the one-op kernels: ceil(Q / tile); the chain kernels:
// their own cluster of ceil(max(T, V) / TILE), where a rank may own no output
// index and still forms its share of the scores and meets every barrier).
// Every operand of a product is staged once in shared memory in the
// kind's element (bf16, or float32 split into TF32 halves when a fragment
// is built), and the feature projection, the mixing and the aggregation
// are mma.sync (bf16: m16n8k16; 3xTF32: three m16n8k8 .tf32 a step) with
// float32 accumulators on fragments that ldmatrix reads: no conversion or
// edge test in a fragment, zeros in the padding of each operand instead.
// ldmatrix moves 16-bit elements: an A fragment of either kind (16 rows,
// 32 bytes of depth) is four 8 x 16-byte matrices, so it reads float32
// rows as pairs of b16 halves unchanged; a B fragment of bf16 is read
// transposed from a (depth x n) operand, which would split the halves of
// a float, so the 3xTF32 kind stages its B operands (wf, wrm, xf) as
// (n x depth) and reads them untransposed, one instruction for two n8
// tiles as at bf16.  Per block:
//  1. stage the tile's rows of x (the rows row(o, i) of its output ref
//     indices, all i; the bf16 one-op kernels read x as bf16, the wrapper's
//     cast of a float32 x being the contract's rounding; the chain rounds
//     its float32 activation here, where the contract rounds it), wqk and
//     wf;
//  2. the q/k projection of those rows on the CUDA cores, each sum in the
//     order of the backward's q/k launch, and
//     the feature projection xf (batch K, N = Co) on the tensor cores,
//     both from the one staged x tile;
//  3. stage wrm (the mixing's B operand), base and brm, their loads in
//     flight while the cluster meets (barrier 1), then copy the other
//     blocks' q/k through distributed shared memory (DSMEM); the scores
//     once per sample: the pair rows (k, i, j) of the sample are split
//     over the cluster in 16-row tiles, and each block forms
//     tanh(q - k) for its pair rows at every depth (r, s), one warp a row
//     (about 1/7 of the sample's scores at T = 35, tile 5, where the
//     retired CUDA-core body formed all of them in each block);
//  4. the mixing as a product: for its pair rows, all Q outputs o, depth
//     (r, s); the epilogue adds brm, scales by alpha, adds base and stores
//     the adjacency of its pair rows at every o;
//  5. after cluster barrier 2 each block gathers the adjacency of its own
//     output ref indices, all pairs, from the blocks that own them (DSMEM,
//     16 bytes a load), laid out as the A operand of its aggregation
//     (transposed for agg right), and arrives at cluster barrier 3;
//  6. the aggregation as a product per output ref index (batch), summed
//     over k: M = the P output pair indices, N = Co, depth the P source
//     pair indices; the float32 sums go through the caller's store (the
//     one-op kernels and the chains: device memory; the encoder: its
//     affine, residual and PReLU); then the block waits at barrier 3, so
//     no block leaves while another reads its shared memory.
// The order of every sum is fixed (no atomics): two calls give the same
// bits.  Row strides are multiples of 16 bytes with an odd number of
// 16-byte chunks (ldm_stride), so the 8 rows of one ldmatrix phase hit 8
// distinct bank groups.  Indices are split by a float reciprocal (Div),
// not by integer division, which cost the first version 2x in its
// elementwise loops.  At float32 every staged operand takes 4 bytes, and
// the bf16 order of the steps would need 184 KB at T = 35, V = 22,
// 64->64, tile 5 (one block to an SM; measured 1.15x the CUDA-core body
// it replaces, PERF.md): there the scores are formed in the mixing's
// fragments and the features projected one group of output channels at a
// time after the gather (FwdLayout), 101 KB, two blocks to an SM.  The
// bf16 kernels keep their own order: the float32 order at bf16 matched
// their errors to the last digit but measured 1b 1.13x and 2b 1.03x
// slower (4b 0.92x; PERF.md).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "dstd_common.cuh"
#include "dstd_mma.cuh"

namespace dstd_fwd {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using dstd::OpArgs;
using dstd_mma::Bf16Mma;
using dstd_mma::Tf32x3Mma;

// The third element kind: float32 operands staged and read as for 3xTF32,
// each m16n8k8 step as four float64 tensor-core products (DMMA, mma.sync
// m8n8k4 .f64) summed in float64 accumulators, rounded to float32 once at
// the store.  Its A fragment is the float32 bits as ldmatrix reads them.
struct F64Mma {
  struct A {
    uint32_t r[4];
  };
  __device__ static A a_bits(const uint32_t (&r)[4]) {
    return {{r[0], r[1], r[2], r[3]}};
  }
};

// The kinds that stage their operands as float32 (FwdLayout's f32), and
// the accumulator of a kind
template <typename Mma>
constexpr bool kStagedF32 =
    std::is_same_v<Mma, Tf32x3Mma> || std::is_same_v<Mma, F64Mma>;
template <typename Mma>
using AccOf = std::conditional_t<std::is_same_v<Mma, F64Mma>, double, float>;

// The staged element of an element kind and the depth of one mma step
// (32 bytes of an operand row in both)
template <typename Mma>
struct Elem;
template <>
struct Elem<Bf16Mma> {
  using E = bf16;
  static constexpr int kStep = 16;
};
template <>
struct Elem<Tf32x3Mma> {
  using E = float;
  static constexpr int kStep = 8;
};
template <>
struct Elem<F64Mma> : Elem<Tf32x3Mma> {};

__device__ inline float tof(bf16 v) { return __bfloat162float(v); }
__device__ inline float tof(float v) { return v; }
template <typename E>
__device__ inline E cvt(float v) {
  if constexpr (std::is_same_v<E, bf16>)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// row stride (elements of es bytes) of a staged operand with n columns: a
// multiple of 16 bytes with an odd number of 16-byte chunks
__host__ __device__ constexpr int ldm_stride(int n, int es = 2) {
  return (((n + 16 / es - 1) / (16 / es)) | 1) * (16 / es);
}
__host__ __device__ constexpr int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr long long align16(long long bytes) {
  return (bytes + 15) & ~15LL;
}

// Sizes and shared-memory layout (byte offsets, 16-byte aligned) of one
// block of the forward of either op, for the bf16 kind or (f32) the kinds
// that stage float32 (3xTF32, float64).
// `tile`: the output ref indices a block owns; nblk: the blocks of the
// cluster.  Depths are padded to the kind's step (kd: 16 or 8).
//
// bf16: qk (float32, the whole sample's q/k, [K*2R][Q][P]), xf (the tile's
// features, [K][tile*P rows + a zero row][fs]), adjl (the block's pair
// rows' adjacency, [Q][lrows]) and one region `u` reused in turn by (x
// tile, wqk, wf [k][ci][co]) for step 2, (scores, wrm [k][(r,s)][o], base
// and brm) for steps 3-4 and the gathered adjacency ag for steps 5-6.
//
// float32 holds fewer regions at once, so that two blocks share an SM
// (101 KB at T = 35, V = 22, 64->64, tile 5, where the bf16 regions at 4
// bytes would take 184 KB): adjl and the x tile live throughout; `u`
// holds in turn (qk, wqk) for steps 1-2, (qk, wrm [k][o][(r,s)], base and
// brm) for steps 3-4 and (ag, one group of gw output channels' wf
// [k][c][ci] and xf [k][tile][c][fs]) for steps 5-6.  The scores are not
// staged: the mixing forms them in its A fragments.  A B operand is
// staged (n x depth).
struct FwdLayout {
  int P, Q, K, R, J, Ci, Co, tile, nblk, es, kd;
  int cik, xs, j8, qs, co8, gw, fs, wfs;  // projections
  int pp, mtk, mt, per, lrows, rq, rqk, ss, q8, ws;  // scores and mixing
  int pk, as;                             // aggregation
  long long qk, xf, adjl, u, x, wq, wf, s, w, ab, ag, total;
  __host__ __device__ FwdLayout(bool spatial, int T, int V, int Ci_, int Co_,
                                int K_, int R_, int tile_, int nblk_,
                                bool f32) {
    P = spatial ? V : T;
    Q = spatial ? T : V;
    K = K_;
    R = R_;
    J = K * 2 * R;
    Ci = Ci_;
    Co = Co_;
    tile = tile_;
    nblk = nblk_;
    es = f32 ? 4 : 2;
    kd = f32 ? 8 : 16;
    cik = (Ci + kd - 1) / kd * kd;
    xs = ldm_stride(cik, es);
    j8 = pad8(J);
    qs = ldm_stride(j8, es);
    co8 = pad8(Co);
    gw = co8 < 16 ? co8 : 16;
    pp = P * P;
    mtk = (pp + 15) / 16;
    mt = K * mtk;
    per = (mt + nblk - 1) / nblk;
    lrows = per * 16;
    rq = R * Q;
    rqk = (rq + kd - 1) / kd * kd;
    ss = ldm_stride(rqk, es);
    q8 = pad8(Q);
    pk = (P + kd - 1) / kd * kd;
    as = ldm_stride(pk, es);
    fs = f32 ? ldm_stride(pk, es) : ldm_stride(co8, es);
    wfs = f32 ? ldm_stride(cik, es) : fs;
    ws = f32 ? ldm_stride(rqk, es) : ldm_stride(q8, es);
    const long long rows = (long long)tile * P;  // + 1 zero row each
    long long end2, end3, end5;
    if (f32) {
      adjl = 0;
      x = adjl + align16(4LL * Q * lrows);
      u = x + align16(4 * (rows + 1) * xs);
      qk = u;
      // steps 1-2
      wq = qk + align16(4LL * J * Q * P);
      end2 = wq + align16(4LL * cik * qs);
      // steps 3-4
      s = u;
      w = wq;
      ab = w + align16(4LL * K * q8 * ws);
      end3 = ab + align16(4LL * K * (pp + Q));
      // steps 5-6
      ag = u;
      wf = ag + align16(4 * (K * rows + 1) * as);
      xf = wf + align16(4LL * K * gw * wfs);
      end5 = xf + align16(4LL * K * tile * gw * fs);
    } else {
      qk = 0;
      xf = qk + align16(4LL * J * Q * P);
      adjl = xf + align16(2 * (K * rows + 1) * fs);
      u = adjl + align16(2LL * Q * lrows);
      // step 2
      x = u;
      wq = x + align16(2 * (rows + 1) * xs);
      wf = wq + align16(2LL * cik * qs);
      end2 = wf + align16(2LL * K * cik * wfs);
      // steps 3-4
      s = u;
      w = s + align16(2LL * lrows * ss);
      ab = w + align16(2LL * K * rqk * ws);
      end3 = ab + align16(4LL * K * (pp + Q));
      // steps 5-6
      ag = u;
      end5 = ag + align16(2 * (K * rows + 1) * as);
    }
    total = end2 > end3 ? end2 : end3;
    total = total > end5 ? total : end5;
  }
};

// The layout of a one-op kernel's block: its sample's ceil(Q / tile)
// blocks form the cluster.
__host__ __device__ inline FwdLayout op_layout(bool spatial, int T, int V,
                                               int Ci, int Co, int K, int R,
                                               int tile, bool f32) {
  const int Q = spatial ? T : V;
  return FwdLayout(spatial, T, V, Ci, Co, K, R, tile, (Q + tile - 1) / tile,
                   f32);
}

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

// four floats as bf16 at p (8-byte aligned), or as they are (16-byte
// aligned)
__device__ inline void store4(bf16* p, const float4& v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ inline void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

// ldmatrix (dstd_mma.cuh)
using dstd_mma::ldsm_x2;
using dstd_mma::ldsm_x2_t;
using dstd_mma::ldsm_x4;
using dstd_mma::ldsm_x4_t;

__device__ inline void barrier_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ inline void barrier_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The one-op kernels' store of two output channels c, c + 1 (c + 1 may
// lie past Co) of device row `row`; `out` is the sample's (T*V, Co) block.
struct PairStore {
  float* out;
  int Co;
  __device__ void put2(int row, int, int c, float v0, float v1) const {
    float* dst = out + (size_t)row * Co + c;
    if ((Co & 1) == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      dst[0] = v0;
      if (c + 1 < Co) dst[1] = v1;
    }
  }
};

// The tensor cores add into their float32 accumulator with truncation
// (round toward zero) at every mma, relative to the accumulator's size:
// summed across the depth that bias grows with the number of steps (1e-6
// of the peak at 3xTF32, four times the plain op's distance from float64;
// in the bf16 encoder a rounding of xf or the adjacency to bf16 flipped
// where the plain op's round-to-nearest sums do not; PERF.md).  So with
// kStepAcc each depth step's products go into a zeroed accumulator
// (truncated relative to that step alone) and are added to the running
// sum on the CUDA cores, rounded to nearest: always at 3xTF32, and in the
// chain kernels at bf16 (the bf16 one-op kernels keep the accumulation
// they were measured and tested with).
__device__ inline void add4(float (&acc)[4], const float (&step)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += step[i];
}
template <bool kStepAcc>
__device__ inline void mma_step(float (&acc)[4], const uint32_t (&a)[4],
                                const uint32_t (&b)[2]) {
  if constexpr (kStepAcc) {
    float step[4] = {0.f, 0.f, 0.f, 0.f};
    dstd_mma::mma_bf16(step, a, b);
    add4(acc, step);
  } else {
    dstd_mma::mma_bf16(acc, a, b);
  }
}
__device__ inline void mma_step(float (&acc)[4], const Tf32x3Mma::A& a,
                                const uint32_t (&b)[2]) {
  float step[4] = {0.f, 0.f, 0.f, 0.f};
  Tf32x3Mma::mma_bits(step, a, b);
  add4(acc, step);
}

// d (8 x 8, float64) += a (8 x 4) b (4 x 8): a lane holds a[g][t], b[t][g]
// and d[g][2t], d[g][2t + 1] (g = lane / 4, t = lane % 4)
__device__ inline void mma_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}
// One m16n8k8 step in float64: the m16n8k8 fragments (a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g))
// as four m8n8k4 products into the rows g and g + 8 of acc
__device__ inline void mma_step(double (&acc)[4], const F64Mma::A& a,
                                const uint32_t (&b)[2]) {
  const double b0 = __uint_as_float(b[0]), b1 = __uint_as_float(b[1]);
  double lo[2] = {acc[0], acc[1]}, hi[2] = {acc[2], acc[3]};
  mma_f64(lo, __uint_as_float(a.r[0]), b0);
  mma_f64(lo, __uint_as_float(a.r[2]), b1);
  mma_f64(hi, __uint_as_float(a.r[1]), b0);
  mma_f64(hi, __uint_as_float(a.r[3]), b1);
  acc[0] = lo[0];
  acc[1] = lo[1];
  acc[2] = hi[0];
  acc[3] = hi[1];
}

// acc[j] += A B_j in a float32-staged kind (3xTF32 or float64) for the
// live of NT n8 tiles B_j at columns n0 + 8j, depth step ks: B staged
// (n x depth), b_col(r) pointing at its column r; two tiles a ldmatrix.x4
// (lanes 0-7 and 16-23 the columns of depths 0-3, lanes 8-15 and 24-31 of
// depths 4-7).
template <int NT, typename Acc, typename AFrag, typename BCol>
__device__ inline void f32_tiles(Acc (&acc)[NT][4], const AFrag& a3,
                                 BCol b_col, int n0, int ks, int live) {
  const int lane = threadIdx.x & 31;
  const int bn = (lane & 7) + ((lane >> 4) << 3), bd = ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    if (j + 1 < live) {
      uint32_t bq[4];
      ldsm_x4(bq, b_col(n0 + 8 * j + bn) + ks * 8 + bd);
      const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
      mma_step(acc[j], a3, b0);
      mma_step(acc[j + 1], a3, b1);
    } else if (j < live) {
      uint32_t bq[2];
      ldsm_x2(bq, b_col(n0 + 8 * j + (lane & 7)) + ks * 8 + bd);
      mma_step(acc[j], a3, bq);
    }
  }
}

// C[b] (+)= sum_{s < S, depth < kStep ksteps} A[b,s] B[b,s] on the tensor
// cores in products of kind Mma, the warps of the block walking over (b,
// 16-row tile, group of NT n8 tiles).  a_row(b, s, m) points at row m of
// A[b,s] (depth contiguous, zeros past its depth; a row past M points at a
// zero row); b_row(b, s, r) at row r of B[b,s] as staged: at bf16 the
// depth r (n contiguous), at 3xTF32 the column r (depth contiguous).
// st(b, m, n, v0, v1) stores columns n and n + 1 of row m (m may lie past
// M, n + 1 past N).  n8: the n8 tiles of N.
template <typename Mma, int NT, bool kStepAcc = false, typename ARow,
          typename BRow, typename Store>
__device__ inline void block_mma(int batch, int mtiles, int n8, int S,
                                 int ksteps, ARow a_row, BRow b_row,
                                 Store st) {
  using E = typename Elem<Mma>::E;
  constexpr int kd = Elem<Mma>::kStep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int groups = (n8 + NT - 1) / NT, per = mtiles * groups;
  // a lane's row of a 16-row tile and its 16-byte half
  const int lrow = lane & 15, lcol = (lane >> 4) * (16 / (int)sizeof(E));
  for (int task = warp; task < batch * per; task += warps) {
    const int b = task / per, rem = task - b * per;
    const int mt = rem / groups, m0 = mt << 4;
    const int n0 = (rem - mt * groups) * NT * 8;
    const int live = min(NT, n8 - (n0 >> 3));
    AccOf<Mma> acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int s = 0; s < S; ++s) {
      const E* arow = a_row(b, s, m0 + lrow) + lcol;
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, arow + ks * kd);
        if constexpr (std::is_same_v<Mma, Bf16Mma>) {
          const E* brow = b_row(b, s, ks * 16 + lrow) + n0;
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            if (j + 1 < live) {
              uint32_t bq[4];
              ldsm_x4_t(bq, brow + 8 * j + lcol);
              const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
              mma_step<kStepAcc>(acc[j], af, b0);
              mma_step<kStepAcc>(acc[j + 1], af, b1);
            } else if (j < live) {
              uint32_t bq[2];
              ldsm_x2_t(bq, brow + 8 * j);
              mma_step<kStepAcc>(acc[j], af, bq);
            }
          }
        } else {
          f32_tiles<NT>(acc, Mma::a_bits(af),
                        [&](int r) { return b_row(b, s, r); }, n0, ks, live);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < live) {
        const int c = n0 + 8 * j + 2 * t;
        st(b, m0 + g, c, (float)acc[j][0], (float)acc[j][1]);
        st(b, m0 + g + 8, c, (float)acc[j][2], (float)acc[j][3]);
      }
    }
  }
}

// One block's share of the op (spatial: kSpatial, the output frames
// [o0, o0 + on) of sample n; temporal: its output joints; on may be 0) in
// products of kind Mma, through out.put2(row, joint, c, v0, v1), as the
// file header describes.  kChain: x is the chain's float32 activation,
// which other blocks of the launch wrote (read at L2, rounded here at
// bf16); else x is the one-op kernels' input (bf16 at bf16, else
// float32).  The float32-staged kinds run the steps in another order to
// fit the float32 layout (FwdLayout): no projection in step 2, the scores
// formed in the mixing's fragments, and step 6 projects and aggregates
// one group of gw output channels at a time.  Every thread of every block of the cluster
// runs every barrier.
template <bool kSpatial, typename Mma, bool kChain = false, typename Store>
__device__ void op_mma(const OpArgs& a, char* smem, int n, int o0, int on,
                       int tile, int nblk, const Store& out) {
  using E = typename Elem<Mma>::E;
  constexpr bool kF32 = kStagedF32<Mma>;
  constexpr int kd = Elem<Mma>::kStep;
  // n8 tiles a warp owns in the bf16 projection and aggregation: the
  // chain, capped at 64 registers with both ops inlined, takes two
  constexpr int kNT = kChain ? 2 : 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int T = a.T, V = a.V;
  const FwdLayout L(kSpatial, T, V, a.Ci, a.Co, a.K, a.R, tile, nblk, kF32);
  const int P = L.P, Q = L.Q, K = L.K, R = L.R, J = L.J, Ci = L.Ci,
            Co = L.Co;
  float* qk = reinterpret_cast<float*>(smem + L.qk);
  E* xf = reinterpret_cast<E*>(smem + L.xf);
  E* adjl = reinterpret_cast<E*>(smem + L.adjl);
  E* xt = reinterpret_cast<E*>(smem + L.x);
  E* wq = reinterpret_cast<E*>(smem + L.wq);
  E* wf = reinterpret_cast<E*>(smem + L.wf);
  E* sc = reinterpret_cast<E*>(smem + L.s);
  E* wm = reinterpret_cast<E*>(smem + L.w);
  float* base = reinterpret_cast<float*>(smem + L.ab);  // then brm
  E* ag = reinterpret_cast<E*>(smem + L.ag);
  const int rows = on * P;           // the tile's rows of x
  const int zx = tile * P;           // the zero row of the x tile
  const int zf = K * tile * P;       // the zero row of ag (and bf16 xf)
  // the one-op bf16 kernels' x comes as bf16 (the rounding the contract
  // puts on it); the others' as float32
  const size_t xoff = (size_t)n * T * V * Ci;
  const bf16* xb = reinterpret_cast<const bf16*>(a.x) + xoff;
  const float* xs32 = a.x + xoff;
  const E zero = cvt<E>(0.f);
  // device row of x (and of out) of output ref index o, pair index i
  auto grow = [V](int o, int i) { return kSpatial ? o * V + i : i * V + o; };

  // 1. stage the x tile, wqk and (bf16) wf, zeros in the padding
  const Div div_p(P);
  if ((Ci & 3) == 0) {  // 8- or 16-byte loads of 4 channels
    const int c4 = L.cik >> 2;
    const Div div_c4(c4);
#pragma unroll 4
    for (int e = threadIdx.x; e < (rows + 1) * c4; e += blockDim.x) {
      const int lr = div_c4(e), c = (e - lr * c4) << 2;
      const bool in = lr < rows && c < Ci;
      size_t src = 0;
      if (in) {
        const int ol = div_p(lr);
        src = (size_t)grow(o0 + ol, lr - ol * P) * Ci + c;
      }
      E* dst = xt + (lr < rows ? lr : zx) * L.xs + c;
      if constexpr (!kF32 && !kChain) {
        uint2 v = make_uint2(0u, 0u);
        if (in) v = __ldg(reinterpret_cast<const uint2*>(xb + src));
        *reinterpret_cast<uint2*>(dst) = v;
      } else {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in) {
          const float4* p = reinterpret_cast<const float4*>(xs32 + src);
          v = kChain ? __ldcg(p) : __ldg(p);
        }
        store4(dst, v);
      }
    }
  } else {
    const Div div_c(L.cik);
    for (int e = threadIdx.x; e < (rows + 1) * L.cik; e += blockDim.x) {
      const int lr = div_c(e), c = e - lr * L.cik;
      E v = zero;
      if (lr < rows && c < Ci) {
        const int ol = div_p(lr);
        const size_t src = (size_t)grow(o0 + ol, lr - ol * P) * Ci + c;
        if constexpr (!kF32 && !kChain)
          v = xb[src];
        else
          v = cvt<E>(kChain ? __ldcg(xs32 + src) : __ldg(xs32 + src));
      }
      xt[(lr < rows ? lr : zx) * L.xs + c] = v;
    }
  }
  for (int e = threadIdx.x; e < L.cik * L.j8; e += blockDim.x) {
    const int ci = e / L.j8, jj = e - ci * L.j8;
    float v = 0.f;
    if (ci < Ci && jj < J) {
      const int k = jj / (2 * R), jr = jj - k * 2 * R;
      v = jr < R ? __ldg(a.wm1 + (k * Ci + ci) * R + jr)
                 : __ldg(a.wm2 + (k * Ci + ci) * R + jr - R);
    }
    wq[ci * L.qs + jj] = cvt<E>(v);
  }
  const Div div_ci(L.cik);
  if constexpr (!kF32) {
    // wf as the projection's B operand, [k][ci][co] as in device memory
    if ((Co & 3) == 0) {  // float4 loads
      const int c4 = L.co8 >> 2;
      const Div div_c4(c4);
#pragma unroll 4
      for (int e = threadIdx.x; e < K * L.cik * c4; e += blockDim.x) {
        const int kc = div_c4(e), c = (e - kc * c4) << 2;
        const int k = div_ci(kc), ci = kc - k * L.cik;
        const float4 v =
            ci < Ci && c < Co
                ? __ldg(reinterpret_cast<const float4*>(
                      a.wf + ((size_t)k * Ci + ci) * Co + c))
                : make_float4(0.f, 0.f, 0.f, 0.f);
        store4(wf + kc * L.wfs + c, v);
      }
    } else {
      const Div div_c(L.co8);
      for (int e = threadIdx.x; e < K * L.cik * L.co8; e += blockDim.x) {
        const int kc = div_c(e), c = e - kc * L.co8;
        const int k = div_ci(kc), ci = kc - k * L.cik;
        const float v = ci < Ci && c < Co
                            ? __ldg(a.wf + ((size_t)k * Ci + ci) * Co + c)
                            : 0.f;
        wf[kc * L.wfs + c] = cvt<E>(v);
      }
    }
    for (int c = threadIdx.x; c < L.fs; c += blockDim.x)
      xf[zf * L.fs + c] = zero;
  }
  __syncthreads();

  // 2. q/k of the tile's rows (float32, into the sample's q/k at slot
  // (s = o, i)) and (bf16) the tile's features, from the one x tile
  const int mrows = (rows + 15) >> 4, ksx = L.cik / kd;
  auto x_row = [&](int, int, int m) {
    return xt + (m < rows ? m : zx) * L.xs;
  };
  // q/k on the CUDA cores, each sum over ci in order, as the backward's
  // q/k launch forms it: q/k feed the tanh, and
  // a score whose bf16 rounding flips moves the adjacency; summed on the
  // tensor cores they lay one card test's forward 1.8e-3 from the float64
  // run of the contract, where the plain contract lies 5e-8 (PERF.md)
  {
    const Div div_j(J);
    for (int e = threadIdx.x; e < rows * J; e += blockDim.x) {
      const int m = div_j(e), j = e - m * J;
      const int k = j / (2 * R), jr = j - k * 2 * R;
      const E* xr = xt + m * L.xs;
      float acc = 0.f;
      for (int ci = 0; ci < Ci; ++ci)
        acc = fmaf(tof(xr[ci]), tof(wq[ci * L.qs + j]), acc);
      qk[j * Q * P + o0 * P + m] =
          acc + (jr < R ? __ldg(a.bm1 + k * R + jr)
                        : __ldg(a.bm2 + k * R + jr - R));
    }
  }
  if constexpr (!kF32) {
    block_mma<Mma, kNT, kChain>(
        K, mrows, L.co8 >> 3, 1, ksx, x_row,
        [&](int k, int, int r) { return wf + (k * L.cik + r) * L.wfs; },
        [&](int k, int m, int c, float v0, float v1) {
          if (m >= rows) return;
          const float b0 = c < Co ? __ldg(a.bf + k * Co + c) : 0.f;
          const float b1 = c + 1 < Co ? __ldg(a.bf + k * Co + c + 1) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(xf + (k * tile * P + m) * L.fs +
                                             c) =
              __floats2bfloat162_rn(c < Co ? v0 + b0 : 0.f,
                                    c + 1 < Co ? v1 + b1 : 0.f);
        });
  }
  __syncthreads();  // wqk (and at bf16 the x tile and wf) are dead

  // 3. wrm as the mixing's B operand (bf16 [k][(r, s)][o], float32
  // [k][o][(r, s)]), base and brm (their loads in flight while the cluster
  // meets); the sample's q/k; (bf16) the block's pair rows of the scores,
  // tanh(q - k) at every depth (r, s)
  const Div div_rqk(L.rqk), div_mtk16(L.mtk * 16);
  {
    const Div div_q8(L.q8);
#pragma unroll 4
    for (int e = threadIdx.x; e < K * L.rqk * L.q8; e += blockDim.x) {
      const int kd_ = div_q8(e), o = e - kd_ * L.q8;
      const int k = div_rqk(kd_), d = kd_ - k * L.rqk;
      const float v =
          d < L.rq && o < Q ? __ldg(a.wrm + ((size_t)k * L.rq + d) * Q + o)
                            : 0.f;
      wm[kF32 ? (k * L.q8 + o) * L.ws + d : kd_ * L.ws + o] = cvt<E>(v);
    }
#pragma unroll 4
    for (int e = threadIdx.x; e < K * (L.pp + Q); e += blockDim.x)
      base[e] = e < K * L.pp ? __ldg(a.base + e) : __ldg(a.brm + e - K * L.pp);
  }
  cluster.sync();  // every block's q/k share is written
  {
    // every slot of the other blocks' shares, all loads of a thread in
    // flight together
    const Div div_qp(Q * P), div_tp(tile * P);
#pragma unroll 4
    for (int e = threadIdx.x; e < J * Q * P; e += blockDim.x) {
      const int j = div_qp(e), owner = div_tp(e - j * Q * P);
      if (owner != rank) qk[e] = cluster.map_shared_rank(qk, owner)[e];
    }
  }
  __syncthreads();
  // the pair rows (k, i, j) of the block: q[k, r, s, i] is
  // qk[(k 2R Q + d) P + i], k[k, r, s, j] is qk[((k 2R + R) Q + d) P + j]
  // at depth d = r Q + s
  const int mt0 = rank * L.per;
  const int mine = max(0, min(L.per, L.mt - mt0));  // the block's m tiles
  if constexpr (!kF32) {
    // one warp per pair row, the lanes over the depth
    const int lane = threadIdx.x & 31;
    for (int lr = threadIdx.x >> 5; lr < mine * 16; lr += blockDim.x >> 5) {
      const int prow = mt0 * 16 + lr;
      const int k = div_mtk16(prow), p = prow - k * L.mtk * 16;
      const int i = div_p(p), j = p - i * P;
      const float* q = qk + k * 2 * R * Q * P + i;
      const float* kk = qk + (k * 2 * R + R) * Q * P + j;
      for (int d = lane; d < L.rqk; d += 32) {
        const float v =
            p < L.pp && d < L.rq ? tanhf(q[d * P] - kk[d * P]) : 0.f;
        sc[lr * L.ss + d] = cvt<E>(v);
      }
    }
    __syncthreads();
  }

  // 4. the mixing: per 16-row tile of pair rows (batch), all outputs o,
  // depth (r, s); the epilogue stores (dyn + brm) alpha + base
  const float alpha = __ldg(a.alpha);
  auto mixed = [&](int lr, int o, float dyn) {
    const int prow = mt0 * 16 + lr;
    const int k = div_mtk16(prow), p = prow - k * L.mtk * 16;
    if (p < L.pp && o < Q)
      adjl[o * L.lrows + lr] = cvt<E>(
          (dyn + base[K * L.pp + k * Q + o]) * alpha + base[k * L.pp + p]);
  };
  if constexpr (kF32) {
    // the scores formed in the A fragments, each by the one lane that
    // holds it: a warp per (16-row tile, group of 4 n8 tiles of outputs)
    constexpr int NT = 4;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int n8 = L.q8 >> 3, groups = (n8 + NT - 1) / NT;
    for (int task = threadIdx.x >> 5; task < mine * groups;
         task += blockDim.x >> 5) {
      const int b = task / groups, n0 = (task - b * groups) * NT * 8;
      const int live = min(NT, n8 - (n0 >> 3));
      const int k = (mt0 + b) / L.mtk;
      // the lane's two pair rows g and g + 8 of the tile
      const float* q[2];
      const float* kk[2];
      bool in[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mt0 + b) * 16 + g + 8 * h - k * L.mtk * 16;
        in[h] = p < L.pp;
        const int i = in[h] ? div_p(p) : 0, j = in[h] ? p - i * P : 0;
        q[h] = qk + k * 2 * R * Q * P + i;
        kk[h] = qk + (k * 2 * R + R) * Q * P + j;
      }
      AccOf<Mma> acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      for (int ks = 0; ks < L.rqk >> 3; ++ks) {
        // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        uint32_t af[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r & 1, d = ks * 8 + t + ((r >> 1) << 2);
          const int dd = min(d, L.rq - 1);
          const float v = tanhf(q[h][dd * P] - kk[h][dd * P]);
          af[r] = __float_as_uint(in[h] && d < L.rq ? v : 0.f);
        }
        f32_tiles<NT>(
            acc, Mma::a_bits(af),
            [&](int r) { return wm + (k * L.q8 + r) * L.ws; }, n0, ks,
            live);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < live) {
          const int o = n0 + 8 * j + 2 * t;
          mixed(b * 16 + g, o, (float)acc[j][0]);
          mixed(b * 16 + g, o + 1, (float)acc[j][1]);
          mixed(b * 16 + g + 8, o, (float)acc[j][2]);
          mixed(b * 16 + g + 8, o + 1, (float)acc[j][3]);
        }
      }
    }
  } else {
    block_mma<Mma, 1, kChain>(
        mine, 1, L.q8 >> 3, 1, L.rqk / kd,
        [&](int b, int, int m) { return sc + (b * 16 + m) * L.ss; },
        [&](int b, int, int r) {
          const int k = (mt0 + b) / L.mtk;
          return wm + (k * L.rqk + r) * L.ws;
        },
        [&](int b, int m, int o, float v0, float v1) {
          mixed(b * 16 + m, o, v0);
          mixed(b * 16 + m, o + 1, v1);
        });
  }
  // every block's adjacency rows are written (and no block reads q/k of
  // another any more)
  cluster.sync();

  // 5. gather the adjacency of the tile's outputs as the aggregation's A
  // operand: ag[k][o - o0][m][d] = adj[k, o, d, m] (right) or
  // adj[k, o, m, d] (left), zeros past P in d and a zero row
  // (kPer pair rows of one owner, one k, a 16-byte load a thread)
  const bool left = a.agg_left != 0;
  {
    constexpr int kPer = 16 / (int)sizeof(E);
    const int chunks = K * L.mtk * (16 / kPer);
    const Div div_chunks(chunks), div_per(L.per);
#pragma unroll 2
    for (int e = threadIdx.x; e < on * chunks; e += blockDim.x) {
      const int ol = div_chunks(e), prow0 = (e - ol * chunks) * kPer;
      const int owner = div_per(prow0 >> 4);
      const uint4 raw = *reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(adjl, owner) + (o0 + ol) * L.lrows + prow0 -
          owner * L.lrows);
      const E* val = reinterpret_cast<const E*>(&raw);
      const int k = div_mtk16(prow0), p0 = prow0 - k * L.mtk * 16;
      E* dst = ag + (k * tile + ol) * P * L.as;
#pragma unroll
      for (int h = 0; h < kPer; ++h) {
        const int p = p0 + h;
        if (p < L.pp) {
          const int i = div_p(p), j = p - i * P;
          dst[(left ? i * L.as + j : j * L.as + i)] = val[h];
        }
      }
    }
  }
  // zeros past P in d (every row), and the zero row
  for (int e = threadIdx.x; e < K * tile * P * (L.pk - P); e += blockDim.x) {
    const int row = e / (L.pk - P);
    ag[row * L.as + P + e - row * (L.pk - P)] = zero;
  }
  for (int d = threadIdx.x; d < L.as; d += blockDim.x) ag[zf * L.as + d] = zero;
  barrier_arrive();  // done reading the other blocks' shared memory

  // 6. the aggregation per output ref index (batch), summed over k
  if constexpr (kF32) {
    // one group of gw output channels at a time: its wf [k][c][ci], its
    // features xf [k][o][c][i] (zeros past P in i), then its aggregation
    const int gw = L.gw, pad = L.pk - P;
    for (int e = threadIdx.x; e < K * tile * gw * pad; e += blockDim.x) {
      const int row = e / pad;
      xf[row * L.fs + P + e - row * pad] = 0.f;
    }
    const Div div_gw(gw);
    auto stage_wf = [&](int c0) {
      for (int e = threadIdx.x; e < K * L.cik * gw; e += blockDim.x) {
        const int kc = div_gw(e), c = e - kc * gw;
        const int k = div_ci(kc), ci = kc - k * L.cik;
        wf[(k * gw + c) * L.wfs + ci] =
            ci < Ci && c0 + c < Co
                ? __ldg(a.wf + ((size_t)k * Ci + ci) * Co + c0 + c)
                : 0.f;
      }
    };
    stage_wf(0);
    __syncthreads();
    for (int c0 = 0; c0 < L.co8; c0 += gw) {
      block_mma<Mma, 2>(
          K, mrows, gw >> 3, 1, ksx, x_row,
          [&](int k, int, int r) { return wf + (k * gw + r) * L.wfs; },
          [&](int k, int m, int c, float v0, float v1) {
            if (m >= rows) return;
            const int ol = div_p(m), i = m - ol * P, co = c0 + c;
            E* dst = xf + ((k * tile + ol) * gw + c) * L.fs + i;
            dst[0] = co < Co ? v0 + __ldg(a.bf + k * Co + co) : 0.f;
            dst[L.fs] =
                co + 1 < Co ? v1 + __ldg(a.bf + k * Co + co + 1) : 0.f;
          });
      __syncthreads();  // the group's features are written, wf is dead
      block_mma<Mma, 2>(
          on, (P + 15) >> 4, gw >> 3, K, L.pk / kd,
          [&](int ol, int k, int m) {
            return ag + (m < P ? (k * tile + ol) * P + m : zf) * L.as;
          },
          [&](int ol, int k, int r) {
            return xf + ((k * tile + ol) * gw + r) * L.fs;
          },
          [&](int ol, int m, int c, float v0, float v1) {
            if (m >= P || c0 + c >= Co) return;
            out.put2(grow(o0 + ol, m), kSpatial ? m : o0 + ol, c0 + c, v0,
                     v1);
          });
      if (c0 + gw < L.co8) stage_wf(c0 + gw);
      __syncthreads();  // the group's features are read
    }
  } else {
    __syncthreads();
    block_mma<Mma, kNT, kChain>(
        on, (P + 15) >> 4, L.co8 >> 3, K, L.pk / kd,
        [&](int ol, int k, int m) {
          return ag + (m < P ? (k * tile + ol) * P + m : zf) * L.as;
        },
        [&](int ol, int k, int r) {
          return xf + (r < P ? k * tile * P + ol * P + r : zf) * L.fs;
        },
        [&](int ol, int m, int c, float v0, float v1) {
          if (m >= P || c >= Co) return;
          out.put2(grow(o0 + ol, m), kSpatial ? m : o0 + ol, c, v0, v1);
        });
  }
  barrier_wait();
}

}  // namespace dstd_fwd
