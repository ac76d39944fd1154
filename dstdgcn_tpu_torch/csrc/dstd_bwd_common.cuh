// Whole-op backward of the DSTD-GC ops (float32, and bf16 contraction
// operands), shared by dstd_spatial_bwd.cu and dstd_temporal_bwd.cu.
//
// Both ops are one computation over two axes: the mixing axis of length REF
// (frames T for the spatial op, joints V for the temporal op) and the pair
// axis of length P (joints for the spatial op, frames for the temporal op).
// With q/k[k,r,s,i] the projections of the x row at (mixing index s, pair
// index i):
//   S[k,r,s,i,j]  = tanh(q[k,r,s,i] - k[k,r,s,j])
//   dyn[k,o,i,j]  = sum_{r,s} S[k,r,s,i,j] wrm[k,r,s,o] + brm[k,o]
//   adj[k,o,i,j]  = alpha dyn[k,o,i,j] + base[k,i,j]
//   right: out[o,j] = sum_{k,i} xf[k,o,i] adj[k,o,i,j]
//   left:  out[o,i] = sum_{k,j} adj[k,o,i,j] xf[k,o,j]
// The x row of (s, i) is s*V + i (spatial) or i*V + s (temporal).
//
// Given the saved x and the output cotangent g, four launches compute dx and
// every weight gradient (dstdgcn_tpu/kernels/fused_bwd.py derives the same):
//   1. qk_kernel: q/k of every row into scratch (N, J, REF, P).
//   2. out_kernel, one block per (sample, tile of output indices o): rebuilds
//      the tile's adjacency and features in shared memory, then dA (the
//      adjacency's cotangent), ddyn = alpha dA into scratch, dxf, the first
//      part of dx (dxf wf^T, stored), and per-block partial sums of dwf, dbf,
//      dbase, dalpha, dbrm.
//   3. src_kernel, one block per (sample, tile of source indices s): reads
//      ddyn of all output indices o of its sample from scratch (L2), forms
//      ds = sum_o wrm ddyn, du = ds (1 - S^2), dq/dk, adds dqk wqk^T to dx,
//      and writes partial sums of dwrm, dwqk, dbqk.
// The five products of pass 2 (features, dA, dxf, dx, dwf) and pass 3's
// dwrm run on the tensor cores (dstd_mma.cuh; MmaKind below): in the bf16
// kernels as bf16 mma.sync products with float32 accumulators, in the
// float32 ones as 3xTF32 products (float32 accuracy from three TF32
// mma.sync a step), where pass 3's ds is a product too; the same function
// in another summation order.  Pass 2 of the float32 kernels and pass 3 of
// both build their fragments from float32 shared memory one element a
// loader call (block_mma, LayoutOut); pass 2 of the bf16 kernels stores
// the operands of its products as bf16 and reads the fragments by
// ldmatrix (block_mma_ldsm, LayoutOutBf16, out_bf16).  The mixing loop
// (tanh of every pair, times wrm) stays on the CUDA cores: it is bound by
// its tanhf, which the contract rounds, and on the tensor cores it
// measured no faster (PERF.md).
//   4. reduce_kernel: sums each partial array in a fixed order, one thread
//      per weight-gradient element.  No atomics: the result is the same from
//      run to run.
// ddyn couples every output index with every source index (ds needs ddyn of
// all o), which is why passes 2 and 3 are separate launches: each block of
// pass 2 writes its tile's share of a sample's ddyn to scratch, and each
// block of pass 3 reads all of it back (135 KB spatial, 108 KB temporal at
// V = 22, T = 35); at N = 32 the whole scratch (about 14 MB) stays in the
// 50 MB L2 between the launches.
//
// Every kernel takes a rounding policy Rnd (dstd_common.cuh): Exact for the
// float32 backward, Bf16 for the TPU kernel's bf16 dtype
// (fused_bwd.py::_contract_rows_fn), which rounds the operands of its 11
// contractions (the q/k and feature projections, the mixing, dxf, dwf, dx
// from dxf, dA, dwrm, ds, dwqk and dx from dq/dk) and keeps everything else
// float32.  An operand that feeds products alone is rounded once where it is
// stored (x, g, wf, wrm, wqk, the features, the adjacency, ddyn); one that
// also feeds a float32 sum is rounded where a product loads it (the
// scores, which du reads; dq/dk, whose sum is dbqk), or, where it is
// stored as bf16, after the sum has read it in float32 (dxf, whose sum is
// dbf: out_bf16 sums it from the product's accumulators).
#pragma once

#include <type_traits>

#include "dstd_common.cuh"
#include "dstd_mma.cuh"

namespace dstd_bwd {

using dstd::Bf16;
using dstd::Exact;
using dstd::kMaxTile;
using dstd::kThreads;
using dstd::round4;

constexpr int kWarps = kThreads / 32;
constexpr int kSmallThreads = 256;  // qk and reduction launches

struct BwdArgs {
  const float* x;
  const float* g;
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
  float* dx;
  float* dbase;
  float* dalpha;
  float* dwf;
  float* dbf;
  float* dwm1;
  float* dbm1;
  float* dwm2;
  float* dbm2;
  float* dwrm;
  float* dbrm;
  float* scratch;
  int N, T, V, Ci, Co, K, R, agg_left, tile;
};

// Offsets (in floats) of the scratch arrays: q/k, ddyn, and the partial
// sums of the weight gradients (per block of pass 2 or 3, or per sample).
struct Scratch {
  long long qk, ddyn, pwf, pbf, pbase, palpha, pbrm, pwrm, pwqk, pbqk, total;
  __host__ __device__ Scratch(int N, int T, int V, int Ci, int Co, int K,
                              int R, int tile, bool temporal) {
    const long long REF = temporal ? V : T, P = temporal ? T : V;
    const long long J = 2LL * K * R, n = N;
    const long long nb = n * ((REF + tile - 1) / tile);  // blocks per pass
    qk = 0;
    ddyn = qk + round4(n * J * REF * P);
    pwf = ddyn + round4(n * K * REF * P * P);
    pbf = pwf + round4(nb * K * Ci * Co);
    pbase = pbf + round4(nb * K * Co);
    palpha = pbase + round4(nb * K * P * P);
    pbrm = palpha + round4(nb);
    pwrm = pbrm + round4(n * K * REF);
    pwqk = pwrm + round4(n * K * R * REF * REF);
    pbqk = pwqk + round4(nb * Ci * J);
    total = pbqk + round4(nb * J);
  }
};

// Shared memory of a float32 pass-2 block (floats): wmix [K][R][REF][tile] (the
// tile's columns of wrm), qk [J][REF][P], dyn [K][tile][P*P] (then the
// adjacency), dd [K][tile][P*P] (dA), xf [K][tile*P][CS] (then dxf), gs
// [tile*P][CS] (the tile's rows of g), wfs [K][Ci][CS], xs [tile*P][XS]
// (the tile's rows of x), red [32].  Row strides CS = Co|1 and XS = Ci|1
// are odd, so threads on neighbouring rows hit distinct banks.
struct LayoutOut {
  long long wmix, qk, dyn, dd, xf, gs, wfs, xs, red, total;
  __host__ __device__ LayoutOut(int T, int V, int Ci, int Co, int K, int R,
                                int tile, bool temporal) {
    const long long REF = temporal ? V : T, P = temporal ? T : V;
    const long long J = 2LL * K * R, CS = Co | 1, XS = Ci | 1;
    wmix = 0;
    qk = wmix + round4((long long)K * R * REF * tile);
    dyn = qk + round4(J * REF * P);
    dd = dyn + round4((long long)K * tile * P * P);
    xf = dd + round4((long long)K * tile * P * P);
    gs = xf + round4((long long)K * tile * P * CS);
    wfs = gs + round4((long long)tile * P * CS);
    xs = wfs + round4((long long)K * Ci * CS);
    red = xs + round4((long long)tile * P * XS);
    total = red + 32;
  }
};

// Shared memory of a bf16 pass-2 block (bytes).  The operands of its five
// products are bf16 for ldmatrix (dstd_mma::block_mma_ldsm): row strides
// of 16 n + 8 elements (an odd number of 16-byte chunks, so the 8 rows of
// one ldmatrix phase hit 8 distinct bank groups), zeros from the last
// channel to the stride, and rows up to the 16-row tile that reads them.
// Regions, each reused once its first array is dead:
//   mix  wmix [K][R][REF][tile] and qk [J][REF][P] (float32) for the mixing
//        loop; then adj, the tile's adjacency (bf16), one (P, PS) slab per
//        (k, output index), [i][j] at agg right and [j][i] at left: dxf's A
//        operand, its depth along the rows either way
//   dyn  dyn [K][tile][P*P] (float32), then dA in its place
//   xf   the features [K][FR][CS], then dxf
//   gs   the tile's rows of g [GR][CS]
//   xs   the tile's rows of x [XR][XS]
//   wfs  wf [K][CIP][CS]
//   pbf  dbf's partial sums [K][tile][P16 / 16][Co] (float32)
//   red  dalpha's partial sum of each warp
__host__ __device__ inline long long r16(long long n) {
  return (n + 15) & ~15LL;
}

struct LayoutOutBf16 {
  int P16, CS, XS, PS, CIP, XR, GR, FR;
  long long mix, dyn, xf, gs, xs, wfs, pbf, red, total;
  __host__ __device__ LayoutOutBf16(int T, int V, int Ci, int Co, int K,
                                    int R, int tile, bool temporal) {
    const int REF = temporal ? V : T, P = temporal ? T : V, J = 2 * K * R;
    P16 = (P + 15) & ~15;
    CS = ((Co + 15) & ~15) + 8;
    XS = ((Ci + 15) & ~15) + 8;
    PS = P16 + 8;
    CIP = (Ci + 15) & ~15;
    XR = (tile * P + 15) & ~15;
    GR = (tile - 1) * P + P16;
    FR = XR > GR ? XR : GR;
    const long long mixing =
        4 * (round4((long long)K * R * REF * tile) + (long long)J * REF * P);
    const long long adj = 2LL * ((K * tile - 1) * P + P16) * PS;
    mix = 0;
    dyn = r16(mixing > adj ? mixing : adj);
    xf = dyn + r16(4LL * K * tile * P * P);
    gs = xf + r16(2LL * K * FR * CS);
    xs = gs + r16(2LL * GR * CS);
    wfs = xs + r16(2LL * XR * XS);
    pbf = wfs + r16(2LL * K * CIP * CS);
    red = pbf + r16(4LL * K * tile * (P16 / 16) * Co);
    total = red + 4 * kWarps;
  }
};

// Shared memory of a pass-3 block (floats): qk [J][tile][P] (the tile's
// q/k), wrow [K][R][tile][REF] (the tile's rows of wrm), su [K][R][tile][P*P]
// (scores, then du), dqk [tile*P][J], wqk [Ci][J|1], and in the temporal
// op part, the partial 16 x 8 tiles of dwrm (dstd_mma::block_mma_split).
struct LayoutSrc {
  long long qk, wrow, su, dqk, wqk, part, total;
  __host__ __device__ LayoutSrc(int T, int V, int Ci, int K, int R, int tile,
                                bool temporal) {
    const long long REF = temporal ? V : T, P = temporal ? T : V;
    const long long J = 2LL * K * R;
    const long long dwrm_tiles = K * ((R * tile + 15) / 16) * ((REF + 7) / 8);
    qk = 0;
    wrow = qk + round4(J * tile * P);
    su = wrow + round4((long long)K * R * tile * REF);
    dqk = su + round4((long long)K * R * tile * P * P);
    wqk = dqk + round4((long long)tile * P * J);
    part = wqk + round4((long long)Ci * (J | 1));
    total = part + (temporal ? dstd_mma::split_floats(dwrm_tiles, kWarps)
                             : 0);
  }
};

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The element kind of a backward kernel's tensor-core products, by rounding
// policy: the bf16 kernels (5b, 6b) on bf16 mma.sync, the float32 ones (6,
// 5) on 3xTF32 (float32-accurate); both measured faster than the
// register-tiled CUDA-core products they replaced (PERF.md).
template <typename Rnd>
using MmaKind = std::conditional_t<std::is_same_v<Rnd, Bf16>,
                                   dstd_mma::Bf16Mma, dstd_mma::Tf32x3Mma>;

// x / g / dx row of (mixing index s, pair index i)
template <bool TEMPORAL>
__device__ inline int xrow(int s, int i, int V) {
  return TEMPORAL ? i * V + s : s * V + i;
}

using bf16 = __nv_bfloat16;

// rows [0, rows) of a bf16 array at dst, row stride ld (a multiple of 8):
// row r holds src(r)[0 .. C) rounded to bf16 and zeros up to the stride, or
// zeros where src(r) is null; 16 bytes a store.  src(r) points into device
// memory, 16-byte aligned where C is a multiple of 4.
template <typename Src>
__device__ inline void stage_rows(bf16* dst, int rows, int ld, int C,
                                  Src src) {
  const int chunks = ld >> 3;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c0 = (i - r * chunks) << 3;
    const float* row = src(r);
    float v[8];
    if (row && (C & 3) == 0 && c0 + 8 <= C) {
      const float4* p = reinterpret_cast<const float4*>(row + c0);
      const float4 lo = __ldg(p), hi = __ldg(p + 1);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = row && c0 + e < C ? __ldg(row + c0 + e) : 0.f;
    }
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c0) =
        make_uint4(dstd_mma::pack_bf16(v[0], v[1]),
                   dstd_mma::pack_bf16(v[2], v[3]),
                   dstd_mma::pack_bf16(v[4], v[5]),
                   dstd_mma::pack_bf16(v[6], v[7]));
  }
}

// zeros in rows [rows, total) and in columns [C, ld) of rows < rows of a
// bf16 array (row stride ld, a multiple of 8)
__device__ inline void zero_pad(bf16* p, int rows, int total, int C, int ld) {
  uint4* full = reinterpret_cast<uint4*>(p + (size_t)rows * ld);
  for (int i = threadIdx.x; i < (total - rows) * (ld >> 3); i += kThreads)
    full[i] = make_uint4(0u, 0u, 0u, 0u);
  const int w = ld - C;
  for (int i = threadIdx.x; i < rows * w; i += kThreads) {
    const int r = i / w;
    p[(size_t)r * ld + C + (i - r * w)] = __float2bfloat16_rn(0.f);
  }
}

// channels c, c + 1 of a bf16 row (c even, c + 1 may lie past C)
__device__ inline void put2(bf16* row, int c, int C, float v0, float v1) {
  if (c + 1 < C)
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
  else if (c < C)
    row[c] = __float2bfloat16_rn(v0);
}

// Pass 1: q/k of every row, qk[n][j][s][i], column j = k*2R + r (query) or
// k*2R + R + r (key).
template <bool TEMPORAL, typename Rnd>
__global__ void __launch_bounds__(kSmallThreads) qk_kernel(const BwdArgs a) {
  const int T = a.T, V = a.V, Ci = a.Ci, R = a.R, J = 2 * a.K * a.R;
  const int REF = TEMPORAL ? V : T, P = TEMPORAL ? T : V, rows = T * V;
  const Scratch S(a.N, T, V, Ci, a.Co, a.K, R, a.tile, TEMPORAL);
  float* qk = a.scratch + S.qk;
  const long long total = (long long)a.N * rows * J;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % J);
    const long long nr = idx / J;
    const int row = (int)(nr % rows), n = (int)(nr / rows);
    const int k = j / (2 * R), jr = j - k * 2 * R;
    const float* w = jr < R ? a.wm1 + (size_t)k * Ci * R + jr
                            : a.wm2 + (size_t)k * Ci * R + (jr - R);
    const float b = jr < R ? __ldg(a.bm1 + k * R + jr)
                           : __ldg(a.bm2 + k * R + jr - R);
    const float* xr = a.x + ((size_t)n * rows + row) * Ci;
    float acc = 0.f;
    for (int ci = 0; ci < Ci; ++ci)
      acc = fmaf(Rnd::r(__ldg(xr + ci)), Rnd::r(__ldg(w + (size_t)ci * R)),
                 acc);
    const int t = row / V, v = row - t * V;
    const int s = TEMPORAL ? v : t, i = TEMPORAL ? t : v;
    qk[(((size_t)n * J + j) * REF + s) * P + i] = acc + b;
  }
}

// Pass 2 of the bf16 kernels, one block per (tile of output indices o,
// sample n): the steps of out_f32 below, its five products on bf16
// operands in shared memory (LayoutOutBf16) read by ldmatrix
// (dstd_mma::block_mma_ldsm), rounded where the float32 kernels' order
// rounds them, every float32 sum read from float32.  The adjacency is
// formed in dA's epilogue, which reads dyn and writes dA in its place; dbf
// is summed from dxf's float32 accumulators in its epilogue (each tile's
// column sums, then the tiles in a fixed order) before dxf is stored as
// bf16.
template <bool TEMPORAL, int TILE>
__device__ __forceinline__ void out_bf16(const BwdArgs& a, char* smb) {
  using dstd_mma::Smem16;
  using Acc = float[4][4];
  const int T = a.T, V = a.V, K = a.K, R = a.R, Ci = a.Ci, Co = a.Co;
  const int REF = TEMPORAL ? V : T, P = TEMPORAL ? T : V;
  const int J = 2 * K * R, PP = P * P;
  const int n = blockIdx.y, o0 = blockIdx.x * TILE;
  const int tn = min(TILE, REF - o0), rows = tn * P;
  const int blk = n * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const LayoutOutBf16 L(T, V, Ci, Co, K, R, TILE, TEMPORAL);
  const Scratch S(a.N, T, V, Ci, Co, K, R, TILE, TEMPORAL);
  const int CS = L.CS, XS = L.XS, PS = L.PS, CIP = L.CIP, FR = L.FR;
  const int MP = L.P16 >> 4;
  float* wmix = reinterpret_cast<float*>(smb + L.mix);
  float* qk = wmix + round4((long long)K * R * REF * TILE);
  bf16* adj = reinterpret_cast<bf16*>(smb + L.mix);
  float* dyn = reinterpret_cast<float*>(smb + L.dyn);
  bf16* xf = reinterpret_cast<bf16*>(smb + L.xf);
  bf16* gs = reinterpret_cast<bf16*>(smb + L.gs);
  bf16* xs = reinterpret_cast<bf16*>(smb + L.xs);
  bf16* wfs = reinterpret_cast<bf16*>(smb + L.wfs);
  float* pbfs = reinterpret_cast<float*>(smb + L.pbf);
  float* red = reinterpret_cast<float*>(smb + L.red);
  const float alpha = __ldg(a.alpha);
  const size_t TV = (size_t)T * V;
  const float* xn = a.x + n * TV * Ci;
  const float* gn = a.g + n * TV * Co;
  float* dxn = a.dx + n * TV * Ci;

  // stage the tile's mixing columns, the sample's q/k, the tile's rows of
  // x and g and the feature weights, zeros in every operand's padding
  for (int i = tid; i < K * R * REF * TILE; i += kThreads) {
    const int tt = i % TILE, krs = i / TILE;  // krs = (k*R + r)*REF + s
    wmix[i] =
        tt < tn ? Bf16::r(__ldg(a.wrm + (size_t)krs * REF + o0 + tt)) : 0.f;
  }
  const float* qkn = a.scratch + S.qk + (size_t)n * J * REF * P;
  for (int i = tid; i < J * REF * P; i += kThreads) qk[i] = qkn[i];
  auto tile_row = [&](const float* base, int C, int lr) -> const float* {
    if (lr >= rows) return nullptr;
    const int tt = lr / P, b = lr - tt * P;
    return base + (size_t)xrow<TEMPORAL>(o0 + tt, b, V) * C;
  };
  stage_rows(xs, L.XR, XS, Ci,
             [&](int lr) { return tile_row(xn, Ci, lr); });
  stage_rows(gs, L.GR, CS, Co,
             [&](int lr) { return tile_row(gn, Co, lr); });
  stage_rows(wfs, K * CIP, CS, Co, [&](int r) -> const float* {
    const int k = r / CIP, ci = r - k * CIP;
    return ci < Ci ? a.wf + ((size_t)k * Ci + ci) * Co : nullptr;
  });
  for (int k = 0; k < K; ++k)
    zero_pad(xf + (size_t)k * FR * CS, rows, FR, Co, CS);
  __syncthreads();
  // the tile's features: xf[k] = x wf[k] + bf[k]
  dstd_mma::block_mma_ldsm<false, false>(
      K, rows, Co, 1, Ci, [&](int, int) { return Smem16{xs, XS}; },
      [&](int k, int) { return Smem16{wfs + (size_t)k * CIP * CS, CS}; },
      [&](int k, int m0, int n0, int live, const Acc& acc) {
        bf16* d = xf + (size_t)k * FR * CS;
        const float* bk = a.bf + k * Co;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + 8 * j + 2 * t;
          if (j < live && c < Co) {
            const float b0 = __ldg(bk + c);
            const float b1 = c + 1 < Co ? __ldg(bk + c + 1) : 0.f;
            if (m0 + g < rows)
              put2(d + (size_t)(m0 + g) * CS, c, Co, acc[j][0] + b0,
                   acc[j][1] + b1);
            if (m0 + g + 8 < rows)
              put2(d + (size_t)(m0 + g + 8) * CS, c, Co, acc[j][2] + b0,
                   acc[j][3] + b1);
          }
        }
      });

  // dyn (brm included) of the tile's outputs: one thread per (k, i, j)
  for (int p = tid; p < K * PP; p += kThreads) {
    const int k = p / PP, ij = p - k * PP, i = ij / P, j = ij - i * P;
    float acc[TILE];
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt) acc[tt] = 0.f;
    for (int r = 0; r < R; ++r) {
      const float* qr = qk + (size_t)(k * 2 * R + r) * REF * P + i;
      const float* kr = qk + (size_t)(k * 2 * R + R + r) * REF * P + j;
      const float* wm = wmix + (k * R + r) * REF * TILE;
      for (int s = 0; s < REF; ++s) {
        const float sc = Bf16::r(tanhf(qr[s * P] - kr[s * P]));
#pragma unroll
        for (int tt = 0; tt < TILE; ++tt)
          acc[tt] = fmaf(sc, wm[s * TILE + tt], acc[tt]);
      }
    }
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt)
      if (tt < tn)
        dyn[(k * TILE + tt) * PP + ij] =
            acc[tt] + __ldg(a.brm + k * REF + o0 + tt);
  }
  __syncthreads();

  // dA = the adjacency's cotangent, per (k, output index) a (P, P) product
  // over channels, into dyn's place; dalpha = sum dA * dyn; the adjacency
  // (the q/k are dead) and zeros in its padding
  float dal = 0.f;
  const bool left = a.agg_left;
  for (int i = tid; i < K * tn * P * (PS - P); i += kThreads) {
    const int row = i / (PS - P), c = P + (i - row * (PS - P));
    const int kt = row / P, k = kt / tn, tt = kt - k * tn;
    adj[((size_t)(k * TILE + tt) * P + row - kt * P) * PS + c] =
        __float2bfloat16_rn(0.f);
  }
  auto slab_of = [&](bf16* base, int bt) {
    const int k = bt / tn, tt = bt - k * tn;
    return base + ((size_t)k * FR + tt * P) * CS;
  };
  dstd_mma::block_mma_ldsm<false, true>(
      K * tn, P, P, 1, Co,
      [&](int bt, int) {
        return Smem16{left ? gs + (size_t)(bt % tn) * P * CS
                           : slab_of(xf, bt), CS};
      },
      [&](int bt, int) {
        return Smem16{left ? slab_of(xf, bt)
                           : gs + (size_t)(bt % tn) * P * CS, CS};
      },
      [&](int bt, int m0, int n0, int live, const Acc& acc) {
        const int k = bt / tn, tt = bt - k * tn, slab = k * TILE + tt;
        float* dk = dyn + (size_t)slab * PP;
        const float* bk = a.base + k * PP;
        bf16* ak = adj + (size_t)slab * P * PS;
        dstd_mma::tile_each(P, P, m0, n0, live, acc,
                            [&](int i, int j, float v) {
          const int ij = i * P + j;
          const float d = dk[ij];
          dal = fmaf(v, d, dal);
          dk[ij] = v;
          ak[left ? j * PS + i : i * PS + j] =
              __float2bfloat16_rn(d * alpha + __ldg(bk + ij));
        });
      });
  dal = warp_sum(dal);
  if (lane == 0) red[warp] = dal;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    a.scratch[S.palpha + blk] = s;
  }

  // dbase partial (sum over the tile), ddyn = alpha dA to scratch, dbrm
  // (one warp per (k, o))
  const float* dd = dyn;
  float* pbase = a.scratch + S.pbase + (size_t)blk * K * PP;
  for (int p = tid; p < K * PP; p += kThreads) {
    const int k = p / PP, ij = p - k * PP;
    float s = 0.f;
    for (int tt = 0; tt < tn; ++tt) s += dd[(k * TILE + tt) * PP + ij];
    pbase[p] = s;
  }
  float* ddyn = a.scratch + S.ddyn + (size_t)n * K * REF * PP;
  for (int idx = tid; idx < K * tn * PP; idx += kThreads) {
    const int k = idx / (tn * PP), rem = idx - k * tn * PP;
    const int tt = rem / PP, ij = rem - tt * PP;
    ddyn[((size_t)k * REF + o0 + tt) * PP + ij] =
        Bf16::r(alpha * dd[(k * TILE + tt) * PP + ij]);
  }
  float* pbrm = a.scratch + S.pbrm + (size_t)n * K * REF;
  for (int kt = warp; kt < K * tn; kt += kWarps) {
    const int k = kt / tn, tt = kt - k * tn;
    const float* d = dd + (k * TILE + tt) * PP;
    float s = 0.f;
    for (int ij = lane; ij < PP; ij += 32) s += d[ij];
    s = warp_sum(s);
    if (lane == 0) pbrm[k * REF + o0 + tt] = alpha * s;
  }
  __syncthreads();

  // dxf through the aggregation, into xf's place: right dxf[o,b] =
  // sum_m adj[o,b,m] g[o,m]; left dxf[o,b] = sum_m adj[o,m,b] g[o,m] (adj
  // stored transposed); each tile's column sums of the float32 dxf for dbf
  dstd_mma::block_mma_ldsm<false, false>(
      K * tn, P, Co, 1, P,
      [&](int bt, int) {
        const int k = bt / tn, tt = bt - k * tn;
        return Smem16{adj + (size_t)(k * TILE + tt) * P * PS, PS};
      },
      [&](int bt, int) { return Smem16{gs + (size_t)(bt % tn) * P * CS, CS}; },
      [&](int bt, int m0, int n0, int live, const Acc& acc) {
        const int k = bt / tn, tt = bt - k * tn;
        bf16* d = slab_of(xf, bt);
        float* pb = pbfs + ((size_t)(k * TILE + tt) * MP + (m0 >> 4)) * Co;
        const bool in0 = m0 + g < P, in1 = m0 + g + 8 < P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < live) {
            const int c = n0 + 8 * j + 2 * t;
            if (in0)
              put2(d + (size_t)(m0 + g) * CS, c, Co, acc[j][0], acc[j][1]);
            if (in1)
              put2(d + (size_t)(m0 + g + 8) * CS, c, Co, acc[j][2], acc[j][3]);
            float s0 = (in0 ? acc[j][0] : 0.f) + (in1 ? acc[j][2] : 0.f);
            float s1 = (in0 ? acc[j][1] : 0.f) + (in1 ? acc[j][3] : 0.f);
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              s0 += __shfl_xor_sync(0xffffffffu, s0, o);
              s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            }
            if (g == 0 && c < Co) pb[c] = s0;
            if (g == 0 && c + 1 < Co) pb[c + 1] = s1;
          }
        }
      });
  __syncthreads();

  // dx of the tile's rows = sum_k dxf[k] wf[k]^T (the first contribution)
  dstd_mma::block_mma_ldsm<false, true>(
      1, rows, Ci, K, Co,
      [&](int, int k) { return Smem16{xf + (size_t)k * FR * CS, CS}; },
      [&](int, int k) { return Smem16{wfs + (size_t)k * CIP * CS, CS}; },
      [&](int, int m0, int n0, int live, const Acc& acc) {
        dstd_mma::tile_each(rows, Ci, m0, n0, live, acc,
                            [&](int m, int ci, float v) {
          const int tt = m / P, b = m - tt * P;
          dxn[(size_t)xrow<TEMPORAL>(o0 + tt, b, V) * Ci + ci] = v;
        });
      });
  // dwf / dbf partials over the tile's rows
  float* pwf = a.scratch + S.pwf + (size_t)blk * K * Ci * Co;
  dstd_mma::block_mma_ldsm<true, false>(
      K, Ci, Co, 1, rows, [&](int, int) { return Smem16{xs, XS}; },
      [&](int k, int) { return Smem16{xf + (size_t)k * FR * CS, CS}; },
      [&](int k, int m0, int n0, int live, const Acc& acc) {
        float* pk = pwf + (size_t)k * Ci * Co;
        dstd_mma::tile_each(
            Ci, Co, m0, n0, live, acc,
            [&](int ci, int c, float v) { pk[ci * Co + c] = v; });
      });
  float* pbf = a.scratch + S.pbf + (size_t)blk * K * Co;
  for (int i = tid; i < K * Co; i += kThreads) {
    const int k = i / Co, c = i - k * Co;
    float acc = 0.f;
    for (int tt = 0; tt < tn; ++tt)
      for (int mt = 0; mt < MP; ++mt)
        acc += pbfs[((size_t)(k * TILE + tt) * MP + mt) * Co + c];
    pbf[i] = acc;
  }
}

// Pass 2 of the float32 kernels, one block per (tile of output indices o,
// sample n): float32 operands in shared memory (LayoutOut), the products'
// fragments built by their loaders (dstd_mma::block_mma, 3xTF32).
template <bool TEMPORAL, int TILE>
__device__ __forceinline__ void out_f32(const BwdArgs& a, float* sm) {
  const int T = a.T, V = a.V, K = a.K, R = a.R, Ci = a.Ci, Co = a.Co;
  const int REF = TEMPORAL ? V : T, P = TEMPORAL ? T : V;
  const int J = 2 * K * R, PP = P * P, CS = Co | 1;
  const int n = blockIdx.y, o0 = blockIdx.x * TILE;
  const int tn = min(TILE, REF - o0), rows = tn * P;
  const int blk = n * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const LayoutOut L(T, V, Ci, Co, K, R, TILE, TEMPORAL);
  const Scratch S(a.N, T, V, Ci, Co, K, R, TILE, TEMPORAL);
  float* wmix = sm + L.wmix;
  float* qk = sm + L.qk;
  float* dyn = sm + L.dyn;
  float* dd = sm + L.dd;
  float* xf = sm + L.xf;
  float* gs = sm + L.gs;
  float* wfs = sm + L.wfs;
  float* xs = sm + L.xs;
  float* red = sm + L.red;
  // the five products on the tensor cores, 16 x 32 a warp; dA, dxf and dwf
  // in 3xTF32 at 16 x 16 (faster there than 16 x 32, PERF.md)
  using Kind = dstd_mma::Tf32x3Mma;
  constexpr int kNarrow = 2;
  const float alpha = __ldg(a.alpha);
  const size_t TV = (size_t)T * V;
  const float* xn = a.x + n * TV * Ci;
  const float* gn = a.g + n * TV * Co;
  float* dxn = a.dx + n * TV * Ci;

  // stage the tile's mixing columns, the sample's q/k, the tile's rows of
  // g and the feature weights; project the tile's features
  for (int i = tid; i < K * R * REF * TILE; i += kThreads) {
    const int tt = i % TILE, krs = i / TILE;  // krs = (k*R + r)*REF + s
    wmix[i] =
        tt < tn ? __ldg(a.wrm + (size_t)krs * REF + o0 + tt) : 0.f;
  }
  const float* qkn = a.scratch + S.qk + (size_t)n * J * REF * P;
  for (int i = tid; i < J * REF * P; i += kThreads) qk[i] = qkn[i];
  const int XS = Ci | 1;
  for (int i = tid; i < rows * Co; i += kThreads) {
    const int lr = i / Co, c = i - lr * Co, tt = lr / P, b = lr - tt * P;
    gs[lr * CS + c] =
        __ldg(gn + (size_t)xrow<TEMPORAL>(o0 + tt, b, V) * Co + c);
  }
  for (int i = tid; i < rows * Ci; i += kThreads) {
    const int lr = i / Ci, ci = i - lr * Ci, tt = lr / P, b = lr - tt * P;
    xs[lr * XS + ci] =
        __ldg(xn + (size_t)xrow<TEMPORAL>(o0 + tt, b, V) * Ci + ci);
  }
  for (int i = tid; i < K * Ci * Co; i += kThreads) {
    const int kc = i / Co, c = i - kc * Co;
    wfs[kc * CS + c] = __ldg(a.wf + i);
  }
  __syncthreads();
  // the tile's features: xf[k] = x wf[k] + bf[k]
  dstd_mma::block_mma<Kind>(
      K, rows, Co, 1, Ci,
      [&](int, int m, int, int q) { return xs[m * XS + q]; },
      [&](int k, int, int q, int n) { return wfs[(k * Ci + q) * CS + n]; },
      [&](int k, int m, int n, float v) {
        xf[(k * TILE * P + m) * CS + n] =
            v + __ldg(a.bf + k * Co + n);
      });

  // dyn (brm included) of the tile's outputs: one thread per (k, i, j)
  for (int p = tid; p < K * PP; p += kThreads) {
    const int k = p / PP, ij = p - k * PP, i = ij / P, j = ij - i * P;
    float acc[TILE];
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt) acc[tt] = 0.f;
    for (int r = 0; r < R; ++r) {
      const float* qr = qk + (size_t)(k * 2 * R + r) * REF * P + i;
      const float* kr = qk + (size_t)(k * 2 * R + R + r) * REF * P + j;
      const float* wm = wmix + (k * R + r) * REF * TILE;
      for (int s = 0; s < REF; ++s) {
        const float sc = tanhf(qr[s * P] - kr[s * P]);
#pragma unroll
        for (int tt = 0; tt < TILE; ++tt)
          acc[tt] = fmaf(sc, wm[s * TILE + tt], acc[tt]);
      }
    }
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt)
      if (tt < tn)
        dyn[(k * TILE + tt) * PP + ij] =
            acc[tt] + __ldg(a.brm + k * REF + o0 + tt);
  }
  __syncthreads();

  // dA = the adjacency's cotangent, per (k, output index) a (P, P)
  // product over channels; dalpha = sum dA * dyn
  float dal = 0.f;
  const bool left = a.agg_left;
  dstd_mma::block_mma<Kind, kNarrow>(
      K * tn, P, P, 1, Co,
      [&](int bt, int i, int, int c) {
        const int k = bt / tn, tt = bt - k * tn;
        return left ? gs[(tt * P + i) * CS + c]
                    : xf[((k * TILE + tt) * P + i) * CS + c];
      },
      [&](int bt, int, int c, int j) {
        const int k = bt / tn, tt = bt - k * tn;
        return left ? xf[((k * TILE + tt) * P + j) * CS + c]
                    : gs[(tt * P + j) * CS + c];
      },
      [&](int bt, int i, int j, float v) {
        const int k = bt / tn, tt = bt - k * tn;
        const int e = (k * TILE + tt) * PP + i * P + j;
        dal = fmaf(v, dyn[e], dal);
        dd[e] = v;
      });
  dal = warp_sum(dal);
  if (lane == 0) red[warp] = dal;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    a.scratch[S.palpha + blk] = s;
  }

  // dbase partial (sum over the tile), ddyn = alpha dA to scratch, dbrm
  // (one warp per (k, o)), then the adjacency in place of dyn
  float* pbase = a.scratch + S.pbase + (size_t)blk * K * PP;
  for (int p = tid; p < K * PP; p += kThreads) {
    const int k = p / PP, ij = p - k * PP;
    float s = 0.f;
    for (int tt = 0; tt < tn; ++tt) s += dd[(k * TILE + tt) * PP + ij];
    pbase[p] = s;
  }
  float* ddyn = a.scratch + S.ddyn + (size_t)n * K * REF * PP;
  for (int idx = tid; idx < K * tn * PP; idx += kThreads) {
    const int k = idx / (tn * PP), rem = idx - k * tn * PP;
    const int tt = rem / PP, ij = rem - tt * PP;
    const int e = (k * TILE + tt) * PP + ij;
    ddyn[((size_t)k * REF + o0 + tt) * PP + ij] = alpha * dd[e];
    dyn[e] = dyn[e] * alpha + __ldg(a.base + k * PP + ij);
  }
  float* pbrm = a.scratch + S.pbrm + (size_t)n * K * REF;
  for (int kt = warp; kt < K * tn; kt += kWarps) {
    const int k = kt / tn, tt = kt - k * tn;
    const float* d = dd + (k * TILE + tt) * PP;
    float s = 0.f;
    for (int ij = lane; ij < PP; ij += 32) s += d[ij];
    s = warp_sum(s);
    if (lane == 0) pbrm[k * REF + o0 + tt] = alpha * s;
  }
  __syncthreads();

  // dxf through the aggregation, into xf's place: right dxf[o,b] =
  // sum_m adj[o,b,m] g[o,m]; left dxf[o,b] = sum_m adj[o,m,b] g[o,m]
  dstd_mma::block_mma<Kind, kNarrow>(
      K * tn, P, Co, 1, P,
      [&](int bt, int b, int, int m) {
        const int k = bt / tn, tt = bt - k * tn;
        const float* A = dyn + (k * TILE + tt) * PP;
        return left ? A[m * P + b] : A[b * P + m];
      },
      [&](int bt, int, int m, int c) {
        const int tt = bt % tn;
        return gs[(tt * P + m) * CS + c];
      },
      [&](int bt, int b, int c, float v) {
        const int k = bt / tn, tt = bt - k * tn;
        xf[((k * TILE + tt) * P + b) * CS + c] = v;
      });
  __syncthreads();

  // dx of the tile's rows = sum_k dxf[k] wf[k]^T (the first contribution)
  dstd_mma::block_mma<Kind>(
      1, rows, Ci, K, Co,
      [&](int, int m, int k, int c) {
        return xf[(k * TILE * P + m) * CS + c];
      },
      [&](int, int k, int c, int ci) { return wfs[(k * Ci + ci) * CS + c]; },
      [&](int, int m, int ci, float v) {
        const int tt = m / P, b = m - tt * P;
        dxn[(size_t)xrow<TEMPORAL>(o0 + tt, b, V) * Ci + ci] = v;
      });
  // dwf / dbf partials over the tile's rows
  float* pwf = a.scratch + S.pwf + (size_t)blk * K * Ci * Co;
  dstd_mma::block_mma<Kind, kNarrow>(
      K, Ci, Co, 1, rows,
      [&](int, int ci, int, int m) { return xs[m * XS + ci]; },
      [&](int k, int, int m, int c) {
        return xf[(k * TILE * P + m) * CS + c];
      },
      [&](int k, int ci, int c, float v) { pwf[(k * Ci + ci) * Co + c] = v; });
  float* pbf = a.scratch + S.pbf + (size_t)blk * K * Co;
  for (int i = tid; i < K * Co; i += kThreads) {
    const int k = i / Co, c = i - k * Co;
    float acc = 0.f;
    for (int lr = 0; lr < rows; ++lr) acc += xf[(k * TILE * P + lr) * CS + c];
    pbf[i] = acc;
  }
}

// Pass 2: out_bf16 in the bf16 kernels, out_f32 in the float32 ones.
template <bool TEMPORAL, int TILE, typename Rnd>
__global__ void __launch_bounds__(kThreads) out_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  if constexpr (std::is_same_v<Rnd, Bf16>)
    out_bf16<TEMPORAL, TILE>(a, reinterpret_cast<char*>(smem4));
  else
    out_f32<TEMPORAL, TILE>(a, reinterpret_cast<float*>(smem4));
}

// Pass 3: one block per (tile of source indices s, sample n).  The
// temporal kernels are compiled for two blocks per SM (at most 64 registers
// a thread): without, their split dwrm takes more registers (bf16 110,
// float32 95-97), one block per SM, measured slower in both dtypes, though
// at 64 the float32 one spills 8 bytes a thread at tiles 3, 5 and 7 (none
// at its tile 4; PERF.md).  A minimum of 0 leaves the spatial ones to
// ptxas.
template <bool TEMPORAL, int TILE, typename Rnd>
__global__ void __launch_bounds__(kThreads, TEMPORAL ? 2 : 0)
    src_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = a.T, V = a.V, K = a.K, R = a.R, Ci = a.Ci;
  const int REF = TEMPORAL ? V : T, P = TEMPORAL ? T : V;
  const int J = 2 * K * R, JS = J | 1, PP = P * P;
  const int n = blockIdx.y, s0 = blockIdx.x * TILE;
  const int tn = min(TILE, REF - s0), rows = tn * P;
  const int blk = n * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x;
  const LayoutSrc L(T, V, Ci, K, R, TILE, TEMPORAL);
  const Scratch S(a.N, T, V, Ci, a.Co, K, R, TILE, TEMPORAL);
  float* qk = sm + L.qk;
  float* wrow = sm + L.wrow;
  float* su = sm + L.su;
  float* dqk = sm + L.dqk;
  float* wqk = sm + L.wqk;
  // dwrm, and in the float32 kernels ds, on the tensor cores
  using Kind = MmaKind<Rnd>;
  const size_t TV = (size_t)T * V;
  const float* xn = a.x + n * TV * Ci;
  float* dxn = a.dx + n * TV * Ci;
  const float* qkn = a.scratch + S.qk + (size_t)n * J * REF * P;
  const float* ddn = a.scratch + S.ddyn + (size_t)n * K * REF * PP;

  // stage the tile's q/k and rows of wrm, and the q/k weights
  for (int i = tid; i < J * tn * P; i += kThreads) {
    const int j = i / (tn * P), rem = i - j * tn * P;
    const int st = rem / P, b = rem - st * P;
    qk[(j * TILE + st) * P + b] = qkn[((size_t)j * REF + s0 + st) * P + b];
  }
  for (int i = tid; i < K * R * tn * REF; i += kThreads) {
    const int kr = i / (tn * REF), rem = i - kr * tn * REF;
    const int st = rem / REF, o = rem - st * REF;
    wrow[(kr * TILE + st) * REF + o] =
        Rnd::r(__ldg(a.wrm + ((size_t)kr * REF + s0 + st) * REF + o));
  }
  for (int i = tid; i < Ci * J; i += kThreads) {
    const int ci = i / J, j = i - ci * J;
    const int k = j / (2 * R), jr = j - k * 2 * R;
    wqk[ci * JS + j] =
        Rnd::r(jr < R ? __ldg(a.wm1 + (k * Ci + ci) * R + jr)
                      : __ldg(a.wm2 + (k * Ci + ci) * R + jr - R));
  }
  __syncthreads();

  // the tile's scores
  for (int idx = tid; idx < K * R * tn * PP; idx += kThreads) {
    const int krt = idx / PP, ij = idx - krt * PP, i = ij / P, j = ij - i * P;
    const int kr = krt / tn, st = krt - kr * tn, k = kr / R, r = kr - k * R;
    const float q = qk[((k * 2 * R + r) * TILE + st) * P + i];
    const float kk = qk[((k * 2 * R + R + r) * TILE + st) * P + j];
    su[(kr * TILE + st) * PP + ij] = tanhf(q - kk);
  }
  __syncthreads();

  // dwrm[k,r,s,o] = sum_{i,j} S[k,r,s,i,j] ddyn[k,o,i,j]
  float* pwrm = a.scratch + S.pwrm + (size_t)n * K * R * REF * REF;
  // per k an (R tn, REF) product over the P^2 pairs, rows (r, s), in
  // 16 x 8 tiles, as the long depth with ddyn read from L2 wants many
  // warps in flight: one tile a warp in the spatial kernel (10 tiles at
  // T = 35, 484 pairs); in the temporal one (3 tiles at V = 22, 1225
  // pairs) the depth split over the warps of each tile
  auto la = [&](int k, int m, int, int ij) {
    const int r = m / tn, st = m - r * tn;
    return Rnd::r(su[((k * R + r) * TILE + st) * PP + ij]);
  };
  auto lb = [&](int k, int, int ij, int o) {
    return __ldg(ddn + ((size_t)k * REF + o) * PP + ij);
  };
  auto store = [&](int k, int m, int o, float v) {
    const int r = m / tn, st = m - r * tn;
    pwrm[((size_t)(k * R + r) * REF + s0 + st) * REF + o] = v;
  };
  if constexpr (TEMPORAL)
    dstd_mma::block_mma_split<Kind>(sm + L.part, K, R * tn, REF, 1, PP, la,
                                    lb, store);
  else
    dstd_mma::block_mma<Kind, 1>(K, R * tn, REF, 1, PP, la, lb, store);
  __syncthreads();

  // ds = sum_o wrm[k,r,s,o] ddyn[k,o,i,j]; du = ds (1 - S^2) over S
  if constexpr (std::is_same_v<Kind, dstd_mma::Tf32x3Mma>) {
    // per k a product over the REF output indices with rows (r, s) and
    // columns the P^2 pairs, each ddyn element read once a block (the loop
    // below reads it once per r); the temporal op takes its transpose
    // (rows the 1225 frame pairs, 16 x 8 a warp: R tn = 8 columns at its
    // tile 4), faster there and fewer registers under its two blocks per
    // SM, the spatial one not (PERF.md)
    auto wr = [&](int k, int m, int o) {
      const int r = m / tn, st = m - r * tn;
      return wrow[((k * R + r) * TILE + st) * REF + o];
    };
    auto dd = [&](int k, int o, int ij) {
      return __ldg(ddn + ((size_t)k * REF + o) * PP + ij);
    };
    auto du = [&](int k, int m, int ij, float v) {
      const int r = m / tn, st = m - r * tn;
      const int e = ((k * R + r) * TILE + st) * PP + ij;
      const float s = su[e];
      su[e] = v * (1.f - s * s);
    };
    if constexpr (TEMPORAL)
      dstd_mma::block_mma<Kind, 1>(
          K, PP, R * tn, 1, REF,
          [&](int k, int ij, int, int o) { return dd(k, o, ij); },
          [&](int k, int, int o, int m) { return wr(k, m, o); },
          [&](int k, int ij, int m, float v) { du(k, m, ij, v); });
    else
      dstd_mma::block_mma<Kind>(
          K, R * tn, PP, 1, REF,
          [&](int k, int m, int, int o) { return wr(k, m, o); },
          [&](int k, int, int o, int ij) { return dd(k, o, ij); }, du);
  } else {
    // the bf16 kernels on the CUDA cores: on bf16 mma.sync ds moved 5b's
    // dx past the card tests' bound (PERF.md)
    for (int p = tid; p < K * PP; p += kThreads) {
      const int k = p / PP, ij = p - k * PP;
      for (int r = 0; r < R; ++r) {
        const float* wr = wrow + (k * R + r) * TILE * REF;
        float acc[TILE];
#pragma unroll
        for (int st = 0; st < TILE; ++st) acc[st] = 0.f;
        for (int o = 0; o < REF; ++o) {
          const float d = ddn[((size_t)k * REF + o) * PP + ij];
#pragma unroll
          for (int st = 0; st < TILE; ++st)
            acc[st] = fmaf(wr[st * REF + o], d, acc[st]);
        }
#pragma unroll
        for (int st = 0; st < TILE; ++st) {
          if (st < tn) {
            const int e = ((k * R + r) * TILE + st) * PP + ij;
            const float s = su[e];
            su[e] = acc[st] * (1.f - s * s);
          }
        }
      }
    }
  }
  __syncthreads();

  // dq[s,i] = sum_j du[s,i,j]; dk[s,j] = -sum_i du[s,i,j]
  for (int idx = tid; idx < K * R * tn * P; idx += kThreads) {
    const int krt = idx / P, b = idx - krt * P;
    const int kr = krt / tn, st = krt - kr * tn, k = kr / R, r = kr - k * R;
    const float* u = su + (kr * TILE + st) * PP;
    float dq = 0.f, dk = 0.f;
    for (int m = 0; m < P; ++m) {
      dq += u[b * P + m];
      dk += u[m * P + b];
    }
    const int lr = st * P + b;
    dqk[lr * J + k * 2 * R + r] = dq;
    dqk[lr * J + k * 2 * R + R + r] = -dk;
  }
  __syncthreads();

  // dx of the tile's rows += dqk wqk^T (pass 2 stored the first part)
  for (int i = tid; i < rows * Ci; i += kThreads) {
    const int lr = i / Ci, ci = i - lr * Ci, st = lr / P, b = lr - st * P;
    float acc = 0.f;
    for (int j = 0; j < J; ++j)
      acc = fmaf(Rnd::r(dqk[lr * J + j]), wqk[ci * JS + j], acc);
    dxn[(size_t)xrow<TEMPORAL>(s0 + st, b, V) * Ci + ci] += acc;
  }
  // dwqk / dbqk partials over the tile's rows
  float* pwqk = a.scratch + S.pwqk + (size_t)blk * Ci * J;
  for (int i = tid; i < Ci * J; i += kThreads) {
    const int ci = i / J, j = i - ci * J;
    float acc = 0.f;
    for (int lr = 0; lr < rows; ++lr) {
      const int st = lr / P, b = lr - st * P;
      acc = fmaf(
          Rnd::r(__ldg(xn + (size_t)xrow<TEMPORAL>(s0 + st, b, V) * Ci + ci)),
          Rnd::r(dqk[lr * J + j]), acc);
    }
    pwqk[i] = acc;
  }
  float* pbqk = a.scratch + S.pbqk + (size_t)blk * J;
  for (int j = tid; j < J; j += kThreads) {
    float acc = 0.f;
    for (int lr = 0; lr < rows; ++lr) acc += dqk[lr * J + j];
    pbqk[j] = acc;
  }
}

// Element counts of the weight gradients, in the order the reduction
// walks them.
struct GradSizes {
  int wf, bf, base, alpha, brm, wrm, wm, bm, total;
  __host__ __device__ GradSizes(int T, int V, int Ci, int Co, int K, int R,
                                bool temporal) {
    const int REF = temporal ? V : T, P = temporal ? T : V;
    wf = K * Ci * Co;
    bf = K * Co;
    base = K * P * P;
    alpha = 1;
    brm = K * REF;
    wrm = K * R * REF * REF;
    wm = K * Ci * R;  // each of wm1, wm2
    bm = K * R;       // each of bm1, bm2
    total = wf + bf + base + alpha + brm + wrm + 2 * wm + 2 * bm;
  }
};

// Pass 4: each weight-gradient element is the sum of its partials in block
// (or sample) order.
template <bool TEMPORAL>
__global__ void __launch_bounds__(kSmallThreads)
    reduce_kernel(const BwdArgs a) {
  const int T = a.T, V = a.V, Ci = a.Ci, Co = a.Co, K = a.K, R = a.R;
  const int REF = TEMPORAL ? V : T, J = 2 * K * R;
  const int nb = a.N * ((REF + a.tile - 1) / a.tile);
  const Scratch S(a.N, T, V, Ci, Co, K, R, a.tile, TEMPORAL);
  const GradSizes G(T, V, Ci, Co, K, R, TEMPORAL);
  const float* sc = a.scratch;
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  auto sum = [&](long long off, int count, int stride, int i) {
    float s = 0.f;
    for (int b = 0; b < count; ++b) s += sc[off + (long long)b * stride + i];
    return s;
  };
  if (e < G.wf) { a.dwf[e] = sum(S.pwf, nb, G.wf, e); return; }
  e -= G.wf;
  if (e < G.bf) { a.dbf[e] = sum(S.pbf, nb, G.bf, e); return; }
  e -= G.bf;
  if (e < G.base) { a.dbase[e] = sum(S.pbase, nb, G.base, e); return; }
  e -= G.base;
  if (e < G.alpha) { a.dalpha[0] = sum(S.palpha, nb, 1, 0); return; }
  e -= G.alpha;
  if (e < G.brm) { a.dbrm[e] = sum(S.pbrm, a.N, G.brm, e); return; }
  e -= G.brm;
  if (e < G.wrm) { a.dwrm[e] = sum(S.pwrm, a.N, G.wrm, e); return; }
  e -= G.wrm;
  if (e < 2 * G.wm) {  // dwm1 / dwm2 [k][ci][r] from dwqk [ci][j]
    const int which = e / G.wm, i = e - which * G.wm;
    const int k = i / (Ci * R), ci = (i / R) % Ci, r = i % R;
    const float s =
        sum(S.pwqk, nb, Ci * J, ci * J + k * 2 * R + which * R + r);
    (which ? a.dwm2 : a.dwm1)[i] = s;
    return;
  }
  e -= 2 * G.wm;
  if (e < 2 * G.bm) {  // dbm1 / dbm2 [k][r] from dbqk [j]
    const int which = e / G.bm, i = e - which * G.bm;
    const int k = i / R, r = i % R;
    (which ? a.dbm2 : a.dbm1)[i] =
        sum(S.pbqk, nb, J, k * 2 * R + which * R + r);
  }
}

// Shared memory of a pass-2 block (bytes) under rounding policy Rnd
template <bool TEMPORAL, typename Rnd>
long long out_bytes(int T, int V, int Ci, int Co, int K, int R, int tile) {
  if constexpr (std::is_same_v<Rnd, Bf16>)
    return LayoutOutBf16(T, V, Ci, Co, K, R, tile, TEMPORAL).total;
  else
    return LayoutOut(T, V, Ci, Co, K, R, tile, TEMPORAL).total *
           (long long)sizeof(float);
}

// The larger of a pass-2 and a pass-3 block's shared memory (bytes)
template <bool TEMPORAL, typename Rnd>
long long smem_bytes(int T, int V, int Ci, int Co, int K, int R, int tile) {
  const long long out = out_bytes<TEMPORAL, Rnd>(T, V, Ci, Co, K, R, tile);
  const long long src = LayoutSrc(T, V, Ci, K, R, tile, TEMPORAL).total *
                        (long long)sizeof(float);
  return out > src ? out : src;
}

template <bool TEMPORAL, int TILE, typename Rnd>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const int REF = TEMPORAL ? a.V : a.T;
  const dim3 grid((REF + TILE - 1) / TILE, a.N);
  const size_t out_size = (size_t)out_bytes<TEMPORAL, Rnd>(
      a.T, a.V, a.Ci, a.Co, a.K, a.R, TILE);
  const size_t src_bytes =
      LayoutSrc(a.T, a.V, a.Ci, a.K, a.R, TILE, TEMPORAL).total *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      out_kernel<TEMPORAL, TILE, Rnd>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)out_size);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(src_kernel<TEMPORAL, TILE, Rnd>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)src_bytes);
  if (err != cudaSuccess) return err;

  const long long qk_items = (long long)a.N * a.T * a.V * 2 * a.K * a.R;
  const int qk_blocks =
      (int)((qk_items + kSmallThreads - 1) / kSmallThreads);
  qk_kernel<TEMPORAL, Rnd><<<qk_blocks, kSmallThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  out_kernel<TEMPORAL, TILE, Rnd><<<grid, kThreads, out_size, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  src_kernel<TEMPORAL, TILE, Rnd><<<grid, kThreads, src_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total =
      GradSizes(a.T, a.V, a.Ci, a.Co, a.K, a.R, TEMPORAL).total;
  reduce_kernel<TEMPORAL>
      <<<(total + kSmallThreads - 1) / kSmallThreads, kSmallThreads, 0,
         stream>>>(a);
  return cudaGetLastError();
}

// The four launches of one backward call on `stream`; returns the
// cudaError_t of the first that failed (0 = success).
template <bool TEMPORAL, typename Rnd>
int run(const BwdArgs& a, int device, void* stream) {
  if (a.N == 0) return 0;
  if (a.tile < 1 || a.tile > kMaxTile) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (a.tile) {
    case 1: return (int)launch<TEMPORAL, 1, Rnd>(a, st);
    case 2: return (int)launch<TEMPORAL, 2, Rnd>(a, st);
    case 3: return (int)launch<TEMPORAL, 3, Rnd>(a, st);
    case 4: return (int)launch<TEMPORAL, 4, Rnd>(a, st);
    case 5: return (int)launch<TEMPORAL, 5, Rnd>(a, st);
    case 6: return (int)launch<TEMPORAL, 6, Rnd>(a, st);
    case 7: return (int)launch<TEMPORAL, 7, Rnd>(a, st);
    default: return (int)launch<TEMPORAL, 8, Rnd>(a, st);
  }
}

}  // namespace dstd_bwd

// The C interface of one op's backward library: scratch and shared-memory
// sizes (NAME_smem_bytes float32, NAME_bf16_smem_bytes bf16), error
// strings, and the launches (NAME_f32 float32, NAME_bf16 bf16 contraction
// operands).  Argument order: x, g, base, alpha, wf, bf, wm1,
// bm1, wm2, bm2, wrm, brm, then the 11 gradients dx, dbase, dalpha, dwf,
// dbf, dwm1, dbm1, dwm2, dbm2, dwrm, dbrm, the scratch buffer, N, T, V, Ci,
// Co, K, R, agg_left, tile, device, stream.
#define DSTD_BWD_ENTRY(NAME, TEMPORAL, RND)                                   \
  int NAME(const float* x, const float* g, const float* base,                 \
           const float* alpha, const float* wf, const float* bf,              \
           const float* wm1, const float* bm1, const float* wm2,              \
           const float* bm2, const float* wrm, const float* brm, float* dx,   \
           float* dbase, float* dalpha, float* dwf, float* dbf, float* dwm1,  \
           float* dbm1, float* dwm2, float* dbm2, float* dwrm, float* dbrm,   \
           float* scratch, int N, int T, int V, int Ci, int Co, int K, int R, \
           int agg_left, int tile, int device, void* stream) {                \
    const dstd_bwd::BwdArgs a{x,     g,     base,  alpha,   wf,   bf,   wm1,  \
                              bm1,   wm2,   bm2,   wrm,     brm,  dx,   dbase,\
                              dalpha, dwf,  dbf,   dwm1,    dbm1, dwm2, dbm2, \
                              dwrm,  dbrm,  scratch, N,     T,    V,    Ci,   \
                              Co,    K,     R,     agg_left, tile};           \
    return dstd_bwd::run<TEMPORAL, dstd_bwd::RND>(a, device, stream);         \
  }

#define DSTD_BWD_C_API(NAME, TEMPORAL)                                        \
  extern "C" {                                                                \
  long long NAME##_smem_bytes(int T, int V, int Ci, int Co, int K, int R,     \
                              int tile) {                                     \
    return dstd_bwd::smem_bytes<TEMPORAL, dstd_bwd::Exact>(T, V, Ci, Co, K,   \
                                                           R, tile);          \
  }                                                                           \
  long long NAME##_bf16_smem_bytes(int T, int V, int Ci, int Co, int K,       \
                                   int R, int tile) {                         \
    return dstd_bwd::smem_bytes<TEMPORAL, dstd_bwd::Bf16>(T, V, Ci, Co, K, R, \
                                                          tile);              \
  }                                                                           \
  long long NAME##_scratch_floats(int N, int T, int V, int Ci, int Co, int K, \
                                  int R, int tile) {                          \
    return dstd_bwd::Scratch(N, T, V, Ci, Co, K, R, tile, TEMPORAL).total;    \
  }                                                                           \
  const char* dstd_error_string(int err) {                                    \
    return cudaGetErrorString((cudaError_t)err);                              \
  }                                                                           \
  DSTD_BWD_ENTRY(NAME##_f32, TEMPORAL, Exact)                                 \
  DSTD_BWD_ENTRY(NAME##_bf16, TEMPORAL, Bf16)                                 \
  }
