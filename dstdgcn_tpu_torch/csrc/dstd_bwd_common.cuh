// Whole-op backward of the DSTD-GC ops (float32), shared by
// dstd_spatial_bwd.cu and dstd_temporal_bwd.cu.
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
//      and writes partial sums of dwrm (a warp per entry), dwqk, dbqk.
// The five products of pass 2 (features, dA, dxf, dx, dwf) run as
// register-tiled block products (block_gemm: 4 x 4 outputs per thread).
//   4. reduce_kernel: sums each partial array in a fixed order, one thread
//      per weight-gradient element.  No atomics: the result is the same from
//      run to run.
// ddyn couples every output index with every source index (ds needs ddyn of
// all o), which is why passes 2 and 3 are separate launches: each block of
// pass 2 writes its tile's share of a sample's ddyn to scratch, and each
// block of pass 3 reads all of it back (135 KB spatial, 108 KB temporal at
// V = 22, T = 35); at N = 32 the whole scratch (about 14 MB) stays in the
// 50 MB L2 between the launches.
#pragma once

#include "dstd_common.cuh"

namespace dstd_bwd {

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

// Shared memory of a pass-2 block (floats): wmix [K][R][REF][tile] (the
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

// Shared memory of a pass-3 block (floats): qk [J][tile][P] (the tile's
// q/k), wrow [K][R][tile][REF] (the tile's rows of wrm), su [K][R][tile][P*P]
// (scores, then du), dqk [tile*P][J], wqk [Ci][J|1].
struct LayoutSrc {
  long long qk, wrow, su, dqk, wqk, total;
  __host__ __device__ LayoutSrc(int T, int V, int Ci, int K, int R, int tile,
                                bool temporal) {
    const long long REF = temporal ? V : T, P = temporal ? T : V;
    const long long J = 2LL * K * R;
    qk = 0;
    wrow = qk + round4(J * tile * P);
    su = wrow + round4((long long)K * R * tile * REF);
    dqk = su + round4((long long)K * R * tile * P * P);
    wqk = dqk + round4((long long)tile * P * J);
    total = wqk + round4((long long)Ci * (J | 1));
  }
};

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Register-tiled products inside one block: for every batch entry
// b < batch, C[b][m][n] = sum_{s < S, q < Q} A(b, m, s, q) B(b, s, q, n).
// Each thread owns 4 x 4 outputs, rows m_t + u*mt and columns n_t + w*nt
// (u, w < 4), so 8 loads feed 16 FMAs and neighbouring threads load
// neighbouring columns; indices past the edge are clamped on load and
// skipped on store.  la / lb load A / B, st(b, m, n, value) stores.
template <typename LA, typename LB, typename ST>
__device__ inline void block_gemm(int batch, int M, int Nn, int S, int Q,
                                  LA la, LB lb, ST st) {
  const int mt = (M + 3) >> 2, nt = (Nn + 3) >> 2, per = mt * nt;
  for (int task = threadIdx.x; task < batch * per; task += blockDim.x) {
    const int b = task / per, rem = task - b * per;
    const int m_t = rem / nt, n_t = rem - m_t * nt;
    int mi[4], ni[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      mi[u] = min(m_t + u * mt, M - 1);
      ni[u] = min(n_t + u * nt, Nn - 1);
    }
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[u][w] = 0.f;
    for (int s = 0; s < S; ++s) {
      for (int q = 0; q < Q; ++q) {
        float av[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) av[u] = la(b, mi[u], s, q);
#pragma unroll
        for (int w = 0; w < 4; ++w) bv[w] = lb(b, s, q, ni[w]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            acc[u][w] = fmaf(av[u], bv[w], acc[u][w]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (m_t + u * mt < M && n_t + w * nt < Nn)
          st(b, m_t + u * mt, n_t + w * nt, acc[u][w]);
  }
}

// x / g / dx row of (mixing index s, pair index i)
template <bool TEMPORAL>
__device__ inline int xrow(int s, int i, int V) {
  return TEMPORAL ? i * V + s : s * V + i;
}

// Pass 1: q/k of every row, qk[n][j][s][i], column j = k*2R + r (query) or
// k*2R + R + r (key).
template <bool TEMPORAL>
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
      acc = fmaf(__ldg(xr + ci), __ldg(w + (size_t)ci * R), acc);
    const int t = row / V, v = row - t * V;
    const int s = TEMPORAL ? v : t, i = TEMPORAL ? t : v;
    qk[(((size_t)n * J + j) * REF + s) * P + i] = acc + b;
  }
}

// Pass 2: one block per (tile of output indices o, sample n).
template <bool TEMPORAL, int TILE>
__global__ void __launch_bounds__(kThreads) out_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
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
  const float alpha = __ldg(a.alpha);
  const size_t TV = (size_t)T * V;
  const float* xn = a.x + n * TV * Ci;
  const float* gn = a.g + n * TV * Co;
  float* dxn = a.dx + n * TV * Ci;

  // stage the tile's mixing columns, the sample's q/k, the tile's rows of
  // g and the feature weights; project the tile's features
  for (int i = tid; i < K * R * REF * TILE; i += kThreads) {
    const int tt = i % TILE, krs = i / TILE;  // krs = (k*R + r)*REF + s
    wmix[i] = tt < tn ? __ldg(a.wrm + (size_t)krs * REF + o0 + tt) : 0.f;
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
  block_gemm(
      K, rows, Co, 1, Ci,
      [&](int, int m, int, int q) { return xs[m * XS + q]; },
      [&](int k, int, int q, int n) { return wfs[(k * Ci + q) * CS + n]; },
      [&](int k, int m, int n, float v) {
        xf[(k * TILE * P + m) * CS + n] = v + __ldg(a.bf + k * Co + n);
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
  block_gemm(
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
  block_gemm(
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
  block_gemm(
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
  block_gemm(
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

// Pass 3: one block per (tile of source indices s, sample n).
template <bool TEMPORAL, int TILE>
__global__ void __launch_bounds__(kThreads) src_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = a.T, V = a.V, K = a.K, R = a.R, Ci = a.Ci;
  const int REF = TEMPORAL ? V : T, P = TEMPORAL ? T : V;
  const int J = 2 * K * R, JS = J | 1, PP = P * P;
  const int n = blockIdx.y, s0 = blockIdx.x * TILE;
  const int tn = min(TILE, REF - s0), rows = tn * P;
  const int blk = n * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const LayoutSrc L(T, V, Ci, K, R, TILE, TEMPORAL);
  const Scratch S(a.N, T, V, Ci, a.Co, K, R, TILE, TEMPORAL);
  float* qk = sm + L.qk;
  float* wrow = sm + L.wrow;
  float* su = sm + L.su;
  float* dqk = sm + L.dqk;
  float* wqk = sm + L.wqk;
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
        __ldg(a.wrm + ((size_t)kr * REF + s0 + st) * REF + o);
  }
  for (int i = tid; i < Ci * J; i += kThreads) {
    const int ci = i / J, j = i - ci * J;
    const int k = j / (2 * R), jr = j - k * 2 * R;
    wqk[ci * JS + j] = jr < R ? __ldg(a.wm1 + (k * Ci + ci) * R + jr)
                              : __ldg(a.wm2 + (k * Ci + ci) * R + jr - R);
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

  // dwrm[k,r,s,o] = sum_{i,j} S[k,r,s,i,j] ddyn[k,o,i,j]: a warp per entry
  float* pwrm = a.scratch + S.pwrm + (size_t)n * K * R * REF * REF;
  for (int task = warp; task < K * R * tn * REF; task += kWarps) {
    const int krt = task / REF, o = task - krt * REF;
    const int kr = krt / tn, st = krt - kr * tn, k = kr / R;
    const float* sv = su + (kr * TILE + st) * PP;
    const float* dv = ddn + ((size_t)k * REF + o) * PP;
    float acc = 0.f;
    for (int ij = lane; ij < PP; ij += 32) acc = fmaf(sv[ij], dv[ij], acc);
    acc = warp_sum(acc);
    if (lane == 0) pwrm[((size_t)kr * REF + s0 + st) * REF + o] = acc;
  }
  __syncthreads();

  // ds = sum_o wrm[k,r,s,o] ddyn[k,o,i,j]; du = ds (1 - S^2) over S
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
      acc = fmaf(dqk[lr * J + j], wqk[ci * JS + j], acc);
    dxn[(size_t)xrow<TEMPORAL>(s0 + st, b, V) * Ci + ci] += acc;
  }
  // dwqk / dbqk partials over the tile's rows
  float* pwqk = a.scratch + S.pwqk + (size_t)blk * Ci * J;
  for (int i = tid; i < Ci * J; i += kThreads) {
    const int ci = i / J, j = i - ci * J;
    float acc = 0.f;
    for (int lr = 0; lr < rows; ++lr) {
      const int st = lr / P, b = lr - st * P;
      acc = fmaf(__ldg(xn + (size_t)xrow<TEMPORAL>(s0 + st, b, V) * Ci + ci),
                 dqk[lr * J + j], acc);
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

template <bool TEMPORAL>
long long smem_bytes(int T, int V, int Ci, int Co, int K, int R, int tile) {
  const long long out = LayoutOut(T, V, Ci, Co, K, R, tile, TEMPORAL).total;
  const long long src = LayoutSrc(T, V, Ci, K, R, tile, TEMPORAL).total;
  return (out > src ? out : src) * (long long)sizeof(float);
}

template <bool TEMPORAL, int TILE>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const int REF = TEMPORAL ? a.V : a.T;
  const dim3 grid((REF + TILE - 1) / TILE, a.N);
  const size_t out_bytes =
      LayoutOut(a.T, a.V, a.Ci, a.Co, a.K, a.R, TILE, TEMPORAL).total *
      sizeof(float);
  const size_t src_bytes =
      LayoutSrc(a.T, a.V, a.Ci, a.K, a.R, TILE, TEMPORAL).total *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      out_kernel<TEMPORAL, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)out_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(src_kernel<TEMPORAL, TILE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)src_bytes);
  if (err != cudaSuccess) return err;

  const long long qk_items = (long long)a.N * a.T * a.V * 2 * a.K * a.R;
  const int qk_blocks =
      (int)((qk_items + kSmallThreads - 1) / kSmallThreads);
  qk_kernel<TEMPORAL><<<qk_blocks, kSmallThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  out_kernel<TEMPORAL, TILE><<<grid, kThreads, out_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  src_kernel<TEMPORAL, TILE><<<grid, kThreads, src_bytes, stream>>>(a);
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
template <bool TEMPORAL>
int run(const BwdArgs& a, int device, void* stream) {
  if (a.N == 0) return 0;
  if (a.tile < 1 || a.tile > kMaxTile) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (a.tile) {
    case 1: return (int)launch<TEMPORAL, 1>(a, st);
    case 2: return (int)launch<TEMPORAL, 2>(a, st);
    case 3: return (int)launch<TEMPORAL, 3>(a, st);
    case 4: return (int)launch<TEMPORAL, 4>(a, st);
    case 5: return (int)launch<TEMPORAL, 5>(a, st);
    case 6: return (int)launch<TEMPORAL, 6>(a, st);
    case 7: return (int)launch<TEMPORAL, 7>(a, st);
    default: return (int)launch<TEMPORAL, 8>(a, st);
  }
}

}  // namespace dstd_bwd

// The C interface of one op's backward library: scratch and shared-memory
// sizes, error strings, and the launch.  Argument order: x, g, base, alpha,
// wf, bf, wm1, bm1, wm2, bm2, wrm, brm, then the 11 gradients dx, dbase,
// dalpha, dwf, dbf, dwm1, dbm1, dwm2, dbm2, dwrm, dbrm, the scratch buffer,
// N, T, V, Ci, Co, K, R, agg_left, tile, device, stream.
#define DSTD_BWD_C_API(NAME, TEMPORAL)                                        \
  extern "C" {                                                                \
  long long NAME##_smem_bytes(int T, int V, int Ci, int Co, int K, int R,     \
                              int tile) {                                     \
    return dstd_bwd::smem_bytes<TEMPORAL>(T, V, Ci, Co, K, R, tile);          \
  }                                                                           \
  long long NAME##_scratch_floats(int N, int T, int V, int Ci, int Co, int K, \
                                  int R, int tile) {                          \
    return dstd_bwd::Scratch(N, T, V, Ci, Co, K, R, tile, TEMPORAL).total;    \
  }                                                                           \
  const char* dstd_error_string(int err) {                                    \
    return cudaGetErrorString((cudaError_t)err);                              \
  }                                                                           \
  int NAME##_f32(const float* x, const float* g, const float* base,           \
                 const float* alpha, const float* wf, const float* bf,        \
                 const float* wm1, const float* bm1, const float* wm2,        \
                 const float* bm2, const float* wrm, const float* brm,        \
                 float* dx, float* dbase, float* dalpha, float* dwf,          \
                 float* dbf, float* dwm1, float* dbm1, float* dwm2,           \
                 float* dbm2, float* dwrm, float* dbrm, float* scratch,       \
                 int N, int T, int V, int Ci, int Co, int K, int R,           \
                 int agg_left, int tile, int device, void* stream) {          \
    const dstd_bwd::BwdArgs a{x,     g,     base,  alpha,   wf,   bf,   wm1,  \
                              bm1,   wm2,   bm2,   wrm,     brm,  dx,   dbase,\
                              dalpha, dwf,  dbf,   dwm1,    dbm1, dwm2, dbm2, \
                              dwrm,  dbrm,  scratch, N,     T,    V,    Ci,   \
                              Co,    K,     R,     agg_left, tile};           \
    return dstd_bwd::run<TEMPORAL>(a, device, stream);                        \
  }                                                                           \
  }
