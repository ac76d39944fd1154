// Tensor-core block products for the bf16 DSTD-GC kernels.
//
// block_mma computes what dstd_bwd_common.cuh's block_gemm computes, with
// the same call contract, on Hopper's tensor cores: for every batch entry
// b < batch, C[b][m][n] = sum_{s < S, q < Q} A(b, m, s, q) B(b, s, q, n),
// the loaders la / lb returning floats and st(b, m, n, value) storing.
// Each product is one mma.sync.aligned.m16n8k16 with bf16 inputs and
// float32 accumulators: the bf16 contract of the kernels (the operands of a
// contraction rounded to bf16, products and sums in float32).  Every operand
// the contract feeds to a product is already bf16-rounded where it is
// stored or loaded (dstd::Bf16::r), so the conversion to bf16 here is exact.
//
// Each warp owns one 16 x 32 tile of C[b] (four m16n8 tiles sharing one A
// fragment) at a time; the warps of the block walk over (batch entry, m
// tile, n tile).  The depth runs over s, then q in chunks of 32, two
// products each, zeros past the edge of M, N and Q: no atomics, and the
// order of each sum is fixed, so two calls give the same bits.  The
// fragments are built from the loaders, so a call site passes the same
// lambdas as to block_gemm; ldmatrix and bf16 staging in shared memory are
// not used.  Every loader call runs whatever the edge (indices clamped, the
// value zeroed after): a loader's own index arithmetic (a division of the
// batch index, say) is then loop-invariant code the compiler hoists, where
// a call under a condition would repeat it on every load.
// block_mma_split is block_mma for a product with few output tiles and a
// long depth: it splits the depth over the warps of each tile.
//
// Which depth index fills which slot of a product is free, as long as A
// and B agree.  In a chunk of 32 the slots 2t, 2t+1, 2t+8, 2t+9 of the
// product h (0, 1) take the depths 8t + 4h + 0..3, so the lanes of one
// load read depths 8t + c of rows g: for an operand stored with a row
// stride of 1 modulo 32 floats (the kernels' odd strides Co|1, Ci|1 at 64
// channels) the 32 lanes hit 32 distinct banks, whether the depth runs
// along the row or down the column.  Slots in the usual order (2t + c)
// would put 4 lanes on one bank.
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16
// with floating point type"), g = lane / 4, t = lane % 4:
//   A (16 x 16, row-major), 4 registers of two bf16 (low half first):
//     a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1), a2 (g, 2t+8..2t+9),
//     a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, column-major), 2 registers: b0 (2t..2t+1, g),
//     b1 (2t+8..2t+9, g)
//   C (16 x 8), 4 floats: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//     c3 (g+8, 2t+1)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dstd_mma {

// two floats as one register of two bf16 (round to nearest even), lo in
// the low half
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b, one m16n8k16 tile, bf16 inputs, float32 accumulators
__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's 16 x (8 TILES_N) tile of C[b] at rows m0, columns n0: the sum
// over s < S and the depths q_lo <= q < q_hi (q_lo a multiple of 32) added
// into acc, the C fragments of its n8 tiles.
template <int TILES_N, typename LA, typename LB>
__device__ __forceinline__ void warp_tile(float (&acc)[TILES_N][4], int b,
                                          int M, int Nn, int S, int Q,
                                          int m0, int n0, int q_lo, int q_hi,
                                          LA& la, LB& lb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = m0 + g, r1 = r0 + 8;
  const bool in0 = r0 < M, in1 = r1 < M;
  // rows and columns past the edge are clamped on load and zeroed after
  const int l0 = min(r0, M - 1), l1 = min(r1, M - 1);
  // the warp's n8 tiles that reach into N (the same for every lane; the
  // first always does)
  const int live = min(TILES_N, (Nn - n0 + 7) >> 3);
  for (int s = 0; s < S; ++s) {
    for (int q0 = q_lo; q0 < q_hi; q0 += 32) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && q0 + 4 >= Q) break;
        // the depth of this lane's four slots 2t, 2t+1, 2t+8, 2t+9
        const int d = q0 + 8 * t + 4 * h;
        float av[2][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = min(d + c, Q - 1);
          const float v0 = la(b, l0, s, q), v1 = la(b, l1, s, q);
          av[0][c] = in0 && d + c < Q ? v0 : 0.f;
          av[1][c] = in1 && d + c < Q ? v1 : 0.f;
        }
        const uint32_t a[4] = {pack_bf16(av[0][0], av[0][1]),
                               pack_bf16(av[1][0], av[1][1]),
                               pack_bf16(av[0][2], av[0][3]),
                               pack_bf16(av[1][2], av[1][3])};
#pragma unroll
        for (int j = 0; j < TILES_N; ++j) {
          if (j == 0 || j < live) {
            const int col = n0 + 8 * j + g, lc = min(col, Nn - 1);
            float bv[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float v = lb(b, s, min(d + c, Q - 1), lc);
              bv[c] = col < Nn && d + c < Q ? v : 0.f;
            }
            const uint32_t bb[2] = {pack_bf16(bv[0], bv[1]),
                                    pack_bf16(bv[2], bv[3])};
            mma_bf16(acc[j], a, bb);
          }
        }
      }
    }
  }
}

// TILES_N: the n8 tiles of C one warp owns (16 x 32 at 4): the A fragment
// of a depth step feeds all of them.
template <int TILES_N = 4, typename LA, typename LB, typename ST>
__device__ inline void block_mma(int batch, int M, int Nn, int S, int Q,
                                 LA la, LB lb, ST st) {
  constexpr int kWarpN = 8 * TILES_N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = (M + 15) >> 4, nt = (Nn + kWarpN - 1) / kWarpN;
  const int per = mt * nt;
  for (int task = warp; task < batch * per; task += warps) {
    const int b = task / per, rem = task - b * per;
    const int m_t = rem / nt;
    const int m0 = m_t << 4, n0 = (rem - m_t * nt) * kWarpN;
    float acc[TILES_N][4];
#pragma unroll
    for (int j = 0; j < TILES_N; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    warp_tile<TILES_N>(acc, b, M, Nn, S, Q, m0, n0, 0, Q, la, lb);
    const int r0 = m0 + g, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < TILES_N; ++j) {
      const int c0 = n0 + 8 * j + 2 * t;
      if (r0 < M && c0 < Nn) st(b, r0, c0, acc[j][0]);
      if (r0 < M && c0 + 1 < Nn) st(b, r0, c0 + 1, acc[j][1]);
      if (r1 < M && c0 < Nn) st(b, r1, c0, acc[j][2]);
      if (r1 < M && c0 + 1 < Nn) st(b, r1, c0 + 1, acc[j][3]);
    }
  }
}

// Floats of shared memory block_mma_split needs for a product with up to
// `tiles` 16 x 8 output tiles (batch x m tiles x n tiles) in a block of
// `warps` warps.
__host__ __device__ inline long long split_floats(long long tiles,
                                                  int warps) {
  return (tiles > warps ? tiles : warps) * 16LL * 8;
}

// block_mma in 16 x 8 tiles for a product with fewer output tiles than the
// block has warps and a long depth: the depth's 32-deep chunks are split
// over parts = warps / tiles warps per output tile.  Each warp writes its
// partial tile to `part` (split_floats of shared memory); after a barrier
// every output is the sum of its partials in part order, so the order of
// each sum is still fixed.  Every thread of the block must call it.
template <typename LA, typename LB, typename ST>
__device__ inline void block_mma_split(float* part, int batch, int M, int Nn,
                                       int S, int Q, LA la, LB lb, ST st) {
  constexpr int kTile = 16 * 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = (M + 15) >> 4, nt = (Nn + 7) >> 3;
  const int tiles = batch * mt * nt;
  const int parts = max(1, warps / tiles), chunks = (Q + 31) >> 5;
  for (int task = warp; task < tiles * parts; task += warps) {
    const int tile = task / parts, p = task - tile * parts;
    const int b = tile / (mt * nt), rem = tile - b * mt * nt;
    const int m_t = rem / nt;
    const int m0 = m_t << 4, n0 = (rem - m_t * nt) << 3;
    float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    const int q_lo = (p * chunks / parts) << 5;
    const int q_hi = min(((p + 1) * chunks / parts) << 5, Q);
    warp_tile<1>(acc, b, M, Nn, S, Q, m0, n0, q_lo, q_hi, la, lb);
    float* out = part + (size_t)task * kTile;
    out[g * 8 + 2 * t] = acc[0][0];
    out[g * 8 + 2 * t + 1] = acc[0][1];
    out[(g + 8) * 8 + 2 * t] = acc[0][2];
    out[(g + 8) * 8 + 2 * t + 1] = acc[0][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < batch * M * Nn; e += blockDim.x) {
    const int b = e / (M * Nn), rem = e - b * M * Nn;
    const int m = rem / Nn, n = rem - m * Nn;
    const int tile = (b * mt + (m >> 4)) * nt + (n >> 3);
    const float* in =
        part + (size_t)tile * parts * kTile + (m & 15) * 8 + (n & 7);
    float v = 0.f;
    for (int p = 0; p < parts; ++p) v += in[p * kTile];
    st(b, m, n, v);
  }
}

}  // namespace dstd_mma
