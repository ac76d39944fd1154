// Tensor-core block products for the DSTD-GC backward kernels, and the
// element kinds the forward body (dstd_fwd_mma.cuh) runs its products in.
//
// block_mma computes a batch of block products inside one thread block on
// Hopper's tensor cores: for every batch entry b < batch,
// C[b][m][n] = sum_{s < S, q < Q} A(b, m, s, q) B(b, s, q, n), the loaders
// la / lb returning floats and st(b, m, n, value) storing.
// The element kind of the product is a template argument:
//  - Bf16Mma: one mma.sync.aligned.m16n8k16 with bf16 inputs and float32
//    accumulators, the bf16 contract of the kernels (the operands of a
//    contraction rounded to bf16, products and sums in float32).  Every
//    operand the contract feeds to a product is already bf16-rounded where
//    it is stored or loaded (dstd::Bf16::r), so the conversion here is
//    exact.
//  - Tf32x3Mma: float32 products to float32 accuracy on the TF32 tensor
//    cores ("3xTF32").  Each operand x splits into big = tf32(x) (round to
//    nearest, ties away, 10 mantissa bits: the rounding of
//    cvt.rna.tf32.f32) and small = x - big (exact in float32), which the
//    tensor core reads as TF32 by ignoring its low 13 bits (round toward
//    zero); each m16n8k8 step sums small_a big_b + big_a small_b +
//    big_a big_b in a zeroed float32 accumulator, three
//    mma.sync.aligned.m16n8k8 .tf32, and adds it to the running sum on
//    the CUDA cores.  big + small is within 2^-21 of each operand and the
//    term left out, small_a small_b, is below 2^-22 of the product; one
//    TF32 pass alone would err by about 2^-11 of each operand, beyond the
//    float32 kernels' 1e-4 bound over long sums
//    (tests/test_torch_tf32x3.py).
//
// Each warp owns one 16 x 8 TILES_N tile of C[b] (TILES_N m16n8 tiles
// sharing one A fragment; 16 x 32 by default) at a time; the warps of the
// block walk over (batch entry, m tile, n tile).  The depth runs over s,
// then q in chunks of 32 (two bf16 steps of 16, four TF32 steps of 8),
// zeros past the edge of M, N and Q: no atomics, and the order of each sum
// is fixed, so two calls give the same bits.  The fragments are built from
// the loaders, one element a call (pass 3 of both backward kernels and
// pass 2 of the float32 ones).  At the
// edge every loader call still runs (indices clamped, the value zeroed
// after): a loader's own index arithmetic (a division of the batch index,
// say) is then loop-invariant code the compiler hoists, where a call under
// a condition would repeat it on every load.  block_mma_split is block_mma
// for a product with few output tiles and a long depth: it splits the
// depth over the warps of each tile.
//
// block_mma_ldsm is the bf16 product on operands already stored as bf16 in
// shared memory (pass 2 of the bf16 backward kernels): each A fragment and
// each pair of B fragments is one ldmatrix.x4, .trans where the operand is
// stored with its depth down the rows (A) or along them (B); no loader
// call, conversion or edge test inside the depth loop, zeros in the
// padding of the operands instead, as in the forward body.
//
// Which depth index fills which slot of a product is free, as long as A
// and B agree.  In a chunk of 32, lane (g, t) of step h holds the kPer
// depths 8t + kPer h + c (c < kPer) of its rows g (and g + 8) and its
// column g: bf16 (kPer 4) slots 2t, 2t+1, 2t+8, 2t+9 of product h (0, 1);
// TF32 (kPer 2) slot t (c = 0) and t+4 (c = 1) of product h (0..3).  The
// lanes of one load then read depths 8t + c of rows g: for an operand
// stored with a row stride of 1 modulo 32 floats (the kernels' odd strides
// Co|1, Ci|1 at 64 channels) the 32 lanes hit 32 distinct banks, whether
// the depth runs along the row or down the column.  Slots in the usual
// order (2t + c, or t) would put 4 lanes on one bank.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16 with
// floating point type" and "... mma.m16n8k8"), g = lane / 4, t = lane % 4:
//   m16n8k16 bf16: A (16 x 16, row-major), 4 registers of two bf16 (low
//     half first): a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1), a2 (g, 2t+8..2t+9),
//     a3 (g+8, 2t+8..2t+9); B (16 x 8, column-major), 2 registers:
//     b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   m16n8k8 tf32: A (16 x 8), 4 registers: a0 (g, t), a1 (g+8, t),
//     a2 (g, t+4), a3 (g+8, t+4); B (8 x 8), 2 registers: b0 (t, g),
//     b1 (t+4, g)
//   C (16 x 8), both, 4 floats: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
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

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ldmatrix: four 8x8 matrices of 16-bit elements (lanes 8m..8m+7 give the
// rows of matrix m, 16 bytes each), as the A fragment of m16n8k16 bf16
// from a row-major 16x16 tile, of m16n8k8 tf32 from a row-major 16x8 tile
// of floats, or the B fragments of two n8 tiles of tf32 from an (n x
// depth) 16x8 tile of floats (or of bf16 from an (n x depth) 16x16 tile)
__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same transposed: B fragments of two n8 tiles from a row-major
// (depth x n) 16x16 tile of bf16, or the A fragment of a 16x16 tile
// stored (depth x m)
__device__ inline void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two matrices (lanes 0-15 give the rows): the B fragment of one n8 tile,
// transposed (bf16) or not (tf32)
__device__ inline void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}
__device__ inline void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// x rounded to TF32 (nearest, ties away from zero), as a float's bits: the
// rounding of cvt.rna.tf32.f32 in two integer instructions (half a TF32
// ulp added to the magnitude, the low 13 bits cleared); ptxas expands
// cvt.rna into a longer sequence (a floating-point test and a select) that
// measured 0.08 ms slower over kernel 6's 7 calls at N = 32 (PERF.md).  A
// NaN whose top mantissa bits are all ones (0x7fffffff) comes out as -0,
// but x - big stays NaN and carries it through the small terms.
__device__ inline uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a b, one m16n8k8 tile, tf32 inputs, float32 accumulators
__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The element kinds of warp_tile.  kPer: the depths of one row (A) or
// column (B) a lane holds in one step; a step is 8 kPer deep, a chunk of 32
// is 8 / kPer steps.  a(av) builds the A fragment from av[row g, g+8][c],
// mma(d, a, bv) adds the product with the B fragment of bv[c].  kInterior:
// chunks wholly inside M, N and Q skip the edge clamps and zeroing (the
// bf16 kernels keep the one path they were measured with).
struct Bf16Mma {
  static constexpr int kPer = 4;
  static constexpr bool kInterior = false;
  struct A {
    uint32_t r[4];
  };
  __device__ static A a(const float (&av)[2][kPer]) {
    return {{pack_bf16(av[0][0], av[0][1]), pack_bf16(av[1][0], av[1][1]),
             pack_bf16(av[0][2], av[0][3]), pack_bf16(av[1][2], av[1][3])}};
  }
  __device__ static void mma(float (&d)[4], const A& a,
                             const float (&bv)[kPer]) {
    const uint32_t b[2] = {pack_bf16(bv[0], bv[1]), pack_bf16(bv[2], bv[3])};
    mma_bf16(d, a.r, b);
  }
};

struct Tf32x3Mma {
  static constexpr int kPer = 2;
  static constexpr bool kInterior = true;
  struct A {
    uint32_t big[4], small[4];
  };
  __device__ static A a(const float (&av)[2][kPer]) {
    const float v[4] = {av[0][0], av[1][0], av[0][1], av[1][1]};
    A f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f.big[i] = tf32(v[i]);
      f.small[i] = __float_as_uint(v[i] - __uint_as_float(f.big[i]));
    }
    return f;
  }
  __device__ static void mma(float (&d)[4], const A& a,
                             const float (&bv)[kPer]) {
    uint32_t big[2], small[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      big[i] = tf32(bv[i]);
      small[i] = __float_as_uint(bv[i] - __uint_as_float(big[i]));
    }
    // the small terms first, then the big one, into a zeroed accumulator
    // added to d on the CUDA cores: the tensor cores truncate each add
    // relative to the accumulator, so adding into d would bias the sum by
    // about 2^-23 of d a step (step accumulation, as the forward's mma_step)
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(s, a.small, big);
    mma_tf32(s, a.big, small);
    mma_tf32(s, a.big, big);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += s[i];
  }
  // The same from fragment registers that hold float32 bits (ldmatrix on
  // staged float32 operands, csrc/dstd_fwd_mma.cuh): the A fragment's
  // split, then the product with a B fragment in the same order.
  __device__ static A a_bits(const uint32_t (&r)[4]) {
    A f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = __uint_as_float(r[i]);
      f.big[i] = tf32(v);
      f.small[i] = __float_as_uint(v - __uint_as_float(f.big[i]));
    }
    return f;
  }
  __device__ static void mma_bits(float (&d)[4], const A& a,
                                  const uint32_t (&b)[2]) {
    uint32_t big[2], small[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = __uint_as_float(b[i]);
      big[i] = tf32(v);
      small[i] = __float_as_uint(v - __uint_as_float(big[i]));
    }
    mma_tf32(d, a.small, big);
    mma_tf32(d, a.big, small);
    mma_tf32(d, a.big, big);
  }
};

// The rows and columns of a warp's tile (g = lane / 4): its rows r0 = m0 + g
// and r1 = r0 + 8, the same clamped into M (l0, l1) and whether they are
// inside (in0, in1), and its n8 tiles that reach into N (live: the same
// for every lane; the first always does).
struct TileRows {
  int r0, r1, l0, l1, live;
  bool in0, in1;
  __device__ TileRows(int M, int Nn, int m0, int n0, int tiles_n) {
    r0 = m0 + ((threadIdx.x & 31) >> 2);
    r1 = r0 + 8;
    in0 = r0 < M;
    in1 = r1 < M;
    l0 = min(r0, M - 1);
    l1 = min(r1, M - 1);
    live = min(tiles_n, (Nn - n0 + 7) >> 3);
  }
};

// One 32-deep chunk (depths q0 ...) of warp_tile's sum at s: with EDGE,
// rows, columns and depths past the edge are clamped on load and zeroed
// after; without, every one is inside.
template <typename K, int TILES_N, bool EDGE, typename LA, typename LB>
__device__ __forceinline__ void warp_chunk(float (&acc)[TILES_N][4], int b,
                                           int Nn, int Q, int s, int q0,
                                           int n0, const TileRows& w, LA& la,
                                           LB& lb) {
  constexpr int kPer = K::kPer;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 8 / kPer; ++h) {
    // the step's lowest depth is q0 + kPer h
    if (EDGE && h > 0 && q0 + kPer * h >= Q) break;
    // the depth of this lane's first slot
    const int d = q0 + 8 * t + kPer * h;
    float av[2][kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      if constexpr (EDGE) {
        const int q = min(d + c, Q - 1);
        const float v0 = la(b, w.l0, s, q), v1 = la(b, w.l1, s, q);
        av[0][c] = w.in0 && d + c < Q ? v0 : 0.f;
        av[1][c] = w.in1 && d + c < Q ? v1 : 0.f;
      } else {
        av[0][c] = la(b, w.r0, s, d + c);
        av[1][c] = la(b, w.r1, s, d + c);
      }
    }
    const typename K::A a = K::a(av);
#pragma unroll
    for (int j = 0; j < TILES_N; ++j) {
      if (!EDGE || j == 0 || j < w.live) {
        const int col = n0 + 8 * j + g, lc = min(col, Nn - 1);
        float bv[kPer];
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          if constexpr (EDGE) {
            const float v = lb(b, s, min(d + c, Q - 1), lc);
            bv[c] = col < Nn && d + c < Q ? v : 0.f;
          } else {
            bv[c] = lb(b, s, d + c, col);
          }
        }
        K::mma(acc[j], a, bv);
      }
    }
  }
}

// One warp's 16 x (8 TILES_N) tile of C[b] at rows m0, columns n0: the sum
// over s < S and the depths q_lo <= q < q_hi (q_lo a multiple of 32) added
// into acc, the C fragments of its n8 tiles, in products of kind K.
template <typename K, int TILES_N, typename LA, typename LB>
__device__ __forceinline__ void warp_tile(float (&acc)[TILES_N][4], int b,
                                          int M, int Nn, int S, int Q,
                                          int m0, int n0, int q_lo, int q_hi,
                                          LA& la, LB& lb) {
  const TileRows w(M, Nn, m0, n0, TILES_N);
  const bool inside =
      K::kInterior && m0 + 16 <= M && n0 + 8 * TILES_N <= Nn;
  for (int s = 0; s < S; ++s) {
    for (int q0 = q_lo; q0 < q_hi; q0 += 32) {
      if (inside && q0 + 32 <= Q)
        warp_chunk<K, TILES_N, false>(acc, b, Nn, Q, s, q0, n0, w, la, lb);
      else
        warp_chunk<K, TILES_N, true>(acc, b, Nn, Q, s, q0, n0, w, la, lb);
    }
  }
}

// K: the element kind (Bf16Mma, Tf32x3Mma); TILES_N: the n8 tiles of C
// one warp owns (16 x 32 at 4): the A fragment of a depth step feeds all
// of them.
template <typename K, int TILES_N = 4, typename LA, typename LB, typename ST>
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
    warp_tile<K, TILES_N>(acc, b, M, Nn, S, Q, m0, n0, 0, Q, la, lb);
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
template <typename K, typename LA, typename LB, typename ST>
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
    warp_tile<K, 1>(acc, b, M, Nn, S, Q, m0, n0, q_lo, q_hi, la, lb);
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

// One bf16 operand of block_mma_ldsm in shared memory: element (row, col)
// of the stored matrix at p[row * ld + col]; rows start on 16 bytes (ld a
// multiple of 8).
struct Smem16 {
  const __nv_bfloat16* p;
  int ld;
};

// block_mma for bf16 operands staged in shared memory, each fragment one
// ldmatrix.x4 (A, and the B fragments of two n8 tiles): for every batch
// entry b < batch, C[b] (M x N) = sum_{s < S, d < D} A[b,s](m, d)
// B[b,s](d, n).  a(b, s) / bm(b, s) give the stored operands: A stored
// (m x depth), or with A_T (depth x m) and read by ldmatrix .trans; B
// stored (depth x n) and read by .trans, or with B_N (n x depth) and read
// as it is.  The depth runs in steps of 16 up to D rounded up: past D, one
// operand must hold zeros and the other finite values there.  Rows and
// columns past M and N are read (their outputs are dropped), so every
// operand's storage reaches the 16-row, 16-column tile that holds its last
// element.  The warps walk over (b, 16-row tile, 8 TILES_N columns) as
// block_mma does; the order of every sum is fixed.  epi(b, m0, n0, live,
// acc) takes a warp's tile: its C fragments acc[j] at rows m0 + g, m0 + g +
// 8 and columns n0 + 8j + 2t, + 1, for j < live (the n8 tiles that reach
// into N), called by all 32 lanes.
template <bool A_T, bool B_N, int TILES_N = 4, typename AOp, typename BOp,
          typename Epi>
__device__ inline void block_mma_ldsm(int batch, int M, int N, int S, int D,
                                      AOp a, BOp bm, Epi epi) {
  static_assert(TILES_N % 2 == 0, "B fragments come two n8 tiles at a time");
  constexpr int kWarpN = 8 * TILES_N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  // lanes 8q..8q+7 give the rows of matrix q
  const int lr = lane & 7, q = lane >> 3;
  const int mt = (M + 15) >> 4, nt = (N + kWarpN - 1) / kWarpN;
  const int per = mt * nt, ksteps = (D + 15) >> 4;
  for (int task = warp; task < batch * per; task += warps) {
    const int b = task / per, rem = task - b * per;
    const int m_t = rem / nt;
    const int m0 = m_t << 4, n0 = (rem - m_t * nt) * kWarpN;
    const int live = min(TILES_N, (N - n0 + 7) >> 3);
    float acc[TILES_N][4];
#pragma unroll
    for (int j = 0; j < TILES_N; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int s = 0; s < S; ++s) {
      const Smem16 A = a(b, s), B = bm(b, s);
      // this lane's row address at depth 0 and its step per 16 of depth:
      // matrix q of A is (rows 8 (q & 1), depths 8 (q >> 1)) of the 16 x 16
      // tile; of B (depths 8 (q & 1), columns 8 (q >> 1)), two n8 tiles
      const __nv_bfloat16* pa =
          A_T ? A.p + (size_t)(lr + 8 * (q >> 1)) * A.ld + m0 + 8 * (q & 1)
              : A.p + (size_t)(m0 + lr + 8 * (q & 1)) * A.ld + 8 * (q >> 1);
      const __nv_bfloat16* pb =
          B_N ? B.p + (size_t)(n0 + lr + 8 * (q >> 1)) * B.ld + 8 * (q & 1)
              : B.p + (size_t)(lr + 8 * (q & 1)) * B.ld + n0 + 8 * (q >> 1);
      const int da = A_T ? 16 * A.ld : 16, db = B_N ? 16 : 16 * B.ld;
      const int dj = B_N ? 16 * B.ld : 16;  // the next two n8 tiles
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t af[4];
        if constexpr (A_T)
          ldsm_x4_t(af, pa + ks * da);
        else
          ldsm_x4(af, pa + ks * da);
#pragma unroll
        for (int j = 0; j < TILES_N; j += 2) {
          if (j < live) {
            uint32_t bq[4];
            const __nv_bfloat16* p = pb + ks * db + (j >> 1) * dj;
            if constexpr (B_N)
              ldsm_x4(bq, p);
            else
              ldsm_x4_t(bq, p);
            const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
            mma_bf16(acc[j], af, b0);
            if (j + 1 < live) mma_bf16(acc[j + 1], af, b1);
          }
        }
      }
    }
    epi(b, m0, n0, live, acc);
  }
}

// st(m, n, v) for each element of a warp's block_mma_ldsm tile inside M x N
template <int TILES_N, typename ST>
__device__ inline void tile_each(int M, int N, int m0, int n0, int live,
                                 const float (&acc)[TILES_N][4], ST st) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = m0 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < TILES_N; ++j) {
    if (j < live) {
      const int c0 = n0 + 8 * j + 2 * t;
      if (r0 < M && c0 < N) st(r0, c0, acc[j][0]);
      if (r0 < M && c0 + 1 < N) st(r0, c0 + 1, acc[j][1]);
      if (r1 < M && c0 < N) st(r1, c0, acc[j][2]);
      if (r1 < M && c0 + 1 < N) st(r1, c0 + 1, acc[j][3]);
    }
  }
}

}  // namespace dstd_mma
