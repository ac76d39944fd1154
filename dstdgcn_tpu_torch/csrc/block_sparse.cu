// Blocked sparse SpMM, SDDMM and fused SDDMM + SpMM (float32).
//
// Replace the TPU kernels of dstdgcn_tpu/kernels/sparse.py:
//   block_spmm_f32        <- _spmm_kernel        (entry block_spmm)
//   block_sddmm_f32       <- _sddmm_kernel       (entry block_sddmm)
//   block_sddmm_spmm_f32  <- _sddmm_spmm_kernel  (entry block_sddmm_spmm)
// Same contracts as the plain versions of dstdgcn_tpu_torch/kernels/sparse.py
// over a (rows, cols) list of active block x block blocks:
//   spmm:  out[n,i,c] = sum_{active (I,J)} sum_{j in J} adj[n,i,j] x[n,j,c]
//   sddmm: S[n,i,j]   = sum_r w[r] tanh(q[n,i,r] - k[n,j,r])  (active only)
//   fused: out[n,i,c] = sum_{active} S[n,i,j] x[n,j,c], S never stored.
//
// Bound on an H100 SXM (published peaks at its 700 W limit: 67 TFLOP/s
// float32, 495 TFLOP/s TF32, 3.35 TB/s), at the large graph of the sparse
// surface (N=4, V=4096, C=128, R=4, block 128, 174 active blocks of 1024):
// the SpMM does 2.92 GFLOP on 62 MB (the active adjacency blocks, x, out):
// 0.019 ms at 3.35 TB/s, 0.018 ms at the 3xTF32 rate, 0.044 ms at the
// float32 FMA rate; the fused kernel the same products plus 45.6 M tanh
// on 17 MB, bound by its operations.  Accurate tanhf is about 17
// instructions, two of them on the MUFU pipe (16 a cycle an SM): about
// 0.022 ms on that pipe for the 45.6 M.  The SDDMM writes 45.6 MB of scores
// and counts 4 operations per score and r (a tanh as one): bound by bytes,
// 0.014 ms; the accurate tanh makes its operations the closer limit in
// practice.
//
// Design of the SpMM and the SDDMM.  The TPU kernels walk the active-block
// list in order on one core and zero an output block at the first block of
// its row; on the card blocks run in no order, so the products are
// row-owned instead: one block of 256 threads per (64-row tile of a block
// row, sample, 128-channel tile) loops over its row's active column blocks
// from a CSR row pointer (built once per pattern by the wrapper) and keeps
// the 64 x 128 sum in registers, 4 rows x 8 channels a thread: no atomics,
// no zeroing pass, the same bits every call.  Each step stages a 64 x 16
// tile of the adjacency (float4 loads, stored transposed) and a 16 x 128
// tile of x in shared memory; plain FMA on the CUDA cores.  The SDDMM has
// no reduction across blocks: one block per (active block, 64 x 64 tile,
// sample), the q and k slices in shared memory, one score per thread and
// step, stores coalesced along j.  tanhf is the accurate one everywhere (no
// fast-math: the approximate tanh's relative error of about 2^-11 would
// miss the 1e-5 contract).
//
// Design of the fused kernel (namespace fused below), for this card.  A
// row tile's walk is the concatenation of its active column blocks' source
// rows, cut into steps of 32 rows whatever the block (a block of 8 packs
// four blocks into a step).  The thread-block cluster of kSplit = 2 blocks
// of a (64-row tile, sample, 128-channel tile) splits the walk into two
// contiguous runs of steps, so that a large graph's 256 row tiles make 512
// blocks; each block keeps its 64 x 128 partial sum in registers, and at
// the end the two ranks sum the partials of their half of the rows in
// rank order through distributed shared memory: no atomics, every sum in
// a fixed order, the same bits every call.  Per step, one __syncthreads:
// the x rows are copied by cp.async three stages deep (the next step's
// rows in flight while this step's scores and products run); each score
// is formed once per (sample, active block, row, column), 8 rows a warp
// and one source row a lane, four r at a time in one branch-free basic
// block (32 independent accurate tanhf a lane), and stored split into its
// TF32 big part and float32 rest; the products run on the tensor cores at
// 3xTF32 (mma.sync m16n8k8 .tf32, each k8 step summed in a zeroed
// accumulator and added on the CUDA cores), the score parts read by
// ldmatrix, each warp 64 rows x 16 channels so that each x element is
// split once.  Two blocks an SM (128 registers).  Measured at the large
// graph (PERF.md): the scores about 0.044 ms (0.026 of it the tanh, about
// its MUFU floor), the products about 0.050 ms, overlapping in part.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

#include "dstd_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;     // output rows per thread block
constexpr int kBN = 128;    // output channels per thread block
constexpr int kBK = 16;     // source rows per step
constexpr int kAPad = 4;    // row padding of the transposed adjacency tile
constexpr int kMaxR = 32;   // largest R (q / k slices in shared memory)
constexpr int kST = 64;     // SDDMM tile edge

struct __align__(16) GemmTiles {
  float a[kBK][kBM + kAPad];   // adjacency tile, transposed: a[j][i]
  float b[kBK][kBN];           // x tile: b[j][c]
};

// x rows [src, src + klen) and channels [c0, c0 + kBN) into t.b; zeros
// outside.  Thread tid: channel tid % 128, rows tid / 128 + 2s.
__device__ __forceinline__ void load_x_tile(GemmTiles& t, const float* x,
                                            size_t src, int klen, int c0,
                                            int C) {
  const int c = threadIdx.x % kBN;
  const bool cok = c0 + c < C;
#pragma unroll
  for (int s = 0; s < kBK / 2; ++s) {
    const int kk = threadIdx.x / kBN + 2 * s;
    t.b[kk][c] = (cok && kk < klen) ? __ldg(x + (src + kk) * C + c0 + c)
                                    : 0.f;
  }
}

// acc[i][j] += a[kk][ty*4 + i] * b[kk][tx*4 + (j & 3) + 64 * (j >> 2)]
__device__ __forceinline__ void tile_fma(const GemmTiles& t, float acc[4][8]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(&t.a[kk][ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&t.b[kk][tx * 4]);
    const float4 b1 =
        *reinterpret_cast<const float4*>(&t.b[kk][kBN / 2 + tx * 4]);
    const float a[4] = {av.x, av.y, av.z, av.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_out(const float acc[4][8], float* out,
                                          size_t row0, int nrows, int c0,
                                          int C) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
    if (m >= nrows) continue;
    float* o = out + (row0 + m) * C;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + tx * 4 + (j & 3) + (kBN / 2) * (j >> 2);
      if (c < C) o[c] = acc[i][j];
    }
  }
}

// Tile coordinates of a row-owned product block: blockIdx.x = (block row,
// 64-row tile), blockIdx.y = sample, blockIdx.z = 128-channel tile.
struct RowTile {
  int rb, m0, nrows, c0;
  __device__ RowTile(int block) {
    const int tiles = (block + kBM - 1) / kBM;
    rb = blockIdx.x / tiles;
    m0 = (blockIdx.x % tiles) * kBM;
    nrows = min(kBM, block - m0);
    c0 = blockIdx.z * kBN;
  }
};

__global__ void __launch_bounds__(kThreads)
    spmm_kernel(const float* __restrict__ adj, const float* __restrict__ x,
                const int* __restrict__ row_ptr,
                const int* __restrict__ cols, float* __restrict__ out, int V,
                int Vj, int C, int block) {
  __shared__ GemmTiles t;
  const RowTile rt(block);
  const int n = blockIdx.y;
  const float* a_n = adj + (size_t)n * V * Vj;
  const float* x_n = x + (size_t)n * Vj * C;
  const size_t row0 = (size_t)rt.rb * block + rt.m0;
  // adjacency loads: thread tid reads 4 consecutive sources of row tid / 4
  const int am = threadIdx.x / 4, aq = (threadIdx.x % 4) * 4;
  float acc[4][8] = {};
  for (int p = row_ptr[rt.rb], end = row_ptr[rt.rb + 1]; p < end; ++p) {
    const int j0 = cols[p] * block;
    for (int k0 = 0; k0 < block; k0 += kBK) {
      const int klen = min(kBK, block - k0);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (am < rt.nrows && aq < klen)
        v = __ldg(reinterpret_cast<const float4*>(
            a_n + (row0 + am) * Vj + j0 + k0 + aq));
      t.a[aq + 0][am] = v.x;
      t.a[aq + 1][am] = v.y;
      t.a[aq + 2][am] = v.z;
      t.a[aq + 3][am] = v.w;
      load_x_tile(t, x_n, (size_t)j0 + k0, klen, rt.c0, C);
      __syncthreads();
      tile_fma(t, acc);
      __syncthreads();
    }
  }
  store_out(acc, out + (size_t)n * V * C, row0, rt.nrows, rt.c0, C);
}

// blockIdx.x = (active block, 64 x 64 tile), blockIdx.y = sample
__global__ void __launch_bounds__(kThreads)
    sddmm_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ w, const int* __restrict__ rows,
                 const int* __restrict__ cols, float* __restrict__ out, int V,
                 int R, int block) {
  __shared__ float qt[kMaxR][kST];
  __shared__ float kt[kMaxR][kST];
  __shared__ float ws[kMaxR];
  const int tiles = (block + kST - 1) / kST;
  const int a = blockIdx.x / (tiles * tiles);
  const int sub = blockIdx.x % (tiles * tiles);
  const int i0 = (sub / tiles) * kST, j0 = (sub % tiles) * kST;
  const int ni = min(kST, block - i0), nj = min(kST, block - j0);
  const int n = blockIdx.y;
  const size_t gi = (size_t)rows[a] * block + i0;
  const size_t gj = (size_t)cols[a] * block + j0;
  const float* q_n = q + ((size_t)n * V + gi) * R;
  const float* k_n = k + ((size_t)n * V + gj) * R;
  for (int e = threadIdx.x; e < kST * R; e += kThreads) {
    const int m = e / R, r = e % R;
    qt[r][m] = m < ni ? __ldg(q_n + e) : 0.f;
    kt[r][m] = m < nj ? __ldg(k_n + e) : 0.f;
  }
  if (threadIdx.x < R) ws[threadIdx.x] = __ldg(w + threadIdx.x);
  __syncthreads();
  const int j = threadIdx.x % kST;
  if (j >= nj) return;
  float* o = out + ((size_t)n * V + gi) * V + gj + j;
  for (int i = threadIdx.x / kST; i < ni; i += kThreads / kST) {
    float sc = 0.f;
    for (int r = 0; r < R; ++r)
      sc = fmaf(ws[r], tanhf(qt[r][i] - kt[r][j]), sc);
    o[(size_t)i * V] = sc;
  }
}

// ---------------------------------------------------------------------------
// The fused SDDMM + SpMM kernel: its constants, helpers and the kernel, the
// code that no other kernel of this file runs
namespace fused {

constexpr int kWarps = 8;
constexpr int kBlockThreads = kWarps * 32;
constexpr int kM = 64;         // output rows a block owns: 4 m16 tiles
constexpr int kN = 128;        // output channels a block owns: 16 n8 tiles
constexpr int kK = 32;         // source rows a step: 4 k8 steps
// a warp's share: score rows, and n8 tiles of output channels
constexpr int kRowsW = kM / kWarps;
constexpr int kTilesW = kN / kWarps / 8;
// row strides in floats: the score tiles' 36 (9 16-byte chunks, odd:
// ldmatrix reads its A fragments without bank conflicts), the x tile's
// and the partial sums' 136 (8 modulo 32: a B fragment's 32 lanes, and a
// float2 store's 16 lanes a phase, hit distinct banks)
constexpr int kSS = kK + 4;
constexpr int kXS = kN + 8;
constexpr int kXStages = 3;    // x tiles in flight
// blocks of a cluster that split one row tile's walk (4 measured 2.7%
// slower at the large graph; PERF.md)
constexpr int kSplit = 2;

// Shared memory of one block, in floats: two score buffers, each the
// TF32 big parts and the float32 rest of a [kM][kSS] tile, kXStages x
// tiles [kK][kXS], the q slice [kM][R] and w [kMaxR]; at the end the
// partial sums [kM][kXS] reuse the tiles.
struct Smem {
  int s, x, q, w, total;
  __host__ __device__ explicit Smem(int R) {
    s = 0;
    x = s + 4 * kM * kSS;
    q = x + kXStages * kK * kXS;
    w = q + kM * R;
    total = w + kMaxR;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes from global to shared memory, zeros for the bytes past
// `valid` (0: all zeros, nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the A fragment of m16n8k8 tf32 from a row-major 16 x 8 float tile:
// lanes 0-15 give its rows at depth 0-3, lanes 16-31 at depth 4-7
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// v as a TF32 big part and the float32 rest (dstd_mma::Tf32x3Mma)
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = dstd_mma::tf32(v);
  small = __float_as_uint(v - __uint_as_float(big));
}

// acc += A B at 3xTF32: small_a big_b + big_a small_b + big_a big_b in a
// zeroed accumulator, added to acc on the CUDA cores (the tensor cores
// truncate each add relative to their accumulator)
__device__ __forceinline__ void product(float (&acc)[4],
                                        const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4],
                                        const uint32_t (&bb)[2],
                                        const uint32_t (&bs)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  dstd_mma::mma_tf32(d, as, bb);
  dstd_mma::mma_tf32(d, ab, bs);
  dstd_mma::mma_tf32(d, ab, bb);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

// The source row of flat index f of a row tile's walk (the concatenated
// source rows of its active column blocks, in list order), -1 past it.
struct Walk {
  const int* cols;  // the block row's active column blocks
  int block, len;   // len: the walk's rows
  __device__ int row(int f) const {
    if (f >= len) return -1;
    const int p = f / block;
    return __ldg(cols + p) * block + (f - p * block);
  }
};

// The x rows of one step (lane kk of every warp holds the source row kk
// of the step in `src`, -1 past the walk) and channels [c0, c0 + kN) into
// an x tile by cp.async; zeros past the walk and past C.  Warp w copies
// rows w, w + 8, w + 16 and w + 24, lane l their channels 4l..4l+3.
__device__ __forceinline__ void load_x(float* xt, const float* x_n, int src,
                                       int c0, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + 4 * lane;
#pragma unroll
  for (int i = 0; i < kK / kWarps; ++i) {
    const int kk = warp + kWarps * i;
    const int j = __shfl_sync(0xffffffffu, src, kk);
    float* dst = xt + kk * kXS + 4 * lane;
    const float* row = x_n + (size_t)(j < 0 ? 0 : j) * C;
    if ((C & 3) == 0) {
      cp_async16(dst, row + (c < C ? c : 0), j >= 0 && c < C ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(dst + e, row + (c + e < C ? c + e : 0),
                  j >= 0 && c + e < C ? 4 : 0);
    }
  }
}

// The score tile of one step: S[m][kk] = sum_r w[r] tanh(q[m][r] - k[j][r])
// for source row j = src of lane kk (none: 0), the sum over r in order,
// stored as its TF32 big part (sb) and float32 rest (ss).  Warp w forms
// its kRowsW rows (a warp with a row below nrows forms all of them: the q
// rows past nrows are zeros), lane kk column kk, four r at a time: the
// tanhf of a lane are independent and in one basic block, free of
// per-element branches (each a reconvergence point that serialized
// them).  Past R, w is 0 and the last r repeats.
__device__ __forceinline__ void scores(float* sb, float* ss, const float* qt,
                                       const float* ws, const float* k_n,
                                       int src, int R, int nrows) {
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * kRowsW;
  float sc[kRowsW];
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) sc[i] = 0.f;
  if (src >= 0 && w0 < nrows) {
    const float* kr = k_n + (size_t)src * R;
    const float* qr = qt + w0 * R;
    for (int r0 = 0; r0 < R; r0 += 4) {
      float kv[4], wv[4];
      int ru[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ru[u] = min(r0 + u, R - 1);
        kv[u] = __ldg(kr + ru[u]);
        wv[u] = r0 + u < R ? ws[r0 + u] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsW; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sc[i] = fmaf(wv[u], tanhf(qr[i * R + ru[u]] - kv[u]), sc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    uint32_t big, small;
    split(sc[i], big, small);
    sb[(w0 + i) * kSS + lane] = __uint_as_float(big);
    ss[(w0 + i) * kSS + lane] = __uint_as_float(small);
  }
}

// acc += S X for one step: warp w owns all kM rows (four m16 tiles) and
// its kTilesW n8 tiles of channels of the block's output; the score
// tile's parts are read by ldmatrix, already split.
__device__ __forceinline__ void products(float (&acc)[4][kTilesW][4],
                                         const float* sb, const float* ss,
                                         const float* xt) {
  const int lane = threadIdx.x & 31, n0 = (threadIdx.x >> 5) * 8 * kTilesW;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kK / 8; ++ks) {
    uint32_t bb[kTilesW][2], bs[kTilesW][2];
#pragma unroll
    for (int ni = 0; ni < kTilesW; ++ni) {
      const float* b = xt + (8 * ks + t) * kXS + n0 + 8 * ni + g;
      split(b[0], bb[ni][0], bs[ni][0]);
      split(b[4 * kXS], bb[ni][1], bs[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int a = (16 * mi + (lane & 15)) * kSS + 8 * ks + (lane >> 4) * 4;
      uint32_t ab[4], as[4];
      ldsm_x4(ab, sb + a);
      ldsm_x4(as, ss + a);
#pragma unroll
      for (int ni = 0; ni < kTilesW; ++ni)
        product(acc[mi][ni], ab, as, bb[ni], bs[ni]);
    }
  }
}

}  // namespace fused

// One block per (cluster rank, row tile of a block row, sample, channel
// tile): blockIdx.x = row tile * kSplit + rank.  The kSplit blocks of a
// cluster split the row tile's walk into contiguous runs of steps and
// reduce their partial sums in rank order through distributed shared
// memory.
__global__ void __launch_bounds__(fused::kBlockThreads, 2)
    sddmm_spmm_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ w,
                      const float* __restrict__ x,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ cols, float* __restrict__ out,
                      int V, int R, int C, int block) {
  using namespace fused;
  namespace cg = cooperative_groups;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem L(R);
  float* qt = smem + L.q;
  float* ws = smem + L.w;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tiles = (block + kM - 1) / kM;
  const int tile = blockIdx.x / kSplit;
  const int rb = tile / tiles, m0 = (tile % tiles) * kM;
  const int nrows = min(kM, block - m0);
  const int c0 = blockIdx.z * kN;
  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row0 = (size_t)rb * block + m0;
  const float* k_n = k + (size_t)n * V * R;
  const float* x_n = x + (size_t)n * V * C;
  {
    const float* q_n = q + ((size_t)n * V + row0) * R;
    for (int e = threadIdx.x; e < kM * R; e += kBlockThreads)
      qt[e] = e < nrows * R ? __ldg(q_n + e) : 0.f;
    if (threadIdx.x < R) ws[threadIdx.x] = __ldg(w + threadIdx.x);
  }
  const int p0 = __ldg(row_ptr + rb);
  const Walk walk{cols + p0, block, (__ldg(row_ptr + rb + 1) - p0) * block};
  const int steps = (walk.len + kK - 1) / kK;
  const int lo = steps * rank / kSplit, hi = steps * (rank + 1) / kSplit;
  // warps whose channels lie wholly past C skip the products
  const bool live = c0 + warp * 8 * kTilesW < C;
  float acc[4][kTilesW][4] = {};
  int src = lo < hi ? walk.row(lo * kK + lane) : -1;
  if (lo < hi) load_x(smem + L.x, x_n, src, c0, C);
  cp_async_commit();
  __syncthreads();
  for (int s = lo, i = 0; s < hi; ++s, ++i) {
    const int next = s + 1 < hi ? walk.row((s + 1) * kK + lane) : -1;
    if (s + 1 < hi)
      load_x(smem + L.x + ((i + 1) % kXStages) * kK * kXS, x_n, next, c0,
             C);
    cp_async_commit();
    float* sb = smem + L.s + 2 * (i & 1) * kM * kSS;
    float* ss = sb + kM * kSS;
    scores(sb, ss, qt, ws, k_n, src, R, nrows);
    cp_async_wait<1>();
    __syncthreads();
    if (live) products(acc, sb, ss, smem + L.x + (i % kXStages) * kK * kXS);
    src = next;
  }
  cp_async_wait<0>();
  __syncthreads();
  // the partial sums, then the rank's share of the rows summed over the
  // ranks in order
  float* part = smem;
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < kTilesW; ++ni) {
        float* p =
            part + (16 * mi + g) * kXS + (warp * kTilesW + ni) * 8 + 2 * t;
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<float2*>(p + 8 * kXS) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
  }
  cluster.sync();
  constexpr int kRows = kM / kSplit;
  float* o_n = out + (size_t)n * V * C;
  for (int e = threadIdx.x; e < kRows * (kN / 4); e += kBlockThreads) {
    const int m = rank * kRows + e / (kN / 4), c4 = 4 * (e % (kN / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part + m * kXS + c4, r));
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int c = c0 + c4;
    if (m >= nrows || c >= C) continue;
    float* o = o_n + (row0 + m) * C + c;
    if ((C & 3) == 0) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && c + j < C; ++j) o[j] = vs[j];
    }
  }
  // no block leaves while another reads its partial sums
  cluster.sync();
}

bool grid_ok(long long x, int y, long long z) {
  return x > 0 && x < (1LL << 31) && y > 0 && y <= 65535 && z > 0 &&
         z <= 65535;
}

}  // namespace

extern "C" {

const char* dstd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Each launches on `stream` and returns the cudaError_t of the launch
// (0 = success).  Pointers are device pointers; row_ptr has V / block + 1
// entries, rows / cols one per active block.

int block_spmm_f32(const float* adj, const float* x, const int* row_ptr,
                   const int* cols, float* out, int N, int V, int Vj, int C,
                   int block, int device, void* stream) {
  if (N == 0 || C == 0) return 0;
  if (block < 4 || block % 4 || V % block || Vj % block)
    return (int)cudaErrorInvalidValue;
  const long long gx = (long long)(V / block) * ((block + kBM - 1) / kBM);
  const long long gz = (C + kBN - 1) / kBN;
  if (!grid_ok(gx, N, gz)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  spmm_kernel<<<dim3((unsigned)gx, N, (unsigned)gz), kThreads, 0,
                (cudaStream_t)stream>>>(adj, x, row_ptr, cols, out, V, Vj, C,
                                        block);
  return (int)cudaGetLastError();
}

int block_sddmm_f32(const float* q, const float* k, const float* w,
                    const int* rows, const int* cols, float* out, int N,
                    int V, int R, int block, int num_blocks, int device,
                    void* stream) {
  if (N == 0 || num_blocks == 0) return 0;
  if (block < 1 || V % block || R < 1 || R > kMaxR)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (block + kST - 1) / kST;
  const long long gx = (long long)num_blocks * tiles * tiles;
  if (!grid_ok(gx, N, 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sddmm_kernel<<<dim3((unsigned)gx, N), kThreads, 0, (cudaStream_t)stream>>>(
      q, k, w, rows, cols, out, V, R, block);
  return (int)cudaGetLastError();
}

int block_sddmm_spmm_f32(const float* q, const float* k, const float* w,
                         const float* x, const int* row_ptr, const int* cols,
                         float* out, int N, int V, int R, int C, int block,
                         int device, void* stream) {
  if (N == 0 || C == 0) return 0;
  if (block < 1 || V % block || R < 1 || R > kMaxR)
    return (int)cudaErrorInvalidValue;
  const long long gx = (long long)(V / block) *
                       ((block + fused::kM - 1) / fused::kM) * fused::kSplit;
  const long long gz = (C + fused::kN - 1) / fused::kN;
  if (!grid_ok(gx, N, gz)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bytes = fused::Smem(R).total * (int)sizeof(float);
  err = cudaFuncSetAttribute(sddmm_spmm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx, N, (unsigned)gz);
  cfg.blockDim = dim3(fused::kBlockThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = fused::kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sddmm_spmm_kernel, q, k, w, x, row_ptr,
                           cols, out, V, R, C, block);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
