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
// practice.  tanhf is the accurate one everywhere (no fast-math: the
// approximate tanh's relative error of about 2^-11 would miss the 1e-5
// contract).
//
// On the card blocks run in no order, so where the TPU kernels walk the
// active-block list in order on one core and zero an output block at the
// first block of its row, the products here are row-owned: one block per
// (64-row tile of a block row, sample, 128-channel tile) walks its row's
// active column blocks from a CSR row pointer (built once per pattern by
// the wrapper).  A row tile's walk is the concatenation of its active
// column blocks' sources (source rows of x, columns of the adjacency), cut
// into steps of 32 whatever the block (a block of 8 packs four blocks into
// a step).  The thread-block cluster of kSplit = 2 blocks of a row tile
// splits the walk into two contiguous runs of steps, so that a large
// graph's 256 row tiles make 512 blocks; each block keeps its 64 x 128
// partial sum in registers, and at the end the two ranks sum the partials
// of their half of the rows in rank order through distributed shared
// memory: no atomics, no zeroing pass, every sum in a fixed order, the
// same bits every call.  Per step, one __syncthreads; the tiles of later
// steps are copied by cp.async while this step's products run; the
// products run on the tensor cores at 3xTF32 (mma.sync m16n8k8 .tf32, each
// k8 step summed in a zeroed accumulator and added on the CUDA cores), the
// A tile (adjacency or scores) stored split into its TF32 big part and
// float32 rest and read by ldmatrix, each warp 64 rows x 16 channels so
// that each x element is split once.  Two blocks an SM.
//
// The SpMM (7): three stages in flight, each a 64 x 32 adjacency tile
// (16-byte copies: block % 4 == 0, so a 16-byte run of a row never crosses
// a column block) and a 32 x 128 x tile; each thread splits the adjacency
// elements it copied itself, in place, once its own copies have landed, so
// the one barrier a step serves both the split and the products (107,520
// B a block, two blocks an SM).  The active adjacency (45.6 MB at the
// large graph) is read once from device memory, x again by each row tile
// that walks its block (91 MB from L2).  Measured at the large graph
// (PERF.md): about 0.080 ms, the loads alone 0.034 and the products
// alone 0.070, overlapping little; the same within 2% with the products on
// wgmma or in warp tiles of 32 x 32, 0.098 ms with float32 FMA on the CUDA
// cores, 8% slower with the adjacency split in registers by every warp.
//
// The fused kernel (9): x tiles three deep; each score is formed once per
// (sample, active block, row, column), 8 rows a warp and one source row a
// lane, four r at a time in one branch-free basic block (32 independent
// accurate tanhf a lane).  Measured at the large graph (PERF.md): the
// scores about 0.044 ms (0.026 of it the tanh, about its MUFU floor), the
// products about 0.050 ms, overlapping in part.
//
// The SDDMM (8) has no reduction across blocks: one block per (active
// block, 64 x 128 tile of it, sample), q and k slices in shared memory
// (k transposed: a lane reads its four columns as one 16-byte load), each
// thread 8 rows x 4 columns, four r at a time in one branch-free basic
// block (the r past R repeat the last with w = 0): 32 independent accurate
// tanhf a lane and r, the sum over r in order, as the TPU kernel's.
// Stores of four columns as 16 bytes with the streaming hint (nothing
// reads the scores again here) where block % 4 == 0.  Three blocks an SM
// (80 registers).  Measured at the large graph (PERF.md): about 0.036 ms,
// 0.017-0.019 of it without the tanh.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

#include "dstd_mma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxR = 32;   // largest R (q / k slices in shared memory)

// ---------------------------------------------------------------------------
// The row-owned 3xTF32 walk: constants and helpers that the SpMM and the
// fused kernel both run
namespace tc {

constexpr int kWarps = 8;
constexpr int kBlockThreads = kWarps * 32;
constexpr int kM = 64;         // output rows a block owns: 4 m16 tiles
constexpr int kN = 128;        // output channels a block owns: 16 n8 tiles
constexpr int kK = 32;         // sources a step: 4 k8 steps
// a warp's n8 tiles of output channels
constexpr int kTilesW = kN / kWarps / 8;
// row strides in floats: the A tiles' 36 (9 16-byte chunks, odd: ldmatrix
// reads its A fragments without bank conflicts), the x tile's and the
// partial sums' 136 (8 modulo 32: a B fragment's 32 lanes, and a float2
// store's 16 lanes a phase, hit distinct banks)
constexpr int kSS = kK + 4;
constexpr int kXS = kN + 8;
constexpr int kXStages = 3;    // x tiles in flight
// blocks of a cluster that split one row tile's walk (4 measured 2.7%
// slower in the fused kernel and 5% in the SpMM at the large graph;
// PERF.md)
constexpr int kSplit = 2;

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

// The source of flat index f of a row tile's walk (the concatenated
// sources of its active column blocks, in list order), -1 past it.
struct Walk {
  const int* cols;  // the block row's active column blocks
  int block, len;   // len: the walk's sources
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

// acc += A X for one step: warp w owns all kM rows (four m16 tiles) and
// its kTilesW n8 tiles of channels of the block's output; the A tile's
// parts (sb: TF32 big parts, ss: float32 rest, [kM][kSS]) are read by
// ldmatrix, already split.
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

// The end of a row-owned walk: every copy landed, the block's partial sums
// into `part` ([kM][kXS], over the tiles), then the rank's kM / kSplit
// rows summed over the cluster's ranks in rank order into the output rows
// [row0, row0 + nrows), channels [c0, min(c0 + kN, C)).
__device__ __forceinline__ void reduce_store(
    const float (&acc)[4][kTilesW][4], float* part, cg::cluster_group& cluster,
    int rank, float* o_n, size_t row0, int nrows, int c0, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cp_async_wait<0>();
  __syncthreads();
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

// The coordinates of a row-owned block: blockIdx.x = row tile * kSplit +
// rank, blockIdx.y = sample, blockIdx.z = channel tile.
struct RowTile {
  int rb, nrows, c0;
  size_t row0;
  __device__ explicit RowTile(int block) {
    const int tiles = (block + kM - 1) / kM;
    const int tile = blockIdx.x / kSplit;
    rb = tile / tiles;
    const int m0 = (tile % tiles) * kM;
    nrows = min(kM, block - m0);
    c0 = blockIdx.z * kN;
    row0 = (size_t)rb * block + m0;
  }
};

}  // namespace tc

// ---------------------------------------------------------------------------
// The SpMM (7)
namespace spmm {

using namespace tc;

constexpr int kStages = 3;   // steps in flight
// Shared memory of one block, in floats: kStages stages, each the TF32
// big parts and the float32 rest of a [kM][kSS] adjacency tile and a
// [kK][kXS] x tile; at the end the partial sums [kM][kXS] reuse them.
constexpr int kBig = 0, kRest = kM * kSS, kX = 2 * kM * kSS;
constexpr int kStage = kX + kK * kXS;
constexpr int kBytes = kStages * kStage * (int)sizeof(float);

// The tiles of one step by cp.async (lane kk of every warp holds the
// step's source kk in `src`, -1 past the walk): the adjacency rows [row0,
// row0 + nrows) at the step's sources into the stage's rest part (zeros
// past nrows and past the walk), and the x tile.  Thread t copies the
// 16-byte chunks (m, q) for m = t / 8 and t / 8 + 32, q = t % 8: the
// sources 4q to 4q + 3 of the step, one run of a row of one column block.
__device__ __forceinline__ void load_step(float* st, const float* a_n,
                                          const float* x_n, int src,
                                          size_t row0, int nrows, int Vj,
                                          int c0, int C) {
  const int q = threadIdx.x & 7, m = threadIdx.x >> 3;
  const int j = __shfl_sync(0xffffffffu, src, 4 * q);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int mm = m + kBlockThreads / 8 * h;
    const bool ok = j >= 0 && mm < nrows;
    cp_async16(st + kRest + mm * kSS + 4 * q,
               a_n + (ok ? (row0 + mm) * Vj + j : 0), ok ? 16 : 0);
  }
  load_x(st + kX, x_n, src, c0, C);
}

// This thread's chunks of a landed adjacency tile split in place: the
// TF32 big parts into the big part, the float32 rest where they were.
__device__ __forceinline__ void split_adj(float* st) {
  const int q = threadIdx.x & 7, m = threadIdx.x >> 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = (m + kBlockThreads / 8 * h) * kSS + 4 * q;
    const float4 v = *reinterpret_cast<const float4*>(st + kRest + e);
    const float vs[4] = {v.x, v.y, v.z, v.w};
    uint32_t big[4], small[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(vs[i], big[i], small[i]);
    *reinterpret_cast<float4*>(st + kBig + e) =
        make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]),
                    __uint_as_float(big[2]), __uint_as_float(big[3]));
    *reinterpret_cast<float4*>(st + kRest + e) =
        make_float4(__uint_as_float(small[0]), __uint_as_float(small[1]),
                    __uint_as_float(small[2]), __uint_as_float(small[3]));
  }
}

}  // namespace spmm

__global__ void __launch_bounds__(tc::kBlockThreads, 2)
    spmm_kernel(const float* __restrict__ adj, const float* __restrict__ x,
                const int* __restrict__ row_ptr,
                const int* __restrict__ cols, float* __restrict__ out, int V,
                int Vj, int C, int block) {
  using namespace spmm;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const RowTile rt(block);
  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const float* a_n = adj + (size_t)n * V * Vj;
  const float* x_n = x + (size_t)n * Vj * C;
  const int p0 = __ldg(row_ptr + rt.rb);
  const Walk walk{cols + p0, block,
                  (__ldg(row_ptr + rt.rb + 1) - p0) * block};
  const int steps = (walk.len + kK - 1) / kK;
  const int lo = steps * rank / kSplit, hi = steps * (rank + 1) / kSplit;
  // warps whose channels lie wholly past C skip the products
  const bool live = rt.c0 + (threadIdx.x >> 5) * 8 * kTilesW < C;
  float acc[4][kTilesW][4] = {};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (lo + i < hi)
      load_step(smem + i * kStage, a_n, x_n, walk.row((lo + i) * kK + lane),
                rt.row0, rt.nrows, Vj, rt.c0, C);
    cp_async_commit();
  }
  // the sources of the next step to load, read a step ahead: a copy whose
  // address waits on its index stalls the warp's products behind it
  int ahead = walk.row((lo + kStages - 1) * kK + lane);
  for (int s = lo, i = 0; s < hi; ++s, ++i) {
    // step s landed (this thread's copies), split, then one barrier: the
    // splits and every thread's copies visible, and the stage of step
    // s - 1 free for step s + kStages - 1
    cp_async_wait<kStages - 2>();
    float* st = smem + (i % kStages) * kStage;
    split_adj(st);
    __syncthreads();
    if (s + kStages - 1 < hi)
      load_step(smem + ((i + kStages - 1) % kStages) * kStage, a_n, x_n,
                ahead, rt.row0, rt.nrows, Vj, rt.c0, C);
    cp_async_commit();
    ahead = walk.row((s + kStages) * kK + lane);
    const float *big = st + kBig, *rest = st + kRest, *xt = st + kX;
    if (live) products(acc, big, rest, xt);
  }
  reduce_store(acc, smem, cluster, rank, out + (size_t)n * V * C, rt.row0,
               rt.nrows, rt.c0, C);
}

// ---------------------------------------------------------------------------
// The SDDMM (8)
namespace sddmm {

constexpr int kThreads = 256;
constexpr int kTI = 64;                  // rows of a block's tile
constexpr int kTJ = 128;                 // columns of a block's tile
constexpr int kRowsT = kTI / (kThreads / 32);   // rows a thread (a warp's)
constexpr int kRU = 4;                   // r a basic block

}  // namespace sddmm

// blockIdx.x = active block, blockIdx.y = (row tile, column tile) of it,
// blockIdx.z = sample.  Warp w forms rows 8w..8w+7 of the tile, lane l
// columns 4l..4l+3.
__global__ void __launch_bounds__(sddmm::kThreads, 3)
    sddmm_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ w, const int* __restrict__ rows,
                 const int* __restrict__ cols, float* __restrict__ out, int V,
                 int R, int block) {
  using namespace sddmm;
  __shared__ __align__(16) float qt[kMaxR][kTI];
  __shared__ __align__(16) float kt[kMaxR][kTJ];
  __shared__ float ws[kMaxR];
  const int tiles_j = (block + kTJ - 1) / kTJ;
  const int i0 = (blockIdx.y / tiles_j) * kTI;
  const int j0 = (blockIdx.y % tiles_j) * kTJ;
  const int ni = min(kTI, block - i0), nj = min(kTJ, block - j0);
  const int n = blockIdx.z;
  const size_t gi = (size_t)__ldg(rows + blockIdx.x) * block + i0;
  const size_t gj = (size_t)__ldg(cols + blockIdx.x) * block + j0;
  {
    // thread t stages q row t % 64 at r = t / 64 + 4u and k row t % 128 at
    // r = t / 128 + 2u, transposed; zeros past the block
    const float* q_n = q + ((size_t)n * V + gi) * R;
    const float* k_n = k + ((size_t)n * V + gj) * R;
    const int m = threadIdx.x % kTI, j = threadIdx.x % kTJ;
    for (int r = threadIdx.x / kTI; r < R; r += kThreads / kTI)
      qt[r][m] = m < ni ? __ldg(q_n + (size_t)m * R + r) : 0.f;
    for (int r = threadIdx.x / kTJ; r < R; r += kThreads / kTJ)
      kt[r][j] = j < nj ? __ldg(k_n + (size_t)j * R + r) : 0.f;
    if (threadIdx.x < R) ws[threadIdx.x] = __ldg(w + threadIdx.x);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, r0w = (threadIdx.x >> 5) * kRowsT;
  if (r0w >= ni || 4 * lane >= nj) return;
  float sc[kRowsT][4];
#pragma unroll
  for (int i = 0; i < kRowsT; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) sc[i][u] = 0.f;
  for (int r0 = 0; r0 < R; r0 += kRU) {
#pragma unroll
    for (int v = 0; v < kRU; ++v) {
      const int r = min(r0 + v, R - 1);
      const float wv = r0 + v < R ? ws[r] : 0.f;
      const float4 kv = *reinterpret_cast<const float4*>(&kt[r][4 * lane]);
      const float4 qa = *reinterpret_cast<const float4*>(&qt[r][r0w]);
      const float4 qb = *reinterpret_cast<const float4*>(&qt[r][r0w + 4]);
      const float kc[4] = {kv.x, kv.y, kv.z, kv.w};
      const float qr[kRowsT] = {qa.x, qa.y, qa.z, qa.w,
                                qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int i = 0; i < kRowsT; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sc[i][u] = fmaf(wv, tanhf(qr[i] - kc[u]), sc[i][u]);
    }
  }
  float* o = out + ((size_t)n * V + gi + r0w) * V + gj + 4 * lane;
#pragma unroll
  for (int i = 0; i < kRowsT; ++i) {
    if (r0w + i >= ni) break;
    float* oi = o + (size_t)i * V;
    if ((block & 3) == 0) {
      __stcs(reinterpret_cast<float4*>(oi),
             make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]));
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * lane + u < nj) __stcs(oi + u, sc[i][u]);
    }
  }
}

// ---------------------------------------------------------------------------
// The fused SDDMM + SpMM kernel (9): the code that no other kernel of this
// file runs
namespace fused {

using namespace tc;

// a warp's score rows
constexpr int kRowsW = kM / kWarps;

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

}  // namespace fused

// One block per (cluster rank, row tile of a block row, sample, channel
// tile): blockIdx.x = row tile * kSplit + rank.  The kSplit blocks of a
// cluster split the row tile's walk into contiguous runs of steps and
// reduce their partial sums in rank order through distributed shared
// memory.
__global__ void __launch_bounds__(tc::kBlockThreads, 2)
    sddmm_spmm_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ w,
                      const float* __restrict__ x,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ cols, float* __restrict__ out,
                      int V, int R, int C, int block) {
  using namespace fused;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem L(R);
  float* qt = smem + L.q;
  float* ws = smem + L.w;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const RowTile rt(block);
  const int nrows = rt.nrows, c0 = rt.c0;
  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row0 = rt.row0;
  const float* k_n = k + (size_t)n * V * R;
  const float* x_n = x + (size_t)n * V * C;
  {
    const float* q_n = q + ((size_t)n * V + row0) * R;
    for (int e = threadIdx.x; e < kM * R; e += kBlockThreads)
      qt[e] = e < nrows * R ? __ldg(q_n + e) : 0.f;
    if (threadIdx.x < R) ws[threadIdx.x] = __ldg(w + threadIdx.x);
  }
  const int p0 = __ldg(row_ptr + rt.rb);
  const Walk walk{cols + p0, block, (__ldg(row_ptr + rt.rb + 1) - p0) * block};
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
  reduce_store(acc, smem, cluster, rank, out + (size_t)n * V * C, row0,
               nrows, c0, C);
}

bool grid_ok(long long x, int y, long long z) {
  return x > 0 && x < (1LL << 31) && y > 0 && y <= 65535 && z > 0 &&
         z <= 65535;
}

// A launch of a row-owned kernel as clusters of tc::kSplit blocks.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), long long gx, int N,
                             long long gz, int bytes, void* stream,
                             Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx, N, (unsigned)gz);
  cfg.blockDim = dim3(tc::kBlockThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tc::kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  const long long gx =
      (long long)(V / block) * ((block + tc::kM - 1) / tc::kM) * tc::kSplit;
  const long long gz = (C + tc::kN - 1) / tc::kN;
  if (!grid_ok(gx, N, gz)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clustered(spmm_kernel, gx, N, gz, spmm::kBytes, stream,
                               adj, x, row_ptr, cols, out, V, Vj, C, block);
}

int block_sddmm_f32(const float* q, const float* k, const float* w,
                    const int* rows, const int* cols, float* out, int N,
                    int V, int R, int block, int num_blocks, int device,
                    void* stream) {
  if (N == 0 || num_blocks == 0) return 0;
  if (block < 1 || V % block || R < 1 || R > kMaxR)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((block + sddmm::kTI - 1) / sddmm::kTI) *
                          ((block + sddmm::kTJ - 1) / sddmm::kTJ);
  if (tiles > 65535 || !grid_ok(num_blocks, (int)tiles, N))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sddmm_kernel<<<dim3((unsigned)num_blocks, (unsigned)tiles, N),
                 sddmm::kThreads, 0, (cudaStream_t)stream>>>(
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
                       ((block + tc::kM - 1) / tc::kM) * tc::kSplit;
  const long long gz = (C + tc::kN - 1) / tc::kN;
  if (!grid_ok(gx, N, gz)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clustered(sddmm_spmm_kernel, gx, N, gz,
                               fused::Smem(R).total * (int)sizeof(float),
                               stream, q, k, w, x, row_ptr, cols, out, V, R,
                               C, block);
}

}  // extern "C"
