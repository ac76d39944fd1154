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
// float32, 3.35 TB/s), at the large graph of the sparse surface (N=4,
// V=4096, C=128, R=4, block 128, 174 active blocks of 1024): the SpMM does
// 2.92 GFLOP on 62 MB (the active adjacency blocks, x, out), so it is bound
// by float32 CUDA-core operations (0.044 ms at 67 TFLOP/s against 0.019 ms
// at 3.35 TB/s); so is the fused kernel (the same products plus 45.6 M tanh
// on 17 MB).  The SDDMM writes 45.6 MB of scores and counts 4 operations per
// score and r (a tanh as one): bound by bytes, 0.014 ms; accurate tanhf,
// some 20 instructions, makes its operations the closer limit in practice.
//
// Design.  The TPU kernels walk the active-block list in order on one core
// and zero an output block at the first block of its row; on the card
// blocks run in no order, so the products are row-owned instead: one block
// of 256 threads per (64-row tile of a block row, sample, 128-channel
// tile) loops over its row's active column blocks from a CSR row pointer
// (built once per pattern by the wrapper) and keeps the 64 x 128 sum in
// registers, 4 rows x 8 channels a thread: no atomics, no zeroing pass, the
// same bits every call.  Each step stages a 64 x 16 tile of the adjacency
// (SpMM: float4 loads, stored transposed; fused: computed from the q slice
// held in shared memory and the 16 keys, w[r] tanh(q - k) summed over r)
// and a 16 x 128 tile of x in shared memory.  The SDDMM has no reduction
// across blocks: one block per (active block, 64 x 64 tile, sample), the
// q and k slices in shared memory, one score per thread and step, stores
// coalesced along j.  Plain FMA on the CUDA cores (float32 as the JAX
// outputs); tanhf is the accurate one (no fast-math: the approximate
// tanh's relative error of about 2^-11 would miss the 1e-5 contract).  No
// tensor cores, TMA or pipelining yet.
#include <cuda_runtime.h>

#include <cstddef>

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

__global__ void __launch_bounds__(kThreads)
    sddmm_spmm_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ w,
                      const float* __restrict__ x,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ cols, float* __restrict__ out,
                      int V, int R, int C, int block) {
  __shared__ GemmTiles t;
  __shared__ float qt[kMaxR][kBM];   // q slice of the row tile: qt[r][i]
  __shared__ float ws[kMaxR];
  const RowTile rt(block);
  const int n = blockIdx.y;
  const size_t row0 = (size_t)rt.rb * block + rt.m0;
  const float* q_n = q + ((size_t)n * V + row0) * R;
  const float* k_n = k + (size_t)n * V * R;
  const float* x_n = x + (size_t)n * V * C;
  for (int e = threadIdx.x; e < kBM * R; e += kThreads) {
    const int m = e / R, r = e % R;
    qt[r][m] = m < rt.nrows ? __ldg(q_n + e) : 0.f;
  }
  if (threadIdx.x < R) ws[threadIdx.x] = __ldg(w + threadIdx.x);
  __syncthreads();
  // score entries: thread tid owns row tid % 64 of the tile, sources
  // tid / 64 + 4s (one key per warp: broadcast loads)
  const int sm = threadIdx.x % kBM;
  float acc[4][8] = {};
  for (int p = row_ptr[rt.rb], end = row_ptr[rt.rb + 1]; p < end; ++p) {
    const int j0 = cols[p] * block;
    for (int k0 = 0; k0 < block; k0 += kBK) {
      const int klen = min(kBK, block - k0);
#pragma unroll
      for (int s = 0; s < kBK / 4; ++s) {
        const int kk = threadIdx.x / kBM + 4 * s;
        float sc = 0.f;
        if (sm < rt.nrows && kk < klen) {
          const float* kr = k_n + (size_t)(j0 + k0 + kk) * R;
          for (int r = 0; r < R; ++r)
            sc = fmaf(ws[r], tanhf(qt[r][sm] - __ldg(kr + r)), sc);
        }
        t.a[kk][sm] = sc;
      }
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
  const long long gx = (long long)(V / block) * ((block + kBM - 1) / kBM);
  const long long gz = (C + kBN - 1) / kBN;
  if (!grid_ok(gx, N, gz)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sddmm_spmm_kernel<<<dim3((unsigned)gx, N, (unsigned)gz), kThreads, 0,
                      (cudaStream_t)stream>>>(q, k, w, x, row_ptr, cols, out,
                                              V, R, C, block);
  return (int)cudaGetLastError();
}

}  // extern "C"
