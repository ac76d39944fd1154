// Graph WaveNet's dense adaptive hop and its two gradients (float32), on
// Hopper's warpgroup MMA (wgmma) at 3xTF32.
//
// Replaces no TPU kernel: the JAX package leaves the dense product to XLA.
// It takes the place of cuBLAS's float32 SGEMM in models/gwnet.py::_gcn,
// whose adaptive hops are half of a training step at the forecast
// configuration (V = 3,834 sensors, F = N C L up to 24,576), where TF32 is
// off and cuBLAS runs on the CUDA cores.  Contracts (kernels/dense.py holds
// the plain versions):
//   dense_hop_f32:   out[n][f] = sum_k B[n][k] x[k][f]  (B = adp^T for the
//                    forward out = adp^T x, B = adp for d_x = adp g)
//   dense_outer_f32: out[v][w] = sum_f x[v][f] g[w][f]  (d_adp = x g^T)
//
// Bound on an H100 SXM (700 W): a call does 2 V^2 F products and moves
// 4 (V^2 + 2 V F) bytes; at the float32-accurate tensor-core rate (3xTF32,
// 494.7 / 3 = 164.9 TFLOP/s) and 3.35 TB/s every call is bound by its
// products: at L = 12 (F = 24,576) 4.38 ms of products against 0.24 ms of
// bytes; a training step's 44 calls are bound at 112.4 ms.
//
// Design:
//  * Products: 3xTF32 on wgmma.m64nNk8.f32.tf32.tf32, small_a big_b +
//    big_a small_b + big_a big_b a k8 step; big is the operand rounded to
//    TF32 (nearest, ties away), small the rest, which the tensor core
//    reads truncated to TF32: within 2^-21 of each product, as kernel 7's
//    3xTF32 (csrc/dstd_mma.cuh).
//  * Sums: the tensor cores round a sum toward zero.  Into one
//    accumulator over all of K that bias grows with the total, to 5-15
//    times float32's own error at these depths (measured), so the
//    products of every 2 k8 steps sum into a fresh accumulator that is
//    added to a float32 total on the CUDA cores.
//  * Operand layouts: wgmma takes a .tf32 operand from shared memory only
//    K-major (no transpose bit, unlike f16 / bf16), and A may come from
//    registers.  In the hops the activation runs along F, which is the M
//    side of the product (MN-major), so it is the register operand A:
//    each thread loads its fragment from the stage's shared tile and
//    splits it in registers.  The adjacency is the shared-memory operand
//    B, K-major in both orientations: the wrapper copies adp^T (the
//    forward's) and adp (d_x's) once per adjacency, rows padded to a
//    multiple of 4 floats (TMA takes row strides of 16 bytes; 3,834 floats
//    is 15,336 bytes).  In d_adp both operands are K-major as stored: x is
//    the register operand, g the shared one.  Which F a row of the product
//    stands for is free: in the hops row g of a warp's 16 is F 2g and row
//    g + 8 is F 2g + 1, so a thread's two rows are one float2 in the
//    shared tile and one float2 in the output.
//  * Pipeline: a block is a producer warpgroup and two consumer
//    warpgroups of 64 product rows each (128 x 192 in the hops, 128 x 128
//    in d_adp, whose sums also pass through a running sum every 256
//    depths).  K walks in stages of 32 (one 128-byte swizzle row of
//    float32), 3 (hops) or 4 (d_adp) in a ring.  One producer thread loads
//    each stage's A tile and B tile by TMA with the 128-byte swizzle that
//    the wgmma descriptors read (and conflict-free fragment loads in
//    d_adp); three producer warps then split the B tile in place into
//    its big plane and beside it its small one, so B crosses from L2 once
//    (loading both planes instead measured about 20% slower at L = 12:
//    the loads, not the tensor cores, bound the product).  A full, a
//    ready (split) and an empty mbarrier a stage; the consumers release a
//    stage once the wgmmas that read it are done.  A fragments are
//    double-buffered across k8 steps, so the loads and splits of step s + 1
//    run while step s's wgmmas do.
//  * Ragged edges: TMA fills rows and columns past V and F with zeros
//    (they add nothing) and the epilogue stores only inside the output.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;            // warpgroups, 64 product rows each
constexpr int kBM = 64 * kConsumers;     // product rows a block owns
constexpr int kBK = 32;                  // depth a stage
constexpr int kThreads = 128 * (kConsumers + 1);   // and a producer
constexpr int kABytes = kBM * kBK * 4;
// the A tile of a hop in boxes of 32 F (one 128-byte swizzle row each)
constexpr int kBoxBytes = kBK * 32 * 4;

// The tiling of a product.  kMnA, the hops (depth V): 192 columns a block,
// the partial sums of 2 k8 steps added into the float32 total.  Else d_adp
// (depth F, up to 24,576): 128 columns, the partial sums added into a
// running sum that joins the total every 256 depths: the running sum
// takes 16 terms and the total one a 256 depths, 96 at F 24,576 (one total
// of all 3,072 k8 steps' sums erred 2.5x as far as cuBLAS's split sum at
// V 200, F 24,576, measured).  The B tile takes two planes' room: it is
// split in place.
template <bool kMnA>
struct Tile {
  static constexpr int kBN = kMnA ? 192 : 128;   // product columns a block
  static constexpr int kBBytes = kBN * kBK * 4;  // one plane of B
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr int kStages = 200 * 1024 / kStageBytes;
  // the stages, 1024-byte alignment for the swizzle, the mbarriers
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 3 *
                                    kStages * 8;
  static constexpr bool kRunning = !kMnA;
  static constexpr int kRunTiles = 8;   // stages a running sum spans
  static constexpr int kPromote = 2;   // k8 steps a partial sum
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one 2-D box of `map` at (c0 inner, c1 outer) into shared memory, counted
// on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// makes this thread's writes to shared memory visible to the tensor cores'
// reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a K-major operand tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= a b: a 64 x 8 TF32 A fragment from registers, b a K-major
// 8 x 128 tile in shared memory; `scale` 0 overwrites d
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int scale) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

// d (+)= a b: a 64 x 8 TF32 A fragment from registers, b a K-major
// 8 x 192 tile in shared memory; `scale` 0 overwrites d
__device__ __forceinline__ void wgmma_n192(float (&d)[96],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int scale) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale) {
  if constexpr (N == 128) wgmma_n128(d, a, b, scale);
  else wgmma_n192(d, a, b, scale);
}

// x rounded to TF32 (nearest, ties away from zero), as a float's bits
// (dstd_mma.cuh::tf32)
__device__ __forceinline__ uint32_t tf32_big(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_big(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// byte offset of element (row, col) in a tile of 128-byte rows written by
// TMA with the 128-byte swizzle: 16-byte chunk (col / 4) XOR (row % 8)
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
}

// The A fragment of k8 step kk for the 64 rows at `row0` of the block
// tile (lane g, t: rows g and g + 8, depths t and t + 4), split.
// kMnA: the tile holds A transposed (depth rows, product rows along them)
// in boxes of 32 product rows; rows g and g + 8 are product rows 2g and
// 2g + 1.  Else the tile holds A as is (product rows of 32 depths).
template <bool kMnA>
__device__ __forceinline__ void load_a(const uint8_t* tile, int row0, int kk,
                                       int g, int t, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  float v[4];
  if (kMnA) {
    const int r = row0 + 2 * g;
    const uint8_t* box = tile + (r >> 5) * kBoxBytes;
    const float2 lo = *reinterpret_cast<const float2*>(
        box + sw128(kk * 8 + t, r & 31));
    const float2 hi = *reinterpret_cast<const float2*>(
        box + sw128(kk * 8 + t + 4, r & 31));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  } else {
    const int r = row0 + g;
    v[0] = *reinterpret_cast<const float*>(tile + sw128(r, kk * 8 + t));
    v[1] = *reinterpret_cast<const float*>(tile + sw128(r + 8, kk * 8 + t));
    v[2] = *reinterpret_cast<const float*>(tile + sw128(r, kk * 8 + t + 4));
    v[3] =
        *reinterpret_cast<const float*>(tile + sw128(r + 8, kk * 8 + t + 4));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], big[i], small[i]);
}

// D[m][n] = sum_k A(m, k) B(n, k) over a (kBM x kBN) tile a block.  A is
// `tmA`: kMnA, a (K rows, M columns) matrix, D stored transposed into
// out (N rows, ldo columns); else an (M rows, K columns) matrix, D stored
// into out (M rows, ldo columns).  B is `tmB`, an (N rows, K columns)
// matrix, split into its planes in shared memory.  The products of every
// kPromote k8 steps sum into a fresh accumulator (the small terms first),
// added on the CUDA cores: the tensor cores round a sum toward zero, and
// into one accumulator over all of K that bias grows with the total, to
// 5-15 times float32's own error at these depths (measured).
template <bool kMnA>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                const __grid_constant__ CUtensorMap tmB, float* __restrict__ out,
                int M, int N, int K, int ldo) {
  using T = Tile<kMnA>;
  constexpr int kBN = T::kBN, kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // full: the stage's A tile and B tile have landed; ready: B is split;
  // empty: the consumers are done with the stage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages *
                                                T::kStageBytes);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int ktiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 3);                 // one a splitting warp
      mbar_init(&empty[s], 4 * kConsumers);    // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0) {
      // one thread keeps the ring full: the A tile and B as stored, into
      // the big plane's place
      if (lane == 0) {
        for (int kt = 0; kt < ktiles; ++kt) {
          const int s = kt % kStages;
          mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
          uint8_t* st = smem + s * T::kStageBytes;
          mbar_expect_tx(&full[s], kABytes + T::kBBytes);
          const int k0 = kt * kBK;
          if (kMnA) {
#pragma unroll
            for (int i = 0; i < kBM / 32; ++i)
              tma_load(st + i * kBoxBytes, &tmA, &full[s], m0 + 32 * i, k0);
          } else {
            tma_load(st, &tmA, &full[s], k0, m0);
          }
          tma_load(st + kABytes, &tmB, &full[s], k0, n0);
        }
      }
    } else {
      // three warps split each B tile in place into its big plane and its
      // small one (the same swizzled layout), 16 bytes a load
      constexpr int kVecs = T::kBBytes / 16;
      const int id = threadIdx.x - 32;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&full[s], (kt / kStages) & 1);
        float4* big = reinterpret_cast<float4*>(smem + s * T::kStageBytes +
                                                kABytes);
        float4* small = big + kVecs;
        for (int i = id; i < kVecs; i += 96) {
          const float4 v = big[i];
          uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
          split(v.x, b0, s0);
          split(v.y, b1, s1);
          split(v.z, b2, s2);
          split(v.w, b3, s3);
          big[i] = make_float4(__uint_as_float(b0), __uint_as_float(b1),
                               __uint_as_float(b2), __uint_as_float(b3));
          small[i] = make_float4(__uint_as_float(s0), __uint_as_float(s1),
                                 __uint_as_float(s2), __uint_as_float(s3));
        }
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(&ready[s]);
      }
    }
  } else {
    // the consumers: warpgroup c owns product rows 64c .. 64c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = 64 * c + 16 * warp;
    constexpr int kR = kBN / 2;
    float acc[kR], total[kR], run[T::kRunning ? kR : 1];
#pragma unroll
    for (int i = 0; i < kR; ++i) total[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (T::kRunning ? kR : 1); ++i) run[i] = 0.0f;
    // [k8 step parity]: the next step's fragment loads while this one's
    // products run
    uint32_t big[2][4], small[2][4];

    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      mbar_wait(&ready[s], (kt / kStages) & 1);
      const uint8_t* st = smem + s * T::kStageBytes;
      const uint32_t b_big = smem_u32(st + kABytes);
      const uint32_t b_small = b_big + T::kBBytes;
      load_a<kMnA>(st, row0, 0, g, t, big[0], small[0]);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const int p = kk & 1;
        // 8 depths of 4 bytes: 32 bytes into the swizzled rows
        const uint64_t db = desc_sw128(b_big + 32 * kk);
        const uint64_t ds = desc_sw128(b_small + 32 * kk);
        // a partial sum starts afresh every kPromote steps
        const int fresh = kk % T::kPromote != 0;
        wgmma_fence();
        fence_acc(acc);
        wgmma_tf32<kBN>(acc, small[p], db, fresh);
        wgmma_tf32<kBN>(acc, big[p], ds, 1);
        wgmma_tf32<kBN>(acc, big[p], db, 1);
        wgmma_commit();
        fence_acc(acc);
        // the previous step's products are done: its fragments are free
        wgmma_wait<1>();
        if (kk + 1 < kBK / 8)
          load_a<kMnA>(st, row0, kk + 1, g, t, big[p ^ 1], small[p ^ 1]);
        if (kk % T::kPromote != T::kPromote - 1) continue;
        wgmma_wait<0>();
        fence_acc(acc);
        // after a stage's last step its tiles are free
        if (kk + 1 == kBK / 8 && lane == 0) mbar_arrive(&empty[s]);
        if constexpr (T::kRunning) {
#pragma unroll
          for (int i = 0; i < kR; ++i) run[i] += acc[i];
        } else {
#pragma unroll
          for (int i = 0; i < kR; ++i) total[i] += acc[i];
        }
      }
      if constexpr (T::kRunning) {
        if (kt % T::kRunTiles == T::kRunTiles - 1 || kt + 1 == ktiles) {
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            total[i] += run[i];
            run[i] = 0.0f;
          }
        }
      }
    }

    // accumulator (lane g, t), value 4j + q: row g + 8 (q / 2), column
    // 8j + 2t + q % 2
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (kMnA) {
        // rows g, g + 8 are product rows 2g, 2g + 1: one float2 of out
        const int m = m0 + row0 + 2 * g;
        if (m < M) {
          if (n < N)
            *reinterpret_cast<float2*>(out + (long long)n * ldo + m) =
                make_float2(total[4 * j], total[4 * j + 2]);
          if (n + 1 < N)
            *reinterpret_cast<float2*>(out + (long long)(n + 1) * ldo + m) =
                make_float2(total[4 * j + 1], total[4 * j + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int m = m0 + row0 + g + 8 * q;
          if (m >= M) continue;
          float* o = out + (long long)m * ldo + n;
          const float x0 = total[4 * j + 2 * q];
          const float x1 = total[4 * j + 2 * q + 1];
          if (n + 1 < N && !(ldo & 1)) {
            *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
          } else {
            if (n < N) o[0] = x0;
            if (n + 1 < N) o[1] = x1;
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (no link to libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a float32 (outer x inner) matrix of row stride `ld` floats, read in
// boxes of (box_outer x box_inner) with the 128-byte swizzle, zeros
// outside
bool make_map(CUtensorMap* map, const float* base, int inner, int outer,
              int ld, int box_inner, int box_outer) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool kMnA>
int launch_gemm(const float* a, const float* b, float* out, int M, int N,
                int K, int lda, int ldb, int ldo, int device, void* stream) {
  using T = Tile<kMnA>;
  if (M < 1 || N < 1 || K < 1 || lda % 4 || ldb % 4 || !aligned16(a) ||
      !aligned16(b))
    return (int)cudaErrorInvalidValue;
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap ta, tb;
  const bool ok = (kMnA ? make_map(&ta, a, M, K, lda, 32, 32)
                        : make_map(&ta, a, K, M, lda, 32, kBM)) &&
                  make_map(&tb, b, K, N, ldb, 32, T::kBN);
  if (!ok) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gemm_kernel<kMnA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + T::kBN - 1) / T::kBN, (M + kBM - 1) / kBM);
  gemm_kernel<kMnA><<<grid, kThreads, T::kSmemBytes,
                      (cudaStream_t)stream>>>(ta, tb, out, M, N, K, ldo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dstd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Each launches on `stream` and returns the cudaError_t of the launch
// (0 = success).  Pointers are device pointers to row-major float32
// matrices starting on 16-byte boundaries; F a multiple of 4.

// out (V x F) = B x: x (V x F), B (V rows of stride ldb, a multiple of 4)
int dense_hop_f32(const float* x, const float* b, float* out, int V, int F,
                  int ldb, int device, void* stream) {
  return launch_gemm<true>(x, b, out, F, V, V, F, ldb, F, device, stream);
}

// out (V x V) = x g^T: x and g (V x F)
int dense_outer_f32(const float* x, const float* g, float* out, int V, int F,
                    int device, void* stream) {
  return launch_gemm<false>(x, g, out, V, V, F, F, F, V, device, stream);
}

}  // extern "C"
