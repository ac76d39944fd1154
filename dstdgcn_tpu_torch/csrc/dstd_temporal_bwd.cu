// Temporal DSTD-GC backward, whole op in four launches (float32, and bf16
// contraction operands).
//
// Replaces the TPU kernel dstdgcn_tpu/kernels/fused_bwd.py::
// _temporal_bwd_kernel (entry temporal_bwd), the VJP of the forward kernel
// in dstd_temporal.cu.  Same contract as the plain version
// dstdgcn_tpu_torch/ops/dstd_bwd.py::dstd_temporal_bwd: from the saved x
// (N,T,V,Ci) and the output cotangent g (N,T,V,Co) it returns dx and the
// gradients of base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm and brm, the
// weight gradients summed over the batch.  Mixing axis: joints (REF = V);
// pair axis: frames (P = T); K = 1, R = 2.
//
// Bound on an H100 SXM: at N=32, T=35, V=22, 64->64 channels about
// 1.1 GFLOP of contractions, about 7 us at the 3xTF32 rate (the dense TF32
// tensor-core peak over 3, the least time for float32-accurate products),
// against about 19 MB of inputs and outputs (about 6 us at 3.35 TB/s):
// operation-bound, with 2*22*1225 tanh per sample recomputed twice.  At
// bf16, with the contractions at the tensor cores' 989 TFLOP/s, the bytes
// bound it (chip_smoke.py::op_cost).
//
// Design (dstd_bwd_common.cuh): as the spatial backward, with the roles of
// frames and joints exchanged: a pass over tiles of output joints (the
// (T, T) adjacency of each, dA, ddyn to scratch, dxf, the first part of dx,
// partials of dwf, dbf, dbase, dalpha, dbrm), a pass over tiles of source
// joints (ds, du, dq/dk, the rest of dx, partials of dwrm and the q/k
// weights), and a reduction of the partials in a fixed order.  ddyn
// (3.4 MB at N = 32) stays in L2 between the passes.  Pass 2's five block
// products (features, dA, dxf, dx, dwf) and pass 3's dwrm run as mma.sync
// tiles with float32 accumulators on the tensor cores (dstd_mma.cuh), dwrm
// with its 1225-pair depth split over the warps of each of its three
// output tiles and the partials summed in a fixed order
// (dstd_mma::block_mma_split): in the float32 entry as 3xTF32 products
// (float32-accurate), where pass 3's ds is one such product too (its rows
// (r, source joint), its columns the frame pairs, each ddyn element read
// once a block) and the wrapper's tile is 4; in the bf16 entry (the TPU
// kernel's bf16 dtype: the operands of the 11 contractions rounded to
// bf16) as bf16 products, pass 2's on operands stored as bf16 in shared
// memory and read by ldmatrix.  The mixing loop (2*22 tanhf a frame pair), the
// bf16 ds, the q/k products and every float32 sum stay on the CUDA cores.
#include "dstd_bwd_common.cuh"

DSTD_BWD_C_API(dstd_temporal_bwd, true)
