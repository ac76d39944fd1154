// Spatial DSTD-GC backward, whole op in four launches (float32, and bf16
// contraction operands).
//
// Replaces the TPU kernel dstdgcn_tpu/kernels/fused_bwd.py::
// _spatial_bwd_kernel (entry spatial_bwd), the VJP of the forward kernel in
// dstd_spatial.cu.  Same contract as the plain version
// dstdgcn_tpu_torch/ops/dstd_bwd.py::dstd_spatial_bwd: from the saved x
// (N,T,V,Ci) and the output cotangent g (N,T,V,Co) it returns dx and the
// gradients of base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm and brm, the
// weight gradients summed over the batch.  Mixing axis: frames (REF = T);
// pair axis: joints (P = V); K = 2, R = 2.
//
// Bound on an H100 SXM: at N=32, T=35, V=22, 64->64 channels the backward
// does about 2.6x the forward's operations (the recompute of projections,
// scores and adjacency, then dA, dxf, dx, dwf, ds, dwrm and the q/k
// products), about 2 GFLOP of contractions, about 13 us at the 3xTF32
// rate (the dense TF32 tensor-core peak over 3, the least time for
// float32-accurate products), against about 19 MB of inputs and outputs
// (about 6 us at 3.35 TB/s): operation-bound, with 2*35*484 tanh per
// sample recomputed twice.  At bf16, with the contractions at the tensor
// cores' 989 TFLOP/s, the bytes bound it (chip_smoke.py::op_cost).
//
// Design (dstd_bwd_common.cuh): the TPU kernel carried the weight
// gradients from one grid step to the next; here blocks run in no order, so
// each block writes partial sums to a scratch buffer the wrapper allocates,
// and a fourth launch reduces them in a fixed order (no atomics: results
// repeat bit for bit).  The cross-frame coupling (ds of a source frame needs
// ddyn of every output frame) splits the work into a pass over output-frame
// tiles and a pass over source-frame tiles, with ddyn (4.3 MB at N = 32) in
// scratch, resident in L2 between them.  The five block products of pass 2
// (features, dA, dxf, dx, dwf) and pass 3's dwrm run as mma.sync tiles with
// float32 accumulators on the tensor cores (dstd_mma.cuh): in the float32
// entry as 3xTF32 products (float32-accurate), their fragments built from
// float32 shared memory, where pass 3's ds is one such product too; in the
// bf16 entry (the TPU kernel's bf16 dtype: the operands of the 11
// contractions rounded to bf16) as bf16 products, pass 2's on operands
// stored as bf16 in shared memory and read by ldmatrix (138,384 B a block
// at 64->64 and tile 5, where the float32 layout takes 213,984 B, so the
// bf16 wrapper's tile is 7: 175,216 B).  The
// mixing loop, the bf16 ds, the q/k products and every float32 sum stay on
// the CUDA cores.
#include "dstd_bwd_common.cuh"

DSTD_BWD_C_API(dstd_spatial_bwd, false)
