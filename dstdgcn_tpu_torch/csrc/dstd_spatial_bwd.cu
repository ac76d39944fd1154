// Spatial DSTD-GC backward, whole op in four launches (float32).
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
// products), about 2 GFLOP of float32 CUDA-core work (about 30 us at
// 67 TFLOP/s) against about 20 MB of inputs and outputs (about 6 us at
// 3.35 TB/s): operation-bound, with 2*35*484 tanh per sample recomputed
// twice.
//
// Design (dstd_bwd_common.cuh): the TPU kernel carried the weight
// gradients from one grid step to the next; here blocks run in no order, so
// each block writes partial sums to a scratch buffer the wrapper allocates,
// and a fourth launch reduces them in a fixed order (no atomics: results
// repeat bit for bit).  The cross-frame coupling (ds of a source frame needs
// ddyn of every output frame) splits the work into a pass over output-frame
// tiles and a pass over source-frame tiles, with ddyn (4.3 MB at N = 32) in
// scratch, resident in L2 between them.  Plain float32 FMA on the CUDA
// cores, `tanhf`; no tensor cores yet.
#include "dstd_bwd_common.cuh"

DSTD_BWD_C_API(dstd_spatial_bwd, false)
