// Temporal DSTD-GC backward, whole op in four launches (float32).
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
// Bound on an H100 SXM: at N=32, T=35, V=22, 64->64 channels about 1 GFLOP
// of float32 CUDA-core work (about 15 us at 67 TFLOP/s) against about
// 19 MB of inputs and outputs (about 6 us at 3.35 TB/s): operation-bound,
// with 2*22*1225 tanh per sample recomputed twice.
//
// Design (dstd_bwd_common.cuh): as the spatial backward, with the roles of
// frames and joints exchanged: a pass over tiles of output joints (the
// (T, T) adjacency of each, dA, ddyn to scratch, dxf, the first part of dx,
// partials of dwf, dbf, dbase, dalpha, dbrm), a pass over tiles of source
// joints (ds, du, dq/dk, the rest of dx, partials of dwrm and the q/k
// weights), and a reduction of the partials in a fixed order.  ddyn
// (3.4 MB at N = 32) stays in L2 between the passes.  Plain float32 FMA on
// the CUDA cores, `tanhf`.
#include "dstd_bwd_common.cuh"

DSTD_BWD_C_API(dstd_temporal_bwd, true)
