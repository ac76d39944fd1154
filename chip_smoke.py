#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which must pass (exit code 1 and no result line otherwise):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every CUDA kernel from ``dstdgcn_tpu_torch/csrc`` for
   ``sm_90a``, one ``nvcc`` per source in parallel (6 libraries: the
   spatial and temporal forward and backward, each with its float32 and
   bf16 variant, the chain library with ``dstd_chain`` and
   ``dstd_encoder_chain``, each with its float32 and bf16 variant, and the
   block-sparse library with ``block_spmm``, ``block_sddmm`` and
   ``block_sddmm_spmm``: 15 kernels), with each entry function's registers
   and spills as ``ptxas`` reports them, and the number of tensor-core
   instructions (``HMMA``, and ``DMMA`` for float64 products; of all
   instructions) in the SASS of each function of every library
   (``cuobjdump``): some in passes 2 and 3 of every
   backward kernel (bf16 ``mma.sync`` in 5b and 6b, 3xTF32 in 5 and 6:
   ``MMA_FUNCTIONS``), in both forward kernels (float64 in 1 and 2, bf16
   in 1b and 2b), all four chain kernels (3xTF32 in 3 and 4, bf16 in 3b
   and 4b: ``MMA_FORWARD``) and the SpMM and the fused sparse kernel
   (3xTF32 in 7 and 9: ``MMA_SPARSE``), none in the q/k and reduction
   launches or the SDDMM kernel (8);
3. each kernel against its plain PyTorch version on the card, agg right and
   left, N=32, T=35, V=22, seeded inputs, TF32 off.  One-op kernels at
   every (Ci, Co) the serving and training paths give them.  Forward
   kernels: |kernel - plain| <= 1e-4 + 1e-4 |plain| elementwise.  Backward
   kernels (against ``ops/dstd_bwd.py``, seeded cotangent): per output
   tensor max |kernel - plain| <= 1e-4 max(max |plain|, 1), the JAX
   package's own norm, since the weight gradients sum 24,640 rows in
   another order (the float32 backward kernels' products run as 3xTF32
   tensor-core products, float32-accurate, in another order still), and
   two calls give the same bits.  The backward's plain time is autograd
   through the plain forward; the device time of each of the backward
   call's four launches (``launch_ms``: qk, out, src, reduce) beside the
   call's.  Chain kernels
   on the serving model's 5 encoder layers (BatchNorm
   calibrated, ``models/infer.py::encoder_chain_params``) at C=64, the
   encoder's input computed by the model on the plain ops (no kernel under
   test computes it: ``encoder_case``):
   ``dstd_encoder_chain`` and ``dstd_chain`` (the layers' ops, each scaled
   to an output peak of 1) against their plain versions, two calls
   bit-equal, and the gradients
   of ``dstd_chain`` (x and all 100 weights) against autograd through the
   plain chain, all within 1e-4 max(max |plain|, 1) (the JAX chain test's
   norm), the plain chain in float64 printed beside them.  The bf16
   variants of the one-op kernels at the bf16 slice's batch (N=128) and
   every (Ci, Co) its model gives them, both aggregations, against the
   plain versions of their contract (``ops/dstd.py::kernel_spatial`` /
   ``kernel_temporal``, ``ops/dstd_bwd.py`` with the dtype): the error
   within BF16_TOL and BF16_TOL below half of the check's own
   bf16-versus-float32 gap, all three printed, with the kernel's and the
   plain version's distance to the plain version run in float64 (the same
   rounding points; ``kernel_plain_vs_f64``).  The bf16 chain kernels
   (``dstd_encoder_chain_bf16``, ``dstd_chain_bf16``) on the serving
   model's calibrated encoder at N=128 (the bf16 fused slice's batch) and
   at N=1, both aggregations, against their plain versions
   (``_encoder_oracle`` / ``_chain_oracle`` with the dtype): each layer on
   the kernel's own input within BF16_LAYER_FRAC of the layer's
   bf16-versus-float32 gap; the five one-layer launches
   bit-equal to the five-layer launch, two calls bit-equal; the five-layer
   error within BF16_CHAIN_FRAC of its gap (rounding flips spread over the
   layers); a layer or the five layers past the fraction still held where
   the kernel lies near the float64 run of the bf16 contract
   (``chain_held``: F64_NOISE times the plain contract's distance to it,
   printed beside); the N=128 call timed beside the float32 kernel at
   N=128 and the bf16 kernel at N=32;
4. the serving slice: ``dstdgcn_tpu_torch.main.run`` on the config
   ``synthetic_h36m_serving`` (full-width H36M DSTD-GCN, random weights from
   seed 777) on ``cuda``: finite per-frame MPJPE, wall time per batch, and
   each forward kernel's launch count at exactly 7 per forward; then batch-1
   requests, and one full batch served through the kernels against the
   plain path (at the same 1e-4);
5. the fused serving slice: ``main.run`` on ``synthetic_h36m_fused`` (the
   same weights, ``engine.fused_inference``): per-frame MPJPE within 1e-4
   relative of phase 4's, exactly 1 ``dstd_encoder_chain``, 2 ``dstd_spatial``
   and 2 ``dstd_temporal`` launches per eval batch and no backward; a
   batch-1 eval sweep, the batch-32 fused forward's wall and device time
   beside the standard forward's, and one calibrated batch against the
   plain path (1e-4 + 1e-4 |plain|);
6. ``dstd_chain``'s own path (the kernel API with its gradient): one
   forward and backward of the 5-block chain, exact launch counts; then
   the same at bf16, counts from zero: exactly 1 ``dstd_chain_bf16``, and
   the backward replays the chain at float32 as the JAX package's VJP of
   its float32 oracle does (5 + 5 float32 forward launches, 5 backward
   calls of each op, no bf16 one-op kernel), so its gradients equal the
   float32 pass's bit for bit;
7. the training slice: ``main.run`` on ``synthetic_h36m_train`` (the same
   model, ``use_pallas: True``, 2 epochs of 8 steps of batch 32, an eval
   sweep of 2 batches after each): finite losses and per-frame MPJPE, the
   csv and both checkpoints written, and exact launch counts (forward
   kernels 14 per train step plus 7 per eval batch; backward kernels 14
   calls per train step, 4 launches each); wall ms per train step and the
   device-busy share of one step; then one train step on one batch with
   dropout 0 and BatchNorm calibrated, kernel path against plain path
   (loss to 1e-5 relative; each parameter's gradient against the plain
   path run in float64, within 1e-3 max(max |float64|, 1) or twice the
   plain float32 path's own distance, see GRAD_TOL), and the train step
   timed on both paths;
8. the blocked sparse surface (``kernels/sparse.py``): each of its three
   kernels against its plain version (the masked dense form) at a small
   pattern (V=256, block 128) and at the large graph of
   ``bench.py::bench_sparse_kernels`` (N=4, V=4096, R=4, C=128, block 128,
   a band of +-2 blocks plus 3% random ones: 174 active blocks), within
   tol max(max |plain|, 1), tol 1e-5 for the SpMM and SDDMM (active blocks
   only) and 1e-4 for the fused op, two calls bit-equal; then the main
   path, counts from zero: the scores (``block_sddmm``, no gradient), h =
   ``block_sddmm_spmm(q, k, w, x)`` and y = ``block_spmm(adj, h)``,
   forward and backward, exactly one launch of each kernel, y and the
   gradients of q, k, w, x and adj against autograd through the masked
   dense oracle (1e-4 of max(|plain|, 1)); times, bounds, and for the SpMM
   the dense ``torch.bmm`` of the pre-masked adjacency as ``library_ms``;
8b. Graph WaveNet's dense adaptive hop (``kernels/dense.py``): the
   forward and both gradients at V 3,834 and 200, F 2,048 and 24,576,
   against float64 within twice the plain float32 product's distance (or
   1e-6 of the peak), exact launches; device ms beside the bound and
   ``torch.mm``; then, counts from zero, one Graph WaveNet training step
   at the forecast configuration's graph and widths (batch 2, dropout 0):
   44 launches, the loss and each gradient against the same step on the
   plain products (``dense_phase``, alone after the build: about a
   minute);
9. the bf16 slice: ``main.run`` on ``synthetic_h36m_tpu_train`` (the
   flagship TPU configuration's model and engine blocks, "auto" knobs,
   batch 128, 2 epochs of 4 steps and an eval batch after each): the
   knobs resolve to bf16, exact launch counts of the four bf16 kernels and
   none of the float32 DSTD-GC kernels, finite losses and MPJPE, step wall
   times and one step's device time by kernel; then one bf16 train step
   (dropout 0, BatchNorm calibrated) of a fresh kernel-path model against
   the plain path of the same contract on the card, at the weights the
   plain path reaches in as many train steps from the same seeded initial
   weights (no kernel under test moves them): the loss within
   BF16_LOSS_RTOL, and the gate gradients and the other gradients, each as
   a group, on average no farther from the plain path's float64 run than
   BF16_STEP_NOISE times the plain path's own distance;
10. the bf16 fused serving slice: ``main.run`` on
   ``synthetic_h36m_tpu_fused`` (the flagship TPU configuration's model and
   engine blocks with ``engine.fused_inference``, batch 128, 4 eval
   batches): the knobs resolve to bf16, exactly 1
   ``dstd_encoder_chain_bf16`` per eval batch and no other DSTD-GC kernel
   (the in and out layers run the plain ops at bf16, the XLA path's
   rounding, as the JAX function has it), finite per-frame MPJPE; batch-1
   requests (one bf16 launch each); the batch-128 bf16 fused forward's
   wall and device time beside the float32 fused forward, the standard
   bf16 forward and a batch-1 request; one calibrated batch against the
   same function with the encoder through ``_encoder_oracle`` (the dtype),
   within BF16_CHAIN_FRAC of the batch's bf16-versus-float32 gap;
11. the real-dataset slice: seeded trees in each dataset's own format
   under ``chiprun_out/chip_smoke/data/``, removed after the phase
   (``write_h36m_tree``, ``write_cmu_tree``, ``write_pw3d_tree``: expmap
   CSVs of 99 and 117 channels, pickled ``jointPositions``; sizes in
   REAL_TREES); the float32
   one-op kernels, forward and backward, both aggregations, against their
   plain versions at every (Ci, Co) of the CMU (T=35, V=25) and 3DPW
   (T=40, V=23) models by phase 3's rules (``real_op_checks``); then
   ``main.run`` on ``real_h36m_train`` (2 epochs of 8 steps, the eval over
   all 15 actions after each), ``real_cmu_train`` and ``real_3dpw_train``
   (1 epoch of REAL_STEPS steps and an eval), each with exact launch
   counts, finite losses and per-action MPJPE, ``training_loss.csv`` of
   the JAX runner's columns with the best row appended, both checkpoints,
   every CSV file read by the native reader; for H36M the recovery probe
   (``test`` mode on ``best.ckpt`` gives the best row's test loss
   exactly), ``test-all`` (15 action rows and an ``average`` row of 25
   frame columns) and one calibrated test batch against the plain path
   (1e-4 + 1e-4 |plain|); for CMU and 3DPW one train step against the
   plain path by phase 7's rules; printed: the files each reader served,
   the tree write and dataset build seconds, the wall ms of a train step,
   an eval batch and a loader fetch, and a train step's device ms;
12. the engine remainder: ``main.run`` on ``synthetic_h36m_engine_train``
   (the training slice with ``model.dstdgcn.remat``, the ``engine.solver``
   block, ``engine.callbacks`` and a profiler trace of steps 1-3,
   ``engine.profile``): finite losses and MPJPE, both checkpoints, exact
   launch counts (28 of each float32 forward kernel per train step under
   remat plus 7 per eval batch, 14 backward calls of 4 launches), each
   epoch's group learning rates (the bias group at exactly twice the base
   group), the callback CSV (2 rows), one trace whose kernel events are
   exactly 3 times a step's launches of the four kernels
   (``trace_kernel_counts``; the trace is removed after); then, at the
   slice's weights with dropout 0 and BatchNorm calibrated, remat ``True``
   and ``"dots"`` against no remat on the kernel path (loss and every
   gradient bit-equal) and the kernel path with remat against the plain
   path by phase 7's rules; the solver's train step by phase 7's rules and
   each path's update against optax's rule in float64
   (``solver_update_check``); the resume from a checkpoint in the JAX
   package's layout of the slice's state (``write_jax_checkpoint``:
   parameters, statistics and Adam moments bit-equal, the payload, one
   more step through the kernels); each remat mode's peak memory
   (batches 32 and 128, both paths) and device time of a train step;
   ``utils/timing.py::time_looped`` of the float32 spatial op beside the
   profiler's time; ``visualize-debug`` on a seeded H36M tree of the debug
   action (8 GIFs and 8 PNGs with matplotlib and imageio, none without
   them, as on the card);
13. the parallel slice (``dstdgcn_tpu_torch/parallel/``): (a)
   ``main.run`` on ``synthetic_h36m_dp_train`` (the training slice with
   ``parallel: {data: auto}``) under a one-rank NCCL group started by the
   ``DSTDGCN_*`` variables: the launch counts, losses and per-frame MPJPE
   of phase 7 exactly (a group of one adds nothing to a sum), and the three
   ``shard.py`` ops at world size 1 against the plain ops within 1e-5
   max(|plain|, 1); (b) DP_RANKS ranks on the one card, each a child
   process (``chip_smoke.py --dp-rank``) started with the ``DSTDGCN_*``
   variables and ``DSTDGCN_BACKEND=gloo`` (NCCL takes one rank a GPU), each
   with a run directory of its own: 2 epochs of DP_STEPS steps at a global
   batch of 32 (16 a rank), exact launch counts on each rank at batch 16,
   finite losses equal on both ranks, rank 0's csv and checkpoints and no
   file from rank 1; then one step (dropout 0, BatchNorm calibrated)
   against the single-process kernel path at batch 32 (loss within
   LOSS_RTOL) and by phase 7's rules; then the two edge-partitioned
   ``shard.py`` ops over the two ranks (gloo's CUDA tensors take the
   all-gather and the reduce-scatter) against the plain ops, output and x
   gradient within 1e-5 max(|plain|, 1); (c) what the card runs with two
   ranks (PROBES, a finding, not a check: NCCL's refusal of two ranks on
   one GPU, each collective on gloo's CUDA tensors); printed: the step's
   wall on 1 and 2 ranks, the CUDA-event ms of a step's flat gradient
   all-reduce and of one BatchNorm's statistics all-reduce under NCCL (1
   rank) and gloo (2 ranks), the phase's seconds;
14. the graph and model axes: the float32 one-op kernels, forward and
   backward, both aggregations, against their plain versions at the model
   axis's new shapes (AXIS_SHAPES: 6 -> 32 and 64 -> 32, T=35, V=22) by
   phase 3's rules; then AXIS_RANKS ranks on the one card, each a child
   process (``chip_smoke.py --axis-rank``) started with the ``DSTDGCN_*``
   variables and ``DSTDGCN_BACKEND=gloo``, each running
   ``synthetic_h36m_graph_train`` (``parallel: {graph: 2}``: every op's
   kernels on all joints of the gathered input, the rank's rows kept),
   ``synthetic_h36m_model_train`` (``{model: 2}``: every op's kernels at
   half the output channels, the 64 -> 3 out layer whole) and
   ``synthetic_h36m_fast_graph_train`` (the fast variant of
   ``configs/dstdgcn_fast_multihost.yaml``, the plain edge-partitioned
   ops) through ``main.run`` for one epoch of AXIS_STEPS steps and an eval
   sweep: exact launch counts on each rank (14 of each forward kernel a
   step and 7 an eval batch, 14 backward calls a step; none on the plain
   path), finite losses equal on both ranks, rank 0's csv and checkpoints
   and no file from rank 1; ``engine.test`` under the mesh within 1e-4
   relative of one process with the same state and, on the kernel path,
   with ``engine.fused_inference`` (the whole-encoder kernel whole on each
   rank, one launch a batch) within 1e-4 relative of it; one step (dropout 0,
   BatchNorm calibrated) against the single-process path at the same
   global batch (loss within LOSS_RTOL) and by phase 7's rules; printed:
   each rank's step wall, the collectives a step issues (calls and values
   of each ``torch.distributed`` function), the phase's seconds;
15. the remaining configurations: (a) the kernels at the shapes they
   take there, each with the tile its wrapper chose: the bf16 one-op
   kernels at N=128 at every (Ci, Co) of the CMU (T=35, V=25) and 3DPW
   (T=40, V=23) models by phase 3's bf16 rules, the float32 one-op kernels
   at every (Ci, Co) of the fast model (T=20, V=22, 16 features; N=64) by
   phase 3's rules (``real_op_checks``), the float32 whole-encoder kernel
   on each model's calibrated encoder by phase 3's rule and the bf16 one
   on the CMU and 3DPW encoders by phase 3's chain rules
   (``encoder_checks``, ``bf16_chain_checks``); (b) ``main.run`` on
   ``real_cmu_tpu_train`` and ``real_3dpw_tpu_train`` (the JAX package's
   TPU profiles at batch 128, "auto" resolving to bf16) on phase 11's
   seeded trees for one epoch of 4 steps and the per-action eval: exact
   launches of the bf16 one-op kernels and none of the float32 ones,
   finite losses and MPJPE, one bf16 step against the plain path of its
   contract by phase 9's rule, the ``engine.fused_inference`` sweep on
   the trained state (one ``dstd_encoder_chain_bf16`` a batch) and one
   calibrated batch by phase 10's rule; (c) ``main.run`` on
   ``synthetic_h36m_fast_train`` (the fast variant, agg left, through the
   float32 kernels) for one epoch and its eval: exact launches, one step
   against the plain path by phase 7's rules, the fused sweep (one
   ``dstd_encoder_chain`` and 2 + 2 one-op launches a batch) within 1e-4
   relative of the standard one; printed: each run's step wall and device
   ms, an eval batch's wall, a batch's fused and standard forward times;
16. a ``{"kernels": [...]}`` line with each of the 16 kernels' launches on
   its main path (the training slice for the float32 one-op kernels, the
   bf16 slice for their bf16 variants, the fused slices for the encoder
   kernels, phase 6 and its bf16 pass for ``dstd_chain``, phase 8 for the
   sparse kernels, phase 8b's Graph WaveNet step for the dense hop), max
   error, times and bound (contractions at the
   tensor cores' rate for the dtype: dense bf16, or for float32 3xTF32,
   the dense TF32 rate over 3; the rest at the float32 rate), the float32
   one-op kernels' launches in phase 11's training runs beside them
   (``real_launches``), the four float32 DSTD-GC kernels' in phase
   12's slice run (``remat_launches``), every kernel's in phase 13's
   runs (``dp_launches``: world size 1 and each rank of the two), in
   phase 14's (``axis_launches``: each config, each rank) and in phase
   15's (``profile_launches``: each run), and each kernel's times and
   bound at phase 15's shapes (``profile_ms``).

The last line is ``{"ok": true, "device": {...}}``.  ``ms`` / ``plain_ms``
are device times per call from ``torch.profiler`` (the kernels' own time);
``call_ms`` is the CUDA-event mean per call of back-to-back calls, host
launch overhead included.  Caches are warm: the 12.7 MB activations of a
batch-32 launch fit in the 50 MB L2, as they do between the ops of one
forward; at batch 128 the chain kernels' three activation buffers (25.2 MB
each) do not.
Run logs and a full report go to ``chiprun_out/chip_smoke/``.
"""

import copy
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")

N, T, V = 32, 35, 22
TOL = 1e-4
#: train-step comparison: the loss against the plain path; each gradient
#: against the plain path run in float64, within 1e-3 of max(|float64|, 1)
#: or, where float32 rounding alone is larger, within twice the plain
#: float32 path's own distance to float64.  The gradient of a gate alpha
#: sums about a million products dA * dyn that largely cancel, so float32
#: summation order alone moves it by a few 1e-3 (the plain float32 path has
#: measured up to 4.7e-3 from float64 there), and no fixed bound of 1e-3
#: or tighter separates a kernel fault from rounding.
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
#: bf16 variants against the plain versions of their contract
#: (``ops/dstd.py::kernel_spatial``, ``ops/dstd_bwd.py`` with the dtype):
#: forward over the peak |plain float32 output|, backward per gradient over
#: max(max |plain|, 1).  Two right implementations that sum in another
#: order can round an intermediate to neighbouring bf16 values, so these
#: are set from the measured spread (at N=128 on the H100: forward up to
#: 6.8e-4, backward up to 1.49e-3), and each check holds them below half
#: of its own bf16-versus-float32 gap (printed beside it; 3.4e-3 to 6.1e-3
#: forward, 9.2e-3 to 7.9e-2 backward).
BF16_TOL = dict(forward=1.2e-3, backward=2.5e-3)
#: the bf16 train step, kernel path against the plain path of the same
#: contract, at weights the plain path trains: the loss (relative), and
#: for the gate gradients (alpha) and for the rest, the mean over the
#: group's parameters of the distance to the plain path's float64 run (the
#: same rounding points), max |a - b| over max(max |float64|, 1), within
#: BF16_STEP_NOISE times the plain float32 path's own mean distance (the
#: float32 step's factor, GRAD_TOL).  A rounding flip in one float32 run
#: moves a bf16 intermediate by a bf16 step and the gradients downstream
#: with it: the gates sum about a million cancelling products dA * dyn,
#: and every run's flips move them by up to a tenth of max(|g|, 1), the
#: float64 run's own included.  So the noise is the plain path's distance
#: at the same weights, neither a fixed bound nor the bf16-versus-float32
#: gap (which that noise reaches at many weights); and a group's mean, as
#: one run's flips hit other parameters than another's (the largest
#: distances differ by up to 2.5x between right kernels).  Measured on the
#: H100 (``step_noise.py``, 6 weight states, 5b's tensor-core kernel and
#: its CUDA-core predecessor): the mean ratio 0.70-1.21 (gates) and
#: 0.96-1.09 (the rest); a 5b whose dx misses one joint reaches 2.4-11.7
#: and 5.1-10.8.  A 1% error in one weight gradient stays under it: phase
#: 3 holds each kernel's gradients at BF16_TOL.
BF16_LOSS_RTOL = 1e-3
BF16_STEP_NOISE = 2.0
#: the bf16 chain kernels against their plain versions (``_chain_oracle`` /
#: ``_encoder_oracle`` with the dtype) on the calibrated serving encoder,
#: max |kernel - plain| over the peak |plain float32 output|, each held
#: against its own bf16-versus-float32 gap.  Two right implementations can
#: round an op's input to neighbouring bf16 values: each layer, on the
#: kernel's own input, within BF16_LAYER_FRAC of the layer's gap (measured
#: on the H100 up to 0.195 of it, 1.46e-3 of the peak, against gaps of
#: 2.7e-3 to 1.1e-2).  Over five layers a flip moves the next layers'
#: inputs and their roundings flip in turn: the five-layer error, and that
#: of the bf16 fused forward (``synthetic_h36m_tpu_fused``, batch 128)
#: against the same function with the encoder through ``_encoder_oracle``,
#: within BF16_CHAIN_FRAC of their own gap (measured up to 0.69 of it).
BF16_LAYER_FRAC = 0.3
BF16_CHAIN_FRAC = 0.9
#: a check past its bound is still held where the kernel lies near the
#: float64 run of its contract (the same rounding points, sums in
#: float64): within F64_NOISE times the plain contract's own distance to
#: that run (F4: the card tests' tile cases; F7: the chain checks below).
#: A bf16 rounding flip moves an output by a bf16 step in one summation
#: order and not in another, so the kernel and the plain contract are runs
#: of the same rounding noise about the float64 run, and a fixed fraction
#: of the gap on one input measures which of them flipped, not a fault
#: (``chain_held``).  The factor of the train steps' GRAD_TOL and
#: BF16_STEP_NOISE.
F64_NOISE = 2.0
#: the right float32 orders of the float32 chain gradient (F7): besides
#: the plain chain on the card and on the CPU, ROUNDING_RUNS plain chains
#: that each move every op's output by one float32 rounding (y + y d, d
#: uniform in +-ROUNDING_UNIT from a generator seeded with the draw:
#: ``rounding_deltas``, ``rounded_chain``), the errors a right float32
#: forward kernel may make.  The gate gradients sum about a million
#: products that cancel, so such a rounding moves them far more than the
#: one op it enters; two orders alone measure how close they happened to
#: land
ROUNDING_RUNS = 8
ROUNDING_UNIT = 2.0 ** -24
#: published H100 SXM peaks (float32 outside the tensor cores, dense bf16
#: and TF32 on the tensor cores, HBM3)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES = 3.35e12
#: float32-accurate contractions at their least time on this card: 3xTF32,
#: three TF32 tensor-core products for each (csrc/dstd_mma.cuh)
PEAK_F32_DOT_FLOPS = PEAK_TF32_FLOPS / 3
#: file:line of the TPU kernel each CUDA kernel replaces, and its source
KERNELS = {
    "dstd_spatial": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_spatial.cu",
        replaces="dstdgcn_tpu/kernels/fused.py:137"),
    "dstd_temporal": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_temporal.cu",
        replaces="dstdgcn_tpu/kernels/fused.py:193"),
    "dstd_spatial_bwd": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_spatial_bwd.cu",
        replaces="dstdgcn_tpu/kernels/fused_bwd.py:85"),
    "dstd_temporal_bwd": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_temporal_bwd.cu",
        replaces="dstdgcn_tpu/kernels/fused_bwd.py:177"),
    "dstd_spatial_bf16": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_spatial.cu",
        replaces="dstdgcn_tpu/kernels/fused.py:137"),
    "dstd_temporal_bf16": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_temporal.cu",
        replaces="dstdgcn_tpu/kernels/fused.py:193"),
    "dstd_spatial_bwd_bf16": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_spatial_bwd.cu",
        replaces="dstdgcn_tpu/kernels/fused_bwd.py:85"),
    "dstd_temporal_bwd_bf16": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_temporal_bwd.cu",
        replaces="dstdgcn_tpu/kernels/fused_bwd.py:177"),
    "dstd_chain": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_chain.cu",
        replaces="dstdgcn_tpu/kernels/fused.py:498"),
    "dstd_encoder_chain": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_chain.cu",
        replaces="dstdgcn_tpu/kernels/fused.py:654"),
    "dstd_chain_bf16": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_chain.cu",
        replaces="dstdgcn_tpu/kernels/fused.py:498"),
    "dstd_encoder_chain_bf16": dict(
        source="dstdgcn_tpu_torch/csrc/dstd_chain.cu",
        replaces="dstdgcn_tpu/kernels/fused.py:654"),
    "block_spmm": dict(
        source="dstdgcn_tpu_torch/csrc/block_sparse.cu",
        replaces="dstdgcn_tpu/kernels/sparse.py:101"),
    "block_sddmm": dict(
        source="dstdgcn_tpu_torch/csrc/block_sparse.cu",
        replaces="dstdgcn_tpu/kernels/sparse.py:162"),
    "block_sddmm_spmm": dict(
        source="dstdgcn_tpu_torch/csrc/block_sparse.cu",
        replaces="dstdgcn_tpu/kernels/sparse.py:199"),
    "dense_hop": dict(
        source="dstdgcn_tpu_torch/csrc/dense_hop.cu",
        replaces="none"),
}
FORWARD = ("dstd_spatial", "dstd_temporal")
BACKWARD = ("dstd_spatial_bwd", "dstd_temporal_bwd")
CHAINS = ("dstd_chain", "dstd_encoder_chain")
#: the bf16 variants of the one-op kernels (launch counters ``<name>_bf16``)
BF16_FORWARD = ("dstd_spatial_bf16", "dstd_temporal_bf16")
BF16_BACKWARD = ("dstd_spatial_bwd_bf16", "dstd_temporal_bwd_bf16")
BF16_CHAINS = ("dstd_chain_bf16", "dstd_encoder_chain_bf16")
SPARSE = ("block_spmm", "block_sddmm", "block_sddmm_spmm")
#: the 11 outputs of a DSTD-GC backward call, in order
GRADIENTS = ("dx", "dbase", "dalpha", "dwf", "dbf", "dwm1", "dbm1", "dwm2",
             "dbm2", "dwrm", "dbrm")
#: the four launches of a DSTD-GC backward call (``dstd_bwd_common.cuh``)
BWD_PASSES = ("qk", "out", "src", "reduce")
#: the functions whose products run on the tensor cores: passes 2 and 3
#: of every backward kernel (``csrc/dstd_mma.cuh``; the bf16 ones, 5b and
#: 6b, on bf16 ``mma.sync``, the float32 ones, 5 and 6, on 3xTF32), every
#: tile; the q/k and reduction launches keep their CUDA-core FMAs
MMA_FUNCTIONS = ("dstd_bwd::out_kernel<", "dstd_bwd::src_kernel<")
#: the forward functions that run every product but q/k on the tensor
#: cores in the body of ``csrc/dstd_fwd_mma.cuh``: the spatial and the
#: temporal kernel in both dtypes (1 and 2 on float64 ``mma.sync``, 1b and
#: 2b on bf16) and every chain instantiation (``chain_kernel<TILE,
#: kEncoder, Rnd>``: 3 and 4 on 3xTF32, 3b and 4b on bf16)
MMA_FORWARD = ("spatial_kernel<", "temporal_kernel<", "chain_kernel<")
#: the sparse kernels whose products run on the tensor cores (7 and 9,
#: 3xTF32); the SDDMM (8) has no products
MMA_SPARSE = ("spmm_kernel", "sddmm_spmm_kernel")


#: the libraries whose SASS phase 2 reads
SASS_LIBRARIES = ("dstd_spatial", "dstd_temporal", "dstd_chain",
                  "dstd_spatial_bwd", "dstd_temporal_bwd", "block_sparse")


def uses_mma(function):
    return function.startswith(MMA_FUNCTIONS + MMA_FORWARD + MMA_SPARSE)


#: the large graph of the sparse surface (``bench.py::bench_sparse_kernels``)
SPARSE_N, SPARSE_V, SPARSE_R, SPARSE_C, SPARSE_BLOCK = 4, 4096, 4, 128, 128
#: kernel against plain version, max |kernel - plain| <= tol max(|plain|, 1)
#: per output: the JAX sparse tests' tolerances, taken against the largest
#: magnitude since sums over up to 896 sources cancel
SPARSE_TOL = dict(block_spmm=1e-5, block_sddmm=1e-5, block_sddmm_spmm=1e-4)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def ptxas_usage(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] of each
    entry function in an ``nvcc -Xptxas -v`` log, names demangled by
    ``c++filt`` where the toolchain has it."""
    import re
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), *spill])
            name = None
    for r, full in zip(rows, demangle([r[0] for r in rows])):
        r[0] = full
    return [tuple(r) for r in rows]


def demangle(names):
    """``names`` demangled by ``c++filt`` where the toolchain has it, as
    ``ns::kernel<args>``; else as they are."""
    try:
        full = subprocess.run(["c++filt"], input="\n".join(names),
                              capture_output=True, text=True,
                              timeout=60).stdout.splitlines()
    except OSError:
        full = []
    if len(full) != len(names):
        return list(names)
    return [f.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for f in full]


def sass_mma(path, pattern=r"\b[HD]MMA\b"):
    """{kernel: (number of tensor-core instructions, ``HMMA`` and
    ``DMMA`` or those ``pattern`` matches, of all instructions)} of each
    function in the SASS of the built library at ``path`` (``cuobjdump
    -sass``); fails where the toolkit has no cuobjdump, since the
    tensor-core check cannot run without it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.access(tool, os.X_OK), "no cuobjdump: the SASS of the "
                                    "kernels cannot be read")
    proc = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr}")
    counts = sass_counts(proc.stdout, pattern)
    return dict(zip(demangle(list(counts)), counts.values()))


def sass_counts(text, pattern=r"\b[HD]MMA\b"):
    """{mangled kernel: (tensor-core instructions, those ``pattern``
    matches, HMMA or DMMA by default; instructions)} of a
    ``cuobjdump -sass`` listing: an instruction is a line with an address
    comment (``/*0a70*/``), a function starts at ``Function : name``."""
    import re
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = (0, 0)
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            hmma, total = counts[name]
            counts[name] = (hmma + bool(re.search(pattern, line)),
                            total + 1)
    return counts


def op_weights(mode, ci, co, t=T, v=V):
    """Weight floats of one op (base, alpha, wf, bf, wm1, bm1, wm2, bm2,
    wrm, brm) at T = ``t``, V = ``v``."""
    k, r = (2 if mode == "spatial" else 1), 2
    ref, pair = (t, v) if mode == "spatial" else (v, t)
    return (k * pair * pair + 1 + k * ci * co + k * co + 2 * k * ci * r
            + 2 * k * r + k * r * ref * ref + k * ref)


def chain_cost(n, c, layers, encoder, dtype=None, t=T, v=V):
    """(flops, bytes, contraction flops, their peak) of one chain call of
    ``layers`` (spatial, temporal) blocks at C channels, T = ``t``, V =
    ``v``: the ops' operations (as ``op_cost``) plus, for the encoder, 10
    elementwise operations per activation element and layer (affine,
    residual and PReLU after each op); x read and the output written once
    in float32, every weight read once (the encoder's affines and slopes
    too)."""
    rows = n * t * v
    costs = [op_cost(mode, n, c, c, dtype=dtype, t=t, v=v)
             for mode in ("spatial", "temporal")]
    flops = layers * sum(cost[0] for cost in costs)
    tensor_flops = layers * sum(cost[2] for cost in costs)
    weights = layers * (op_weights("spatial", c, c, t, v)
                        + op_weights("temporal", c, c, t, v))
    if encoder:
        flops += layers * 10 * rows * c
        weights += layers * (4 * v * c + 2)
    return flops, 4 * (2 * rows * c + weights), tensor_flops, costs[0][3]


def bound_of(flops, nbytes, dot_flops=0.0, dot_peak=PEAK_F32_DOT_FLOPS):
    """(least ms, ms of the operations, ms of the bytes): ``flops`` (the
    elementwise work) at the float32 rate, ``dot_flops`` (the
    contractions) at ``dot_peak``: the dense bf16 tensor-core rate for a
    bf16 contract, the 3xTF32 rate for float32."""
    t_ops = (flops / PEAK_F32_FLOPS + dot_flops / dot_peak) * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_mem), t_ops, t_mem


def op_cost(mode, n, ci, co, backward=False, dtype=None, t=T, v=V):
    """(flops, bytes, contraction flops, their peak) one call needs at T =
    ``t``, V = ``v``: every input read once, every output written once;
    tanh and the pair difference count one op each.  The backward
    recomputes the forward up to the adjacency, then does the dA and dxf
    products, dalpha / dbase /
    dbrm, dx from dxf, dwf / dbf, dwrm, ds, du, the dq / dk sums, dx from
    dq / dk and dwqk / dbqk; it reads x, g and the weights and writes dx
    and the weight gradients.  The contractions (the projections, the
    mixing, the aggregation and their backward products) run at the
    tensor cores' rate for the dtype (bf16: dense bf16; float32: 3xTF32,
    the least time for float32-accurate products on this card), the rest
    at the float32 rate; the bytes are those the kernel moves: float32
    inputs and outputs at either dtype, but for the bf16 forward, which
    reads x as bf16."""
    k = 2 if mode == "spatial" else 1
    r = 2
    ref, pair = (t, v) if mode == "spatial" else (v, t)
    rows = n * t * v
    scores = n * k * r * ref * pair * pair          # score entries
    adj = n * k * ref * pair * pair                 # adjacency entries
    proj = 2 * rows * ci * co * k                   # feature projection
    qk = 2 * rows * ci * 2 * r * k                  # q/k projections
    mix = 2 * scores * ref                          # frame/joint mixing
    agg = 2 * adj * co                              # aggregation
    weights = op_weights(mode, ci, co, t, v)
    if not backward:
        dots = proj + qk + mix + agg
        rest = 2 * scores + 2 * adj
        x_bytes = 4 if dtype is None else 2
        nbytes = x_bytes * rows * ci + 4 * (rows * co + weights)
    else:
        dots = (proj + qk + mix                      # recompute
                + 2 * agg                            # dA, dxf
                + 2 * proj                           # dx(dxf), dwf
                + 2 * mix                            # dwrm, ds
                + 2 * qk)                            # dx(dqk), dwqk
        rest = (2 * scores + 2 * adj                 # recompute
                + 3 * adj                            # dalpha, dbase, dbrm
                + rows * co * k                      # dbf
                + 3 * scores + 2 * scores            # du, dq / dk sums
                + rows * 2 * r * k)                  # dbqk
        nbytes = 4 * (2 * rows * ci + rows * co + 2 * weights)
    return rest, nbytes, dots, (PEAK_F32_DOT_FLOPS if dtype is None
                                else PEAK_BF16_FLOPS)


def bound_ms(mode, n, ci, co, backward=False, dtype=None, t=T, v=V):
    """(least ms, ms of the operations, ms of the bytes) of one call."""
    return bound_of(*op_cost(mode, n, ci, co, backward, dtype, t, v))


def sparse_cost(name, n, blocks, block, r, c, v, vj=None):
    """(flops, bytes, contraction flops, their peak) one sparse call needs
    at ``blocks`` active blocks: every input read once (the adjacency's
    active blocks only), every output written once (the SDDMM's active
    blocks only).  Per score entry and r: the difference and the tanh
    (counted as one operation each, though accurate tanhf is some 20
    instructions) at the float32 rate, the multiply and the add of the sum
    over r a contraction; per product term a multiply-add (2), a
    contraction.  Contractions at the 3xTF32 rate (float32, as
    ``op_cost``)."""
    vj = v if vj is None else vj
    entries = n * blocks * block * block
    if name == "block_spmm":
        return (0, 4 * (entries + n * vj * c + n * v * c), 2 * entries * c,
                PEAK_F32_DOT_FLOPS)
    if name == "block_sddmm":
        return (2 * r * entries, 4 * (2 * n * v * r + r + entries),
                2 * r * entries, PEAK_F32_DOT_FLOPS)
    return (2 * r * entries, 4 * (2 * n * v * r + r + 2 * n * v * c),
            (2 * r + 2 * c) * entries, PEAK_F32_DOT_FLOPS)


def large_graph(np, sparse):
    """The large graph of ``bench.py::bench_sparse_kernels`` (seed 0): a
    band of +-2 blocks plus 3% random blocks, then q, k, w, x."""
    rng = np.random.RandomState(0)
    n, v, r, c, block = (SPARSE_N, SPARSE_V, SPARSE_R, SPARSE_C,
                         SPARSE_BLOCK)
    nb = v // block
    mask_b = np.zeros((nb, nb), bool)
    bw = max(1, nb // 16)
    for i in range(nb):
        mask_b[i, max(0, i - bw):i + bw + 1] = True
    mask_b |= rng.rand(nb, nb) < 0.03
    rows, cols = sparse.active_blocks(mask_b)
    arrs = dict(q=rng.randn(n, v, r), k=rng.randn(n, v, r), w=rng.randn(r),
                x=rng.randn(n, v, c))
    return rows, cols, {key: a.astype(np.float32) for key, a in arrs.items()}


def norm_err(got, want):
    """(max abs err, max abs err / max(max |want|, 1))."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1.0)


def sparse_phase(torch, np, sparse, fused, device):
    """The blocked sparse surface: each kernel against its plain version at
    a small pattern and at the large graph; the main path (the scores, a
    fused SDDMM + SpMM aggregation and an SpMM over it, forward and
    backward through the autograd Functions) with exact launch counts and
    its gradients against autograd through the masked dense oracle; times
    and bounds.  Returns (report, {name: kernels-line entry})."""
    report, max_err = {}, {name: 0.0 for name in SPARSE}

    def held(name, got, want, where):
        abs_err, rel = norm_err(got, want)
        max_err[name] = max(max_err[name], abs_err)
        line = dict(kernel=name, at=where, max_abs_err=abs_err,
                    max_norm_err=rel, peak=float(want.abs().max()),
                    ok=rel <= SPARSE_TOL[name])
        print("check " + json.dumps(line))
        check(line["ok"], f"{name} at {where} disagrees with its plain "
                          f"version: {rel} of max(|plain|, 1)")
        return line

    def calls(q, k, w, x, adj, xj, rows, cols, block):
        """(kernel call, plain call) of each op, outside autograd."""
        m = sparse.pattern(rows, cols, block, q.shape[1],
                           adj.shape[2]).mask(device)
        pat = (rows, cols, block)
        return {
            "block_spmm": (lambda: sparse.block_spmm(adj, xj, *pat),
                           lambda: sparse.spmm_dense(adj * m, xj)),
            "block_sddmm": (lambda: sparse.block_sddmm(q, k, w, *pat),
                            lambda: sparse.sddmm_dense(q, k, w, m)),
            "block_sddmm_spmm": (
                lambda: sparse.block_sddmm_spmm(q, k, w, x, *pat),
                lambda: sparse.sddmm_spmm_dense(q, k, w, x, m)),
        }, m

    def held_all(ops, m, where):
        lines = []
        with torch.no_grad():
            for name, (kernel, plain) in ops.items():
                before = sparse.launch_counts()[name]
                got = kernel()
                again = kernel()
                torch.cuda.synchronize()
                check(sparse.launch_counts()[name] == before + 2,
                      f"{name} did not count its launches")
                want = plain()
                if name == "block_sddmm":
                    # inactive blocks are undefined: active blocks only
                    sel = m.bool().expand_as(want)
                    got, again, want = got[sel], again[sel], want[sel]
                check(bool(torch.equal(got, again)),
                      f"{name} at {where}: two calls differ")
                lines.append(held(name, got, want, where))
        return lines

    # a small pattern: V = 256, block 128, one block row with one block
    rng = np.random.RandomState(7)
    small = [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        device) for shape in ((2, 256, 4), (2, 256, 4), (4,), (2, 256, 16),
                              (2, 256, 256), (2, 256, 16))]
    rows_s, cols_s = sparse.active_blocks(np.array([[True, False],
                                                    [True, True]]))
    ops, m = calls(*small, rows_s, cols_s, 128)
    report["small"] = held_all(ops, m, "V=256")

    # the large graph
    rows, cols, arrs = large_graph(np, sparse)
    n, v, r, c, block = (SPARSE_N, SPARSE_V, SPARSE_R, SPARSE_C,
                         SPARSE_BLOCK)
    q, k, w, x = (torch.from_numpy(arrs[key]).to(device) for key in "qkwx")
    adj = torch.randn((n, v, v), device=device,
                      generator=torch.Generator(device).manual_seed(3))
    nblocks = len(rows)
    print(f"sparse: large graph N={n} V={v} R={r} C={c} block {block}: "
          f"{nblocks} active blocks of {(v // block) ** 2} (density "
          f"{nblocks / (v // block) ** 2:.3f}), "
          f"{int(np.bincount(rows).min())}-{int(np.bincount(rows).max())} "
          "a row")
    ops, m = calls(q, k, w, x, adj, x, rows, cols, block)
    report["large"] = held_all(ops, m, f"V={v}")

    # the main path, counts from zero: the scores (no gradient), then
    # h = S @ x fused and y = adj @ h, forward and backward
    sparse.reset_launch_counts()
    fused.reset_launch_counts()
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, w, x, adj)]
    gy = torch.randn((n, v, c), device=device,
                     generator=torch.Generator(device).manual_seed(4))
    t0 = time.perf_counter()
    with torch.no_grad():
        scores = sparse.block_sddmm(q, k, w, rows, cols, block)
    h = sparse.block_sddmm_spmm(*leaves[:4], rows, cols, block)
    y = sparse.block_spmm(leaves[4], h, rows, cols, block)
    grads = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = sparse.launch_counts()
    print(f"sparse: main path (scores, fused SDDMM + SpMM, SpMM, backward) "
          f"in {wall * 1e3:.1f} ms, launches {counts}")
    check(counts == {name: 1 for name in SPARSE},
          f"the sparse path launched {counts}, expected one of each")
    check(not any(fused.launch_counts().values()),
          "the sparse path launched a DSTD-GC kernel")
    check(tuple(y.shape) == (n, v, c) and bool(torch.isfinite(y).all())
          and bool(torch.isfinite(scores[m.bool().expand_as(scores)]).all()),
          "the sparse path gave a non-finite or misshapen output")
    # against autograd through the masked dense oracle
    pleaves = [a.detach().clone().requires_grad_() for a in (q, k, w, x, adj)]
    ph = sparse.sddmm_spmm_dense(*pleaves[:4], m)
    py = sparse.spmm_dense(pleaves[4] * m, ph)
    pgrads = torch.autograd.grad(py, pleaves, gy)
    y_err, y_rel = norm_err(y.detach(), py.detach())
    g_errs = {key: norm_err(a, b)
              for key, a, b in zip(("q", "k", "w", "x", "adj"), grads,
                                   pgrads)}
    print(f"sparse: main path against the masked dense oracle: y {y_rel:.3g}"
          " of max(|plain|, 1); gradients "
          + ", ".join(f"{key} {e[1]:.3g}" for key, e in g_errs.items()))
    check(y_rel <= SPARSE_TOL["block_sddmm_spmm"],
          f"sparse path output: {y_rel} of max(|plain|, 1)")
    worst = max(g_errs, key=lambda key: g_errs[key][1])
    check(g_errs[worst][1] <= TOL, f"sparse path gradient of {worst}: "
                                   f"{g_errs[worst][1]} of max(|plain|, 1)")
    report["path"] = dict(launches=counts, wall_ms=wall * 1e3,
                          y_norm_err=y_rel,
                          grad_norm_err={key: e[1]
                                         for key, e in g_errs.items()})
    del leaves, pleaves, grads, pgrads, h, y, ph, py, scores

    # times at the large graph: the kernel, its plain version, and for the
    # SpMM one library call on the same inputs (a dense bmm of the
    # pre-masked adjacency; a yardstick the port never calls)
    entries = {}
    adj_masked = adj * m
    with torch.no_grad():
        for name, (kernel, plain) in ops.items():
            k_call = time_ms(torch, kernel, 20)
            k_ms, k_by = device_ms(torch, kernel, 20)
            p_ms, p_by = device_ms(torch, plain, 5)
            lib_ms = None
            if name == "block_spmm":
                lib_ms, _ = device_ms(torch, lambda: torch.bmm(adj_masked, x),
                                      10)
            b_ms, t_ops, t_mem = bound_of(*sparse_cost(name, n, nblocks,
                                                       block, r, c, v))
            entries[name] = dict(
                name=name, route="cuda", source=KERNELS[name]["source"],
                replaces=KERNELS[name]["replaces"], launches=counts[name],
                max_abs_err=max_err[name], ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms,
                bound_by="operations" if t_ops >= t_mem else "bytes",
                library_ms=lib_ms, call_ms=k_call,
                timed_by="+".join(sorted({k_by, p_by})))
            print("sparse: " + json.dumps(entries[name]))
    report["kernels"] = entries
    return report, entries


# -- the dense adaptive hop ---------------------------------------------------

#: the dense hop's checks: Graph WaveNet's V at the forecast configuration
#: and a small ragged V, at the F of its shortest and its longest layer (L
#: 1 and 12 at batch 64 and 32 channels); its timings at V 3,834
DENSE_V = (3834, 200)
DENSE_F = (2048, 24576)
#: the products of a hop: the forward and its two gradients
DENSE_PRODUCTS = ("out", "d_x", "d_adp")


def dense_cost(v, f):
    """(least ms, ms of the products, ms of the bytes) of one dense-hop
    product: 2 V^2 F products at the 3xTF32 rate, 4 (V^2 + 2 V F) bytes."""
    return bound_of(0.0, 4.0 * (v * v + 2 * v * f), 2.0 * v * v * f)


def dense_inputs(torch, v, f, device, seed):
    """The model's adaptive support softmax(relu(E1 E2)) of seeded
    standard-normal embeddings, and x and g standard normal."""
    gen = torch.Generator().manual_seed(seed)
    e1, e2 = torch.randn(v, 10, generator=gen), torch.randn(10, v,
                                                             generator=gen)
    adp = torch.softmax(torch.relu(e1 @ e2), 1)
    x, g = (torch.randn(v, f, generator=gen) for _ in range(2))
    return adp.to(device), x.to(device), g.to(device)


def dense_plain(adp, x, g):
    """{product: plain value} of the hop adp^T x and its gradients."""
    return dict(out=adp.t().mm(x), d_x=adp.mm(g), d_adp=x.mm(g.t()))


def dense_phase(torch, np, device):
    """The dense adaptive hop (``kernels/dense.py``, ``csrc/dense_hop.cu``):
    its build (ptxas, ``HGMMA`` in the SASS of both product kernels); the
    forward and both gradients through the
    autograd Function at every (V, F) of DENSE_V x DENSE_F against the
    float64 product, each within twice the plain float32 product's
    distance or 1e-6 of the largest element, with one launch of each
    product a case; then at V 3,834 each product's
    device ms beside its bound and ``torch.mm``'s (the plain version, TF32
    off: cuBLAS on the CUDA cores); last, counts from zero, one training
    step of Graph WaveNet at the forecast configuration (``dense_step``).
    Returns the phase's report and the kernel's entry of the kernels line
    (its launches those of the step, its times the three products' sum at
    F 24,576, the layer of 12 steps at batch 64)."""
    from dstdgcn_tpu_torch.kernels import build, dense
    t_start = time.perf_counter()
    secs = build.build_all(["dense_hop"])
    report = dict(build_seconds=secs["dense_hop"],
                  ptxas=ptxas_usage(build.build_log("dense_hop")),
                  hgmma=sass_mma(build.library("dense_hop")._name,
                                 r"\bHGMMA\b"))
    for row in report["ptxas"]:
        print(f"  ptxas dense_hop: {row[0]}: {row[1]} registers, spill "
              f"{row[2]} bytes stored / {row[3]} loaded")
    for kernel, (count, size) in report["hgmma"].items():
        print(f"  sass dense_hop: {kernel}: {count} HGMMA of {size} "
              "instructions")
        check(count > 0, f"{kernel}: {count} HGMMA instructions")
    op = dense.dense_hop
    checks = []
    for v in DENSE_V:
        for f in DENSE_F:
            adp, x, g = dense_inputs(torch, v, f, device, seed=v + f)
            before = dense.launch_counts()
            a = adp.clone().requires_grad_(True)
            xr = x.clone().requires_grad_(True)
            out = op(a, xr)
            d_adp, d_x = torch.autograd.grad(out, (a, xr), g)
            torch.cuda.synchronize()
            after = dense.launch_counts()
            got = dict(out=out.detach(), d_x=d_x, d_adp=d_adp)
            want = dense_plain(adp.double(), x.double(), g.double())
            plain = dense_plain(adp, x, g)
            line = dict(v=v, f=f, launches=after["dense_hop"]
                        - before["dense_hop"])
            for name in DENSE_PRODUCTS:
                err = float((got[name].double() - want[name]).abs().max())
                floor = float((plain[name].double() - want[name]).abs()
                              .max())
                peak = float(want[name].abs().max())
                line[name] = dict(err=err, plain_err=floor, peak=peak,
                                  ok=err <= max(2 * floor, 1e-6 * peak))
            print("dense: " + json.dumps(line))
            checks.append(line)
            check(line["launches"] == 3,
                  f"dense hop launches at V {v}, F {f}: {line}")
            for name in DENSE_PRODUCTS:
                check(line[name]["ok"], f"dense hop {name} at V {v}, F {f}: "
                      f"{line[name]}")
            del adp, x, g, a, xr, out, d_adp, d_x, got, want, plain
    report["checks"] = checks
    timings = []
    v = DENSE_V[0]
    with torch.no_grad():
        for f in DENSE_F:
            adp, x, g = dense_inputs(torch, v, f, device, seed=f)
            ops = dense.Operands(adp)
            ops.get(True), ops.get(False)
            calls = dict(out=lambda: op.forward(ops, x),
                         d_x=lambda: op.d_x(ops, g),
                         d_adp=lambda: op.d_adp(x, g))
            plains = dict(out=lambda: torch.mm(adp.t(), x),
                          d_x=lambda: torch.mm(adp, g),
                          d_adp=lambda: torch.mm(x, g.t()))
            for name in DENSE_PRODUCTS:
                prof = device_profile(torch, calls[name], 10)
                k_ms = sum(prof.values())
                p_ms, p_by = device_ms(torch, plains[name], 5)
                b_ms, t_ops, t_mem = dense_cost(v, f)
                line = dict(product=name, v=v, f=f, ms=k_ms,
                            plain_ms=p_ms, library_ms=p_ms, bound_ms=b_ms,
                            bound_by="operations" if t_ops >= t_mem
                            else "bytes",
                            tflops=2.0 * v * v * f / k_ms / 1e9,
                            roofline=100.0 * b_ms / k_ms,
                            timed_by="profiler" if prof else "none")
                print("dense: " + json.dumps(line))
                timings.append(line)
            copies = device_profile(
                torch, lambda: dense.Operands(adp).get(True), 10)
            timings.append(dict(product="adp_t_padded_copy", v=v,
                                ms=sum(copies.values())))
            print("dense: " + json.dumps(timings[-1]))
            del adp, x, g, ops
    report["timings"] = timings
    report["step"] = dense_step(torch, np, device)
    longest = [t for t in timings
               if t.get("f") == DENSE_F[-1] and "ms" in t and "plain_ms" in t]
    entry = dict(
        name="dense_hop", route="cuda", source=KERNELS["dense_hop"]["source"],
        replaces=KERNELS["dense_hop"]["replaces"],
        launches=report["step"]["launches"],
        max_abs_err=max(c[name]["err"] for c in checks
                        for name in DENSE_PRODUCTS),
        ms=sum(t["ms"] for t in longest),
        plain_ms=sum(t["plain_ms"] for t in longest),
        bound_ms=sum(t["bound_ms"] for t in longest),
        bound_by="operations", library_ms=sum(t["library_ms"]
                                              for t in longest),
        call_ms=None, timed_by="profiler")
    print("dense: " + json.dumps(entry))
    report["seconds"] = time.perf_counter() - t_start
    print(f"dense: the phase took {report['seconds']:.1f} s")
    return report, entry


def dense_step(torch, np, device):
    """One training step of Graph WaveNet at the forecast configuration's
    graph (3,834 sensors) and published widths, batch 2, dropout 0, TF32
    off, counts from zero: the wrapper's launches (16 forward, 14 ``d_x``, 14
    ``d_adp``: 44) and the loss and each gradient against the same step on
    the plain products, by ``tests/test_torch_dense.py``'s rule (loss
    within 1e-5 of max(|plain|, 1), each gradient within 1e-4 of the
    plain gradient's norm; a plain gradient under 1e-3 of the median
    leaf's is rounding noise and the kernel's is held under that floor)."""
    from dstdgcn_tpu_torch.graphs import road
    from dstdgcn_tpu_torch.kernels import dense
    from dstdgcn_tpu_torch.models import GWNet
    v = DENSE_V[0]
    model = GWNet(joints_to_consider=v, dropout=0.0,
                  adjacency=road.road_graph(v, 21)).to(device)
    plain_model = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 12, v, 3, generator=gen).to(device)
    y = torch.randn(2, 12, v, generator=gen).to(device)

    def step(m):
        m.train()
        loss = (m(x) - y).abs().mean()
        loss.backward()
        torch.cuda.synchronize()
        grads = {k: p.grad for k, p in m.named_parameters()
                 if p.grad is not None}
        return float(loss.detach()), grads

    kernel_hop = dense.dense_hop
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dense.reset_launch_counts()
        loss, grads = step(model)
        launches = dense.launch_counts()["dense_hop"]
        dense.dense_hop = lambda a, b, ops: dense.hop_dense(a, b)
        plain_loss, plain_grads = step(plain_model)
    finally:
        dense.dense_hop = kernel_hop
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    check(grads.keys() == plain_grads.keys(),
          "dense step: the two paths' gradients differ in their leaves")
    floor = 1e-3 * float(np.median([float(w.norm())
                                    for w in plain_grads.values()]))
    worst = 0.0
    for k, want in plain_grads.items():
        scale = float(want.norm())
        if scale < floor:
            check(float(grads[k].norm()) < floor,
                  f"dense step: gradient {k} above the noise floor")
            continue
        worst = max(worst, float((grads[k] - want).norm()) / scale)
    out = dict(launches=launches, loss=loss, plain_loss=plain_loss,
               grad_rel_err=worst)
    print("dense: step " + json.dumps(out))
    check(launches == 44, f"dense step: {launches} launches, 44 expected")
    check(abs(loss - plain_loss) <= 1e-5 * max(abs(plain_loss), 1.0),
          f"dense step: loss {loss} against {plain_loss}")
    check(worst <= 1e-4, f"dense step: gradient error {worst}")
    return out


def time_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(torch, fn, iters, tries=3, host=None):
    """{name: device ms per call} of what ``fn`` runs on the card, from
    ``torch.profiler`` (CUPTI): the kernels' own time, no host gaps.  The
    profiler now and then records nothing; it is then asked again, and an
    empty dict returned after ``tries`` attempts.  A ``host`` dict receives
    {name: host ms per call} (self CPU time) from the same window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # device-side entries only (kernels, copies): an operator's entry
        # repeats the device time of the kernels it launched, and so does a
        # user annotation's device range (Optimizer.step, for one).  Per
        # call: the mean time of one record times the records per call, so
        # a record the profiler dropped does not shrink the result.
        out = {e.key: e.self_device_time_total / e.count / 1e3
               * max(1, round(e.count / iters))
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")
               and e.self_device_time_total > 0}
        if out:
            if host is not None:
                host.update({e.key: e.self_cpu_time_total / iters / 1e3
                             for e in prof.key_averages()
                             if e.self_cpu_time_total > 0})
            return out
    return {}


def device_ms(torch, fn, iters, split=None):
    """(ms per call, how it was timed): the profiler's device time, or the
    CUDA-event time per call (host gaps included) if the profiler saw
    nothing.  A ``split`` dict receives the device ms per call of each of a
    backward call's four launches (``bwd_split``)."""
    prof = device_profile(torch, fn, iters)
    total = sum(prof.values())
    if total > 0:
        if split is not None:
            split.update(bwd_split(prof))
        return total, "profiler"
    return time_ms(torch, fn, iters), "events"


def bwd_split(prof):
    """{launch: device ms per call} of the four launches of a DSTD-GC
    backward call (``dstd_bwd::qk_kernel``, ``out_kernel``, ``src_kernel``,
    ``reduce_kernel``) in a ``device_profile`` dict."""
    split = dict.fromkeys(BWD_PASSES, 0.0)
    for key, ms in prof.items():
        for name in BWD_PASSES:
            if f"dstd_bwd::{name}_kernel<" in key:
                split[name] += ms
    return split


def errors(torch, got, want):
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-6)
    ok = bool((diff <= TOL + TOL * want.abs()).all())
    return float(diff.max()), float(rel.max()), ok


def grad_errors(got, want):
    """(max abs err, worst err / max(max |plain|, 1), ok) over the tensors
    of one backward call."""
    abs_err = norm_err = 0.0
    for a, b in zip(got, want):
        d = float((a - b).abs().max())
        abs_err = max(abs_err, d)
        norm_err = max(norm_err, d / max(float(b.abs().max()), 1.0))
    return abs_err, norm_err, norm_err <= TOL


def op_inputs(torch, np, mode, ci, co, device, seed, n=N, t=T, v=V):
    """Seeded inputs at the model's initialization scales, with the gates
    and biases that initialize at zero made non-zero."""
    rng = np.random.RandomState(seed)
    k = 2 if mode == "spatial" else 1
    ref, pair = (t, v) if mode == "spatial" else (v, t)

    def nrm(std, *shape):
        return (rng.randn(*shape) * std).astype(np.float32)

    arrs = [nrm(1.0, n, t, v, ci), nrm(0.3, k, pair, pair),
            np.asarray([0.7], np.float32), nrm((2 / co) ** 0.5, k, ci, co),
            nrm(0.1, k, co), nrm(1.0, k, ci, 2), nrm(0.1, k, 2),
            nrm(1.0, k, ci, 2), nrm(0.1, k, 2),
            nrm((2 / ref) ** 0.5, k, 2, ref, ref), nrm(0.1, k, ref)]
    return [torch.from_numpy(a).to(device) for a in arrs]


def forward_shapes(model_cfg):
    """(mode, Ci, Co) of the 7 spatial and 7 temporal launches of one
    forward: in-layer, encoders, out-layer."""
    f, layers = model_cfg["num_feature"], model_cfg["num_layers"]
    cin, cout = model_cfg["input_channels"], model_cfg["input_channels"] // 2
    spatial = [(cin, f)] + [(f, f)] * layers + [(f, cout)]
    temporal = [(f, f)] * (layers + 1) + [(cout, cout)]
    return ([("spatial",) + s for s in spatial]
            + [("temporal",) + s for s in temporal])


def train_step_check(torch, fused, engine, rcfg, batch, label,
                     fwd_per_step=14, kernel_step=None, routed=True,
                     bwd_per_step=14):
    """One train step of ``engine`` (the kernel path) on ``batch`` (inputs,
    inverse inputs, targets) against the plain path with the same weights,
    dropout 0, BatchNorm calibrated on the batch: the loss within
    LOSS_RTOL, each parameter's gradient against the plain path run in
    float64 (within GRAD_TOL of max(|float64|, 1) or twice the plain
    float32 path's own distance), and the launches of one step
    (``fwd_per_step`` of each float32 forward kernel: 14, or 28 under
    remat; ``bwd_per_step`` calls of each backward one, 14, nothing else;
    none with ``routed`` False, a config on the plain path).  ``kernel_step``
    (default ``engine.compute_gradients(*batch)``) computes the kernel
    path's losses and gradients: phases 13 and 14 pass the step of a mesh
    on this rank's share.  Prints under ``label``; returns (report, the
    plain path's engine)."""
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.models import get_model
    device = engine.device
    tmodel = engine.model
    topts = {k: v for k, v in rcfg["model"].items() if k != "name"}
    pmodel = get_model(rcfg["model"]["name"], **dict(topts,
                                                     use_pallas=False))
    peng = PredictionEngine(rcfg["engine"], pmodel, device=device)
    peng.init()
    pmodel.load_state_dict(tmodel.state_dict())
    calibrate_batchnorm(torch, pmodel,
                        peng.transform(peng.to_device(batch[0])))
    tmodel.load_state_dict(pmodel.state_dict())
    for m in (tmodel, pmodel):
        m.do_in.p = 0.0
    before = fused.launch_counts()
    k_loss = float((kernel_step or (lambda: engine.compute_gradients(
        *batch)))()["total"])
    after = fused.launch_counts()
    p_loss = float(peng.compute_gradients(*batch)["total"])
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    # the plain path once more in float64, the yardstick of both
    m64 = copy.deepcopy(pmodel).double()
    e64 = PredictionEngine(rcfg["engine"], m64, device=device)
    b64 = [torch.as_tensor(a, dtype=torch.float64, device=device)
           for a in batch]
    m64.train()
    total64 = (sum(e64._one_pass(b64[0], b64[2], None, None, None).values())
               + sum(e64._one_pass(b64[1], b64[2].flip(1), None, None,
                                   None).values())) / 2
    total64.backward()
    total64 = total64.detach()

    def rel(got, want):
        return float((got.double() - want).abs().max()) / max(
            float(want.abs().max()), 1.0)

    g64 = {n: p.grad for n, p in m64.named_parameters()}
    pgrads = dict(pmodel.named_parameters())
    grad_errs = {pname: (rel(p.grad, pgrads[pname].grad.double()),
                         rel(p.grad, g64[pname]),
                         rel(pgrads[pname].grad, g64[pname]))
                 for pname, p in tmodel.named_parameters()}
    # each gradient's distance to float64 over what it may be
    excess = {k: e[1] / max(GRAD_TOL, 2 * e[2])
              for k, e in grad_errs.items()}
    worst_name = max(excess, key=excess.get)
    worst = grad_errs[worst_name][1]
    step_launches = {k: after[k] - before[k] for k in after}
    print(f"{label}: one step, kernel path vs plain path: loss {k_loss} vs "
          f"{p_loss} (rel {loss_rel:.3g}; float64 {total64.item()}); "
          f"launches {step_launches}")
    top = set(sorted(grad_errs, key=lambda k: -grad_errs[k][0])[:3]
              + sorted(grad_errs, key=lambda k: -grad_errs[k][1])[:3])
    for pname in sorted(top, key=lambda k: -grad_errs[k][1]):
        kp, k64, p64 = grad_errs[pname]
        print(f"{label}: gradient {pname}: kernel vs plain {kp:.3g}, kernel "
              f"vs float64 {k64:.3g}, plain vs float64 {p64:.3g} of "
              "max(|reference|, 1)")
    check(loss_rel <= LOSS_RTOL, f"{label} loss: kernel path {k_loss}, "
                                 f"plain path {p_loss}")
    check(excess[worst_name] <= 1.0,
          f"{label} gradient of {worst_name}: {worst} of max(|float64|, "
          f"1), the plain float32 path {grad_errs[worst_name][2]}")
    per = int(routed)
    check(step_launches == {
        **{k: fwd_per_step * per for k in FORWARD},
        **{k: bwd_per_step * fused.BWD_LAUNCHES * per for k in BACKWARD},
        **{k: 0 for k in CHAINS + BF16_FORWARD + BF16_BACKWARD
           + BF16_CHAINS}},
        f"{label}: one train step launched {step_launches}")
    return dict(loss=k_loss, plain_loss=p_loss, loss_rel=loss_rel,
                worst_grad=worst, worst_excess=excess[worst_name],
                worst_param=worst_name, grad_errs=grad_errs), peng


def calibrate_batchnorm(torch, model, inputs):
    """Set every JointBatchNorm's statistics to those of ``inputs`` (one
    train-mode forward of the plain path, momentum 1, no dropout) so the
    activations of a random-weight model stay O(1) as in a trained one."""
    from dstdgcn_tpu_torch.models import JointBatchNorm
    bns = [m for m in model.modules() if isinstance(m, JointBatchNorm)]
    saved = [m.momentum for m in bns]
    p = model.do_in.p
    for m in bns:
        m.momentum = 1.0
    model.do_in.p = 0.0
    with torch.no_grad():
        model.train()(inputs)
    for m, mom in zip(bns, saved):
        m.momentum = mom
    model.do_in.p = p
    model.eval()


def write_h36m_tree(root, seed=0, actions=None, subjects=(1, 5, 6, 7, 8, 9),
                    frames=160, test_frames=300):
    """A seeded tree in Human3.6M's expmap format:
    ``root/S<subject>/<action>_<1|2>.txt``, 99 comma-separated channels a
    frame (0.3 x normal values, six decimals), ``test_frames`` raw frames
    for subject 5 (the test split) and ``frames`` for the others; every
    action by default.  Returns ``root``, the train and test splits'
    ``data_path``."""
    import numpy as np
    from dstdgcn_tpu_torch.data.datasets import H36M_ACTIONS
    rng = np.random.RandomState(seed)
    for subj in subjects:
        d = os.path.join(root, f"S{subj}")
        os.makedirs(d, exist_ok=True)
        for act in actions or H36M_ACTIONS:
            for sub in (1, 2):
                n = test_frames if subj == 5 else frames
                arr = 0.3 * rng.randn(n, 99).astype(np.float32)
                np.savetxt(os.path.join(d, f"{act}_{sub}.txt"), arr,
                           delimiter=",", fmt="%.6f")
    return root


def write_cmu_tree(root, seed=0, actions=None, files=(2, 1),
                   frames=(200, 200)):
    """A seeded tree in CMU Mocap's expmap format:
    ``root/{train,test}/<action>/<action>_<i>.txt``, 117 comma-separated
    channels a frame (0.3 x normal values, six decimals), ``files`` files
    of ``frames`` raw frames an action in each split; every action by
    default.  Returns the train and test ``data_path``."""
    import numpy as np
    from dstdgcn_tpu_torch.data.datasets import CMU_ACTIONS
    rng = np.random.RandomState(seed)
    paths = []
    for split, count, n in zip(("train", "test"), files, frames):
        paths.append(os.path.join(root, split))
        for act in actions or CMU_ACTIONS:
            d = os.path.join(root, split, act)
            os.makedirs(d, exist_ok=True)
            for i in range(count):
                arr = 0.3 * rng.randn(n, 117).astype(np.float32)
                np.savetxt(os.path.join(d, f"{act}_{i + 1}.txt"), arr,
                           delimiter=",", fmt="%.6f")
    return tuple(paths)


def write_pw3d_tree(root, seed=0, files=(4, 2), people=2,
                    frames=(150, 100)):
    """A seeded tree in 3DPW's format: ``root/{train,test}/seq_<i>.pkl``,
    each a pickled ``{"jointPositions": [...]}`` of ``people`` float64
    arrays of ``frames`` x 72 (24 joints, metres: a pose of 0.3 x normal
    values walking by steps of 0.01 x normal values).  Returns the train
    and test ``data_path`` (with the trailing slash of the shipped
    configs)."""
    import pickle
    import numpy as np
    rng = np.random.RandomState(seed)
    paths = []
    for split, count, n in zip(("train", "test"), files, frames):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        paths.append(d + "/")
        for i in range(count):
            blob = {"jointPositions": [
                0.3 * rng.randn(1, 72) + np.cumsum(0.01 * rng.randn(n, 72),
                                                   axis=0)
                for _ in range(people)]}
            with open(os.path.join(d, f"seq_{i + 1}.pkl"), "wb") as f:
                pickle.dump(blob, f)
    return tuple(paths)


def chain_held(err, gap, frac, kernel64, *plain64):
    """Whether a bf16 chain check holds (F7; ``chip_smoke.py`` phase 3 and
    the card tests' ``_bf16_chain_case``): the kernel's distance to its
    plain version ``err`` within ``frac`` of their bf16-versus-float32
    ``gap``, or, failing that, its distance to the float64 run of the bf16
    contract ``kernel64`` within max(frac gap, F64_NOISE times the plain
    contract's own distance to that run, the largest of ``plain64``); all
    over one norm."""
    return err <= frac * gap or kernel64 <= max(frac * gap,
                                                F64_NOISE * max(plain64))


def rounding_deltas(torch, shape, ops, seed, device="cpu"):
    """[[d of each of ``ops`` ops] for each of ROUNDING_RUNS runs]: float32
    tensors of ``shape`` uniform in +-ROUNDING_UNIT from a generator on
    ``device`` seeded with ``seed``, the same for the same arguments."""
    gen = torch.Generator(device).manual_seed(seed)
    return [[(torch.rand(shape, generator=gen, device=device) * 2 - 1)
             * ROUNDING_UNIT for _ in range(ops)]
            for _ in range(ROUNDING_RUNS)]


def rounded_chain(fused, x, blocks, agg, deltas):
    """The plain float32 chain (``kernels/fused.py::_chain_oracle``) with
    each op's output y replaced by y + y d (``deltas``, one per op in
    order): a run of the chain that rounds every op's output once more,
    as a right float32 forward kernel may."""
    it = iter(deltas)
    for sp, tm in blocks:
        for mode, w in (("spatial", sp), ("temporal", tm)):
            x = fused._plain_op(mode, x, w, agg, None)
            x = x + x * next(it)
    return x


def encoder_case(torch, cfg, batch, device="cuda"):
    """The serving model (weights from seed 777, every parameter moved by
    seeded noise, BatchNorm calibrated on ``batch``) with the encoder's
    input for ``batch`` (the in-layer, BatchNorm and PReLU of the model)
    and its encoder layers (``models/infer.py::encoder_chain_params``):
    the activations the encoder kernel sees in a trained model.  The model
    runs on the plain ops (``use_pallas`` False), so that no kernel under
    test computes the chain checks' input: a change of a forward kernel's
    low bits would otherwise redraw the checks of the chain kernels."""
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.models import get_model, infer
    from dstdgcn_tpu_torch.utils.config import resolve
    rcfg = resolve(cfg)
    opts = {k: v for k, v in rcfg["model"].items() if k != "name"}
    opts["use_pallas"] = False
    engine = PredictionEngine(cfg["engine"],
                              get_model(rcfg["model"]["name"], **opts),
                              device=device)
    model = engine.init()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.device))
    x = engine.transform(engine.to_device(batch))
    calibrate_batchnorm(torch, model, x)
    with torch.no_grad():
        h = torch.cat([x, x - x[:, -1:]], dim=-1)
        # the plain ops may return another layout; the chain kernels
        # read a contiguous x
        h = model.prelu(model.bn_in(model.conv_st_in(h))).contiguous()
        layers = infer.encoder_chain_params(model)
    return h, layers


def chain_blocks(torch, plain, layers, h, agg):
    """The encoder layers' (spatial, temporal) ops as chain blocks, each
    op's wf and bf divided by the peak of its output on the plain chain
    (the output is linear in them), so every op's output peaks at 1:
    without BatchNorm and residuals the raw ops grow the activation about
    10x per block and leave float32 nothing to compare."""
    blocks, x = [], h
    with torch.no_grad():
        for sp, tm, *_ in layers:
            ops = []
            for fn, args in ((plain.dstd_spatial, sp),
                             (plain.dstd_temporal, tm)):
                y = fn(x, *args, agg=agg)
                peak = float(y.abs().max())
                args = args[:2] + (args[2] / peak, args[3] / peak) + args[4:]
                x = y / peak
                ops.append(tuple(a.detach().clone().contiguous()
                                 for a in args))
            blocks.append(tuple(ops))
    return blocks


def chain_leaves(torch, x, blocks, dtype=None):
    """Fresh leaves requiring gradients: x and every weight, and the blocks
    rebuilt over them."""
    leaves = [a.detach().to(dtype or a.dtype).clone().requires_grad_()
              for a in [x] + [w for blk in blocks for op in blk for w in op]]
    it = iter(leaves[1:])
    rebuilt = [tuple(tuple(next(it) for _ in op) for op in blk)
               for blk in blocks]
    return leaves, rebuilt


def bf16_kernel_checks(torch, np, fused, plain, plain_bwd, device, n, shapes,
                       timings, max_err, t=T, v=V, f64_hold=False):
    """Each bf16 kernel (forward, and the 11 gradients of the backward)
    against the plain version of its contract at batch ``n``, (T, V) =
    (``t``, ``v``) and every (Ci, Co) of ``shapes``, both aggregations,
    with the tile the wrapper chose: the error, the tolerance and
    the bf16-versus-float32 gap of the plain versions, the error within
    BF16_TOL and BF16_TOL below half the gap; for the forward and per
    gradient of the backward, the kernel's and the plain version's
    distance to the plain version in float64 (``kernel_plain_vs_f64``).
    The forward compares the kernel's float32 output before the wrapper's
    cast (``FusedOp.launch``).  Times (the model's aggregation, right): the
    kernel (the forward on a bf16 x, as the model gives it), its plain
    version (the plain forward; the hand-derived plain backward), and the
    float32 kernel at the same shape.  With ``f64_hold`` (phase 15) an
    output (the forward, or one gradient) past BF16_TOL is still held
    where the kernel lies near the plain version's float64 run, within
    max(BF16_TOL, F64_NOISE times the plain version's own distance to it):
    F4's rule, which the card tests' tile cases hold by (``_held``)."""
    bf16, lines = torch.bfloat16, []
    for mode in ("spatial", "temporal"):
        op, bwd = getattr(fused, f"dstd_{mode}"), getattr(fused,
                                                          f"dstd_{mode}_bwd")
        kplain, fplain = (getattr(plain, f"kernel_{mode}"),
                          getattr(plain, f"dstd_{mode}"))
        pbwd = getattr(plain_bwd, f"dstd_{mode}_bwd")
        for ci, co in sorted({(ci, co) for m, ci, co in shapes
                              if m == mode}):
            args = op_inputs(torch, np, mode, ci, co, device, seed=ci + co,
                             n=n, t=t, v=v)
            g = torch.randn((n, t, v, co), device=device, generator=torch
                            .Generator(device).manual_seed(ci * co))
            for agg in ("right", "left"):
                before = fused.launch_counts()
                with torch.no_grad():
                    got = op.launch(*args, agg=agg, dtype=bf16)
                    grads = bwd(args[0], g, *args[1:], agg=agg, dtype=bf16)
                torch.cuda.synchronize()
                after = fused.launch_counts()
                check(after[f"dstd_{mode}_bf16"] == before[
                    f"dstd_{mode}_bf16"] + 1 and after[
                    f"dstd_{mode}_bwd_bf16"] == before[
                    f"dstd_{mode}_bwd_bf16"] + fused.BWD_LAUNCHES,
                    f"the bf16 {mode} kernels did not count their launches")
                with torch.no_grad():
                    want = kplain(*args, agg, bf16)
                    want64 = kplain(*[a.double() for a in args], agg, bf16)
                    want32 = fplain(*args, None, agg)
                    gwant = pbwd(args[0], g, *args[1:], agg=agg, dtype=bf16)
                    gwant32 = pbwd(args[0], g, *args[1:], agg=agg)
                    gwant64 = pbwd(*[a.double() for a in (args[0], g)],
                                   *[a.double() for a in args[1:]], agg=agg,
                                   dtype=bf16)
                peak = float(want32.abs().max())
                # the forward's and its plain version's distance to the
                # plain version in float64, over its peak
                peak64 = float(want64.abs().max())
                fwd64 = [float((a.double() - want64).abs().max()) / peak64
                         for a in (got, want)]
                results = {}
                fwd_err = float((got - want).abs().max())
                results["forward"] = (
                    fwd_err, fwd_err / peak,
                    float((want - want32).abs().max()) / peak)
                norms = [max(float(b.abs().max()), 1.0) for b in gwant]
                g_abs = max(float((a - b).abs().max())
                            for a, b in zip(grads, gwant))
                g_errs = [float((a - b).abs().max()) / nrm
                          for a, b, nrm in zip(grads, gwant, norms)]
                results["backward"] = (
                    g_abs, max(g_errs),
                    max(float((b - c).abs().max()) / nrm
                        for b, c, nrm in zip(gwant, gwant32, norms)))
                # per gradient, the kernel's and the plain version's
                # distance to the plain version in float64 (the same
                # rounding points), over max(max |float64|, 1)
                f64 = {}
                for key, a, b, c in zip(GRADIENTS, grads, gwant, gwant64):
                    nrm = max(float(c.abs().max()), 1.0)
                    f64[key] = [float((a.double() - c).abs().max()) / nrm,
                                float((b.double() - c).abs().max()) / nrm]
                for part, (abs_err, err, gap) in results.items():
                    name = (f"dstd_{mode}_bf16" if part == "forward"
                            else f"dstd_{mode}_bwd_bf16")
                    tol = BF16_TOL[part]
                    kernel = op if part == "forward" else bwd
                    if part == "forward":
                        outs = {"forward": (err, *fwd64)}
                    else:
                        outs = {key: (e, *f64[key])
                                for key, e in zip(GRADIENTS, g_errs)}
                    held = {key: e <= tol or (f64_hold and k64 <= max(
                        tol, F64_NOISE * p64))
                        for key, (e, k64, p64) in outs.items()}
                    line = dict(kernel=name, agg=agg, ci=ci, co=co, n=n,
                                t=t, v=v, tile=plan_tiles(kernel, "bf16", n,
                                                          t, v, ci, co),
                                max_abs_err=abs_err, norm_err=err, tol=tol,
                                bf16_vs_f32_gap=gap,
                                ok=all(held.values()) and tol < gap / 2)
                    if err > tol:
                        line["held_near_f64"] = [k for k, h in held.items()
                                                 if h and outs[k][0] > tol]
                    line.update(kernel_plain_vs_f64=f64 if part == "backward"
                                else fwd64)
                    max_err[name] = max(max_err[name], abs_err)
                    if agg == "right":
                        if part == "forward":
                            # timed on the bf16 x of the model's path,
                            # which the bf16 kernel reads as it is
                            def call(args=args, xb=args[0].to(bf16)):
                                with torch.no_grad():
                                    return op.launch(xb, *args[1:],
                                                     dtype=bf16)

                            def plain_call(args=args):
                                with torch.no_grad():
                                    return kplain(*args, "right", bf16)
                        else:
                            def call(args=args, g=g):
                                return bwd(args[0], g, *args[1:], dtype=bf16)

                            def plain_call(args=args, g=g):
                                return pbwd(args[0], g, *args[1:], dtype=bf16)
                        if part == "forward":
                            def f32_call(args=args):
                                with torch.no_grad():
                                    return op.launch(*args)
                        else:
                            def f32_call(args=args, g=g):
                                return bwd(args[0], g, *args[1:])
                        split = {} if part == "backward" else None
                        f32_split = {} if part == "backward" else None
                        k_call = time_ms(torch, call, 10)
                        k_ms, k_by = device_ms(torch, call, 10, split)
                        p_ms, p_by = device_ms(torch, plain_call, 3)
                        f32_ms, _ = device_ms(torch, f32_call, 10, f32_split)
                        b_ms, t_ops, t_mem = bound_ms(
                            mode, n, ci, co, part == "backward", bf16, t, v)
                        timings[(name, ci, co, agg)] = (k_ms, p_ms, k_call,
                                                        k_by, split)
                        if split is not None:
                            line.update(launch_ms=split,
                                        f32_launch_ms=f32_split)
                        line.update(ms=k_ms, plain_ms=p_ms, call_ms=k_call,
                                    f32_kernel_ms=f32_ms,
                                    timed_by=[k_by, p_by], bound_ms=b_ms,
                                    bound_by="operations" if t_ops >= t_mem
                                    else "bytes")
                    lines.append(line)
                    print("check " + json.dumps(line))
                    check(line["ok"], f"{name} agg={agg} {ci}->{co}: "
                                      f"{err} against its plain version, "
                                      f"tolerance {tol}, bf16-versus-float32 "
                                      f"gap {gap}")
    return lines


def plan_tiles(kernel, variant, n, t, v, ci, co):
    """The tiles a one-op wrapper planned for ``variant`` at a call shape
    (``_Kernel._plans``: one a tile request)."""
    return sorted({plan[1] for key, plan in kernel._plans.items()
                   if key[:6] == (variant, n, t, v, ci, co)})


def chain_tiles(kernel, variant, t, v, c):
    """The tiles a chain wrapper chose for ``variant`` at (T, V, C)
    (``ChainOp._tiles``)."""
    return sorted({tile for key, tile in kernel._tiles.items()
                   if key[:4] == (variant, t, v, c)})


def widened(given):
    """Chain layers (nested tuples of tensors) in float64."""
    if isinstance(given, (tuple, list)):
        return type(given)(widened(a) for a in given)
    return given.double()


def bf16_chain_checks(torch, fused, plain, cfg, inputs, n_big, agg_main,
                      timings, max_err,
                      bases=("dstd_encoder_chain", "dstd_chain")):
    """The bf16 chain kernels of ``bases`` against their plain versions (the
    oracles with the dtype) on the calibrated encoder of ``cfg``'s model
    (the serving model in phase 3) at batch ``n_big`` and at batch 1, both
    aggregations, each op of the chain scaled
    to an output peak of 1 (``chain_blocks``); the input is computed on the
    plain ops (``encoder_case``).  Layer by layer: one launch of each layer
    on the kernel's own activation against the plain layer on the same
    input, the error over the peak |plain float32 layer output| within
    BF16_LAYER_FRAC of the layer's bf16-versus-float32 gap; the five
    one-layer launches equal the one five-layer launch bit for bit, and two
    five-layer calls are bit-equal.  End to end, a rounding flip of one
    layer moves the next layers' inputs and so their roundings, and the
    flips spread: the five-layer error is held within BF16_CHAIN_FRAC of
    its own gap, both printed.  Each layer and the five layers are held by
    ``chain_held``: past its fraction, a check still holds where the kernel
    lies as near the float64 run of the bf16 contract (the oracle on
    float64 inputs with the dtype) as F64_NOISE says, beside the plain
    contract's own distance to it (``kernel_plain_vs_f64``, over the same
    peak).  Times at
    ``agg_main`` and batch ``n_big``: the kernel, its plain version and the
    float32 kernel, and the bf16 kernel at batch N (the activation buffers
    of a batch-``n_big`` call no longer fit in the 50 MB L2)."""
    bf16, lines = torch.bfloat16, []
    h_all, layers = encoder_case(torch, cfg, inputs[:n_big])
    _, t, v, _ = h_all.shape
    for agg in ("right", "left"):
        blocks = (chain_blocks(torch, plain, layers, h_all, agg)
                  if "dstd_chain" in bases else None)
        for base, ref, given in (("dstd_encoder_chain",
                                  fused._encoder_oracle, layers),
                                 ("dstd_chain", fused._chain_oracle, blocks)):
            if base not in bases:
                continue
            name, kernel = f"{base}_bf16", getattr(fused, base)
            arg = fused.pack_chain(given)
            one = [fused.pack_chain(given[i:i + 1])
                   for i in range(len(given))]
            for n in (n_big, 1):
                h = h_all[:n]

                def call(h=h, kernel=kernel, arg=arg, agg=agg, dtype=bf16):
                    with torch.no_grad():
                        return kernel(h, arg, agg, dtype)

                def plain_call(h=h, ref=ref, given=given, agg=agg,
                               dtype=bf16):
                    with torch.no_grad():
                        return ref(h, given, agg, dtype)

                def held(got, h, given, frac):
                    """(abs error, error, gap, kernel and plain distance
                    to the float64 run) over the peak |plain float32
                    output|, and chain_held's verdict."""
                    want = plain_call(h=h, given=given)
                    want32 = plain_call(h=h, given=given, dtype=None)
                    want64 = plain_call(h=h.double(), given=widened(given))
                    peak = float(want32.abs().max())
                    abs_err = float((got - want).abs().max())
                    d = [abs_err / peak,
                         float((want - want32).abs().max()) / peak,
                         float((got.double() - want64).abs().max()) / peak,
                         float((want.double() - want64).abs().max()) / peak]
                    return (abs_err, *d,
                            chain_held(d[0], d[1], frac, d[2], d[3]))

                before = kernel.launches_bf16
                got, again = call(), call()
                x, per_layer = h, []
                for i, packed in enumerate(one):
                    y = call(h=x, arg=packed)
                    per_layer.append(held(y, x, given[i:i + 1],
                                          BF16_LAYER_FRAC))
                    x = y
                torch.cuda.synchronize()
                check(kernel.launches_bf16 == before + 2 + len(one),
                      f"{name} did not count its launches")
                abs_err, err, gap, k64, p64, chain_ok = held(
                    got, h, given, BF16_CHAIN_FRAC)
                repeat = bool(torch.equal(got, again))
                layered = bool(torch.equal(got, x))
                worst = max(range(len(per_layer)),
                            key=lambda i: per_layer[i][1] / per_layer[i][2])
                l_err, l_gap = per_layer[worst][1:3]
                line = dict(kernel=name, agg=agg, n=n, t=t, v=v,
                            c=h.shape[-1], layers=len(given),
                            tile=chain_tiles(kernel, "bf16", t, v,
                                             h.shape[-1]),
                            layer_norm_err=[e[1] for e in per_layer],
                            layer_gap=[e[2] for e in per_layer],
                            layer_plain_vs_f64=[e[3:5] for e in per_layer],
                            layer_held=[e[5] for e in per_layer],
                            layer_frac=BF16_LAYER_FRAC,
                            worst_layer_over_gap=l_err / l_gap,
                            max_abs_err=abs_err, norm_err=err,
                            bf16_vs_f32_gap=gap, over_gap=err / gap,
                            kernel_plain_vs_f64=[k64, p64],
                            frac=BF16_CHAIN_FRAC, repeatable=repeat,
                            layers_equal_one_launch=layered,
                            ok=(all(e[5] for e in per_layer) and chain_ok
                                and repeat and layered))
                max_err[name] = max(max_err[name], abs_err,
                                    *(e[0] for e in per_layer))
                if agg == agg_main and n == n_big:
                    k_call = time_ms(torch, call, 10)
                    k_ms, k_by = device_ms(torch, call, 10)
                    p_ms, p_by = device_ms(torch, plain_call, 3)
                    f32_ms, _ = device_ms(torch, lambda: call(dtype=None),
                                          10)
                    small_ms, _ = device_ms(
                        torch, lambda: call(h=h_all[:N]), 10)
                    b_ms, t_ops, t_mem = bound_of(*chain_cost(
                        n, h.shape[-1], len(given), base ==
                        "dstd_encoder_chain", bf16, t, v))
                    timings[(name, agg)] = (k_ms, p_ms, k_call, k_by, None)
                    line.update(ms=k_ms, plain_ms=p_ms, call_ms=k_call,
                                f32_kernel_ms=f32_ms, **{
                                    f"ms_n{N}": small_ms,
                                    f"ms_over_{n // N}x_n{N}":
                                        k_ms / (n // N * small_ms)},
                                timed_by=[k_by, p_by], bound_ms=b_ms,
                                bound_by="operations" if t_ops >= t_mem
                                else "bytes")
                lines.append(line)
                print("check " + json.dumps(line))
                check(line["ok"], f"{name} agg={agg} n={n}: layers held "
                                  f"{line['layer_held']} (worst {worst}: "
                                  f"{l_err} against its plain version, gap "
                                  f"{l_gap}, frac {BF16_LAYER_FRAC}); five "
                                  f"layers {err} (gap {gap}, frac "
                                  f"{BF16_CHAIN_FRAC}, to float64 {k64}, "
                                  f"plain {p64}): held {chain_ok}; "
                                  f"repeatable {repeat}, one-layer launches "
                                  f"equal {layered}")
    return lines


def dstd_kernel_of(key, bf16_reduce):
    """The launch-counter name of a DSTD-GC kernel from its profiler key
    (``spatial_kernel<5, dstd::Bf16>``, ``dstd_bwd::out_kernel<false, 5,
    dstd::Exact>``, ...), else None.  The backward's reduction kernel has
    no rounding policy; ``bf16_reduce`` says which variant it belongs to."""
    bwd = "dstd_bwd::" in key
    if bwd:
        mode = "temporal" if "<true" in key else "spatial"
        bf16 = "Bf16" in key or ("reduce_kernel" in key and bf16_reduce)
        return f"dstd_{mode}_bwd" + ("_bf16" if bf16 else "")
    for mode in ("spatial", "temporal"):
        if f"{mode}_kernel<" in key:
            return f"dstd_{mode}" + ("_bf16" if "Bf16" in key else "")
    return None


def plain_contract(torch, model):
    """Route every DSTD-GC op of ``model`` through the plain version of the
    kernels' contract (``ops/dstd.py::kernel_spatial`` forward, the
    ``ops/dstd_bwd.py`` backward, each at the op's compute dtype) on the
    device its tensors lie on: the plain path of the bf16 train-step check
    on the card (the package's wrappers launch the kernels there)."""
    import types

    from dstdgcn_tpu_torch.models.layers import DSTDGC
    from dstdgcn_tpu_torch.ops import dstd as plain
    from dstdgcn_tpu_torch.ops import dstd_bwd as plain_bwd

    class PlainOp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, mode, agg, dtype, *args):
            ctx.mode, ctx.agg, ctx.dtype = mode, agg, dtype
            ctx.save_for_backward(*args)
            out = getattr(plain, f"kernel_{mode}")(*args, agg, dtype)
            return out if dtype is None else out.to(dtype)

        @staticmethod
        def backward(ctx, g):
            saved = ctx.saved_tensors
            grads = getattr(plain_bwd, f"dstd_{ctx.mode}_bwd")(
                saved[0], g.contiguous(), *saved[1:], agg=ctx.agg,
                dtype=ctx.dtype)
            return (None,) * 3 + tuple(gr.to(a.dtype)
                                       for gr, a in zip(grads, saved))

    def forward(self, x, base_adj, alpha, mask=None):
        dtype = (None if self.compute_dtype is None
                 else getattr(torch, self.compute_dtype))
        return PlainOp.apply(self.mode, self.agg, dtype, x, base_adj, alpha,
                             self.wf, self.bf, self.wm1, self.bm1, self.wm2,
                             self.bm2, self.wrm, self.brm)

    for m in model.modules():
        if isinstance(m, DSTDGC):
            m.forward = types.MethodType(forward, m)
    return model


def bf16_phase(torch, np, fused, device):
    """The bf16 training slice through ``main.run`` on ``cuda``, counts
    from zero: the resolved knobs, exact launch counts of the four bf16
    kernels and none of the float32 ones, finite losses and MPJPE, the csv
    and checkpoints, step wall times, and one step's device time by kernel;
    then one bf16 train step on one batch (dropout 0, BatchNorm calibrated)
    against the plain path of the same contract on the card: the loss, every
    gradient (below half of the step's bf16-versus-float32 gap), and the
    gate gradients against a float64 run of the same rounding
    (``bf16_step_check``).  Returns (report, the slice's launch counts)."""
    from dstdgcn_tpu_torch import configs
    from dstdgcn_tpu_torch.data import get_dataset
    from dstdgcn_tpu_torch.main import run
    from dstdgcn_tpu_torch.utils.config import resolve
    report = {}
    cfg = configs.synthetic_h36m_tpu_train()
    rcfg = resolve(cfg)
    bs, epochs = rcfg["train_batch_size"], rcfg["epoch"]
    steps = epochs * -(-rcfg["dataset"]["train"]["synthetic"][
        "num_sequences"] // bs)
    evals = epochs * -(-rcfg["dataset"]["test"]["synthetic"][
        "num_sequences"] // rcfg["test_batch_size"])
    # each forward runs the in-layer, the encoder layers and the out-layer,
    # one spatial and one temporal op each; a train step two forwards
    per_fwd = rcfg["model"]["dstdgcn"]["num_layers"] + 2
    run_dir = os.path.join(OUT_DIR, "train_bf16")
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    runner, history = run(cfg, "cuda", run_dir=run_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused.launch_counts()
    eng = runner.engine
    model = eng.model
    knobs = model.resolve_knobs(bs)
    print(f"bf16: resolved knobs at batch {bs} (hint "
          f"{model.auto_batch_hint}): {knobs}; the blocks run "
          f"{model.active_dtype}")
    check(knobs["compute_dtype"] == "bfloat16"
          and model.active_dtype == "bfloat16",
          f"the bf16 slice resolved {knobs}, running {model.active_dtype}")
    step_s = eng.train_step_seconds
    rows = np.asarray(history, dtype=np.float64)
    print(f"bf16: main.run on cuda, {len(step_s)} steps of {bs} and {evals} "
          f"eval batches in {wall:.2f} s; per epoch (epoch, lr, train loss, "
          f"test loss, per-frame MPJPE) {rows.tolist()}")
    print(f"bf16: wall ms per step, first {step_s[0] * 1e3:.3f}, then "
          f"median {float(np.median(step_s[1:])) * 1e3:.3f} (min "
          f"{min(step_s[1:]) * 1e3:.3f}, max {max(step_s[1:]) * 1e3:.3f})")
    print(f"bf16: launches {counts} over {steps} steps and {evals} eval "
          "batches")
    check(len(step_s) == steps, f"{len(step_s)} bf16 train steps, expected "
                                f"{steps}")
    check(rows.shape == (epochs, 4 + len(rcfg["setting"]["eval_frame"]))
          and bool(np.all(np.isfinite(rows))),
          "non-finite losses or MPJPE in bf16 training")
    with open(os.path.join(run_dir, "training_loss.csv")) as f:
        csv_rows = [line.strip().split(",") for line in f if line.strip()]
    check(len(csv_rows) == epochs + 2, f"training_loss.csv holds {csv_rows}")
    for ckpt in ("last.ckpt", "best.ckpt"):
        check(os.path.isfile(os.path.join(run_dir, "checkpoints", ckpt)),
              f"{ckpt} was not written")
    want = {name: 0 for name in counts}
    want.update({name: 2 * per_fwd * steps + per_fwd * evals
                 for name in BF16_FORWARD})
    want.update({name: fused.BWD_LAUNCHES * 2 * per_fwd * steps
                 for name in BF16_BACKWARD})
    check(counts == want, f"the bf16 slice launched {counts}, expected "
                          f"{want}")
    report.update(knobs=knobs, history=rows.tolist(), step_seconds=step_s,
                  launches=counts, steps=steps, evals=evals, wall=wall)

    # where the time of one bf16 train step goes on the card
    train = get_dataset("synthetic", **rcfg["dataset"]["train"]).arrays()[:3]
    batches = [[a[i:i + bs] for a in train]
               for i in range(0, len(train[0]) - bs + 1, bs)]

    def step():
        return eng.train_step(*batches[0])

    step_call = time_ms(torch, step, 5)
    host = {}
    prof = device_profile(torch, step, 3, host=host)
    step_dev = sum(prof.values())
    by_kernel = {}
    for key, ms in prof.items():
        name = dstd_kernel_of(key, bf16_reduce=True)
        if name is not None:
            by_kernel[name] = by_kernel.get(name, 0.0) + ms
    check(not prof or set(by_kernel) <= set(BF16_FORWARD + BF16_BACKWARD),
          f"a float32 DSTD-GC kernel ran in the bf16 step: {by_kernel}")
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:8]
    busy = (f"{step_dev:.3f} ms ({100 * step_dev / step_call:.1f}%)"
            if prof else "not measured (the profiler recorded nothing)")
    print(f"profile: batch-{bs} bf16 train step {step_call:.3f} ms per "
          f"call, device busy {busy}; DSTD-GC kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(by_kernel.items()))
          + "; top " + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top))
    print(f"profile: bf16 train step host self time {sum(host.values()):.3f}"
          " ms per call (under the profiler)")
    report["profile"] = dict(call_ms=step_call, device_ms=step_dev,
                             by_kernel=prof, dstd_ms=by_kernel,
                             host_ms=sum(host.values()))

    # one bf16 train step against the plain path of the same contract, at
    # weights the plain path trains (no kernel under test moves them)
    report["step_check"] = bf16_step_check(torch, fused, device, rcfg,
                                           batches, steps, per_fwd)
    return report, counts


def bf16_step_engines(torch, device, rcfg):
    """The engines of the bf16 step check, each at the bf16 slice's seeded
    initial weights: ``kernel`` (the port's model), ``plain`` (the plain
    path of the same contract, ``plain_contract``), ``plain_f32`` (that at
    float32: the gap bf16 makes) and ``float64`` (the plain path in
    float64 with the same rounding points)."""
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.models import get_model
    opts = dict({k: v for k, v in rcfg["model"].items() if k != "name"},
                auto_batch_hint=rcfg["train_batch_size"])
    engines = {}
    for label, extra, dtype in (("kernel", {}, None), ("plain", {}, None),
                                ("plain_f32", dict(compute_dtype=None), None),
                                ("float64", {}, torch.float64)):
        m = get_model("dstdgcn", **dict(opts, **extra))
        if label != "kernel":
            m = plain_contract(torch, m)
        if dtype is not None:
            m = m.to(dtype)
        engines[label] = PredictionEngine(rcfg["engine"], m, device=device)
        engines[label].init()
    return engines


def bf16_step_grads(torch, device, engines, state, batch):
    """Every engine at ``state`` (BatchNorm calibrated on ``batch`` through
    the plain path, dropout 0), one train step's loss and gradients each
    (float64 per parameter name); the float64 engine runs the step's two
    passes in float64.  Returns (losses, grads)."""
    pmodel = engines["plain"].model
    pmodel.load_state_dict(state)
    calibrate_batchnorm(torch, pmodel, engines["plain"].transform(
        engines["plain"].to_device(batch[0])))
    losses = {}
    for label, e in engines.items():
        if label != "plain":
            e.model.load_state_dict(pmodel.state_dict())
        e.model.do_in.p = 0.0
        if label != "float64":
            losses[label] = float(e.compute_gradients(*batch)["total"])
    m64, e64 = engines["float64"].model, engines["float64"]
    b64 = [torch.as_tensor(a, dtype=torch.float64, device=device)
           for a in batch]
    m64.train()
    m64.zero_grad(set_to_none=True)
    total64 = (sum(e64._one_pass(b64[0], b64[2], None, None, None).values())
               + sum(e64._one_pass(b64[1], b64[2].flip(1), None, None,
                                   None).values())) / 2
    total64.backward()
    losses["float64"] = float(total64.detach())
    grads = {label: {n: p.grad.double() for n, p in e.model
                     .named_parameters()} for label, e in engines.items()}
    return losses, grads


def step_errors(grads):
    """{parameter: (kernel vs plain, plain bf16 vs plain float32, kernel vs
    float64, plain vs float64)}, each max |a - b| over max(max |b|, 1)."""
    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)

    return {n: (rel(g, grads["plain"][n]),
                rel(grads["plain_f32"][n], grads["plain"][n]),
                rel(g, grads["float64"][n]),
                rel(grads["plain"][n], grads["float64"][n]))
            for n, g in grads["kernel"].items()}


def step_groups(names):
    """{"gates": the gate parameters (alpha), "others": the rest}."""
    gates = [n for n in names if n.endswith(("alpha_sm", "alpha_tm"))]
    return dict(gates=gates, others=[n for n in names if n not in gates])


def step_verdict(errs):
    """The judgement of the bf16 step check on ``step_errors``: for the
    gate gradients (alpha) and for the other gradients, the group's mean
    distance of the kernel path to the float64 run against the plain
    path's.  Returns {group: (kernel mean, plain mean, bound, the parameter
    farthest from float64 on the kernel path)}."""
    out = {}
    for group, names in step_groups(errs).items():
        kernel64 = sum(errs[n][2] for n in names) / len(names)
        plain64 = sum(errs[n][3] for n in names) / len(names)
        worst = max(names, key=lambda n: errs[n][2])
        out[group] = (kernel64, plain64, BF16_STEP_NOISE * plain64, worst)
    return out


def bf16_step_check(torch, fused, device, rcfg, batches, steps, per_fwd):
    """One bf16 train step of the kernel path against the plain path of the
    same contract on the card, at the weights the plain path reaches in
    ``steps`` train steps from the slice's seeded initial weights: the loss
    within BF16_LOSS_RTOL, each gradient group (gates, the rest) on average
    no farther from the float64 run than BF16_STEP_NOISE times the plain
    path's own distance, and the step's launches.  Returns the numbers."""
    engines = bf16_step_engines(torch, device, rcfg)
    for i in range(steps):      # dropout on, as the slice trains
        engines["plain"].train_step(*batches[i % len(batches)])
    state = copy.deepcopy(engines["plain"].model.state_dict())
    before = fused.launch_counts()
    losses, grads = bf16_step_grads(torch, device, engines, state,
                                    batches[0])
    after = fused.launch_counts()
    step_launches = {k: after[k] - before[k] for k in after}
    loss_rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    errs = step_errors(grads)
    verdict = step_verdict(errs)
    print(f"bf16: one step at the weights of {steps} plain-path steps, "
          f"kernel path vs plain path: loss {losses} (rel {loss_rel:.3g}); "
          f"launches {step_launches}")
    for n in sorted(errs, key=lambda n: -errs[n][2])[:6]:
        print(f"bf16: gradient {n}: kernel vs float64 {errs[n][2]:.3g}, "
              f"plain vs float64 {errs[n][3]:.3g}, kernel vs plain "
              f"{errs[n][0]:.3g}, plain bf16 vs plain float32 "
              f"{errs[n][1]:.3g} of max(|reference|, 1)")
    for group, (k64, p64, bound, worst) in verdict.items():
        print(f"bf16: {group} gradients: kernel path on average {k64:.3g} "
              f"from the float64 run (farthest {worst}), plain path "
              f"{p64:.3g}, tolerance {bound:.3g} ({BF16_STEP_NOISE} times "
              "the plain path's)")
    check(loss_rel <= BF16_LOSS_RTOL, f"bf16 train loss: {losses}")
    for group, (k64, p64, bound, worst) in verdict.items():
        check(k64 <= bound, f"bf16 {group} gradients: on average {k64} from "
                            f"float64, plain path {p64}")
    check(step_launches == {
        **{k: 0 for k in step_launches},
        **{k: 2 * per_fwd for k in BF16_FORWARD},
        **{k: 2 * per_fwd * fused.BWD_LAUNCHES for k in BF16_BACKWARD}},
        f"one bf16 train step launched {step_launches}")
    return dict(steps=steps, losses=losses, loss_rel=loss_rel,
                verdict=verdict, grad_errs=errs)


def fused_bf16_phase(torch, np, fused, device):
    """The bf16 fused serving slice through ``main.run`` on ``cuda``,
    counts from zero: the knobs resolve to bf16, exactly one
    ``dstd_encoder_chain_bf16`` per eval batch and no other DSTD-GC kernel
    (the in and out layers run the plain ops at bf16: the XLA path's
    rounding, as the JAX function has it), finite per-frame MPJPE and
    ``testing_loss.csv``; batch-1 requests; the batch-128 bf16 fused
    forward's wall and device time beside the float32 fused forward and the
    standard bf16 forward; then one calibrated batch against the same
    function with the encoder through its plain version (``_encoder_oracle``
    with the dtype): the error over the float32 output's peak within
    BF16_CHAIN_FRAC of the batch's bf16-versus-float32 gap (the encoder's
    five layers spread rounding flips; phase 3 holds each layer).
    Returns (report, the slice's launch counts)."""
    from dstdgcn_tpu_torch import configs
    from dstdgcn_tpu_torch.data import get_dataset
    from dstdgcn_tpu_torch.main import run
    from dstdgcn_tpu_torch.models import infer
    from dstdgcn_tpu_torch.utils.config import resolve
    report = {}
    cfg = configs.synthetic_h36m_tpu_fused()
    rcfg = resolve(cfg)
    bs = rcfg["test_batch_size"]
    n_test = rcfg["dataset"]["test"]["synthetic"]["num_sequences"]
    run_dir = os.path.join(OUT_DIR, "fused_bf16")
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    runner, (avg, per_frame) = run(cfg, "cuda", run_dir=run_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused.launch_counts()
    eng = runner.engine
    model = eng.model
    knobs = model.resolve_knobs(bs)
    batches = eng.test_batch_seconds
    nb = len(batches)
    print(f"fused bf16: resolved knobs at batch {bs} (hint "
          f"{model.auto_batch_hint}): {knobs}")
    print(f"fused bf16: main.run on cuda, {nb} batches of {bs} in "
          f"{wall:.2f} s; per-frame MPJPE {[float(m) for m in per_frame]} "
          f"avg {float(avg)}")
    print(f"fused bf16: wall ms per batch "
          f"{[round(t * 1e3, 3) for t in batches]} (median "
          f"{float(np.median(batches)) * 1e3:.3f})")
    print(f"fused bf16: launches {counts} over {nb} eval batches")
    check(knobs["compute_dtype"] == "bfloat16" and eng.fused_inference,
          f"the fused bf16 slice resolved {knobs}")
    check(nb == -(-n_test // bs), f"{nb} eval batches, expected "
                                  f"{-(-n_test // bs)}")
    check(bool(np.all(np.isfinite(per_frame))) and np.isfinite(avg),
          "the fused bf16 slice gave a non-finite MPJPE")
    per_batch = {"dstd_encoder_chain_bf16": 1}
    check(counts == {k: per_batch.get(k, 0) * nb for k in counts},
          f"the fused bf16 slice launched {counts} over {nb} batches, "
          f"expected {per_batch} per batch")
    with open(os.path.join(run_dir, "testing_loss.csv")) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    check(len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1]),
          f"testing_loss.csv holds {rows}")
    report.update(knobs=knobs, per_frame=[float(m) for m in per_frame],
                  avg=float(avg), batch_seconds=batches, launches=counts,
                  wall=wall)

    # batch-1 requests: "auto" is pinned to the configured batch, so a
    # single sequence runs the same bf16 kernel, one cluster
    inputs = get_dataset("synthetic", **rcfg["dataset"]["test"]).input_seqs
    fforward = eng._eval_forward()

    def serve(x, forward=fforward):
        with torch.inference_mode():
            return eng._serve(x, forward, None, None)

    req_ms = []
    for i in range(4):
        before = fused.launch_counts()
        t0 = time.perf_counter()
        out = serve(inputs[i:i + 1])
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        after = fused.launch_counts()
        check(out.shape == (1, T, inputs.shape[-1])
              and bool(torch.isfinite(out).all()), "bad batch-1 output")
        check({k: after[k] - before[k] for k in after}
              == {k: per_batch.get(k, 0) for k in after},
              f"a batch-1 bf16 request launched {after} (before {before})")
    print(f"fused bf16: 4 batch-1 requests, ms {[round(m, 3) for m in req_ms]}")

    # where the time of one batch-128 forward goes: the bf16 fused forward,
    # the float32 fused forward and the standard bf16 forward (the model's
    # ops through the bf16 one-op kernels)
    weights = infer.fused_weights(model)

    def fused32(x):
        return infer.fused_eval_forward(model, x, None, weights)

    forwards = dict(
        fused_bf16=lambda: serve(inputs[:bs]),
        fused_f32=lambda: serve(inputs[:bs], fused32),
        standard_bf16=lambda: eng.predict(inputs[:bs]),
        fused_bf16_batch1=lambda: serve(inputs[:1]))
    times = {}
    for label, fn in forwards.items():
        call = time_ms(torch, fn, 10)
        prof = device_profile(torch, fn, 5)
        dev = sum(prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:5]
        times[label] = dict(call_ms=call, device_ms=dev, by_kernel=prof)
        busy = (f"{dev:.3f} ms ({100 * dev / call:.1f}%)" if prof
                else "not measured (the profiler recorded nothing)")
        print(f"profile: {label} forward (batch "
              f"{1 if label.endswith('batch1') else bs}) {call:.3f} ms per "
              f"call, device busy {busy}; top "
              + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top))
    report.update(batch1_ms=req_ms, forwards=times)

    # one calibrated batch: the fused path against the same function with
    # the encoder through its plain version, the float32 function beside it
    report["check"] = fused_bf16_check(torch, fused, eng, inputs[:bs],
                                       per_batch, "fused bf16")
    return report, counts


def fused_bf16_check(torch, fused, eng, inputs, per_batch, label):
    """Phase 10's rule on one calibrated batch of ``inputs`` (every weight
    of ``eng``'s model moved by seeded noise, BatchNorm calibrated on the
    batch): the bf16 fused forward against the same function with the
    encoder through its plain version (``_encoder_oracle`` with the
    dtype), the error over the float32 function's peak within
    BF16_CHAIN_FRAC of the batch's bf16-versus-float32 gap, and the
    forward's launches ``per_batch``.  Returns the check line."""
    from unittest import mock

    from dstdgcn_tpu_torch.models import infer
    model, device = eng.model, eng.device
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(device))
    x = eng.transform(eng.to_device(inputs))
    calibrate_batchnorm(torch, model, x)
    weights = infer.fused_weights(model)

    def plain_encoder(h, packed, agg, dtype=None, nb=None):
        # contiguous, as the kernel's output is (the float32 out layer runs
        # the one-op kernels)
        return fused._encoder_oracle(h, packed.layers, agg,
                                     dtype).contiguous()

    with torch.inference_mode():
        before = fused.launch_counts()
        got = infer.fused_eval_forward(model, x, torch.bfloat16, weights)
        torch.cuda.synchronize()
        after = fused.launch_counts()
        with mock.patch.object(fused, "dstd_encoder_chain", plain_encoder):
            want = infer.fused_eval_forward(model, x, torch.bfloat16,
                                            weights)
            want32 = infer.fused_eval_forward(model, x, None, weights)
    peak = float(want32.abs().max())
    abs_err = float((got - want).abs().max())
    err = abs_err / peak
    gap = float((want - want32).abs().max()) / peak
    launched = {k: after[k] - before[k] for k in after}
    line = dict(n=x.shape[0], max_abs_err=abs_err, norm_err=err,
                frac=BF16_CHAIN_FRAC, bf16_vs_f32_gap=gap,
                over_gap=err / gap, peak=peak,
                launches=launched, ok=err <= BF16_CHAIN_FRAC * gap)
    print(f"check {label} forward vs its plain path " + json.dumps(line))
    check(line["ok"], f"{label}: the bf16 fused forward is {err} from its "
                      "plain path, "
                      f"above {BF16_CHAIN_FRAC} of its bf16-versus-float32 "
                      f"gap {gap}")
    check(launched == {k: per_batch.get(k, 0) for k in launched},
          f"{label}: the calibrated bf16 fused forward launched "
          f"{launched}")
    return line


#: the seeded trees of phase 11, in each dataset's format (the writers'
#: keyword arguments).  H36M: subjects 1, 6, 7, 8 and 9 (train) of 160 raw
#: frames a file, 46 windows after downsampling, 13,800 mirrored; subject 5
#: (test) of 300, 50 ``all``-mode windows a subaction, 4 eval batches an
#: action.  CMU: each action 2 train files and 1 test file of 200 raw
#: frames, 66 windows each.  3DPW: 4 train and 2 test files of 2 people,
#: 150 and 100 frames (111 and 61 windows each)
REAL_TREES = {"h36m": dict(seed=17, frames=160, test_frames=300),
              "cmu": dict(seed=18, files=(2, 1), frames=(200, 200)),
              "3dpw": dict(seed=19, files=(4, 2), frames=(150, 100))}
#: train steps of phase 11's CMU and 3DPW runs (one epoch); the H36M run
#: takes its config's 2 epochs of ``max_iter`` steps
REAL_STEPS = 4


def real_op_checks(torch, np, fused, plain, plain_bwd, device, label, t, v,
                   shapes, tag="real", n=N, timings=None, timed_agg="right"):
    """Each float32 one-op kernel, forward and backward, both aggregations,
    against its plain version at batch ``n`` (N=32), (T, V) = (``t``,
    ``v``) and every (mode, Ci, Co) of ``shapes``, by phase 3's rules:
    forward within 1e-4 + 1e-4 |plain| elementwise, the backward's 11
    tensors each within 1e-4 max(max |plain|, 1), two calls of each
    bit-equal.  With a ``timings`` dict, each pass at ``timed_agg`` is timed
    as phase 3 times it (device ms of the kernel and of its plain version,
    the bound; the backward's four launches) into ``timings[(kernel, ci,
    co, agg)]``.  Prints each line after ``tag``; returns the check lines
    (with the tile the wrapper chose)."""
    lines = []
    for mode, ci, co in sorted(set(shapes)):
        fwd, ref = getattr(fused, f"dstd_{mode}"), getattr(plain,
                                                           f"dstd_{mode}")
        bwd = getattr(fused, f"dstd_{mode}_bwd")
        ref_bwd = getattr(plain_bwd, f"dstd_{mode}_bwd")
        args = op_inputs(torch, np, mode, ci, co, device, seed=ci + co + t,
                         n=n, t=t, v=v)
        gen = torch.Generator(device=device).manual_seed(ci * co + v)
        g = torch.randn((n, t, v, co), generator=gen, device=device)
        for agg in ("right", "left"):
            got, again = (fwd(*args, None, agg) for _ in range(2))
            want = ref(*args, None, agg)
            f_abs, f_rel, f_ok = errors(torch, got, want)
            f_rep = bool(torch.equal(got, again))
            got, again = (bwd(args[0], g, *args[1:], agg=agg)
                          for _ in range(2))
            want = ref_bwd(args[0], g, *args[1:], agg=agg)
            b_abs, b_norm, b_ok = grad_errors(got, want)
            b_rep = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            tiles = {op.name: plan_tiles(op, "f32", n, t, v, ci, co)
                     for op in (fwd, bwd)}
            line = dict(dataset=label, t=t, v=v, mode=mode, ci=ci, co=co,
                        agg=agg, n=n, tiles=tiles,
                        forward=dict(max_abs_err=f_abs, max_rel_err=f_rel,
                                     ok=f_ok, repeatable=f_rep),
                        backward=dict(max_abs_err=b_abs, max_norm_err=b_norm,
                                      ok=b_ok, repeatable=b_rep))
            if timings is not None and agg == timed_agg:
                for part, call, plain_call in (
                        ("forward", lambda: fwd(*args, None, agg),
                         lambda: ref(*args, None, agg)),
                        ("backward", lambda: bwd(args[0], g, *args[1:],
                                                 agg=agg),
                         lambda: ref_bwd(args[0], g, *args[1:], agg=agg))):
                    name = fwd.name if part == "forward" else bwd.name
                    split = {} if part == "backward" else None
                    k_call = time_ms(torch, call, 10)
                    k_ms, k_by = device_ms(torch, call, 10, split)
                    p_ms, p_by = device_ms(torch, plain_call, 3)
                    b_ms, t_ops, t_mem = bound_ms(
                        mode, n, ci, co, part == "backward", None, t, v)
                    timings[(name, ci, co, agg)] = (k_ms, p_ms, k_call,
                                                    k_by, split)
                    line[part].update(
                        ms=k_ms, plain_ms=p_ms, call_ms=k_call,
                        timed_by=[k_by, p_by], bound_ms=b_ms,
                        bound_by="operations" if t_ops >= t_mem
                        else "bytes", **({} if split is None
                                         else dict(launch_ms=split)))
            lines.append(line)
            print(f"{tag} check " + json.dumps(line))
            where = f"{label} (T={t}, V={v}) dstd_{mode} agg={agg} {ci}->{co}"
            check(f_ok, f"{where}: forward max abs err {f_abs}")
            check(b_ok, f"{where}: backward {b_norm} of max(|plain|, 1)")
            check(f_rep and b_rep, f"{where}: two calls differ")
    return lines


def real_data_phase(torch, np, fused, plain, plain_bwd, device):
    """Phase 11, the real-dataset slice: seeded trees in each dataset's
    format, the float32 one-op kernels at CMU's and 3DPW's shapes, then
    ``main.run`` on ``real_h36m_train`` (2 epochs; the recovery probe,
    ``test-all`` and a calibrated batch against the plain path after it),
    ``real_cmu_train`` and ``real_3dpw_train`` (1 epoch of REAL_STEPS
    steps; one train step against the plain path after each), every run's
    launches exact.  Returns (report, {dataset: launches of its training
    run})."""
    from dstdgcn_tpu_torch import configs
    from dstdgcn_tpu_torch.data import datasets as tds
    from dstdgcn_tpu_torch.data import get_dataset
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.main import run
    from dstdgcn_tpu_torch.models import get_model
    from dstdgcn_tpu_torch.utils.config import resolve
    report, launches = {}, {}
    start = time.perf_counter()
    out = os.path.join(OUT_DIR, "real")
    data = os.path.join(OUT_DIR, "data")
    for d in (out, data):
        shutil.rmtree(d, ignore_errors=True)

    # the trees, in each dataset's own format
    writers = {"h36m": write_h36m_tree, "cmu": write_cmu_tree,
               "3dpw": write_pw3d_tree}
    paths, write_s = {}, {}
    for name, writer in writers.items():
        t0 = time.perf_counter()
        got = writer(os.path.join(data, name), **REAL_TREES[name])
        write_s[name] = time.perf_counter() - t0
        paths[name] = (got, got) if isinstance(got, str) else got
    print(f"real: trees written in {sum(write_s.values()):.2f} s "
          + " ".join(f"{k}={v:.2f}s" for k, v in write_s.items()))
    report["write_seconds"] = write_s

    # the float32 one-op kernels at the CMU and 3DPW models' shapes
    checks = []
    for name in ("cmu", "3dpw"):
        mcfg = resolve(getattr(configs, f"REAL_{name.upper()}_TRAIN"))[
            "model"]["dstdgcn"]
        checks += real_op_checks(
            torch, np, fused, plain, plain_bwd, device, name,
            mcfg["input_time_frame"] + mcfg["output_time_frame"],
            mcfg["joints_to_consider"], forward_shapes(mcfg))
    report["op_checks"] = checks

    for name in ("h36m", "cmu", "3dpw"):
        cfg = configs.set_data_paths(
            getattr(configs, f"real_{name}_train")(), *paths[name])
        if name != "h36m":
            cfg["epoch"] = 1
            cfg["engine"]["max_iter"] = REAL_STEPS
        rcfg = resolve(cfg)
        epochs, max_iter = rcfg["epoch"], rcfg["engine"]["max_iter"]
        run_dir = os.path.join(out, name)
        tds.reset_reader_counts()
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        runner, history = run(cfg, device.type, run_dir=run_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches[name] = fused.launch_counts()
        reads = tds.reader_counts()
        eng = runner.engine
        steps = len(eng.train_step_seconds)
        evals = epochs * len(runner.test_batch_seconds)
        rows = np.asarray(history, dtype=np.float64)
        step_ms = [s * 1e3 for s in eng.train_step_seconds]
        eval_ms = [s * 1e3 for s in runner.test_batch_seconds]
        fetch_ms = [s * 1e3 for s in eng.train_fetch_seconds]
        print(f"real {name}: main.run on {device.type} in {wall:.2f} s, "
              f"{steps} train steps of {rcfg['train_batch_size']} and "
              f"{evals} eval batches; files read {reads}; dataset build s "
              f"{ {k: round(v, 3) for k, v in runner.data_seconds.items()} }")
        print(f"real {name}: wall ms per train step, first "
              f"{step_ms[0]:.3f}, then median "
              f"{float(np.median(step_ms[1:])):.3f}; per eval batch median "
              f"{float(np.median(eval_ms)):.3f}; loader ms per train batch "
              f"median {float(np.median(fetch_ms)):.3f}")
        print(f"real {name}: per epoch (epoch, lr, train loss, test loss, "
              f"horizons) {rows[:, :12].tolist()}; launches {counts}")
        check(steps == epochs * max_iter,
              f"{name}: {steps} train steps, expected {epochs} x {max_iter}")
        check(rows.shape[0] == epochs and bool(np.all(np.isfinite(rows))),
              f"{name}: non-finite losses or MPJPE in training")
        if name == "3dpw":
            check(reads == {"native": 0, "loadtxt": 0},
                  f"3dpw read CSV files: {reads}")
            width = 3 + 1 + len(rcfg["setting"]["eval_frame"])
        else:
            check(reads["native"] > 0 and reads["loadtxt"] == 0,
                  f"{name}: the native reader did not serve every file: "
                  f"{reads}")
            width = 3 + 9 + 8 * len(tds.define_actions("all", name))
        with open(os.path.join(run_dir, "training_loss.csv")) as f:
            csv_rows = [line.strip().split(",") for line in f
                        if line.strip()]
        check(len(csv_rows) == epochs + 2
              and {len(r) for r in csv_rows} == {width}
              and csv_rows[-1] == csv_rows[1 + int(np.argmin(rows[:, 3]))],
              f"{name}: training_loss.csv holds {len(csv_rows)} rows of "
              f"{sorted({len(r) for r in csv_rows})} columns, expected "
              f"{epochs + 2} of {width} with the best row last")
        for ckpt in ("last.ckpt", "best.ckpt"):
            check(os.path.isfile(os.path.join(run_dir, "checkpoints", ckpt)),
                  f"{name}: {ckpt} was not written")
        want = {k: 0 for k in counts}
        want.update({k: 14 * steps + 7 * evals for k in FORWARD})
        want.update({k: fused.BWD_LAUNCHES * 14 * steps for k in BACKWARD})
        check(counts == want, f"{name}: training launched {counts}, "
                              f"expected {want}")

        # one test batch (32 windows of one action) for the step's device
        # time and the checks against the plain path
        split = dict(rcfg["dataset"]["test"][name])
        if name != "3dpw":
            split["actions"] = "walking"
        arrays = get_dataset(name, **{name: split}).arrays()
        batch = [a[:N] for a in arrays[:3]]
        prof = device_profile(torch, lambda: eng.train_step(*batch), 3)
        step_dev = sum(prof.values())
        print(f"real {name}: train step device "
              + (f"{step_dev:.3f} ms" if prof else "not measured (the "
                 "profiler recorded nothing)"))
        report[name] = dict(
            wall=wall, steps=steps, evals=evals, reads=reads,
            data_seconds=runner.data_seconds, step_ms=step_ms,
            eval_ms=eval_ms, fetch_ms=fetch_ms, step_device_ms=step_dev,
            history=rows.tolist(), launches=counts)
        if name != "h36m":
            report[name]["train_check"], _ = train_step_check(
                torch, fused, eng, rcfg, batch, f"real {name}")
            continue

        # the recovery probe: test mode on best.ckpt gives the best row's
        # test loss exactly
        best = os.path.join(run_dir, "checkpoints", "best.ckpt")
        results = {}
        for mode in ("test", "test-all"):
            mcfg = configs.set_data_paths(configs.real_h36m_train(),
                                          *paths[name])
            mcfg["mode"] = mode
            mcfg["model"].update(load=True, ckpt=best)
            fused.reset_launch_counts()
            mrunner, _ = run(mcfg, device.type,
                             run_dir=os.path.join(out, f"h36m_{mode}"))
            torch.cuda.synchronize()
            with open(os.path.join(out, f"h36m_{mode}",
                                   "testing_loss.csv")) as f:
                results[mode] = ([line.strip().split(",") for line in f
                                  if line.strip()], fused.launch_counts(),
                                 mrunner)
        (test_rows, test_counts, trunner), (all_rows, all_counts, _) = (
            results["test"], results["test-all"])
        n_eval = len(trunner.test_batch_seconds)
        print(f"real h36m: recovery probe test_loss {test_rows[1][0]} "
              f"against the best row's {csv_rows[-1][3]}; test-all rows "
              f"{[r[0] for r in all_rows[1:]]}, average {all_rows[-1][:4]}"
              f"...; launches {test_counts} and {all_counts}")
        check(float(test_rows[1][0]) == float(csv_rows[-1][3]),
              f"recovery probe: test_loss {test_rows[1][0]}, best row "
              f"{csv_rows[-1][3]}")
        check(len(test_rows) == 2 and len(test_rows[0]) == width - 3,
              f"testing_loss.csv of test mode holds {test_rows[:1]}")
        check([r[0] for r in all_rows[1:]]
              == tds.define_actions("all", "h36m") + ["average"]
              and {len(r) for r in all_rows} == {2 + 25}
              and all(np.isfinite(float(x)) for r in all_rows[1:]
                      for x in r[1:]),
              f"the test-all table holds {all_rows}")
        for mode, c in (("test", test_counts), ("test-all", all_counts)):
            want = {k: 7 * n_eval if k in FORWARD else 0 for k in c}
            check(c == want, f"h36m {mode} launched {c}, expected {want}")
        report["h36m"].update(recovery=float(test_rows[1][0]),
                              best=float(csv_rows[-1][3]),
                              test_all=all_rows)

        # one calibrated test batch through the kernels against the plain
        # path, the served weights moved off the checkpoint as phase 4 does
        teng = trunner.engine
        model = teng.model
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen).to(device))
        opts = {k: v for k, v in rcfg["model"].items() if k != "name"}
        pmodel = get_model("dstdgcn", **dict(opts, use_pallas=False))
        pmodel.load_state_dict(model.state_dict())
        peng = PredictionEngine(rcfg["engine"], pmodel, device=device)
        calibrate_batchnorm(torch, pmodel,
                            peng.transform(peng.to_device(batch[0])))
        model.load_state_dict(pmodel.state_dict())
        before = fused.launch_counts()
        got = teng.predict(batch[0])
        want = peng.predict(batch[0])
        torch.cuda.synchronize()
        after = fused.launch_counts()
        abs_err, rel_err, ok = errors(torch, got, want)
        served = {k: after[k] - before[k] for k in FORWARD}
        print(f"real h36m: batch {N} kernel path vs plain path max_abs_err "
              f"{abs_err} max_rel_err {rel_err} (|out| max "
              f"{float(want.abs().max())}) launches {served}")
        check(ok, f"h36m served batch: kernel path disagrees with the plain "
                  f"path (max abs err {abs_err})")
        check(served == {k: 7 for k in FORWARD},
              f"h36m served batch launched {served}")
        report["h36m"]["model_check"] = dict(max_abs_err=abs_err,
                                             max_rel_err=rel_err)
    # the trees (36 MB) are rebuilt from their seeds by every run: removed
    # so that the run's output directory stays small
    shutil.rmtree(data)
    report["seconds"] = time.perf_counter() - start
    print(f"real: the phase took {report['seconds']:.1f} s")
    return report, launches


# -- phase 12: the engine remainder ----------------------------------------

#: the kernels of the four float32 DSTD-GC one-op kernels as a profiler
#: trace names them: the backward launches carry their mode as the first
#: template argument (``dstd_bwd::qk_kernel<true, ...>``: temporal)
TRACE_KERNELS = (("dstd_spatial", re.compile(r"\bspatial_kernel<")),
                 ("dstd_temporal", re.compile(r"\btemporal_kernel<")),
                 ("dstd_spatial_bwd",
                  re.compile(r"dstd_bwd::\w+_kernel<false\b")),
                 ("dstd_temporal_bwd",
                  re.compile(r"dstd_bwd::\w+_kernel<true\b")))
#: batch sizes of the remat memory table
REMAT_BATCHES = (32, 128)
REMAT_MODES = (False, True, "dots")


def _msgpack(obj, out):
    """Append the msgpack encoding of ``obj`` to ``out`` (a list of bytes),
    for what a flax state dict holds here: dicts with str keys, lists,
    non-negative ints, str and bytes, and numpy arrays as flax's ndarray
    extension (type 1: the msgpack of shape, dtype name and C bytes)."""
    import numpy as np

    def head(n, fix, fix_limit, codes):
        if n < fix_limit:
            out.append(bytes([fix | n]))
            return
        code, fmt = next((c, f) for c, f, limit in codes if n < limit)
        out.append(bytes([code]) + struct.pack(">" + fmt, n))

    wide = ((1 << 8, "B"), (1 << 16, "H"), (1 << 32, "I"))

    def sized(first):
        return [(first + k, f, limit) for k, (limit, f) in enumerate(wide)]

    if isinstance(obj, np.ndarray):
        inner = []
        _msgpack((list(obj.shape), obj.dtype.name, obj.tobytes("C")), inner)
        data = b"".join(inner)
        head(len(data), 0, 0, sized(0xC7))
        out.append(bytes([1]) + data)
    elif isinstance(obj, int) and 0 <= obj < 1 << 64:
        out.append(bytes([obj]) if obj < 128
                   else b"\xcf" + struct.pack(">Q", obj))
    elif isinstance(obj, str):
        data = obj.encode()
        head(len(data), 0xA0, 32, sized(0xD9))
        out.append(data)
    elif isinstance(obj, bytes):
        head(len(obj), 0, 0, sized(0xC4))
        out.append(obj)
    elif isinstance(obj, dict):
        head(len(obj), 0x80, 16, [(0xDE, "H", 1 << 16),
                                  (0xDF, "I", 1 << 32)])
        for k, v in obj.items():
            _msgpack(k, out)
            _msgpack(v, out)
    elif isinstance(obj, (list, tuple)):
        head(len(obj), 0x90, 16, [(0xDC, "H", 1 << 16),
                                  (0xDD, "I", 1 << 32)])
        for v in obj:
            _msgpack(v, out)
    else:
        raise TypeError(f"msgpack: cannot encode {obj!r}")


def _nested(flat):
    """{"a.b.c": leaf} -> nested dicts."""
    out = {}
    for key, val in flat.items():
        node = out
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return out


def jax_train_state(engine, seed=777):
    """The JAX engine's ``TrainState`` for ``engine`` (a port engine whose
    optimizer is Adam), as flax's state dict for optax 0.2's layout:
    ``params`` and ``batch_stats`` (the weight bridge's reverse),
    ``opt_state`` (``inject_hyperparams`` over Adam, with L2 decay
    ``add_decayed_weights`` before it, or over the solver block's
    ``multi_transform`` of the ``base`` and ``bias`` groups, a masked
    leaf an empty dict; under a clip, the chain ``clip_by_global_norm``
    then that), and ``dropout_key``, threefry key data of ``seed + 1``."""
    import numpy as np
    from dstdgcn_tpu_torch.utils.bridge import to_flax_variables
    opt = engine.optimizer
    names = {id(p): n for n, p in engine.model.named_parameters()}
    steps = {int(st["step"]) for st in opt.state.values()}
    check(len(steps) <= 1, f"Adam steps differ between parameters: {steps}")
    count = steps.pop() if steps else 0

    def adam(label):
        mu, nu = {}, {}
        for group in opt.param_groups:
            for p in group["params"]:
                name, st = names[id(p)], opt.state.get(p, {})
                if label is not None and group.get("label") != label:
                    mu[name] = nu[name] = {}
                    continue
                zeros = np.zeros(tuple(p.shape), np.float32)
                mu[name] = st["exp_avg"].cpu().numpy() if st else zeros
                nu[name] = st["exp_avg_sq"].cpu().numpy() if st else zeros
        return {"count": np.asarray(count, np.int32), "mu": _nested(mu),
                "nu": _nested(nu)}

    def chain(label, decay):
        scaled = {"0": adam(label), "1": {}}
        return {"0": {}, "1": scaled} if decay > 0 else scaled

    hyper = {"learning_rate": np.asarray(engine.lr, np.float32)}
    if engine.solver:
        wd = float(engine.solver.get("weight_decay", 0.0))
        decays = {"base": wd, "bias": float(engine.solver.get(
            "weight_decay_bias", wd))}
        inner = {"inner_states": {label: {"inner_state": chain(label, d)}
                                  for label, d in decays.items()}}
    elif engine.weight_decay > 0:
        inner = chain(None, engine.weight_decay)
    else:
        inner = chain(None, 0.0)
        hyper = {"b1": np.asarray(0.9, np.float32),
                 "b2": np.asarray(0.999, np.float32),
                 "eps": np.asarray(1e-8, np.float32),
                 "eps_root": np.asarray(0.0, np.float32), **hyper}
    opt_state = {"count": np.asarray(count, np.int32), "hyperparams": hyper,
                 "hyperparams_states": {}, "inner_state": inner}
    if engine.clip > 0:
        opt_state = {"0": {}, "1": opt_state}
    variables = to_flax_variables(engine.model)
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"], "opt_state": opt_state,
            "dropout_key": np.asarray([0, seed + 1], np.uint32)}


def write_jax_checkpoint(path, engine, payload):
    """Write ``engine``'s state as the JAX package writes a checkpoint
    (``dstdgcn_tpu/engine/checkpoint.py::save_checkpoint``): an 8-byte
    little-endian length, the JSON ``payload``, then the msgpack of
    :func:`jax_train_state` (flax's ``to_bytes`` of a ``TrainState``)."""
    blob = []
    _msgpack(jax_train_state(engine), blob)
    meta = json.dumps(payload).encode()
    with open(path, "wb") as f:
        f.write(len(meta).to_bytes(8, "little"))
        f.write(meta)
        f.write(b"".join(blob))


def trace_kernel_counts(path):
    """{kernel: events} of the four float32 DSTD-GC kernels in a Chrome
    trace of ``torch.profiler``, and the names of its ``engine.step``
    spans."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {name: 0 for name, _ in TRACE_KERNELS}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for name, pattern in TRACE_KERNELS:
            if pattern.search(e.get("name", "")):
                counts[name] += 1
                break
    # the host side of each annotation (its device range, category
    # gpu_user_annotation, repeats the name)
    steps = sorted(e["name"] for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == "engine.step")
    return counts, steps


def set_remat(torch, model, remat):
    """Set ``remat`` on every DSTD-GC op of ``model``."""
    from dstdgcn_tpu_torch.models.layers import DSTDGC
    for m in model.modules():
        if isinstance(m, DSTDGC):
            m.remat = remat


def solver_update_check(torch, engine, label):
    """One optimizer step of ``engine`` (the solver block's Adam) from the
    gradients in its parameters' ``.grad``, each parameter's update against
    optax's rule run in float64 on the same gradient and state: L2 decay of
    the group, Adam at the group's learning rate; within 1e-6 of max(|p|,
    1).  Returns (worst error, {group: lr})."""
    opt = engine.optimizer
    b1, b2, eps = 0.9, 0.999, 1e-8
    want = {}
    with torch.no_grad():
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state[p]
                g = p.grad.double() + group["weight_decay"] * p.double()
                t = float(st["step"]) + 1
                m = b1 * st["exp_avg"].double() + (1 - b1) * g
                v = b2 * st["exp_avg_sq"].double() + (1 - b2) * g * g
                upd = -group["lr"] * (m / (1 - b1 ** t)) / (
                    torch.sqrt(v / (1 - b2 ** t)) + eps)
                want[p] = (p.clone(), upd)
        opt.step()
        worst = 0.0
        for p, (before, upd) in want.items():
            err = float(((p - before).double() - upd).abs().max())
            worst = max(worst, err / max(float(before.abs().max()), 1.0))
    lrs = {g["label"]: g["lr"] for g in opt.param_groups}
    print(f"{label}: one solver step, updates against optax's rule in "
          f"float64: worst {worst:.3g} of max(|p|, 1); group lr {lrs}")
    check(worst <= 1e-6, f"{label}: a solver update lies {worst} of "
                         "max(|p|, 1) from optax's rule")
    return worst, lrs


def engine_phase(torch, np, fused, device):
    """Phase 12, the engine remainder: ``main.run`` on
    ``synthetic_h36m_engine_train`` (remat, the solver block, callbacks,
    a profiler trace of steps 1-3), then remat against no remat, the peak
    memory and device time of a train step under each remat mode, the
    solver step on both paths, the resume from a JAX-layout checkpoint,
    ``time_looped`` beside the profiler, and visualize-debug.  Returns
    (report, the slice run's launches)."""
    from importlib.util import find_spec
    from dstdgcn_tpu_torch import configs
    from dstdgcn_tpu_torch.data import get_dataset
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.engine.checkpoint import read_jax_checkpoint
    from dstdgcn_tpu_torch.main import run
    from dstdgcn_tpu_torch.models import get_model
    from dstdgcn_tpu_torch.utils.config import resolve
    from dstdgcn_tpu_torch.utils.timing import time_looped
    report = {}
    start = time.perf_counter()
    out = os.path.join(OUT_DIR, "engine")
    shutil.rmtree(out, ignore_errors=True)
    run_dir = os.path.join(out, "run")
    profile_dir = os.path.join(out, "profile")

    # 1. the slice through its entry point, counts from zero; each epoch's
    # group learning rates recorded as the engine sets them
    cfg = configs.synthetic_h36m_engine_train()
    cfg["engine"]["profile"] = profile_dir
    rcfg = resolve(cfg)
    epochs, bs = rcfg["epoch"], rcfg["train_batch_size"]
    steps = epochs * -(-rcfg["dataset"]["train"]["synthetic"][
        "num_sequences"] // bs)
    evals = epochs * -(-rcfg["dataset"]["test"]["synthetic"][
        "num_sequences"] // rcfg["test_batch_size"])
    lrs = []
    set_epoch_lr = PredictionEngine.set_epoch_lr

    def recorded(self, epoch):
        lr = set_epoch_lr(self, epoch)
        lrs.append((epoch, {g["label"]: g["lr"]
                            for g in self.optimizer.param_groups}))
        return lr

    PredictionEngine.set_epoch_lr = recorded
    try:
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        runner, history = run(cfg, device.type, run_dir=run_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fused.launch_counts()
    finally:
        PredictionEngine.set_epoch_lr = set_epoch_lr
    eng = runner.engine
    rows = np.asarray(history, dtype=np.float64)
    step_ms = [s * 1e3 for s in eng.train_step_seconds]
    print(f"engine: main.run on {device.type} in {wall:.2f} s, "
          f"{len(step_ms)} steps of {bs} and {evals} eval batches; per "
          f"epoch (epoch, lr, train loss, test loss, per-frame MPJPE) "
          f"{rows.tolist()}; launches {counts}")
    traced = rcfg["engine"]["profile_steps"]
    print(f"engine: wall ms per step, first {step_ms[0]:.3f}, steps 2-"
          f"{traced + 1} under the profiler "
          f"{[round(t, 3) for t in step_ms[1:traced + 1]]}, median of the "
          f"rest {float(np.median(step_ms[traced + 1:])):.3f}")
    print(f"engine: group learning rates per epoch {lrs}")
    check(len(step_ms) == steps, f"{len(step_ms)} train steps, expected "
                                 f"{steps}")
    check(rows.shape == (epochs, 3 + 1 + len(rcfg["setting"]["eval_frame"]))
          and bool(np.all(np.isfinite(rows))),
          "engine slice: non-finite losses or MPJPE")
    for ckpt in ("last.ckpt", "best.ckpt"):
        check(os.path.isfile(os.path.join(run_dir, "checkpoints", ckpt)),
              f"engine slice: {ckpt} was not written")
    want = {k: 0 for k in counts}
    want.update({k: 28 * steps + 7 * evals for k in FORWARD})
    want.update({k: fused.BWD_LAUNCHES * 14 * steps for k in BACKWARD})
    check(counts == want, f"engine slice launched {counts}, expected {want}")
    lr0 = rcfg["engine"]["learn"]["lr"]
    check([e for e, _ in lrs] == list(range(epochs)) and all(
        g["bias"] == 2 * g["base"] and g["base"] == eng.lr_schedule(e)
        for e, g in lrs), f"group learning rates {lrs} (lr {lr0})")
    with open(os.path.join(run_dir, "train_loss.csv")) as f:
        cb_rows = [line.strip().split(",") for line in f if line.strip()]
    print(f"engine: callback CSV {cb_rows}")
    check(cb_rows[0] == ["epoch", "joint", "total"] and len(cb_rows) == 3
          and all(np.isfinite(float(v)) for r in cb_rows[1:] for v in r),
          f"the callback CSV holds {cb_rows}")
    traces = sorted(os.listdir(profile_dir))
    check(len(traces) == 1 and traces[0].endswith(".json"),
          f"the profile directory holds {traces}")
    trace = os.path.join(profile_dir, traces[0])
    trace_mb = os.path.getsize(trace) / 2 ** 20
    tcounts, tsteps = trace_kernel_counts(trace)
    per_step = {"dstd_spatial": 28, "dstd_temporal": 28,
                "dstd_spatial_bwd": 14 * fused.BWD_LAUNCHES,
                "dstd_temporal_bwd": 14 * fused.BWD_LAUNCHES}
    profile_steps = rcfg["engine"]["profile_steps"]
    print(f"engine: trace {traces[0]} ({trace_mb:.1f} MB): kernel events "
          f"{tcounts}, annotations {tsteps}; expected {profile_steps} x "
          f"{per_step}")
    check(tcounts == {k: profile_steps * v for k, v in per_step.items()}
          and tsteps == ["engine.step"] * profile_steps,
          f"the trace holds kernel events {tcounts} and steps {tsteps}")
    os.remove(trace)        # tens of MB; the counts stay in the report
    report["slice"] = dict(wall=wall, history=rows.tolist(),
                           step_ms=step_ms, launches=counts, lrs=lrs,
                           callback_csv=cb_rows, trace_mb=trace_mb,
                           trace_kernels=tcounts, trace_steps=tsteps)

    # 2. resume from a checkpoint in the JAX package's layout of the
    # slice's trained state
    path = os.path.join(out, "jax.ckpt")
    payload = dict(lr=eng.lr, err=float(rows[:, 3].min()),
                   epoch=epochs - 1)
    write_jax_checkpoint(path, eng, payload)
    opts = {k: v for k, v in rcfg["model"].items() if k != "name"}
    other = PredictionEngine(rcfg["engine"], get_model("dstdgcn", **opts),
                             device=device)
    other.init(seed=5)
    got = other.recover(path)
    same_model = all(torch.equal(a, b) for a, b in zip(
        eng.model.state_dict().values(), other.model.state_dict().values()))
    same_moments = all(
        all(torch.equal(torch.as_tensor(eng.optimizer.state[p][k]),
                        torch.as_tensor(other.optimizer.state[q][k]))
            for k in ("exp_avg", "exp_avg_sq", "step"))
        for p, q in zip(eng.model.parameters(), other.model.parameters()))
    back = read_jax_checkpoint(path)[1]
    same_lr = [g["lr"] for g in other.optimizer.param_groups] == [
        g["lr"] for g in eng.optimizer.param_groups]
    ckpt_kb = os.path.getsize(path) / 1024
    print(f"engine: JAX-layout checkpoint ({ckpt_kb:.1f} KB) recovered: "
          f"(epoch, err) {got}; parameters and statistics bit-equal "
          f"{same_model}, Adam moments and steps bit-equal {same_moments}, "
          f"group lrs equal {same_lr}, payload {back}")
    check(same_model and same_moments and same_lr and back == payload
          and got == (payload["epoch"], payload["err"]),
          "the JAX-layout checkpoint did not restore the slice's state")
    train_ds = get_dataset("synthetic", **rcfg["dataset"]["train"])
    arrays = train_ds.arrays()
    batch = [a[:N] for a in arrays[:3]]
    before = fused.launch_counts()
    loss = float(other.train_step(*batch)["total"])
    after = fused.launch_counts()
    resumed = {k: after[k] - before[k] for k in FORWARD + BACKWARD}
    print(f"engine: one step after the resume: loss {loss}, launches "
          f"{resumed}")
    check(np.isfinite(loss) and resumed == {
        **{k: 28 for k in FORWARD},
        **{k: 14 * fused.BWD_LAUNCHES for k in BACKWARD}},
        f"the resumed step: loss {loss}, launches {resumed}")
    report["resume"] = dict(payload=back, recovered=list(got), loss=loss,
                            launches=resumed, kb=ckpt_kb)
    del other

    # 3. remat against no remat at the slice's weights, dropout 0,
    # BatchNorm calibrated: the kernel path bit for bit, then the kernel
    # path with remat against the plain path by phase 7's rules
    engines = {}
    for remat in REMAT_MODES:
        e = PredictionEngine(rcfg["engine"], get_model("dstdgcn", **dict(
            opts, dstdgcn=dict(opts["dstdgcn"], remat=remat))),
            device=device)
        e.init()
        e.model.load_state_dict(eng.model.state_dict())
        calibrate_batchnorm(torch, e.model, e.transform(e.to_device(
            batch[0])))
        e.model.do_in.p = 0.0
        engines[remat] = e
    grads, losses, step_counts = {}, {}, {}
    for remat, e in engines.items():
        before = fused.launch_counts()
        losses[remat] = e.compute_gradients(*batch)["total"]
        after = fused.launch_counts()
        step_counts[remat] = {k: after[k] - before[k]
                              for k in FORWARD + BACKWARD}
        grads[remat] = [p.grad.clone() for p in e.model.parameters()]
    equal = {str(r): bool(torch.equal(losses[r], losses[False])) and all(
        torch.equal(a, b) for a, b in zip(grads[r], grads[False]))
        for r in (True, "dots")}
    print(f"engine: remat against no remat on the kernel path: loss and "
          f"every gradient bit-equal {equal}; launches {step_counts}")
    check(all(equal.values()), f"remat changed the kernel path's loss or "
                               f"gradients: {equal}")
    check(all(step_counts[r][k] == (28 if r else 14) for r in REMAT_MODES
              for k in FORWARD)
          and all(c[k] == 14 * fused.BWD_LAUNCHES for c in
                  step_counts.values() for k in BACKWARD),
          f"remat launches {step_counts}")
    report["remat_equal"] = equal
    report["remat_check"], _ = train_step_check(
        torch, fused, engines[True], rcfg, batch, "engine remat",
        fwd_per_step=28)
    del engines, grads

    # 4. the solver step: gradients by phase 7's rules, then each path's
    # optimizer step against optax's rule in float64
    seng = PredictionEngine(rcfg["engine"], get_model("dstdgcn", **opts),
                            device=device)
    seng.init()
    seng.model.load_state_dict(eng.model.state_dict())
    seng.optimizer.load_state_dict(eng.optimizer.state_dict())
    seng.set_epoch_lr(epochs - 1)
    report["solver_check"], peng = train_step_check(
        torch, fused, seng, rcfg, batch, "engine solver", fwd_per_step=28)
    peng.optimizer.load_state_dict(eng.optimizer.state_dict())
    peng.set_epoch_lr(epochs - 1)
    report["solver_update"] = {
        label: solver_update_check(torch, e, f"engine solver {label}")
        for label, e in (("kernel", seng), ("plain", peng))}
    del seng, peng

    # 5. peak memory (torch.cuda.max_memory_allocated over what is held
    # before the step) and device time of a train step, by remat mode, both
    # paths (the slice's weights, a warm step first)
    memory, device_ms = {}, {}
    for path_name, use_pallas in (("kernel", True), ("plain", False)):
        e = PredictionEngine(rcfg["engine"], get_model(
            "dstdgcn", **dict(opts, use_pallas=use_pallas)), device=device)
        e.init()
        e.model.load_state_dict(eng.model.state_dict())
        for remat in REMAT_MODES:
            set_remat(torch, e.model, remat)
            for n in REMAT_BATCHES:
                b = [a[:n] for a in arrays[:3]]
                e.train_step(*b)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                e.train_step(*b)
                torch.cuda.synchronize()
                memory[(path_name, str(remat), n)] = (
                    torch.cuda.max_memory_allocated() - held) / 2 ** 20
            device_ms[(path_name, str(remat))] = sum(device_profile(
                torch, lambda e=e: e.train_step(*batch), 3).values())
        del e
    for path_name in ("kernel", "plain"):
        for n in REMAT_BATCHES:
            print(f"engine: peak MiB of a batch-{n} train step over the "
                  f"memory held before it, {path_name} path, remat False / "
                  f"True / dots: " + " / ".join(
                      f"{memory[(path_name, str(r), n)]:.1f}"
                      for r in REMAT_MODES))
        print(f"engine: batch-{N} train step device ms, {path_name} path, "
              f"remat False / True / dots: " + " / ".join(
                  f"{device_ms[(path_name, str(r))]:.3f}"
                  for r in REMAT_MODES))
    report["memory_mib"] = {"/".join(map(str, k)): v
                            for k, v in memory.items()}
    report["step_device_ms"] = {"/".join(k): v for k, v in device_ms.items()}

    # 6. time_looped of the float32 spatial op beside the profiler
    args = op_inputs(torch, np, "spatial", 64, 64, device, 12)
    x0, weights = args[0], args[1:]

    def op(h):
        with torch.no_grad():
            return fused.dstd_spatial(h, *weights, agg="right")

    looped_ms = time_looped(op, x0, iters=30, repeats=3) * 1e3
    prof_ms = sum(device_profile(torch, lambda: op(x0), 10).values())
    finite = bool(torch.isfinite(op(x0)).all())
    print(f"engine: time_looped of dstd_spatial (N={N}, 64 -> 64) "
          f"{looped_ms:.4f} ms a call (CUDA events over 30 chained calls, "
          f"best of 3), profiler device {prof_ms:.4f} ms a call; output "
          f"finite {finite}")
    check(looped_ms > 0 and prof_ms > 0, "time_looped or the profiler "
                                         "measured nothing")
    report["timing"] = dict(time_looped_ms=looped_ms, profiler_ms=prof_ms)

    # 7. visualize-debug on a seeded H36M tree of the debug action
    data = os.path.join(out, "data")
    tree = write_h36m_tree(os.path.join(data, "h36m"), seed=17,
                           actions=["walking"], frames=160, test_frames=300)
    vcfg = configs.set_data_paths(configs.real_h36m_train(), tree, tree)
    vcfg["mode"] = "visualize-debug"
    vdir = os.path.join(out, "visualize")
    vrunner, _ = run(vcfg, device.type, run_dir=vdir)
    files = sorted(os.listdir(os.path.join(vdir, "visualize")))
    present = {m: find_spec(m) is not None for m in ("matplotlib",
                                                     "imageio")}
    want_files = sorted(f"Awalking_S{i}.{ext}" for i in range(1, 9)
                        for ext in ("gif", "png")) if all(
        present.values()) else []
    print(f"engine: visualize-debug: matplotlib / imageio present "
          f"{present}; {len(files)} files written "
          f"({'none without them' if not want_files else 'GIF and PNG'})")
    check(vrunner.engine is None and files == want_files,
          f"visualize-debug wrote {files}, expected {want_files}")
    shutil.rmtree(data)
    report["visualize"] = dict(present=present, files=files)
    report["seconds"] = time.perf_counter() - start
    print(f"engine: the phase took {report['seconds']:.1f} s")
    return report, counts


# -- phase 13: the parallel slice ------------------------------------------

#: phase 13's two-rank run: processes on the one card over gloo, train
#: steps an epoch (2 epochs), and seconds before its ranks are killed
DP_RANKS = 2
DP_STEPS = 4
DP_TIMEOUT = 420
#: the environment of a launch (parallel/distributed.py)
LAUNCH_VARS = ("DSTDGCN_COORDINATOR", "DSTDGCN_NUM_PROCESSES",
               "DSTDGCN_PROCESS_ID", "DSTDGCN_BACKEND")


def free_port():
    """A TCP port of this host that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_env(coordinator, world, rank, backend=None):
    """The ``DSTDGCN_*`` variables of rank ``rank`` of ``world``: the launch
    recipe a user follows (``parallel/distributed.py``)."""
    env = dict(DSTDGCN_COORDINATOR=coordinator,
               DSTDGCN_NUM_PROCESSES=str(world),
               DSTDGCN_PROCESS_ID=str(rank))
    if backend:
        env["DSTDGCN_BACKEND"] = backend
    return env


def start_ranks(args, world, coordinator, backend=None, env=None):
    """Start ``chip_smoke.py ARGS`` as the ranks of a launch on this host,
    each with its ``DSTDGCN_*`` variables (and ``env``)."""
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    base.update(env or {},
                PYTHONPATH=REPO + os.pathsep + base.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args], cwd=REPO,
        env=dict(base, **launch_env(coordinator, world, r, backend)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish_ranks(procs, deadline):
    """Each process's (exit code, output), waiting until ``deadline``
    (``time.monotonic``) and killing what still runs then; every process
    is ended on return or on a raise."""
    out = []
    try:
        for p in procs:
            try:
                log = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))[0]
            except subprocess.TimeoutExpired:
                p.kill()
                log = p.communicate()[0] + "\n(killed at the time limit)"
            out.append((p.returncode, log))
    finally:
        end_all(procs)
    return out


def end_all(procs):
    """Kill every process of ``procs`` that still runs."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def dp_config(steps=None):
    """``synthetic_h36m_dp_train``, ``steps`` train steps an epoch when
    given."""
    from dstdgcn_tpu_torch import configs
    cfg = configs.synthetic_h36m_dp_train()
    if steps is not None:
        cfg["engine"]["max_iter"] = steps
    return cfg


def rank_report(log, tag="dp_rank"):
    """The report a rank printed on its ``tag`` line (phase 13's
    ``dp_rank``, phase 14's ``axis_rank``)."""
    for line in log.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise SmokeFailure("a rank printed no report:\n" + log[-4000:])


def files_under(root):
    """Every file under ``root``, relative, sorted (directories left out)."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def allreduce_ms(torch, dist, group, numel, device, iters=20):
    """CUDA-event ms of one all-reduce of ``numel`` float32 values over
    ``group`` (a step's flat gradient and losses), after 3 warm-up
    calls."""
    buf = torch.ones(numel, device=device)
    for _ in range(3):
        dist.all_reduce(buf, group=group)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        dist.all_reduce(buf, group=group)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def step_numel(model):
    """Values in a step's flat all-reduce: the gradients and the two
    losses (``joint``, ``total``)."""
    return sum(p.numel() for p in model.parameters()) + 2


#: values in one BatchNorm's statistics all-reduce (mean and mean_sq of
#: (V, C)); a step takes 30 of them forward and 30 backward (15 BatchNorms,
#: two passes)
BN_NUMEL = 2 * V * 64


def shard_checks(torch, np, plain, shard, mesh, device):
    """The three ``parallel/shard.py`` ops on ``mesh`` (world size 1: the
    whole joint axis on this rank) against the plain ops on the card at the
    slice's shapes: max |op - plain| within 1e-5 max(max |plain|, 1)."""
    fns = dict(dstd_spatial_edge_partitioned=("spatial", plain.dstd_spatial),
               dstd_spatial_ring=("spatial", plain.dstd_spatial),
               dstd_temporal_edge_partitioned=("temporal",
                                               plain.dstd_temporal))
    lines = []
    for name, (mode, ref) in fns.items():
        args = op_inputs(torch, np, mode, 64, 64, device, seed=19)
        with torch.no_grad():
            got = getattr(shard, name)(mesh, *args)
            want = ref(*args)
        err = float((got - want).abs().max())
        norm = err / max(float(want.abs().max()), 1.0)
        lines.append(dict(op=name, max_abs_err=err, max_norm_err=norm))
        print("parallel: world 1 " + json.dumps(lines[-1]))
        check(norm <= 1e-5, f"{name} at world size 1: {norm} of "
                            "max(|plain|, 1) from the plain op")
    return lines


def shard_pair_checks(torch, np, plain, shard, mesh, device):
    """The two edge-partitioned ops (``parallel/shard.py``) on this rank's
    joint slice of the slice's shapes (C = 64), ranks on the card over
    gloo, whose CUDA tensors take the all-gather and the reduce-scatter
    (the ring's sends they do not): the gathered output and x gradient
    (seeded cotangent) against the plain op and its autograd, within 1e-5
    of max(|plain|, 1)."""
    from dstdgcn_tpu_torch.parallel.collectives import all_gather
    n, i, group = mesh.shape["graph"], mesh.index("graph"), \
        mesh.group("graph")
    cut = slice(i * (V // n), (i + 1) * (V // n))
    g = torch.from_numpy(np.random.RandomState(20).randn(
        N, T, V, 64).astype(np.float32)).to(device)
    lines = []
    for name, mode, ref in (
            ("dstd_spatial_edge_partitioned", "spatial", plain.dstd_spatial),
            ("dstd_temporal_edge_partitioned", "temporal",
             plain.dstd_temporal)):
        args = op_inputs(torch, np, mode, 64, 64, device, seed=19)
        x = args[0][:, :, cut].clone().requires_grad_()
        y = getattr(shard, name)(mesh, x, *args[1:])
        (y * g[:, :, cut]).sum().backward()
        got = all_gather(y.detach(), 2, group)
        dx = all_gather(x.grad, 2, group)
        xw = args[0].clone().requires_grad_()
        want = ref(xw, *args[1:])
        (want * g).sum().backward()
        line = dict(op=name, ranks=n)
        for key, a, b in (("out", got, want.detach()), ("dx", dx, xw.grad)):
            line[key] = float((a - b).abs().max()) / max(
                float(b.abs().max()), 1.0)
        line["ok"] = max(line["out"], line["dx"]) <= 1e-5
        lines.append(line)
    return lines


def dp_step_check(torch, np, fused, engine, rcfg, rank, world,
                  label="parallel", step=None):
    """One step of the engine on a mesh on this rank's share of a global
    batch of ``train_batch_size`` (its data index's), dropout 0 and
    BatchNorm calibrated: on rank 0 by phase 7's rules
    (``train_step_check``: the plain path and float64 at the global batch,
    the launches of one step) and, loss within LOSS_RTOL, against the
    single-process path of the config on the whole batch; the other ranks
    take the step's collectives with it (BatchNorm statistics, the flat
    gradient all-reduce and, under a graph or model axis, the gathers).
    ``step`` (default ``engine.compute_gradients``) runs the rank's
    step."""
    from dstdgcn_tpu_torch.data import get_dataset
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.models import get_model
    train_ds = get_dataset("synthetic", **rcfg["dataset"]["train"])
    batch = [a[:rcfg["train_batch_size"]] for a in train_ds.arrays()[:3]]
    i, n = engine.mesh.index("data"), engine.mesh.shape["data"]
    share = [a[i::n] for a in batch]

    def dp_step():
        return (step or engine.compute_gradients)(*share)

    if rank:
        engine.model.do_in.p = 0.0
        return dict(loss=float(dp_step()["total"]))
    routed = bool(rcfg["model"].get("use_pallas"))
    report, _ = train_step_check(torch, fused, engine, rcfg, batch,
                                 f"{label}: rank 0 of {world}",
                                 kernel_step=dp_step, routed=routed)
    topts = {k: v for k, v in rcfg["model"].items() if k != "name"}
    kmodel = get_model(rcfg["model"]["name"], **topts)
    keng = PredictionEngine(rcfg["engine"], kmodel, device=engine.device)
    keng.init()
    kmodel.load_state_dict(engine.model.state_dict())
    kmodel.do_in.p = 0.0
    single = float(keng.compute_gradients(*batch)["total"])
    rel = abs(report["loss"] - single) / abs(single)
    print(f"{label}: {world}-rank step loss {report['loss']} against the "
          f"single-process {'kernel' if routed else 'plain'} path {single} "
          f"(rel {rel:.3g})")
    check(rel <= LOSS_RTOL, f"the {world}-rank step's loss {report['loss']} "
                            f"against one process's {single}")
    report.update(single_loss=single, single_rel=rel)
    return report


#: the collectives phase 13 tries on CUDA tensors with two ranks on the one
#: card, each group of ops in a launch of its own (an op a backend does not
#: take may abort its process): under NCCL, and under gloo the three data
#: parallelism uses, then each of the three the graph-axis ops use
PROBES = (("nccl", ("all_reduce",)),
          ("gloo", ("all_reduce", "broadcast", "barrier")),
          ("gloo", ("all_gather_into_tensor",)),
          ("gloo", ("reduce_scatter_tensor",)),
          ("gloo", ("batch_isend_irecv",)))


def probe_rank_main(ops):
    """One rank of a phase 13 probe (``chip_smoke.py --probe-rank OP,...``,
    the backend from ``DSTDGCN_BACKEND``): each op on CUDA tensors of this
    rank's device, its outcome printed as soon as it is known
    (``probe_op {op: "ok" or the error's first line}``); no teardown."""
    import torch
    import torch.distributed as dist
    from dstdgcn_tpu_torch.parallel import distributed
    distributed.initialize(None, device="cuda")
    dev = distributed.device_of("cuda")
    me, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(me + 1), device=dev)

    def p2p():
        out = torch.empty_like(x)
        ops_ = [dist.P2POp(dist.isend, x, (me + 1) % world),
                dist.P2POp(dist.irecv, out, (me - 1) % world)]
        for req in dist.batch_isend_irecv(ops_):
            req.wait()

    calls = dict(
        all_reduce=lambda: dist.all_reduce(x.clone()),
        broadcast=lambda: dist.broadcast(x.clone(), src=0),
        barrier=dist.barrier,
        all_gather_into_tensor=lambda: dist.all_gather_into_tensor(
            x.new_empty(4 * world), x),
        reduce_scatter_tensor=lambda: dist.reduce_scatter_tensor(
            x.new_empty(4 // world), x),
        batch_isend_irecv=p2p)
    for op in ops:
        print(f"probe_start {op}", flush=True)
        try:
            calls[op]()
            torch.cuda.synchronize(dev)
            result = "ok"
        except Exception as e:  # the backend's refusal is the finding
            result = (str(e).strip().splitlines() or [type(e).__name__])[0]
        print("probe_op " + json.dumps({op: result[:200]}), flush=True)
    os._exit(0)                 # a probe's group needs no teardown


def probe_outcome(log, returncode):
    """Each op's outcome in a probe rank's ``log``: its ``probe_op`` line,
    or for an op started and never ended, how the process ended (the last
    line of its output); NCCL's ``Duplicate GPU`` warning when printed."""
    out, started = {}, None
    for line in log.splitlines():
        if line.startswith("probe_start "):
            started = line.split(" ", 1)[1]
        elif line.startswith("probe_op "):
            out.update(json.loads(line[len("probe_op "):]))
            started = None
        elif "Duplicate GPU" in line:
            out["nccl_warn"] = line.strip()[-200:]
    if started is not None:
        tail = [ln for ln in log.splitlines() if ln.strip()][-1:]
        out[started] = (f"process ended ({returncode}): "
                        + (tail[0].strip()[:200] if tail else ""))
    return out


def backend_probes(timeout=120):
    """Run every probe of PROBES at once, each on two ranks of the one
    card; returns [(backend, ops, [each rank's outcomes])].  A finding,
    not a check: NCCL takes one rank a GPU, gloo's CUDA tensors a subset
    of the collectives."""
    launches = []
    try:
        for backend, ops in PROBES:
            launches.append((backend, ops, start_ranks(
                ["--probe-rank", ",".join(ops)], 2,
                f"127.0.0.1:{free_port()}", backend,
                env=dict(NCCL_DEBUG="WARN"))))
        deadline = time.monotonic() + timeout
        return [(backend, list(ops),
                 [probe_outcome(log, rc)
                  for rc, log in finish_ranks(procs, deadline)])
                for backend, ops, procs in launches]
    finally:
        end_all([p for _, _, procs in launches for p in procs])


def dp_rank_main():
    """One rank of phase 13's two-rank run (``chip_smoke.py --dp-rank``,
    started by :func:`parallel_phase` with the ``DSTDGCN_*`` variables):
    ``main.run`` on ``synthetic_h36m_dp_train`` for 2 epochs of DP_STEPS
    steps, the all-reduce's time, one step against the single-process
    paths; prints its report on a ``dp_rank`` line."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from dstdgcn_tpu_torch.kernels import fused
    from dstdgcn_tpu_torch.main import run
    from dstdgcn_tpu_torch.ops import dstd as plain
    from dstdgcn_tpu_torch.parallel import make_mesh, shard
    from dstdgcn_tpu_torch.utils.config import resolve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["DSTDGCN_PROCESS_ID"])
    run_dir = os.path.join(OUT_DIR, f"dp{DP_RANKS}_rank{rank}")
    cfg = dp_config(DP_STEPS)
    try:
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        runner, history = run(cfg, "cuda", run_dir=run_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng = runner.engine
        report = dict(
            rank=rank, world=dist.get_world_size(),
            backend=dist.get_backend(), device=str(eng.device),
            mesh=eng.mesh.shape, history=np.asarray(history).tolist(),
            launches=fused.launch_counts(),
            step_seconds=eng.train_step_seconds, wall=wall,
            files=files_under(run_dir),
            allreduce_ms=allreduce_ms(torch, dist, eng.mesh.group("data"),
                                      step_numel(eng.model), eng.device),
            bn_allreduce_ms=allreduce_ms(torch, dist,
                                         eng.mesh.group("data"), BN_NUMEL,
                                         eng.device))
        report["step_check"] = dp_step_check(
            torch, np, fused, eng, resolve(cfg), rank, report["world"])
        report["shard_checks"] = shard_pair_checks(
            torch, np, plain, shard, make_mesh(graph=report["world"]),
            eng.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print("dp_rank " + json.dumps(report), flush=True)


def parallel_phase(torch, np, fused, plain, device, train_rows, train_counts):
    """Phase 13: (a) ``main.run`` on ``synthetic_h36m_dp_train`` under a
    one-rank NCCL group, bit-equal to phase 7 (``train_rows``,
    ``train_counts``), and the three ``shard.py`` ops at world size 1;
    (b) DP_RANKS ranks on the one card over gloo, each a child process
    (:func:`dp_rank_main`); (c) the backend probes
    (:func:`backend_probes`).  Returns (report, launch counts: ``world1``
    and each rank's)."""
    import torch.distributed as dist
    from dstdgcn_tpu_torch.main import run
    from dstdgcn_tpu_torch.parallel import make_mesh, shard
    from dstdgcn_tpu_torch.utils.config import resolve
    t_phase = time.perf_counter()
    rcfg = resolve(dp_config())
    epochs = rcfg["epoch"]
    n_train = rcfg["dataset"]["train"]["synthetic"]["num_sequences"]
    n_test = rcfg["dataset"]["test"]["synthetic"]["num_sequences"]
    evals = epochs * -(-n_test // rcfg["test_batch_size"])

    # (a) world size 1: the whole parallel code path under NCCL
    env = launch_env(f"127.0.0.1:{free_port()}", 1, 0)
    saved = {k: os.environ.get(k) for k in LAUNCH_VARS}
    os.environ.update(env)
    try:
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        runner, history = run(dp_config(), "cuda",
                              run_dir=os.path.join(OUT_DIR, "dp1"))
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        counts1 = fused.launch_counts()
        eng = runner.engine
        rows1 = np.asarray(history, dtype=np.float64)
        backend = dist.get_backend()
        print(f"parallel: world 1 ({backend}, mesh {eng.mesh.shape}) "
              f"main.run in {wall1:.2f} s; per epoch {rows1.tolist()}")
        check(backend == "nccl" and dist.get_world_size() == 1
              and eng.mesh.shape == {"data": 1, "graph": 1},
              f"world size 1 ran on {backend}, mesh {eng.mesh.shape}")
        check(np.array_equal(rows1, train_rows),
              f"world size 1 {rows1.tolist()} is not phase 7's "
              f"{train_rows.tolist()} bit for bit")
        check(counts1 == train_counts, f"world size 1 launched {counts1}, "
                                       f"phase 7 {train_counts}")
        step1 = eng.train_step_seconds
        shard_lines = shard_checks(torch, np, plain, shard,
                                   make_mesh(graph=1), device)
        nccl_ms = allreduce_ms(torch, dist, eng.mesh.group("data"),
                               step_numel(eng.model), eng.device)
        nccl_bn_ms = allreduce_ms(torch, dist, eng.mesh.group("data"),
                                  BN_NUMEL, eng.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # (b) DP_RANKS ranks on the one card over gloo, the user's recipe
    t0 = time.perf_counter()
    ended = finish_ranks(
        start_ranks(["--dp-rank"], DP_RANKS, f"127.0.0.1:{free_port()}",
                    "gloo"), time.monotonic() + DP_TIMEOUT)
    wall2 = time.perf_counter() - t0
    for r, (rc, log) in enumerate(ended):
        with open(os.path.join(OUT_DIR, f"dp_rank{r}.log"), "w") as f:
            f.write(log)
        check(rc == 0, f"rank {r} of {DP_RANKS} exited {rc}:\n"
                       f"{log[-4000:]}")
    reports = [rank_report(log) for _, log in ended]
    steps = epochs * min(-(-n_train // rcfg["train_batch_size"]), DP_STEPS)
    want = {name: 14 * steps + 7 * evals for name in FORWARD}
    want.update({name: fused.BWD_LAUNCHES * 14 * steps
                 for name in BACKWARD})
    want.update({name: 0 for name in CHAINS + BF16_FORWARD + BF16_BACKWARD
                 + BF16_CHAINS})
    for rep in reports:
        r = rep["rank"]
        rows = np.asarray(rep["history"], dtype=np.float64)
        print(f"parallel: rank {r} of {rep['world']} ({rep['backend']}, "
              f"{rep['device']}, mesh {rep['mesh']}) per epoch "
              f"{rows.tolist()}; launches {rep['launches']}; files "
              f"{rep['files']}")
        check(rep["world"] == DP_RANKS and rep["backend"] == "gloo"
              and rep["mesh"] == {"data": DP_RANKS, "graph": 1},
              f"rank {r} ran {rep['world']} ranks on {rep['backend']}")
        check(rep["launches"] == want,
              f"rank {r} launched {rep['launches']}, expected {want} "
              f"({steps} steps of {N // DP_RANKS}, {evals} eval batches)")
        check(rows.shape == (epochs, 4 + len(rcfg["setting"]["eval_frame"]))
              and bool(np.all(np.isfinite(rows))),
              f"rank {r}: non-finite losses or MPJPE {rows.tolist()}")
        check(np.array_equal(rows, np.asarray(reports[0]["history"])),
              f"rank {r} reports other losses than rank 0")
    written = reports[0]["files"]
    for name in ("training_loss.csv", os.path.join("checkpoints", "last.ckpt"),
                 os.path.join("checkpoints", "best.ckpt")):
        check(name in written, f"rank 0 did not write {name}: {written}")
    with open(os.path.join(OUT_DIR, f"dp{DP_RANKS}_rank0",
                           "training_loss.csv")) as f:
        csv_rows = [line for line in f if line.strip()]
    check(len(csv_rows) == epochs + 2, f"rank 0's csv holds {csv_rows}")
    for rep in reports[1:]:
        check(not rep["files"], f"rank {rep['rank']} wrote {rep['files']}")
    for rep in reports:
        for line in rep["shard_checks"]:
            print(f"parallel: rank {rep['rank']} of {DP_RANKS} (gloo) "
                  + json.dumps(line))
            check(line["ok"], f"{line['op']} over {DP_RANKS} gloo ranks on "
                              f"the card: {line}")
    step2 = reports[0]["step_seconds"]
    gloo_ms = [rep["allreduce_ms"] for rep in reports]
    gloo_bn_ms = [rep["bn_allreduce_ms"] for rep in reports]
    print(f"parallel: train step wall ms, median after the first: 1 rank "
          f"(nccl) {float(np.median(step1[1:])) * 1e3:.3f}, {DP_RANKS} ranks "
          f"(gloo, rank 0) {float(np.median(step2[1:])) * 1e3:.3f}")
    print(f"parallel: a step's gradient all-reduce ({step_numel(eng.model)} "
          f"float32), CUDA-event ms: nccl 1 rank {nccl_ms:.4f}; gloo "
          f"{DP_RANKS} ranks {', '.join(f'{m:.4f}' for m in gloo_ms)}")
    print(f"parallel: one BatchNorm statistics all-reduce ({BN_NUMEL} "
          f"float32, 60 a step over 2 ranks, none at 1), CUDA-event ms: nccl "
          f"1 rank "
          f"{nccl_bn_ms:.4f}; gloo {DP_RANKS} ranks "
          f"{', '.join(f'{m:.4f}' for m in gloo_bn_ms)}")
    # what the card runs with two ranks under each backend
    facts = backend_probes()
    for backend, _, outcomes in facts:
        for r, res in enumerate(outcomes):
            print(f"parallel: two ranks on the card, {backend}, rank {r}: "
                  + json.dumps(res))
    seconds = time.perf_counter() - t_phase
    print(f"parallel: phase 13 {seconds:.1f} s ({DP_RANKS}-rank launch "
          f"{wall2:.1f} s)")
    counts = dict(world1=counts1, **{f"rank{rep['rank']}": rep["launches"]
                                     for rep in reports})
    return dict(world1=dict(history=rows1.tolist(), launches=counts1,
                            step_seconds=step1, wall=wall1,
                            shard_checks=shard_lines,
                            allreduce_ms=nccl_ms, bn_allreduce_ms=nccl_bn_ms),
                ranks=reports, launch_seconds=wall2, card_facts=facts,
                step_check=reports[0]["step_check"],
                seconds=seconds), counts


# -- phase 14: the graph and model axes -----------------------------------

#: phase 14's configs (``synthetic_h36m_<name>_train``), each run by
#: AXIS_RANKS gloo ranks on the one card for one epoch of AXIS_STEPS train
#: steps; seconds before the ranks are killed
AXIS_CONFIGS = ("graph", "model", "fast_graph")
AXIS_RANKS = 2
AXIS_STEPS = 3
AXIS_TIMEOUT = 300
#: the (mode, Ci, Co) the model axis of 2 gives the one-op kernels that no
#: earlier phase does: the output columns of 64 halved
AXIS_SHAPES = (("spatial", 6, 32), ("spatial", 64, 32),
               ("temporal", 64, 32))
#: the torch.distributed calls a step's collectives go through
COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "broadcast", "barrier")


def axis_config(name):
    """``synthetic_h36m_<name>_train`` for one epoch of AXIS_STEPS steps."""
    from dstdgcn_tpu_torch import configs
    cfg = getattr(configs, f"synthetic_h36m_{name}_train")()
    cfg["epoch"] = 1
    cfg["engine"]["max_iter"] = AXIS_STEPS
    return cfg


def axis_launches(fused, rcfg, world):
    """Each kernel's launches on one rank of ``world`` over a run of
    ``rcfg``: every op is one launch of its kernel on each rank whatever
    the axis (all joints of the rank's data share under ``graph``, the
    rank's output columns under ``model``), none on the plain path."""
    routed = int(bool(rcfg["model"].get("use_pallas")))
    n_train = rcfg["dataset"]["train"]["synthetic"]["num_sequences"]
    n_test = rcfg["dataset"]["test"]["synthetic"]["num_sequences"]
    steps = rcfg["epoch"] * min(n_train // rcfg["train_batch_size"],
                                rcfg["engine"]["max_iter"])
    evals = rcfg["epoch"] * (n_test // rcfg["test_batch_size"] if world > 1
                             else -(-n_test // rcfg["test_batch_size"]))
    want = {name: routed * (14 * steps + 7 * evals) for name in FORWARD}
    want.update({name: routed * fused.BWD_LAUNCHES * 14 * steps
                 for name in BACKWARD})
    want.update({name: 0 for name in CHAINS + BF16_FORWARD + BF16_BACKWARD
                 + BF16_CHAINS})
    return want


class CountedCollectives:
    """Counts the calls of each of COLLECTIVES, and the float32 values of
    their first tensor argument, while entered (the functions of
    ``torch.distributed`` wrapped, every thread: autograd's too)."""

    def __init__(self, dist):
        self.dist = dist
        self.counts = {}

    def __enter__(self):
        self.saved = {name: getattr(self.dist, name) for name in COLLECTIVES}
        for name, fn in self.saved.items():
            setattr(self.dist, name, self._wrap(name, fn))
        return self.counts

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            entry = self.counts.setdefault(name, dict(calls=0, values=0))
            entry["calls"] += 1
            if args and hasattr(args[0], "numel"):
                entry["values"] += int(args[0].numel())
            return fn(*args, **kwargs)
        return call

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def axis_eval_check(torch, np, fused, engine, rcfg):
    """``engine.test`` under the mesh on the config's test split (the
    rank's data share of each batch) and, on rank 0, one process with the
    same state on the whole batches: the per-frame MPJPE of both.  On the
    kernel path the sweep once more with ``engine.fused_inference``: the
    whole-encoder kernel runs whole on each rank under the mesh, one launch
    a batch, within 1e-4 relative of the standard sweep (phase 5's
    rule)."""
    from dstdgcn_tpu_torch.data import Loader, get_dataset
    from dstdgcn_tpu_torch.engine import PredictionEngine
    from dstdgcn_tpu_torch.models import get_model
    import torch.distributed as dist
    setting = rcfg["setting"]
    ds = get_dataset("synthetic", **rcfg["dataset"]["test"])
    mesh = engine.mesh
    # the runner's arguments (runner/simple_runner.py::_test_once)
    kw = dict(input_n=setting["input_n"],
              eval_frame=np.asarray(setting["eval_frame"]),
              dim_used=np.asarray(setting["dim_used"]),
              joint_to_ignore=np.asarray(setting["joint_to_ignore"]),
              joint_equal=np.asarray(setting["joint_to_equal"]),
              time_tsfm=ds.time_tsfm)
    split = Loader(ds.arrays(), rcfg["test_batch_size"], drop_last=True,
                   process_index=mesh.index("data"),
                   process_count=mesh.shape["data"])
    _, got = engine.test(split, **kw)
    out = dict(mesh=got.tolist())
    if rcfg["model"].get("use_pallas"):
        before = fused.launch_counts()["dstd_encoder_chain"]
        engine.fused_inference = True
        try:
            _, fz = engine.test(split, **kw)
        finally:
            engine.fused_inference = False
        launches = fused.launch_counts()["dstd_encoder_chain"] - before
        rel = float(np.max(np.abs(fz - got) / np.abs(got)))
        out.update(fused=fz.tolist(), fused_launches=launches, fused_rel=rel,
                   fused_ok=rel <= 1e-4 and launches == len(split))
    if dist.get_rank() == 0:
        topts = {k: v for k, v in rcfg["model"].items() if k != "name"}
        one = PredictionEngine(rcfg["engine"], get_model(
            rcfg["model"]["name"], **topts), device=engine.device)
        one.init()
        one.model.load_state_dict(engine.model.state_dict())
        _, want = one.test(Loader(ds.arrays(), rcfg["test_batch_size"],
                                  drop_last=True), **kw)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        out.update(one=want.tolist(), max_rel=rel, ok=rel <= 1e-4)
    return out


def axis_rank_main():
    """One rank of phase 14's launch (``chip_smoke.py --axis-rank``,
    started by :func:`axis_phase` with the ``DSTDGCN_*`` variables): for
    each of AXIS_CONFIGS ``main.run`` for one epoch of AXIS_STEPS steps,
    the eval sweep under the mesh against one process, one step against
    the single-process paths with the collectives it issues counted;
    prints its reports on an ``axis_rank`` line."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from dstdgcn_tpu_torch.kernels import fused
    from dstdgcn_tpu_torch.main import run
    from dstdgcn_tpu_torch.utils.config import resolve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["DSTDGCN_PROCESS_ID"])
    reports = {}
    try:
        for name in AXIS_CONFIGS:
            cfg = axis_config(name)
            run_dir = os.path.join(OUT_DIR, f"axis_{name}_rank{rank}")
            fused.reset_launch_counts()
            t0 = time.perf_counter()
            runner, history = run(cfg, "cuda", run_dir=run_dir)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            eng = runner.engine
            rcfg = resolve(cfg)
            rep = dict(rank=rank, world=dist.get_world_size(),
                       backend=dist.get_backend(), device=str(eng.device),
                       mesh=eng.mesh.shape,
                       history=np.asarray(history).tolist(),
                       launches=fused.launch_counts(),
                       step_seconds=eng.train_step_seconds, wall=wall,
                       files=files_under(run_dir))
            rep["eval"] = axis_eval_check(torch, np, fused, eng, rcfg)
            counted = {}

            def step(*share):
                with CountedCollectives(dist) as counts:
                    out = eng.compute_gradients(*share)
                    torch.cuda.synchronize()
                counted.update(counts)
                return out

            rep["step_check"] = dp_step_check(
                torch, np, fused, eng, rcfg, rank, rep["world"],
                label=f"axes {name}", step=step)
            rep["collectives"] = counted
            reports[name] = rep
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print("axis_rank " + json.dumps(reports), flush=True)


def axis_phase(torch, np, fused, plain, plain_bwd, device):
    """Phase 14: the one-op kernels at the model axis's new shapes
    (AXIS_SHAPES) by phase 3's rules, then AXIS_RANKS ranks on the one
    card over gloo, each a child process (:func:`axis_rank_main`) running
    every config of AXIS_CONFIGS.  Returns (report, launch counts: each
    config's, each rank's)."""
    from dstdgcn_tpu_torch.utils.config import resolve
    t_phase = time.perf_counter()
    op_lines = real_op_checks(torch, np, fused, plain, plain_bwd, device,
                              "model axis", T, V, AXIS_SHAPES, tag="axes")
    t0 = time.perf_counter()
    ended = finish_ranks(
        start_ranks(["--axis-rank"], AXIS_RANKS, f"127.0.0.1:{free_port()}",
                    "gloo"), time.monotonic() + AXIS_TIMEOUT)
    wall = time.perf_counter() - t0
    for r, (rc, log) in enumerate(ended):
        with open(os.path.join(OUT_DIR, f"axis_rank{r}.log"), "w") as f:
            f.write(log)
        check(rc == 0, f"phase 14: rank {r} of {AXIS_RANKS} exited {rc}:\n"
                       f"{log[-4000:]}")
    reports = [rank_report(log, "axis_rank") for _, log in ended]
    counts, summary = {}, {}
    for name in AXIS_CONFIGS:
        rcfg = resolve(axis_config(name))
        want_mesh = {"data": AXIS_RANKS // 2, "graph": 1}
        want_mesh.update({k: v for k, v in rcfg["parallel"].items()
                          if k in ("graph", "model")})
        want = axis_launches(fused, rcfg, AXIS_RANKS)
        reps = [rep[name] for rep in reports]
        for rep in reps:
            r = rep["rank"]
            rows = np.asarray(rep["history"], dtype=np.float64)
            walls = rep["step_seconds"]
            print(f"axes {name}: rank {r} of {rep['world']} "
                  f"({rep['backend']}, {rep['device']}, mesh {rep['mesh']}) "
                  f"per epoch {rows.tolist()}; launches {rep['launches']}; "
                  f"step wall ms {[round(t * 1e3, 3) for t in walls]}; "
                  f"files {rep['files']}")
            check(rep["world"] == AXIS_RANKS and rep["backend"] == "gloo"
                  and rep["mesh"] == want_mesh,
                  f"axes {name}: rank {r} ran mesh {rep['mesh']} of "
                  f"{rep['world']} on {rep['backend']}")
            check(rep["launches"] == want,
                  f"axes {name}: rank {r} launched {rep['launches']}, "
                  f"expected {want}")
            check(bool(np.all(np.isfinite(rows))),
                  f"axes {name}: rank {r}: non-finite {rows.tolist()}")
            check(np.array_equal(rows, np.asarray(reps[0]["history"])),
                  f"axes {name}: rank {r} reports other losses than rank 0")
            check(rep["eval"]["mesh"] == reps[0]["eval"]["mesh"],
                  f"axes {name}: rank {r} evaluates otherwise than rank 0")
            if "fused" in rep["eval"]:
                print(f"axes {name}: rank {r} fused eval "
                      f"{rep['eval']['fused']} (rel "
                      f"{rep['eval']['fused_rel']:.3g} of the standard "
                      f"sweep), {rep['eval']['fused_launches']} "
                      "dstd_encoder_chain launches")
                check(rep["eval"]["fused_ok"],
                      f"axes {name}: rank {r} fused eval {rep['eval']}")
            print(f"axes {name}: rank {r} one step's collectives "
                  + json.dumps(rep["collectives"]))
        ev, sc = reps[0]["eval"], reps[0]["step_check"]
        print(f"axes {name}: eval MPJPE under the mesh {ev['mesh']} vs one "
              f"process {ev['one']} (max rel {ev['max_rel']:.3g})")
        check(ev["ok"], f"axes {name}: eval MPJPE {ev['mesh']} vs one "
                        f"process {ev['one']}")
        check("training_loss.csv" in reps[0]["files"]
              and os.path.join("checkpoints", "last.ckpt") in reps[0]["files"],
              f"axes {name}: rank 0 wrote {reps[0]['files']}")
        for rep in reps[1:]:
            check(not rep["files"], f"axes {name}: rank {rep['rank']} "
                                    f"wrote {rep['files']}")
        median = [float(np.median(rep["step_seconds"][1:])) * 1e3
                  for rep in reps]
        print(f"axes {name}: train step wall ms, median after the first, "
              f"per rank {median}")
        counts[name] = {f"rank{rep['rank']}": rep["launches"] for rep in reps}
        summary[name] = dict(
            mesh=reps[0]["mesh"], launches=want, step_median_ms=median,
            step_seconds=[rep["step_seconds"] for rep in reps],
            collectives=reps[0]["collectives"], eval=ev,
            loss=sc["loss"], single_loss=sc["single_loss"],
            loss_rel=sc["single_rel"], worst_grad=sc["worst_grad"],
            worst_param=sc["worst_param"], history=reps[0]["history"])
    seconds = time.perf_counter() - t_phase
    print(f"axes: phase 14 {seconds:.1f} s ({AXIS_RANKS}-rank launch "
          f"{wall:.1f} s)")
    return dict(op_checks=op_lines, configs=summary, launch_seconds=wall,
                seconds=seconds), counts


# -- phase 15: the remaining configurations ---------------------------------

#: the JAX package's TPU profiles phase 15 trains and serves in bf16 at
#: batch 128 (``configs.real_<name>_tpu_train``) on phase 11's seeded trees
PROFILES = ("cmu", "3dpw")


def profile_launches(fused, model_cfg, steps, evals, bf16=False,
                     fused_eval=False):
    """Each kernel's launches over ``steps`` train steps and ``evals`` eval
    batches of a model of ``model_cfg`` on the kernel path: each op of
    ``forward_shapes`` one launch of its one-op kernel a forward, a train
    step two forwards and as many backward calls, at bf16 the bf16
    variants; with ``fused_eval`` the eval batches go through the fused
    path: the whole-encoder kernel once a batch and, at float32, the in and
    out layers' 2 + 2 one-op launches (at bf16 those run the plain ops)."""
    per_fwd = sum(mode == "spatial" for mode, _, _ in
                  forward_shapes(model_cfg))
    fwd, bwd = ((BF16_FORWARD, BF16_BACKWARD) if bf16
                else (FORWARD, BACKWARD))
    want = dict.fromkeys(fused.launch_counts(), 0)
    want.update({k: 2 * per_fwd * steps for k in fwd})
    want.update({k: fused.BWD_LAUNCHES * 2 * per_fwd * steps for k in bwd})
    if not fused_eval:
        for k in fwd:
            want[k] += per_fwd * evals
    elif bf16:
        want["dstd_encoder_chain_bf16"] += evals
    else:
        want["dstd_encoder_chain"] += evals
        for k in FORWARD:
            want[k] += 2 * evals
    return want


def chain_check(torch, fused, name, h, arg, ref, given, agg, timings,
                max_err, iters=(20, 5), tag="check", label=None):
    """One float32 chain kernel (``name``: ``dstd_encoder_chain`` on packed
    encoder layers, ``dstd_chain`` on packed blocks; ``arg`` packed from
    ``given``) on ``h`` by phase 3's rule: two launches counted, the same
    bits, within TOL of max(max |plain|, 1) of its plain version ``ref`` on
    ``given``.  With ``iters`` (kernel, plain calls) it is timed into
    ``timings[(name, agg)]`` with its bound (``chain_cost``).  Prints and
    returns the check line; ``label`` names the model it came from."""
    kernel = getattr(fused, name)
    n, t, v, c = h.shape

    def call():
        with torch.no_grad():
            return kernel(h, arg, agg)

    def plain_call():
        with torch.no_grad():
            return ref(h, given, agg)

    before = kernel.launches
    got, again = call(), call()
    torch.cuda.synchronize()
    check(kernel.launches == before + 2, f"{name} did not count its launches")
    want = plain_call()
    abs_err, rel = norm_err(got, want)
    repeat = bool(torch.equal(got, again))
    max_err[name] = max(max_err[name], abs_err)
    line = dict(kernel=name, dataset=label, agg=agg, n=n, t=t, v=v, c=c,
                layers=len(given), tile=chain_tiles(kernel, "f32", t, v, c),
                max_abs_err=abs_err, max_norm_err=rel,
                peak=float(want.abs().max()), repeatable=repeat,
                ok=rel <= TOL and repeat)
    if iters:
        k_call = time_ms(torch, call, iters[0])
        k_ms, k_by = device_ms(torch, call, iters[0])
        p_ms, p_by = device_ms(torch, plain_call, iters[1])
        b_ms, t_ops, t_mem = bound_of(*chain_cost(
            n, c, len(given), name == "dstd_encoder_chain", None, t, v))
        timings[(name, agg)] = (k_ms, p_ms, k_call, k_by, None)
        line.update(ms=k_ms, plain_ms=p_ms, call_ms=k_call,
                    timed_by=[k_by, p_by], bound_ms=b_ms,
                    bound_by="operations" if t_ops >= t_mem else "bytes")
    print(f"{tag} " + json.dumps(line))
    check(line["ok"], f"{label or ''} {name} agg={agg} (T={t}, V={v}, "
                      f"C={c}): {rel} of max(|plain|, 1) from its plain "
                      f"version, repeatable {repeat}")
    return line


def encoder_checks(torch, fused, cfg, inputs, agg_main, timings, max_err,
                   label):
    """The float32 whole-encoder kernel on the calibrated encoder of
    ``cfg``'s model at the batch of ``inputs`` (``encoder_case``), both
    aggregations, by phase 3's rule (``chain_check``), timed at
    ``agg_main``.  Returns the check lines."""
    h, layers = encoder_case(torch, cfg, inputs)
    packed = fused.pack_chain(layers)
    return [chain_check(torch, fused, "dstd_encoder_chain", h, packed,
                        fused._encoder_oracle, layers, agg, timings, max_err,
                        (10, 3) if agg == agg_main else None,
                        "profiles check", label)
            for agg in ("right", "left")]


def summed_ms(timings, name, model_cfg, n, t, v, agg, dtype=None):
    """A one-op kernel's device ms over the calls of one forward (or its
    backward) of a model of ``model_cfg`` at batch ``n``, (T, V) = (``t``,
    ``v``), from a check's ``timings``, beside its plain version's and the
    bound (``bound_ms``)."""
    mode, backward = name.split("_")[1], "_bwd" in name
    ms = plain_ms = b_ms = ops_ms = mem_ms = 0.0
    calls = 0
    for m, ci, co in forward_shapes(model_cfg):
        if m != mode:
            continue
        k_t, p_t = timings[(name, ci, co, agg)][:2]
        b, t_ops, t_mem = bound_ms(mode, n, ci, co, backward, dtype, t, v)
        ms, plain_ms, b_ms = ms + k_t, plain_ms + p_t, b_ms + b
        ops_ms, mem_ms, calls = ops_ms + t_ops, mem_ms + t_mem, calls + 1
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by="operations" if ops_ms >= mem_ms else "bytes",
                calls=calls, n=n, t=t, v=v, agg=agg)


def forward_times(torch, eng, x, label):
    """Wall and device ms of one forward of ``eng`` on the padded batch
    ``x``, standard (``predict``) and fused (``engine.fused_inference``'s
    forward), printed under ``label``."""
    fforward = eng._eval_forward()

    def fused_fwd():
        with torch.inference_mode():
            return eng._serve(x, fforward, None, None)

    times = {}
    for kind, fn in (("standard", lambda: eng.predict(x)),
                     ("fused", fused_fwd)):
        call = time_ms(torch, fn, 5)
        dev = sum(device_profile(torch, fn, 3).values())
        times[kind] = dict(call_ms=call, device_ms=dev)
    print(f"{label}: batch-{len(x)} forward, standard {times['standard']}, "
          f"fused {times['fused']} (ms)")
    return times


def fused_sweep(torch, np, fused, device, cfg, ckpt, run_dir, history,
                model_cfg, bf16, label):
    """``main.run`` of ``cfg`` in test mode on ``ckpt`` with
    ``engine.fused_inference``: exact launches (``profile_launches``),
    finite MPJPE, and its distance to the training run's own eval of the
    same weights (the last row of ``history``).  Returns (the test
    runner, its report, its launches)."""
    from dstdgcn_tpu_torch.main import run
    cfg["mode"] = "test"
    cfg["model"].update(load=True, ckpt=ckpt)
    cfg["engine"]["fused_inference"] = True
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    runner, _ = run(cfg, device.type, run_dir=run_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused.launch_counts()
    eng = runner.engine
    evals = len(runner.test_batch_seconds)
    with open(os.path.join(run_dir, "testing_loss.csv")) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    got = np.asarray([float(x) for x in rows[1]])
    standard = np.asarray(history[-1][3:], dtype=np.float64)
    rel = float(np.max(np.abs(got - standard) / np.abs(standard)))
    want = profile_launches(fused, model_cfg, 0, evals, bf16, True)
    print(f"{label}: fused eval sweep in {wall:.2f} s, {evals} batches, "
          f"wall ms per batch median "
          f"{float(np.median(runner.test_batch_seconds)) * 1e3:.3f}; test "
          f"loss and horizons {got[:9].tolist()} against the standard "
          f"sweep's {standard[:9].tolist()} (max rel {rel:.3g}); launches "
          f"{counts}")
    check(eng.fused_inference and eng.model.resolve_knobs(1)[
        "compute_dtype"] == ("bfloat16" if bf16 else None),
        f"{label}: the fused sweep ran {eng.model.resolve_knobs(1)}")
    check(len(rows) == 2 and got.shape == standard.shape
          and bool(np.all(np.isfinite(got))),
          f"{label}: testing_loss.csv holds {rows}")
    check(counts == want, f"{label}: the fused sweep launched {counts}, "
                          f"expected {want}")
    return runner, dict(wall=wall, evals=evals, mpjpe=got.tolist(),
                        standard=standard.tolist(), max_rel=rel,
                        batch_seconds=runner.test_batch_seconds,
                        launches=counts), counts


def profile_run(torch, np, fused, device, name, paths, out):
    """Phase 15 (b): ``real_<name>_tpu_train`` through ``main.run`` on a
    seeded tree (1 epoch of its 4 steps at batch 128 and the per-action
    eval): the knobs resolve to bf16, exact launches of the four bf16
    one-op kernels and no float32 DSTD-GC kernel, finite losses and MPJPE;
    one train step's device time; one bf16 step against the plain path of
    its contract (``bf16_step_check``, phase 9's rule); the fused eval
    sweep on the trained state (``fused_sweep``: one
    ``dstd_encoder_chain_bf16`` a batch) and one calibrated batch by phase
    10's rule (``fused_bf16_check``); a batch's standard and fused forward
    times.  Returns (report, {run: launches})."""
    from dstdgcn_tpu_torch import configs
    from dstdgcn_tpu_torch.data import get_dataset
    from dstdgcn_tpu_torch.main import run
    from dstdgcn_tpu_torch.utils.config import resolve
    label = f"profiles {name}"

    def config():
        return configs.set_data_paths(
            getattr(configs, f"real_{name}_tpu_train")(), *paths)

    rcfg = resolve(config())
    bs, mcfg = rcfg["train_batch_size"], rcfg["model"]["dstdgcn"]
    per_fwd = mcfg["num_layers"] + 2
    run_dir = os.path.join(out, f"{name}_tpu")
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    runner, history = run(config(), device.type, run_dir=run_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused.launch_counts()
    eng = runner.engine
    model = eng.model
    knobs = model.resolve_knobs(1)
    steps = len(eng.train_step_seconds)
    evals = rcfg["epoch"] * len(runner.test_batch_seconds)
    rows = np.asarray(history, dtype=np.float64)
    step_ms = [s * 1e3 for s in eng.train_step_seconds]
    eval_ms = [s * 1e3 for s in runner.test_batch_seconds]
    print(f"{label}: main.run on {device.type} in {wall:.2f} s, {steps} "
          f"train steps of {bs} and {evals} eval batches; knobs at any "
          f"batch (hint {model.auto_batch_hint}) {knobs}, the blocks run "
          f"{model.active_dtype}")
    print(f"{label}: wall ms per train step {[round(m, 3) for m in step_ms]}"
          f" (median after the first {float(np.median(step_ms[1:])):.3f}); "
          f"per eval batch median {float(np.median(eval_ms)):.3f}")
    print(f"{label}: per epoch (epoch, lr, train loss, test loss, "
          f"horizons) {rows[:, :12].tolist()}; launches {counts}")
    check(knobs["compute_dtype"] == "bfloat16"
          and model.active_dtype == "bfloat16",
          f"{label}: resolved {knobs}, running {model.active_dtype}")
    check(steps == rcfg["epoch"] * rcfg["engine"]["max_iter"],
          f"{label}: {steps} train steps")
    check(rows.shape[0] == rcfg["epoch"] and bool(np.all(np.isfinite(rows))),
          f"{label}: non-finite losses or MPJPE")
    want = profile_launches(fused, mcfg, steps, evals, bf16=True)
    check(counts == want, f"{label}: launched {counts}, expected {want}")
    report = dict(wall=wall, steps=steps, evals=evals, knobs=knobs,
                  step_ms=step_ms, eval_ms=eval_ms, history=rows.tolist(),
                  launches=counts)

    # one train step's device time, on a batch of the train split
    train = get_dataset(name, **copy.deepcopy(
        rcfg["dataset"]["train"])).arrays()[:3]
    batches = [[a[i:i + bs] for a in train]
               for i in range(0, len(train[0]) - bs + 1, bs)]
    prof = device_profile(torch, lambda: eng.train_step(*batches[0]), 3)
    by_kernel = {}
    for key, ms in prof.items():
        kname = dstd_kernel_of(key, bf16_reduce=True)
        if kname is not None:
            by_kernel[kname] = by_kernel.get(kname, 0.0) + ms
    step_dev = sum(prof.values())
    print(f"{label}: train step device "
          + (f"{step_dev:.3f} ms; DSTD-GC kernels {by_kernel}" if prof
             else "not measured (the profiler recorded nothing)"))
    check(set(by_kernel) <= set(BF16_FORWARD + BF16_BACKWARD),
          f"{label}: a float32 DSTD-GC kernel ran in the step: {by_kernel}")
    report.update(step_device_ms=step_dev, step_dstd_ms=by_kernel)
    report["step_check"] = bf16_step_check(torch, fused, device, rcfg,
                                           batches, steps, per_fwd)

    # the fused eval sweep on the trained state, then a batch's times and
    # one calibrated batch by phase 10's rule
    trunner, report["fused"], fcounts = fused_sweep(
        torch, np, fused, device, config(),
        os.path.join(run_dir, "checkpoints", "best.ckpt"),
        os.path.join(out, f"{name}_tpu_fused"), history, mcfg, True,
        label)
    report["forward_ms"] = forward_times(torch, trunner.engine,
                                         train[0][:bs], label)
    report["fused_check"] = fused_bf16_check(
        torch, fused, trunner.engine, train[0][:bs],
        {"dstd_encoder_chain_bf16": 1}, label)
    return report, {f"{name}_tpu": counts, f"{name}_tpu_fused": fcounts}


def fast_run(torch, np, fused, device, out):
    """Phase 15 (c): ``synthetic_h36m_fast_train`` through ``main.run``
    for one epoch and an eval sweep: exact launches of the float32 one-op
    kernels (8 of each forward kernel a step, 4 an eval batch, 8 backward
    calls a step), finite losses; one step against the plain path by phase
    7's rules (``train_step_check``); the fused eval sweep on the trained
    state (1 ``dstd_encoder_chain`` and 2 + 2 one-op launches a batch)
    within TOL relative of the training run's standard sweep; a batch's
    standard and fused forward times.  Returns (report, {run:
    launches})."""
    from dstdgcn_tpu_torch import configs
    from dstdgcn_tpu_torch.data import get_dataset
    from dstdgcn_tpu_torch.main import run
    from dstdgcn_tpu_torch.utils.config import resolve
    label = "profiles fast"

    def config():
        cfg = configs.synthetic_h36m_fast_train()
        cfg["epoch"] = 1
        return cfg

    rcfg = resolve(config())
    bs = rcfg["train_batch_size"]
    mcfg = rcfg["model"][rcfg["model"]["name"]]
    run_dir = os.path.join(out, "fast")
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    runner, history = run(config(), device.type, run_dir=run_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused.launch_counts()
    eng = runner.engine
    steps = len(eng.train_step_seconds)
    evals = rcfg["epoch"] * len(runner.test_batch_seconds)
    rows = np.asarray(history, dtype=np.float64)
    step_ms = [s * 1e3 for s in eng.train_step_seconds]
    eval_ms = [s * 1e3 for s in runner.test_batch_seconds]
    n_train = rcfg["dataset"]["train"]["synthetic"]["num_sequences"]
    print(f"{label}: main.run on {device.type} in {wall:.2f} s, {steps} "
          f"train steps of {bs} and {evals} eval batches; wall ms per "
          f"train step {[round(m, 3) for m in step_ms]}, per eval batch "
          f"{[round(m, 3) for m in eval_ms]}; per epoch {rows.tolist()}; "
          f"launches {counts}")
    check(model_is_fast(eng.model) and eng.model.active_dtype is None,
          f"{label}: the model is not the float32 fast variant")
    check(steps == rcfg["epoch"] * -(-n_train // bs),
          f"{label}: {steps} train steps")
    check(bool(np.all(np.isfinite(rows))), f"{label}: non-finite {rows}")
    want = profile_launches(fused, mcfg, steps, evals)
    check(counts == want, f"{label}: launched {counts}, expected {want}")
    report = dict(wall=wall, steps=steps, evals=evals, step_ms=step_ms,
                  eval_ms=eval_ms, history=rows.tolist(), launches=counts)

    batch = [a[:bs] for a in get_dataset(
        "synthetic", **rcfg["dataset"]["train"]).arrays()[:3]]
    prof = device_profile(torch, lambda: eng.train_step(*batch), 3)
    report["step_device_ms"] = sum(prof.values())
    print(f"{label}: train step device "
          + (f"{report['step_device_ms']:.3f} ms" if prof
             else "not measured (the profiler recorded nothing)"))
    per_step = 2 * sum(mode == "spatial"
                       for mode, _, _ in forward_shapes(mcfg))
    report["step_check"], _ = train_step_check(
        torch, fused, eng, rcfg, batch, label, fwd_per_step=per_step,
        bwd_per_step=per_step)

    trunner, report["fused"], fcounts = fused_sweep(
        torch, np, fused, device, config(),
        os.path.join(run_dir, "checkpoints", "best.ckpt"),
        os.path.join(out, "fast_fused"), history, mcfg, False, label)
    check(report["fused"]["max_rel"] <= TOL,
          f"{label}: the fused sweep lies {report['fused']['max_rel']} "
          "from the standard sweep (relative)")
    report["forward_ms"] = forward_times(torch, trunner.engine, batch[0],
                                         label)
    return report, {"fast": counts, "fast_fused": fcounts}


def model_is_fast(model):
    """Whether every DSTD-GC op of ``model`` aggregates on the left (the
    fast variant) and goes through the kernel wrappers."""
    from dstdgcn_tpu_torch.models.layers import DSTDGC
    ops = [m for m in model.modules() if isinstance(m, DSTDGC)]
    return model.fast and all(op.agg == "left" and op.routed()
                              for op in ops)


def profiles_phase(torch, np, fused, plain, plain_bwd, device):
    """Phase 15, the remaining configurations: (a) the bf16 one-op kernels
    at the CMU and 3DPW models' shapes at batch 128 (``bf16_kernel_checks``,
    phase 3's bf16 rules), the float32 one-op kernels at the fast model's
    (``real_op_checks`` at its batch, timed at agg left), and the encoder
    kernels on each model's calibrated encoder (float32 by phase 3's rule,
    ``encoder_checks``; bf16 by phase 3's chain rules,
    ``bf16_chain_checks``); (b) ``profile_run`` for each of PROFILES on
    the seeded trees of phase 11 (REAL_TREES), removed after; (c)
    ``fast_run``.  Returns (report, {run: launches})."""
    from dstdgcn_tpu_torch import configs
    from dstdgcn_tpu_torch.data import get_dataset
    from dstdgcn_tpu_torch.utils.config import resolve
    start = time.perf_counter()
    out = os.path.join(OUT_DIR, "profiles")
    data = os.path.join(out, "data")
    shutil.rmtree(out, ignore_errors=True)
    paths = {"cmu": write_cmu_tree(os.path.join(data, "cmu"),
                                   **REAL_TREES["cmu"]),
             "3dpw": write_pw3d_tree(os.path.join(data, "3dpw"),
                                     **REAL_TREES["3dpw"])}
    max_err = dict.fromkeys(KERNELS, 0.0)
    checks, kernel_ms, launches = [], {}, {}

    def record(config, name, entry):
        kernel_ms.setdefault(name, {})[config] = entry

    # (a) the kernels at the new shapes
    for name in PROFILES:
        rcfg = resolve(configs.set_data_paths(
            getattr(configs, f"real_{name}_tpu_train")(), *paths[name]))
        mcfg = rcfg["model"]["dstdgcn"]
        t = mcfg["input_time_frame"] + mcfg["output_time_frame"]
        v, n = mcfg["joints_to_consider"], rcfg["train_batch_size"]
        timings = {}
        checks += bf16_kernel_checks(torch, np, fused, plain, plain_bwd,
                                     device, n, forward_shapes(mcfg),
                                     timings, max_err, t=t, v=v,
                                     f64_hold=True)
        # the encoder's input from the tree's train windows, the model at
        # float32 on the plain ops (``encoder_case``)
        f32 = copy.deepcopy(rcfg)
        f32["model"]["dstdgcn"].update(compute_dtype=None,
                                       agg_group_spatial=None,
                                       agg_group_temporal=None)
        inputs = get_dataset(name, **copy.deepcopy(
            rcfg["dataset"]["train"])).arrays()[0]
        checks += encoder_checks(torch, fused, f32, inputs[:N], "right",
                                 timings, max_err, name)
        checks += bf16_chain_checks(torch, fused, plain, f32, inputs, n,
                                    "right", timings, max_err,
                                    bases=("dstd_encoder_chain",))
        for kname in BF16_FORWARD + BF16_BACKWARD:
            record(name, kname, summed_ms(timings, kname, mcfg, n, t, v,
                                          "right", torch.bfloat16))
        for kname, bn, dtype in (("dstd_encoder_chain", N, None),
                                 ("dstd_encoder_chain_bf16", n,
                                  torch.bfloat16)):
            k_ms, p_ms = timings[(kname, "right")][:2]
            b_ms, t_ops, t_mem = bound_of(*chain_cost(
                bn, mcfg["num_feature"], mcfg["num_layers"], True, dtype,
                t, v))
            record(name, kname, dict(
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by="operations" if t_ops >= t_mem else "bytes",
                calls=1, n=bn, t=t, v=v, agg="right"))
    fcfg = resolve(configs.synthetic_h36m_fast_train())
    fm = fcfg["model"][fcfg["model"]["name"]]
    t = fm["input_time_frame"] + fm["output_time_frame"]
    v, n = fm["joints_to_consider"], fcfg["train_batch_size"]
    timings = {}
    checks += real_op_checks(torch, np, fused, plain, plain_bwd, device,
                             "fast", t, v, forward_shapes(fm),
                             tag="profiles", n=n, timings=timings,
                             timed_agg="left")
    inputs = get_dataset("synthetic", **fcfg["dataset"]["train"]).input_seqs
    checks += encoder_checks(torch, fused, fcfg, inputs[:n], "left",
                             timings, max_err, "fast")
    for kname in FORWARD + BACKWARD:
        record("fast", kname, summed_ms(timings, kname, fm, n, t, v, "left"))
    k_ms, p_ms = timings[("dstd_encoder_chain", "left")][:2]
    b_ms, t_ops, t_mem = bound_of(*chain_cost(
        n, fm["num_feature"], fm["num_layers"], True, None, t, v))
    record("fast", "dstd_encoder_chain", dict(
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by="operations" if t_ops >= t_mem else "bytes", calls=1, n=n,
        t=t, v=v, agg="left"))
    kernels_s = time.perf_counter() - start
    print(f"profiles: kernel checks {kernels_s:.1f} s; device ms at the "
          "new shapes " + json.dumps(kernel_ms))

    # (b) the two profiles, (c) the fast variant
    report = dict(checks=checks, kernel_ms=kernel_ms, max_err=max_err,
                  kernels_seconds=kernels_s)
    for name in PROFILES:
        report[name], got = profile_run(torch, np, fused, device, name,
                                        paths[name], out)
        launches.update(got)
    report["fast"], got = fast_run(torch, np, fused, device, out)
    launches.update(got)
    # the trees are rebuilt from their seeds by every run
    shutil.rmtree(data)
    report["seconds"] = time.perf_counter() - start
    print(f"profiles: phase 15 {report['seconds']:.1f} s")
    return report, launches


def run_smoke():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    try:
        from dstdgcn_tpu_torch import configs
        from dstdgcn_tpu_torch.data import Loader, get_dataset
        from dstdgcn_tpu_torch.engine import PredictionEngine
        from dstdgcn_tpu_torch.kernels import build, fused
        from dstdgcn_tpu_torch.main import run
        from dstdgcn_tpu_torch.models import get_model
        from dstdgcn_tpu_torch.ops import dstd as plain
        from dstdgcn_tpu_torch.ops import dstd_bwd as plain_bwd
        from dstdgcn_tpu_torch.utils.config import resolve
    except ImportError as e:
        raise SmokeFailure(f"cannot import the port ({e}): run "
                           "chip_smoke.py from the repository root") from e

    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    report = {}

    # 1. the card
    smi = nvidia_smi()
    print(smi)
    yaml_ok = subprocess.run([sys.executable, "-c", "import yaml"],
                             capture_output=True).returncode == 0
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} devices {torch.cuda.device_count()} "
          f"yaml {'importable' if yaml_ok else 'missing'}")
    report.update(nvidia_smi=smi, torch=torch.__version__,
                  cuda=torch.version.cuda, yaml=yaml_ok)

    # 2. build every kernel, one nvcc per source in parallel
    t0 = time.perf_counter()
    secs = build.build_all()
    total = time.perf_counter() - t0
    print(f"build: {total:.1f} s for {len(secs)} kernels "
          + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name in secs:
        with open(os.path.join(OUT_DIR, f"build_{name}.log"), "w") as f:
            f.write(build.build_log(name))
    report["build_seconds"] = dict(secs, total=total)
    report["ptxas"] = {}
    for name in secs:
        usage = report["ptxas"][name] = ptxas_usage(build.build_log(name))
        for kernel, regs, stores, loads in usage:
            print(f"  ptxas {name}: {kernel}: {regs} registers, spill "
                  f"{stores} bytes stored / {loads} loaded")
    # the tensor-core products in the SASS of every library
    report["sass_hmma"] = {}
    for name in SASS_LIBRARIES:
        mma = sass_mma(build.library(name)._name)
        report["sass_hmma"][name] = mma
        for kernel, (count, size) in mma.items():
            print(f"  sass {name}: {kernel}: {count} HMMA / DMMA of {size} "
                  "instructions")
            check((count > 0) == uses_mma(kernel),
                  f"{kernel}: {count} HMMA / DMMA instructions in its SASS, "
                  f"expected {'some' if uses_mma(kernel) else 'none'}")

    # 3. each kernel against its plain version at the serving and training
    # shapes (the two slices' configs share the model block)
    model_cfg = resolve(configs.SYNTHETIC_H36M_SERVING)["model"]["dstdgcn"]
    check(model_cfg == resolve(configs.SYNTHETIC_H36M_TRAIN)["model"][
        "dstdgcn"], "the serving and training slices differ in the model")
    shapes = sorted({(ci, co) for _, ci, co in forward_shapes(model_cfg)})
    timings, max_err, checks = {}, {name: 0.0 for name in KERNELS}, []
    for mode in ("spatial", "temporal"):
        name = f"dstd_{mode}"
        kernel, ref = getattr(fused, name), getattr(plain, name)
        for ci, co in shapes:
            args = op_inputs(torch, np, mode, ci, co, device, seed=ci + co)
            for agg in ("right", "left"):
                before = kernel.launches
                got = kernel(*args, None, agg)
                torch.cuda.synchronize()
                check(kernel.launches == before + 1,
                      f"{name} did not count its launch")
                want = ref(*args, None, agg)
                abs_err, rel_err, ok = errors(torch, got, want)
                k_call = time_ms(torch, lambda: kernel(*args, None, agg), 20)
                p_call = time_ms(torch, lambda: ref(*args, None, agg), 10)
                k_ms, k_by = device_ms(
                    torch, lambda: kernel(*args, None, agg), 20)
                p_ms, p_by = device_ms(torch, lambda: ref(*args, None, agg),
                                       10)
                launches = kernel.launches - before
                b_ms, t_ops, t_mem = bound_ms(mode, N, ci, co)
                timings[(name, ci, co, agg)] = (k_ms, p_ms, k_call, k_by,
                                                None)
                max_err[name] = max(max_err[name], abs_err)
                line = dict(kernel=name, agg=agg, ci=ci, co=co, n=N,
                            max_abs_err=abs_err, max_rel_err=rel_err,
                            ok=ok, ms=k_ms, plain_ms=p_ms, call_ms=k_call,
                            plain_call_ms=p_call, timed_by=[k_by, p_by],
                            bound_ms=b_ms,
                            bound_by="operations" if t_ops >= t_mem
                            else "bytes", check_launches=launches)
                checks.append(line)
                print("check " + json.dumps(line))
                check(ok, f"{name} agg={agg} {ci}->{co} disagrees with the "
                          f"plain op: max abs err {abs_err}")
    # the backward kernels against the hand-derived plain backward, and
    # timed against autograd through the plain forward
    for mode in ("spatial", "temporal"):
        name = f"dstd_{mode}_bwd"
        kernel, ref = getattr(fused, name), getattr(plain_bwd, name)
        ref_fwd = getattr(plain, f"dstd_{mode}")
        for ci, co in shapes:
            args = op_inputs(torch, np, mode, ci, co, device, seed=ci + co)
            gen = torch.Generator(device=device).manual_seed(ci * co)
            g = torch.randn((N, T, V, co), generator=gen, device=device)
            req = [a.detach().clone().requires_grad_() for a in args]

            def autograd_plain(req=req, g=g, agg=None):
                out = ref_fwd(*req, None, agg)
                return torch.autograd.grad(out, req, g)

            for agg in ("right", "left"):
                before = kernel.launches
                got = kernel(args[0], g, *args[1:], agg=agg)
                again = kernel(args[0], g, *args[1:], agg=agg)
                torch.cuda.synchronize()
                check(kernel.launches == before + 2 * fused.BWD_LAUNCHES,
                      f"{name} did not count its launches")
                repeat = all(bool(torch.equal(a, b))
                             for a, b in zip(got, again))
                want = ref(args[0], g, *args[1:], agg=agg)
                abs_err, norm_err, ok = grad_errors(got, want)

                def call(agg=agg):
                    return kernel(args[0], g, *args[1:], agg=agg)

                def plain_call(agg=agg):
                    return autograd_plain(agg=agg)

                k_call = time_ms(torch, call, 20)
                p_call = time_ms(torch, plain_call, 10)
                split = {}
                k_ms, k_by = device_ms(torch, call, 20, split)
                p_ms, p_by = device_ms(torch, plain_call, 10)
                b_ms, t_ops, t_mem = bound_ms(mode, N, ci, co, True)
                timings[(name, ci, co, agg)] = (k_ms, p_ms, k_call, k_by,
                                                split)
                max_err[name] = max(max_err[name], abs_err)
                line = dict(kernel=name, agg=agg, ci=ci, co=co, n=N,
                            max_abs_err=abs_err, max_norm_err=norm_err,
                            ok=ok, repeatable=repeat, ms=k_ms,
                            launch_ms=split,
                            plain_ms=p_ms, call_ms=k_call,
                            plain_call_ms=p_call, timed_by=[k_by, p_by],
                            bound_ms=b_ms,
                            bound_by="operations" if t_ops >= t_mem
                            else "bytes")
                checks.append(line)
                print("check " + json.dumps(line))
                check(ok, f"{name} agg={agg} {ci}->{co} disagrees with the "
                          f"plain backward: {norm_err} of max(|plain|, 1)")
                check(repeat, f"{name} agg={agg} {ci}->{co}: two calls on "
                              "the same inputs differ")
    # the bf16 variants against the plain versions of their contract at the
    # batch and channel widths of the bf16 training slice, both aggregations
    bcfg = resolve(configs.SYNTHETIC_H36M_TPU_TRAIN)
    bmodel_cfg = bcfg["model"]["dstdgcn"]
    nb16 = bcfg["train_batch_size"]
    checks += bf16_kernel_checks(torch, np, fused, plain, plain_bwd, device,
                                 nb16, forward_shapes(bmodel_cfg), timings,
                                 max_err)
    report["checks"] = checks

    # the chain kernels against their plain versions on the serving model's
    # encoder at realistic activations; dstd_chain's gradients (the replay
    # through the op kernels) against autograd through the plain chain
    serving_cfg = configs.synthetic_h36m_serving()
    test_ds = get_dataset("synthetic",
                          **resolve(serving_cfg)["dataset"]["test"])
    h, layers = encoder_case(torch, serving_cfg, test_ds.input_seqs[:N])
    packed = fused.pack_chain(layers)
    n_layers, feat = len(layers), h.shape[-1]
    chain_checks, grad_lines, normalized = [], [], {}
    for agg in ("right", "left"):
        blocks = normalized[agg] = chain_blocks(torch, plain, layers, h, agg)
        cases = (("dstd_encoder_chain", packed, fused._encoder_oracle,
                  layers),
                 ("dstd_chain", fused.pack_chain(blocks),
                  fused._chain_oracle, blocks))
        for name, arg, ref, given in cases:
            chain_checks.append(chain_check(torch, fused, name, h, arg, ref,
                                            given, agg, timings, max_err))
        # gradients of x and every weight: kernel path, plain path, and the
        # plain path in float64 beside them
        g = torch.randn(h.shape, device=device,
                        generator=torch.Generator(device).manual_seed(5))
        grads = {}
        for label, fn, dtype in (("kernel", fused.dstd_chain, None),
                                 ("plain", fused._chain_oracle, None),
                                 ("float64", fused._chain_oracle,
                                  torch.float64)):
            leaves, rebuilt = chain_leaves(torch, h, blocks, dtype)
            out = fn(leaves[0], rebuilt, agg)
            grads[label] = torch.autograd.grad(out, leaves,
                                               g.to(out.dtype))
        abs_err, norm_err, ok = grad_errors(grads["kernel"], grads["plain"])
        _, k64, _ = grad_errors([a.double() for a in grads["kernel"]],
                                grads["float64"])
        _, p64, _ = grad_errors([a.double() for a in grads["plain"]],
                                grads["float64"])
        line = dict(kernel="dstd_chain backward", agg=agg, tensors=len(
            grads["kernel"]), max_abs_err=abs_err, max_norm_err=norm_err,
            kernel_vs_float64=k64, plain_vs_float64=p64, ok=ok)
        grad_lines.append(line)
        print("check " + json.dumps(line))
        check(ok, f"dstd_chain agg={agg} gradients disagree with autograd "
                  f"through the plain chain: {norm_err} of max(|plain|, 1)")
    report["chain_checks"] = chain_checks + grad_lines
    # the bf16 chain kernels at the bf16 fused slice's batch and at batch 1
    agg_main = "left" if model_cfg.get("fast") else "right"
    nf16 = resolve(configs.SYNTHETIC_H36M_TPU_FUSED)["test_batch_size"]
    report["bf16_chain_checks"] = bf16_chain_checks(
        torch, fused, plain, serving_cfg, test_ds.input_seqs, nf16, agg_main,
        timings, max_err)

    # 4. the serving slice through its entry point, counts from zero
    cfg = configs.synthetic_h36m_serving()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    runner, (avg, per_frame) = run(cfg, "cuda",
                                   run_dir=os.path.join(OUT_DIR, "run"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused.launch_counts()
    engine = runner.engine
    batches = engine.test_batch_seconds
    forwards = len(batches)
    print(f"slice: main.run on cuda, {forwards} batches of "
          f"{cfg['test_batch_size']} in {wall:.2f} s; per-frame MPJPE "
          f"{[float(m) for m in per_frame]} avg {float(avg)}")
    print(f"slice: wall ms per batch {[round(s * 1e3, 3) for s in batches]}"
          f" (median {float(np.median(batches)) * 1e3:.3f})")
    print(f"slice: launches {counts} over {forwards} forwards")
    check(forwards > 0, "the slice ran no batch")
    check(np.all(np.isfinite(per_frame)) and np.isfinite(avg),
          "non-finite MPJPE")
    for name in FORWARD:
        check(counts[name] == 7 * forwards,
              f"{name}: {counts[name]} launches, expected 7 per forward "
              f"x {forwards}")
    for name in BACKWARD:
        check(counts[name] == 0, f"{name} launched while serving")
    report["slice"] = dict(per_frame=[float(m) for m in per_frame],
                           avg=float(avg), batch_seconds=batches,
                           launches=counts, forwards=forwards, wall=wall)

    # batch-1 requests through the same engine
    test_cfg = resolve(cfg)["dataset"]["test"]
    dataset = get_dataset("synthetic", **test_cfg)
    inputs = dataset.input_seqs
    req_ms = []
    for i in range(4):
        before = fused.launch_counts()
        t0 = time.perf_counter()
        out = engine.predict(inputs[i:i + 1])
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        after = fused.launch_counts()
        check(out.shape == (1, T, inputs.shape[-1])
              and bool(torch.isfinite(out).all()), "bad batch-1 output")
        check(all(after[k] - before[k] == 7 for k in FORWARD),
              f"batch-1 request launched {after} (before {before})")
    print(f"serve: 4 batch-1 requests, ms {[round(m, 3) for m in req_ms]}")
    report["batch1_ms"] = req_ms

    # where the time of one batch-32 forward goes on the card
    def forward():
        return engine.predict(inputs[:N])

    fwd_call = time_ms(torch, forward, 5)
    prof = device_profile(torch, forward, 5)
    fwd_dev = sum(prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:6]
    busy = (f"{fwd_dev:.3f} ms ({100 * fwd_dev / fwd_call:.1f}%)" if prof
            else "not measured (the profiler recorded nothing)")
    print(f"profile: batch-{N} forward {fwd_call:.3f} ms per call, device "
          f"busy {busy}; top "
          + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top))
    report["forward_profile"] = dict(call_ms=fwd_call, device_ms=fwd_dev,
                                     by_kernel=prof)

    # one full batch: kernel path against the plain path, same weights,
    # gates and biases moved off zero, BatchNorm calibrated on the batch
    model = engine.model
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(device))
    model_opts = {k: v for k, v in resolve(cfg)["model"].items()
                  if k != "name"}
    plain_model = get_model("dstdgcn", **dict(model_opts, use_pallas=False))
    plain_model.load_state_dict(model.state_dict())
    plain_engine = PredictionEngine(cfg["engine"], plain_model, device="cuda")
    batch = inputs[:N]
    calibrate_batchnorm(torch, plain_engine.model,
                        plain_engine.transform(plain_engine.to_device(batch)))
    model.load_state_dict(plain_engine.model.state_dict())
    before = fused.launch_counts()
    got = engine.predict(batch)
    want = plain_engine.predict(batch)
    torch.cuda.synchronize()
    abs_err, rel_err, ok = errors(torch, got, want)
    after = fused.launch_counts()
    print(f"serve: batch {N} kernel path vs plain path max_abs_err "
          f"{abs_err} max_rel_err {rel_err} (|out| max "
          f"{float(want.abs().max())}) launches "
          f"{ {k: after[k] - before[k] for k in FORWARD} }")
    check(ok, f"model output: kernel path disagrees with the plain path "
              f"(max abs err {abs_err})")
    check(all(after[k] - before[k] == 7 for k in FORWARD),
          "the kernel path did not launch 7 of each kernel")
    report["model_check"] = dict(max_abs_err=abs_err, max_rel_err=rel_err)

    # the same forwards timed on both paths (CUDA events, host included)
    paths = {}
    for label, eng in (("kernel", engine), ("plain", plain_engine)):
        paths[label] = {
            n: time_ms(torch, lambda: eng.predict(inputs[:n]), 10)
            for n in (N, 1)}
    print(f"serve: forward ms per call, kernel path vs plain path: batch {N}"
          f" {paths['kernel'][N]:.3f} vs {paths['plain'][N]:.3f}; batch 1 "
          f"{paths['kernel'][1]:.3f} vs {paths['plain'][1]:.3f}")
    report["paths_ms"] = paths

    # 5. the fused serving slice through its entry point, counts from zero:
    # the same seed-777 weights, the eval step through the whole-encoder
    # kernel
    fcfg = configs.synthetic_h36m_fused()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    frunner, (favg, fper_frame) = run(fcfg, "cuda",
                                      run_dir=os.path.join(OUT_DIR, "fused"))
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t0
    fcounts = fused.launch_counts()
    feng = frunner.engine
    fbatches = feng.test_batch_seconds
    nb = len(fbatches)
    mpjpe_rel = float(np.max(np.abs(np.asarray(fper_frame)
                                    - np.asarray(per_frame))
                             / np.abs(np.asarray(per_frame))))
    print(f"fused: main.run on cuda, {nb} batches of "
          f"{fcfg['test_batch_size']} in {fwall:.2f} s; per-frame MPJPE "
          f"{[float(m) for m in fper_frame]} avg {float(favg)}; against the "
          f"serving slice max rel diff {mpjpe_rel:.3g}")
    print(f"fused: wall ms per batch {[round(t * 1e3, 3) for t in fbatches]}"
          f" (median {float(np.median(fbatches)) * 1e3:.3f})")
    print(f"fused: launches {fcounts} over {nb} eval batches")
    check(nb > 0 and np.all(np.isfinite(fper_frame)) and np.isfinite(favg),
          "the fused slice gave no batch or a non-finite MPJPE")
    check(mpjpe_rel <= TOL, f"fused slice MPJPE {list(fper_frame)} against "
                            f"the serving slice {list(per_frame)}")
    per_batch = dict(dstd_spatial=2, dstd_temporal=2, dstd_encoder_chain=1)
    check(fcounts == {k: per_batch.get(k, 0) * nb for k in fcounts},
          f"the fused slice launched {fcounts} over {nb} batches, expected "
          f"{per_batch} per batch")
    report["fused_slice"] = dict(per_frame=[float(m) for m in fper_frame],
                                 avg=float(favg), batch_seconds=fbatches,
                                 launches=fcounts, mpjpe_rel=mpjpe_rel,
                                 wall=fwall)

    # batch-1 requests: an eval sweep of single sequences through test()
    ones = Loader([a[:4] for a in dataset.arrays()], 1)
    before = fused.launch_counts()
    frunner._test_once(ones, dataset)
    after = fused.launch_counts()
    freq_ms = [t * 1e3 for t in feng.test_batch_seconds]
    print(f"fused: 4 batch-1 eval requests, ms "
          f"{[round(m, 3) for m in freq_ms]}")
    check({k: after[k] - before[k] for k in per_batch}
          == {k: 4 * v for k, v in per_batch.items()},
          f"batch-1 eval sweep launched {after} (before {before})")
    report["fused_batch1_ms"] = freq_ms

    # where the time of one batch-32 fused forward goes, beside the
    # standard forward of this run (phase 4)
    fforward = feng._eval_forward()

    def fused_forward():
        with torch.inference_mode():
            return feng._serve(inputs[:N], fforward, None, None)

    ffwd_call = time_ms(torch, fused_forward, 5)
    fprof = device_profile(torch, fused_forward, 5)
    ffwd_dev = sum(fprof.values())
    top = sorted(fprof.items(), key=lambda kv: -kv[1])[:6]
    fbusy = (f"{ffwd_dev:.3f} ms ({100 * ffwd_dev / ffwd_call:.1f}%)"
             if fprof else "not measured (the profiler recorded nothing)")
    print(f"profile: batch-{N} fused forward {ffwd_call:.3f} ms per call, "
          f"device busy {fbusy} (standard forward {fwd_call:.3f} ms, device "
          f"{fwd_dev:.3f} ms); top "
          + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top))
    def fused_request():
        with torch.inference_mode():
            return feng._serve(inputs[:1], fforward, None, None)

    f1_call = time_ms(torch, fused_request, 10)
    print(f"serve: fused forward ms per call, batch 1 {f1_call:.3f} "
          f"(standard {paths['kernel'][1]:.3f})")
    report["fused_profile"] = dict(call_ms=ffwd_call, device_ms=ffwd_dev,
                                   by_kernel=fprof, batch1_call_ms=f1_call)

    # one full batch with BatchNorm calibrated (phase 4's weights): the
    # fused path against the plain path
    feng.model.load_state_dict(plain_engine.model.state_dict())
    before = fused.launch_counts()
    with torch.inference_mode():
        got = feng._serve(batch, feng._eval_forward(), None, None)
    want = plain_engine.predict(batch)
    torch.cuda.synchronize()
    after = fused.launch_counts()
    abs_err, rel_err, ok = errors(torch, got, want)
    print(f"fused: batch {N} fused path vs plain path max_abs_err {abs_err} "
          f"max_rel_err {rel_err} (|out| max {float(want.abs().max())})")
    check(ok, f"fused model output disagrees with the plain path (max abs "
              f"err {abs_err})")
    check({k: after[k] - before[k] for k in per_batch} == per_batch,
          "the fused forward did not launch 1 encoder, 2 spatial and 2 "
          "temporal kernels")
    report["fused_check"] = dict(max_abs_err=abs_err, max_rel_err=rel_err)

    # 6. dstd_chain's own path (the kernel API, as bench.py calls it, with
    # its gradient): one forward and backward of the 5-block chain at N=32,
    # counts from zero
    fused.reset_launch_counts()
    leaves, rebuilt = chain_leaves(torch, h, normalized["right"])
    cgrads = torch.autograd.grad(fused.dstd_chain(leaves[0], rebuilt,
                                                  "right"),
                                 leaves, torch.ones_like(h))
    torch.cuda.synchronize()
    ccounts = fused.launch_counts()
    print(f"chain: one forward and backward of dstd_chain, launches "
          f"{ccounts}")
    replay = dict(dstd_spatial=n_layers, dstd_temporal=n_layers,
                  dstd_spatial_bwd=n_layers * fused.BWD_LAUNCHES,
                  dstd_temporal_bwd=n_layers * fused.BWD_LAUNCHES)
    check(ccounts == {**{k: 0 for k in ccounts}, **replay, "dstd_chain": 1},
          f"dstd_chain forward and backward launched {ccounts}")
    # the same at bf16, counts from zero: one bf16 chain launch, and the
    # backward replays the chain at float32 (as the JAX package's VJP of its
    # float32 oracle does), so the gradients are the float32 chain's, bit
    # for bit, and no bf16 one-op kernel runs
    fused.reset_launch_counts()
    leaves, rebuilt = chain_leaves(torch, h, normalized["right"])
    bgrads = torch.autograd.grad(fused.dstd_chain(
        leaves[0], rebuilt, "right", torch.bfloat16), leaves,
        torch.ones_like(h))
    torch.cuda.synchronize()
    bf16_ccounts = fused.launch_counts()
    same = all(bool(torch.equal(a, b)) for a, b in zip(bgrads, cgrads))
    print(f"chain: one bf16 forward and backward of dstd_chain, launches "
          f"{bf16_ccounts}; gradients equal to the float32 chain's: {same}")
    check(bf16_ccounts == {**{k: 0 for k in bf16_ccounts}, **replay,
                           "dstd_chain_bf16": 1},
          f"bf16 dstd_chain forward and backward launched {bf16_ccounts}")
    check(same, "the bf16 dstd_chain's gradients differ from the float32 "
                "chain's")
    report["chain_path"] = dict(float32=ccounts, bf16=bf16_ccounts,
                                bf16_grads_equal_f32=same)
    del leaves, rebuilt, cgrads, bgrads

    # 7. the training slice through its entry point, counts from zero
    tcfg = configs.synthetic_h36m_train()
    rcfg = resolve(tcfg)
    epochs = rcfg["epoch"]
    n_train = rcfg["dataset"]["train"]["synthetic"]["num_sequences"]
    n_test = rcfg["dataset"]["test"]["synthetic"]["num_sequences"]
    steps = epochs * -(-n_train // rcfg["train_batch_size"])
    evals = epochs * -(-n_test // rcfg["test_batch_size"])
    train_dir = os.path.join(OUT_DIR, "train")
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    trunner, history = run(tcfg, "cuda", run_dir=train_dir)
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    tcounts = fused.launch_counts()
    teng = trunner.engine
    step_s = teng.train_step_seconds
    rows = np.asarray(history, dtype=np.float64)
    print(f"train: main.run on cuda, {len(step_s)} steps of "
          f"{rcfg['train_batch_size']} and {evals} eval batches in "
          f"{twall:.2f} s; per epoch (epoch, lr, train loss, test loss, "
          f"per-frame MPJPE) {rows.tolist()}")
    print(f"train: wall ms per step, first {step_s[0] * 1e3:.3f}, then "
          f"median {float(np.median(step_s[1:])) * 1e3:.3f} "
          f"(min {min(step_s[1:]) * 1e3:.3f}, max "
          f"{max(step_s[1:]) * 1e3:.3f})")
    print(f"train: launches {tcounts} over {steps} steps and {evals} eval "
          "batches")
    check(len(step_s) == steps, f"{len(step_s)} train steps, expected "
                                f"{steps}")
    check(rows.shape == (epochs, 3 + 1 + len(rcfg["setting"]["eval_frame"]))
          and bool(np.all(np.isfinite(rows))),
          "non-finite losses or MPJPE in training")
    with open(os.path.join(train_dir, "training_loss.csv")) as f:
        csv_rows = [line.strip().split(",") for line in f if line.strip()]
    check(csv_rows[0][:4] == ["epoch", "lr", "train_loss", "test_loss"]
          and len(csv_rows) == epochs + 2,
          f"training_loss.csv holds {csv_rows}")
    for ckpt in ("last.ckpt", "best.ckpt"):
        check(os.path.isfile(os.path.join(train_dir, "checkpoints", ckpt)),
              f"{ckpt} was not written")
    want_counts = {name: 14 * steps + 7 * evals for name in FORWARD}
    want_counts.update({name: fused.BWD_LAUNCHES * 14 * steps
                        for name in BACKWARD})
    want_counts.update({name: 0 for name in CHAINS + BF16_FORWARD
                        + BF16_BACKWARD + BF16_CHAINS})
    check(tcounts == want_counts, f"training launched {tcounts}, expected "
                                  f"{want_counts}")
    report["train"] = dict(history=rows.tolist(), step_seconds=step_s,
                           launches=tcounts, steps=steps, evals=evals,
                           wall=twall)

    # where the time of one train step goes on the card
    train_ds = get_dataset("synthetic", **rcfg["dataset"]["train"])
    tbatch = [a[:N] for a in train_ds.arrays()[:3]]

    def train_step():
        return teng.train_step(*tbatch)

    step_call = time_ms(torch, train_step, 5)
    shost = {}
    sprof = device_profile(torch, train_step, 3, host=shost)
    step_dev = sum(sprof.values())
    top = sorted(sprof.items(), key=lambda kv: -kv[1])[:8]
    busy = (f"{step_dev:.3f} ms ({100 * step_dev / step_call:.1f}%)"
            if sprof else "not measured (the profiler recorded nothing)")
    print(f"profile: batch-{N} train step {step_call:.3f} ms per call, "
          f"device busy {busy}; top "
          + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top))
    htop = sorted(shost.items(), key=lambda kv: -kv[1])[:10]
    print(f"profile: train step host self time {sum(shost.values()):.3f} "
          "ms per call (under the profiler); top "
          + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in htop))
    report["train_profile"] = dict(call_ms=step_call, device_ms=step_dev,
                                   by_kernel=sprof, host_ms=shost)

    # one train step on one batch: kernel path against the plain path, same
    # weights, dropout 0, BatchNorm calibrated on the batch
    report["train_check"], peng = train_step_check(torch, fused, teng, rcfg,
                                                   tbatch, "train")

    # the train step timed on both paths (CUDA events, host included; the
    # profiler's device time beside it)
    tpaths = {}
    for label, eng in (("kernel", teng), ("plain", peng)):
        def one(eng=eng):
            return eng.train_step(*tbatch)
        tpaths[label] = dict(call_ms=time_ms(torch, one, 10),
                             device_ms=sum(device_profile(torch, one,
                                                          3).values()))
    print(f"train: step ms per call, kernel path vs plain path: "
          f"{tpaths['kernel']['call_ms']:.3f} vs "
          f"{tpaths['plain']['call_ms']:.3f}; device "
          f"{tpaths['kernel']['device_ms']:.3f} vs "
          f"{tpaths['plain']['device_ms']:.3f}")
    report["train_paths_ms"] = tpaths

    # 8. the blocked sparse surface at the large graph
    from dstdgcn_tpu_torch.kernels import sparse
    report["sparse"], sparse_entries = sparse_phase(torch, np, sparse, fused,
                                                    device)

    # 8b. Graph WaveNet's dense adaptive hop against float64 and torch.mm
    report["dense"], dense_entry = dense_phase(torch, np, device)

    # 9. the bf16 training slice and one bf16 train step against the plain
    # path of the same contract
    report["bf16"], bcounts = bf16_phase(torch, np, fused, device)

    # 10. the bf16 fused serving slice and one calibrated batch against the
    # plain path of the same function
    report["fused_bf16"], fbcounts = fused_bf16_phase(torch, np, fused,
                                                      device)

    # 11. the real-dataset slice: H36M, CMU Mocap and 3DPW trees through
    # the loaders, training and per-action evaluation on the kernels
    report["real"], rcounts = real_data_phase(torch, np, fused, plain,
                                              plain_bwd, device)

    # 12. the engine remainder: remat, the solver, callbacks, the profiler
    # trace, a JAX-layout checkpoint, time_looped and visualize-debug
    report["engine"], ecounts = engine_phase(torch, np, fused, device)

    # 13. the parallel slice: world size 1 under NCCL against phase 7, then
    # two ranks on the one card over gloo
    report["parallel"], dcounts = parallel_phase(torch, np, fused, plain,
                                                 device, rows, tcounts)

    # 14. the graph and model axes: two gloo ranks on the one card through
    # the graph, model and fast graph slices
    report["axes"], acounts = axis_phase(torch, np, fused, plain, plain_bwd,
                                         device)

    # 15. the remaining configurations: the CMU and 3DPW TPU profiles at
    # batch 128 in bf16 and the fast variant through the kernels
    report["profiles"], pcounts = profiles_phase(torch, np, fused, plain,
                                                 plain_bwd, device)

    # 16. the kernels line.  One-op kernels: times summed over the 7 calls
    # of one forward (or of its backward) at their (Ci, Co), with the
    # model's aggregation, N=32 for the float32 kernels and N=128 (the bf16
    # slice's batch) for the bf16 variants; launches those of the training
    # slice (float32) or the bf16 slice, the serving slice's beside them.
    # Chain kernels: one call over the 5 encoder layers, N=32 for the
    # float32 kernels and N=128 (the bf16 fused slice's batch) for the bf16
    # ones; launches those of the fused slices (the encoder) and of
    # dstd_chain's own path (phase 6 and its bf16 pass).
    main_launches = dict(
        tcounts, dstd_encoder_chain=fcounts["dstd_encoder_chain"],
        dstd_chain=ccounts["dstd_chain"],
        dstd_encoder_chain_bf16=fbcounts["dstd_encoder_chain_bf16"],
        dstd_chain_bf16=bf16_ccounts["dstd_chain_bf16"],
        **{k: bcounts[k] for k in BF16_FORWARD + BF16_BACKWARD})
    kernels = []
    for name, meta in KERNELS.items():
        if name in SPARSE:
            kernels.append(sparse_entries[name])
            continue
        if name == "dense_hop":
            kernels.append(dense_entry)
            continue
        if name in CHAINS + BF16_CHAINS:
            ms, plain_ms, call_ms, k_by, _ = timings[(name, agg_main)]
            split = None
            timed_by = {k_by}
            bf16 = name in BF16_CHAINS
            b_ms, ops_ms, mem_ms = bound_of(*chain_cost(
                nf16 if bf16 else N, feat, n_layers,
                name.startswith("dstd_encoder_chain"),
                torch.bfloat16 if bf16 else None))
        else:
            mode = name.split("_")[1]
            backward = "_bwd" in name
            bf16 = name.endswith("_bf16")
            n, dtype = (nb16, torch.bfloat16) if bf16 else (N, None)
            ms = plain_ms = call_ms = b_ms = ops_ms = mem_ms = 0.0
            split = dict.fromkeys(BWD_PASSES, 0.0) if backward else None
            timed_by = set()
            for m, ci, co in forward_shapes(bmodel_cfg if bf16
                                            else model_cfg):
                if m != mode:
                    continue
                k_t, p_t, k_call, k_by, k_split = timings[(name, ci, co,
                                                           agg_main)]
                timed_by.add(k_by)
                for key, t in (k_split or {}).items():
                    split[key] += t
                b, t_ops, t_mem = bound_ms(mode, n, ci, co, backward, dtype)
                ms, plain_ms, b_ms = ms + k_t, plain_ms + p_t, b_ms + b
                call_ms += k_call
                ops_ms, mem_ms = ops_ms + t_ops, mem_ms + t_mem
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=main_launches[name],
            max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms,
            bound_by="operations" if ops_ms >= mem_ms else "bytes",
            library_ms=None, call_ms=call_ms,
            serving_launches=counts[name], fused_launches=fcounts[name],
            real_launches={k: c[name] for k, c in rcounts.items()},
            dp_launches={k: c[name] for k, c in dcounts.items()},
            axis_launches={cfg: {r: c[name] for r, c in per.items()}
                           for cfg, per in acounts.items()},
            profile_launches={run: c[name] for run, c in pcounts.items()},
            profile_ms=report["profiles"]["kernel_ms"].get(name, {}),
            timed_by="+".join(sorted(timed_by))))
        if name in FORWARD + BACKWARD:
            kernels[-1].update(remat_launches=ecounts[name])
        if split is not None:
            kernels[-1].update(launch_ms=split)
        if name.endswith("_bf16"):
            kernels[-1].update(n=nf16 if name in BF16_CHAINS else nb16)
    report["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main():
    if sys.argv[1:] == ["--dp-rank"]:   # a rank of phase 13's launch
        dp_rank_main()
        return 0
    if sys.argv[1:] == ["--axis-rank"]:   # a rank of phase 14's launch
        axis_rank_main()
        return 0
    if sys.argv[1:2] == ["--probe-rank"]:   # a rank of phase 13's probe
        probe_rank_main(sys.argv[2].split(","))
        return 0
    try:
        result = run_smoke()
    except Exception:  # any failed phase: report it, print no result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
