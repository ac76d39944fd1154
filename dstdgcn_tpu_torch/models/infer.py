"""Fused inference path of the DSTD-GCN.

Counterpart of ``dstdgcn_tpu/models/infer.py``: the eval-mode forward with
the ``num_layers`` residual encoder layers as ONE launch of the
whole-encoder kernel (:data:`..kernels.fused.dstd_encoder_chain`), which
keeps the activation out of the per-op round trips of the standard forward.
The channel-changing in and out layers (6 -> C, C -> 3) are the XLA ops of
the JAX package (``ops/dstd.py::dstd_spatial`` / ``dstd_temporal``): at
float32 they run through the one-op kernel wrappers
:data:`..kernels.fused.dstd_spatial` / ``dstd_temporal``, which compute the
same function (their plain ops on CPU tensors); with a compute dtype they
run the port's plain :func:`..ops.dstd.dstd_spatial` / ``dstd_temporal``
with it, which round where the XLA ops round (q, k and the adjacency in the
dtype, the output in the dtype) and not where the kernels' bf16 variants
do.  The encoder takes the dtype as the JAX kernel does: on the card the
bf16 variant of the whole-encoder kernel.

It reads a :class:`.dstdgcn.DSTDGCN` module tree, whose names follow the
flax tree the JAX functions read.  :func:`fused_weights` derives what the
forward needs once (bases, folded BatchNorms, the encoder's weights stacked
for the kernel); pass it to :func:`fused_eval_forward` to reuse it while the
weights stay fixed, as the engine does for one evaluation sweep.  Eval only:
BatchNorm uses its running statistics and dropout is the identity.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..kernels import fused as fk
from ..ops import dstd as plain

__all__ = ["encoder_chain_params", "fused_weights", "fused_eval_forward",
           "FusedWeights"]


def _affine(bn) -> torch.Tensor:
    return fk.bn_affine(bn.scale, bn.bias, bn.mean, bn.var, bn.eps)


def _dstd_args(op) -> tuple:
    return (op.wf, op.bf, op.wm1, op.bm1, op.wm2, op.bm2, op.wrm, op.brm)


def _block_bases(blk):
    """Effective static adjacencies (spatial, temporal) of a DSTDGCB, as its
    forward forms them (``R_s * W_s + R_s`` is the JAX package's
    ``R_s * (1 + W_s)``)."""
    base_s = blk.A_s if blk.fast else blk.R_s.detach() * blk.W_s + blk.R_s
    return base_s, blk.A_t + blk.R_t


def _op_args(blk):
    """The (spatial, temporal) 10-tuples of a DSTDGCB's two ops."""
    base_s, base_t = _block_bases(blk)
    return ((base_s, blk.alpha_sm, *_dstd_args(blk.spatial)),
            (base_t, blk.alpha_tm, *_dstd_args(blk.temporal)))


def encoder_chain_params(model) -> List[tuple]:
    """The ``dstd_encoder_chain`` layers of ``model``: per encoder layer the
    two ops' 10-tuples, the block's and the model's BatchNorm folded to
    affines, and the two PReLU slopes."""
    layers = []
    for i in range(model.num_layers):
        blk = getattr(model, f"encoder_{i}").block
        sp, tm = _op_args(blk)
        pa = torch.stack([
            blk.prelu.negative_slope.reshape(()),
            getattr(model, f"encoder_prelu_{i}").negative_slope.reshape(())])
        layers.append((sp, tm, _affine(blk.bn),
                       _affine(getattr(model, f"encoder_bn_{i}")), pa))
    return layers


def _prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, a.reshape(()) * x)


def _apply_affine(x: torch.Tensor, aff: torch.Tensor) -> torch.Tensor:
    return x * aff[0] + aff[1]


def _in_out_params(layer) -> tuple:
    """What one channel-changing ST_GCNN layer reads: the residual
    projection and its BatchNorm, the two ops, the block BatchNorm and the
    block PReLU slope."""
    blk = layer.block
    sp, tm = _op_args(blk)
    return (blk.residual_proj.kernel, blk.residual_proj.bias,
            _affine(blk.residual_bn), sp, _affine(blk.bn),
            blk.prelu.negative_slope, tm)


def _in_out_layer(x: torch.Tensor, params: tuple, agg: str,
                  dtype) -> torch.Tensor:
    """One channel-changing ST_GCNN layer (refine, residual=False): the
    DSTDGCB body with a projected residual.  The ops are the XLA ops of the
    JAX function: the kernel wrappers at float32, the plain ops with a
    ``dtype`` (their rounding, not the kernels')."""
    kernel, bias, res_aff, sp, bn_aff, slope, tm = params
    ops = fk if dtype in (None, torch.float32) else plain
    res = _apply_affine(x @ kernel + bias, res_aff)
    y = ops.dstd_spatial(x, *sp, None, agg, dtype)
    y = _prelu(_apply_affine(y, bn_aff) + res, slope)
    return ops.dstd_temporal(y, *tm, None, agg, dtype).float()


class FusedWeights(NamedTuple):
    """Everything :func:`fused_eval_forward` reads from the model."""
    conv_in: tuple
    bn_in: torch.Tensor
    prelu: torch.Tensor
    encoder: fk.ChainWeights
    conv_out: tuple


@torch.no_grad()
def fused_weights(model) -> FusedWeights:
    """Derive the fused forward's weights from ``model`` once: bases and
    folded BatchNorms, and the encoder layers stacked for the kernel."""
    return FusedWeights(_in_out_params(model.conv_st_in),
                        _affine(model.bn_in), model.prelu.negative_slope,
                        fk.pack_chain(encoder_chain_params(model)),
                        _in_out_params(model.conv_st_out))


def fused_eval_forward(model, x: torch.Tensor, dtype=None,
                       weights: Optional[FusedWeights] = None
                       ) -> torch.Tensor:
    """Eval-mode DSTDGCN forward with the whole-encoder kernel.

    Equals ``model.eval()(x)``; ``x`` is the padded (N, T, V, 3) position
    sequence.  ``weights`` is :func:`fused_weights` of ``model``, derived
    here when not given.  ``dtype`` is the compute dtype: ``None``
    (float32) or ``torch.bfloat16``, the in and out layers on the plain ops
    with it and the encoder on the bf16 variant of its kernel.  The encoder
    kernel has no gradient: call under ``torch.no_grad()`` or
    ``torch.inference_mode()``.
    """
    w = fused_weights(model) if weights is None else weights
    agg = "left" if model.fast else "right"
    residual = x[:, -1:]
    h = torch.cat([x, x - residual], dim=-1)
    h = _in_out_layer(h, w.conv_in, agg, dtype)
    h = _prelu(_apply_affine(h, w.bn_in), w.prelu)  # dropout: eval = id
    h = fk.dstd_encoder_chain(h.contiguous(), w.encoder, agg, dtype)
    h = _in_out_layer(h, w.conv_out, agg, dtype)
    return h + residual
