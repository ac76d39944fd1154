"""The parsers ``chip_smoke.py`` reads its kernel evidence with, on the CPU.

``chip_smoke.py`` holds the card run to what the compiler and the profiler
report: registers and spills from ``nvcc -Xptxas -v`` (``ptxas_usage``),
tensor-core ``HMMA`` / ``DMMA`` instructions per function from ``cuobjdump
-sass`` (``sass_counts``, checked against ``uses_mma``), and the device time
of each of a backward call's four launches from ``torch.profiler`` keys
(``bwd_split``).  These tests feed them listings in the tools' formats.  The
bf16 train step's judgement (``step_verdict``) is held on made-up distances.
The removal variants of ``fwd_variants.py`` (a kernel's split by phase) must
each apply to this checkout's CUDA sources, the sparse ones to the code of
the kernels they name alone.  ``write_jax_checkpoint`` (phase 12's
JAX-layout checkpoint) reads back through ``flax.serialization``.  Phase
13's launch helpers: the ``DSTDGCN_*`` variables it starts each rank with
reach ``parallel.distributed.initialize`` as a user's would, its config is
the training slice with a data axis, it reads each rank's report, written
files and probe outcomes, and it kills a child past its deadline.  Phase
14's: its configs are the graph, model and fast graph slices cut to one
epoch, the launches it expects are one a DSTD-GC op a pass on each rank
(none on the plain path), the kernel shapes it checks first are those the
model axis adds, and it counts a step's collectives and restores
``torch.distributed`` after.  Phase 15 is the kernels line.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict

import chip_smoke as cs
import fwd_variants
from dstdgcn_tpu.engine import PredictionEngine as JaxEngine
from dstdgcn_tpu.engine.checkpoint import restore_checkpoint
from dstdgcn_tpu.models import get_model as jax_get_model
from dstdgcn_tpu_torch import configs
from dstdgcn_tpu_torch.data import Synthetic
from dstdgcn_tpu_torch.engine import PredictionEngine
from dstdgcn_tpu_torch.engine.checkpoint import (msgpack_restore,
                                                 read_jax_checkpoint)
from dstdgcn_tpu_torch.models import get_model

SASS = """
\tcode for sm_90a
\t\tFunction : _ZN8dstd_bwd10out_kernelILb0ELi5EN4dstd4Bf16EEEvNS_7BwdArgsE
\t.headerflags\t@"EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/          LDC R1, c[0x0][0x28] ;    /* 0x00000a00ff017b82 */
                                                    /* 0x000fe40000000800 */
        /*0010*/          HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
                                                    /* 0x000fe20000041804 */
        /*0020*/          HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
        /*0030*/          EXIT ;
\t\tFunction : _ZN8dstd_bwd13reduce_kernelILb0EEEvNS_7BwdArgsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R2, R3 ;
"""


def test_sass_counts_hmma_and_instructions_per_function():
    counts = cs.sass_counts(SASS)
    assert counts == {
        "_ZN8dstd_bwd10out_kernelILb0ELi5EN4dstd4Bf16EEEvNS_7BwdArgsE": (2, 4),
        "_ZN8dstd_bwd13reduce_kernelILb0EEEvNS_7BwdArgsE": (0, 2)}


def test_sass_counts_the_float64_tensor_core_products():
    """DMMA (mma.sync .f64, the float32 forward kernels' products) counts
    as a tensor-core instruction beside HMMA; the CUDA cores' DFMA does
    not."""
    sass = """
\t\tFunction : _ZN12_GLOBAL__N_115temporal_kernelILi4EN4dstd5ExactEEEvNS1_6OpArgsE
        /*0000*/          LDC R1, c[0x0][0x28] ;
        /*0010*/          DMMA.884 R4, R8, R12, R4 ;
        /*0020*/          DFMA R16, R8, R14, R16 ;
        /*0030*/          EXIT ;
"""
    assert list(cs.sass_counts(sass).values()) == [(1, 4)]


@pytest.mark.parametrize("function,mma", [
    ("dstd_bwd::out_kernel<false, 5, dstd::Bf16>", True),
    ("dstd_bwd::out_kernel<false, 1, dstd::Bf16>", True),
    ("dstd_bwd::src_kernel<false, 8, dstd::Bf16>", True),
    ("dstd_bwd::out_kernel<false, 5, dstd::Exact>", True),
    ("dstd_bwd::src_kernel<false, 1, dstd::Exact>", True),
    ("dstd_bwd::out_kernel<true, 5, dstd::Bf16>", True),
    ("dstd_bwd::src_kernel<true, 6, dstd::Bf16>", True),
    ("dstd_bwd::out_kernel<true, 5, dstd::Exact>", True),
    ("dstd_bwd::src_kernel<true, 8, dstd::Exact>", True),
    ("dstd_bwd::qk_kernel<false, dstd::Bf16>", False),
    ("dstd_bwd::qk_kernel<true, dstd::Exact>", False),
    ("dstd_bwd::reduce_kernel<false>", False),
    ("dstd_bwd::reduce_kernel<true>", False),
    # the forward kernels: both one-op kernels and every chain
    # instantiation (encoder or chain, both dtypes) on the tensor cores
    ("spatial_kernel<5, dstd::Bf16>", True),
    ("spatial_kernel<1, dstd::Bf16>", True),
    ("temporal_kernel<6, dstd::Bf16>", True),
    ("temporal_kernel<8, dstd::Bf16>", True),
    ("spatial_kernel<5, dstd::Exact>", True),
    ("spatial_kernel<2, dstd::Exact>", True),
    ("spatial_kernel<8, dstd::Exact>", True),
    ("temporal_kernel<6, dstd::Exact>", True),
    ("temporal_kernel<1, dstd::Exact>", True),
    ("chain_kernel<5, false, dstd::Bf16>", True),
    ("chain_kernel<1, false, dstd::Bf16>", True),
    ("chain_kernel<5, true, dstd::Bf16>", True),
    ("chain_kernel<1, true, dstd::Bf16>", True),
    ("chain_kernel<8, true, dstd::Bf16>", True),
    ("chain_kernel<5, true, dstd::Exact>", True),
    ("chain_kernel<1, false, dstd::Exact>", True),
    ("chain_kernel<5, false, dstd::Exact>", True),
    ("chain_kernel<8, false, dstd::Exact>", True),
    # the sparse kernels: the SpMM and the fused one on the tensor cores,
    # the SDDMM (no products) on the CUDA cores
    ("sddmm_spmm_kernel", True),
    ("spmm_kernel", True),
    ("sddmm_kernel", False),
])
def test_uses_mma_names_the_bf16_out_and_src_passes_of_both_ops(function,
                                                                mma):
    assert cs.uses_mma(function) is mma


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("backward", [False, True])
def test_op_cost_counts_float32_contractions_at_the_3xtf32_rate(mode,
                                                                backward):
    flops, nbytes, dots, peak = cs.op_cost(mode, 32, 64, 64, backward)
    assert peak == cs.PEAK_TF32_FLOPS / 3
    # the same split as the bf16 contract's, at the dense bf16 rate there;
    # the bf16 forward reads x as bf16, two bytes an element fewer
    x_saved = 0 if backward else 2 * 32 * cs.T * cs.V * 64
    assert cs.op_cost(mode, 32, 64, 64, backward, "bfloat16") == (
        flops, nbytes - x_saved, dots, cs.PEAK_BF16_FLOPS)
    assert 0 < flops < dots
    least, t_ops, t_mem = cs.bound_of(flops, nbytes, dots, peak)
    assert t_ops == pytest.approx(
        (flops / 67e12 + dots / (494.7e12 / 3)) * 1e3)
    assert least == max(t_ops, t_mem)
    # below the bound of every operation at the CUDA cores' 67 TFLOP/s
    assert t_ops < (flops + dots) / cs.PEAK_F32_FLOPS * 1e3


@pytest.mark.parametrize("name", ["block_spmm", "block_sddmm",
                                  "block_sddmm_spmm"])
def test_sparse_cost_splits_the_same_operations(name):
    n, blocks, block, r, c, v = 4, 174, 128, 4, 128, 4096
    flops, _, dots, peak = cs.sparse_cost(name, n, blocks, block, r, c, v)
    entries = n * blocks * block * block
    total = dict(block_spmm=2 * c, block_sddmm=4 * r,
                 block_sddmm_spmm=4 * r + 2 * c)[name] * entries
    assert flops + dots == total and peak == cs.PEAK_F32_DOT_FLOPS


def test_bwd_split_sums_each_launch_and_ignores_other_kernels():
    prof = {
        "void dstd_bwd::qk_kernel<false, dstd::Bf16>(dstd_bwd::BwdArgs)": 0.05,
        "void dstd_bwd::out_kernel<false, 5, dstd::Bf16>(dstd_bwd::BwdArgs)":
            0.4,
        "void dstd_bwd::src_kernel<false, 5, dstd::Bf16>(dstd_bwd::BwdArgs)":
            0.3,
        "void dstd_bwd::src_kernel<false, 3, dstd::Bf16>(dstd_bwd::BwdArgs)":
            0.1,
        "void dstd_bwd::reduce_kernel<false>(dstd_bwd::BwdArgs)": 0.08,
        "void (anonymous namespace)::spatial_kernel<5, dstd::Bf16>(...)": 1.0,
        "Memset (Device)": 0.01,
    }
    split = cs.bwd_split(prof)
    assert list(split) == list(cs.BWD_PASSES)
    assert split == pytest.approx(dict(qk=0.05, out=0.4, src=0.4,
                                       reduce=0.08))


def test_ptxas_usage_reads_registers_and_spills():
    log = """ptxas info : Compiling entry function 'plain_entry' for 'sm_90a'
ptxas info    : Function properties for plain_entry
    16 bytes stack frame, 52 bytes spill stores, 112 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function 'other_entry' for 'sm_90a'
ptxas info    : Used 32 registers, 384 bytes cmem[0]
"""
    assert cs.ptxas_usage(log) == [("plain_entry", 64, 52, 112),
                                   ("other_entry", 32, 0, 0)]


def test_sass_mma_fails_without_cuobjdump(monkeypatch):
    import shutil
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cs.os, "access", lambda path, mode: False)
    with pytest.raises(cs.SmokeFailure, match="cuobjdump"):
        cs.sass_mma("libdstd_spatial_bwd.so")


def step_errs(gate_k64, gate_p64, other_k64, other_p64):
    """``step_errors`` rows (kernel vs plain, gap, kernel vs float64, plain
    vs float64) of two gates and two other parameters, whose kernel and
    plain distances average to the given ones."""
    return {"encoder_0.block.alpha_sm": (0.0, 0.1, gate_k64 * 1.5,
                                         gate_p64 / 2),
            "encoder_0.block.alpha_tm": (0.0, 0.1, gate_k64 / 2,
                                         gate_p64 * 1.5),
            "encoder_0.block.spatial.wf": (0.0, 0.01, other_k64 * 2,
                                           other_p64),
            "conv_st_in.block.residual_proj.kernel": (0.0, 0.01, 0.0,
                                                      other_p64)}


@pytest.mark.parametrize("errs,passes", [
    (step_errs(0.03, 0.02, 0.004, 0.003), dict(gates=True, others=True)),
    # twice the plain path's own mean distance is the limit, in each group
    (step_errs(0.04, 0.02, 0.006, 0.003), dict(gates=True, others=True)),
    (step_errs(0.041, 0.02, 0.004, 0.003), dict(gates=False, others=True)),
    (step_errs(0.03, 0.02, 0.0061, 0.003), dict(gates=True, others=False)),
])
def test_step_verdict_holds_each_group_to_the_plain_paths_noise(errs,
                                                                 passes):
    verdict = cs.step_verdict(errs)
    assert set(verdict) == {"gates", "others"}
    for group, (k64, p64, bound, worst) in verdict.items():
        assert bound == pytest.approx(cs.BF16_STEP_NOISE * p64)
        assert (k64 <= bound * (1 + 1e-12)) is passes[group]
    gates = ("encoder_0.block.alpha_sm", "encoder_0.block.alpha_tm")
    assert verdict["gates"][0] == pytest.approx(
        sum(errs[n][2] for n in gates) / 2)
    assert verdict["gates"][1] == pytest.approx(
        sum(errs[n][3] for n in gates) / 2)
    assert verdict["gates"][3] == "encoder_0.block.alpha_sm"
    assert verdict["others"][3] == "encoder_0.block.spatial.wf"


@pytest.mark.parametrize("err,k64,p64,held", [
    # within the fraction of the gap: held, wherever float64 lies
    (0.25, 0.9, 0.01, True),
    (0.3, 0.9, 0.01, True),
    # past the fraction, but as near float64 as twice the plain contract
    (0.4, 0.38, 0.2, True),
    # past the fraction; near float64 within the fraction itself
    (0.4, 0.3, 0.01, True),
    # past both
    (0.4, 0.42, 0.2, False),
    (1.0, 0.31, 0.01, False),
])
def test_chain_held_past_its_fraction_only_near_float64(err, k64, p64,
                                                        held):
    gap, frac = 2.0, 0.3
    assert cs.chain_held(err * gap, gap, frac, k64 * gap,
                         p64 * gap) is held
    # the plain contract's farthest run sets the bound
    assert cs.chain_held(err * gap, gap, frac, k64 * gap, 0.0,
                         p64 * gap) is held


@pytest.mark.parametrize("seed", [1044, 1079])
def test_rounding_deltas_are_seeded_and_one_rounding_wide(seed):
    import torch
    shape = (2, 5, 3, 4)
    first = cs.rounding_deltas(torch, shape, 6, seed)
    again = cs.rounding_deltas(torch, shape, 6, seed)
    other = cs.rounding_deltas(torch, shape, 6, seed + 1)
    assert len(first) == cs.ROUNDING_RUNS
    assert all(len(run) == 6 for run in first)
    for run, run2, run3 in zip(first, again, other):
        for d, d2, d3 in zip(run, run2, run3):
            assert d.shape == shape and d.dtype == torch.float32
            assert torch.equal(d, d2) and not torch.equal(d, d3)
            assert float(d.abs().max()) <= cs.ROUNDING_UNIT
    # the ops of a run and the runs draw apart
    assert not torch.equal(first[0][0], first[0][1])
    assert not torch.equal(first[0][0], first[1][0])


@pytest.mark.parametrize("agg", ["right", "left"])
def test_rounded_chain_is_the_plain_chain_one_rounding_apart(agg):
    """With zero deltas the plain chain bit for bit; with the seeded ones
    each op's output at most one float32 step from the plain op's on the
    same input."""
    import numpy as np
    import torch
    from dstdgcn_tpu_torch.kernels import fused
    rng = np.random.RandomState(0)
    t, v, c = 6, 5, 4

    def nrm(std, *shape):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32))

    blocks = [tuple((nrm(0.3, k, p, p), torch.tensor([0.5]), nrm(0.5, k, c, c),
                     nrm(0.1, k, c), nrm(0.5, k, c, 2), nrm(0.1, k, 2),
                     nrm(0.5, k, c, 2), nrm(0.1, k, 2),
                     nrm(0.3, k, 2, r, r), nrm(0.1, k, r))
                    for k, r, p in ((2, t, v), (1, v, t)))
              for _ in range(2)]
    x = nrm(1.0, 2, t, v, c)
    zeros = [torch.zeros_like(x)] * 4
    assert torch.equal(cs.rounded_chain(fused, x, blocks, agg, zeros),
                       fused._chain_oracle(x, blocks, agg))
    deltas = iter(cs.rounding_deltas(torch, x.shape, 4, 7)[0])
    h = x
    for sp, tm in blocks:
        for mode, w in (("spatial", sp), ("temporal", tm)):
            y = fused._plain_op(mode, h, w, agg, None)
            h = y + y * next(deltas)
            step = torch.abs(torch.nextafter(y, 2 * y) - y)
            assert bool(((h - y).abs() <= step).all())
    assert torch.equal(cs.rounded_chain(
        fused, x, blocks, agg, cs.rounding_deltas(torch, x.shape, 4, 7)[0]),
        h)


@pytest.mark.parametrize("name", sorted(fwd_variants.VARIANTS))
def test_fwd_variants_each_remove_their_phase_from_this_checkout(name,
                                                                 tmp_path):
    """Each variant's substitutions match this checkout's sources exactly
    once (``make`` exits otherwise) and change them."""
    root = os.path.dirname(os.path.abspath(fwd_variants.__file__))
    dst = fwd_variants.make(root, str(tmp_path), name)
    for rel, old, new in fwd_variants.VARIANTS[name]:
        with open(os.path.join(dst, rel)) as f:
            text = f.read()
        assert text.count(new) == 1 and old != new


def _sparse_sections(text):
    """[(start, end, kernels)] of ``fwd_variants.SPARSE_SECTIONS`` in a
    ``block_sparse.cu`` text; each marker once, in order."""
    marks = [m for m, _ in fwd_variants.SPARSE_SECTIONS] + [
        fwd_variants.SPARSE_END]
    assert all(text.count(m) == 1 for m in marks)
    at = [text.index(m) for m in marks]
    assert at == sorted(at)
    return [(a, b, kernels) for a, b, (_, kernels) in
            zip(at, at[1:], fwd_variants.SPARSE_SECTIONS)]


@pytest.mark.parametrize("name", sorted(fwd_variants.SPARSE_KERNELS))
def test_sparse_variants_change_only_their_kernels(name, tmp_path):
    """A variant of the block-sparse kernels changes the sections of
    ``block_sparse.cu`` whose kernels are exactly those
    ``SPARSE_KERNELS`` names for it, and no other text: every other
    kernel times the same code in the variant's tree."""
    root = os.path.dirname(os.path.abspath(fwd_variants.__file__))
    dst = fwd_variants.make(root, str(tmp_path), name)
    (rel, _, _), = fwd_variants.VARIANTS[name]
    texts = []
    for tree in (root, dst):
        with open(os.path.join(tree, rel)) as f:
            texts.append(f.read())
    old, new = (_sparse_sections(text) for text in texts)
    assert texts[0][:old[0][0]] == texts[1][:new[0][0]]
    assert texts[0][old[-1][1]:] == texts[1][new[-1][1]:]
    changed = set()
    for (a0, a1, kernels), (b0, b1, _) in zip(old, new):
        if texts[0][a0:a1] != texts[1][b0:b1]:
            changed.update(kernels)
    assert changed == set(fwd_variants.SPARSE_KERNELS[name])


def test_every_sparse_variant_names_its_kernels():
    sparse = {name for name, edits in fwd_variants.VARIANTS.items()
              if edits[0][0].endswith("block_sparse.cu")}
    assert sparse == set(fwd_variants.SPARSE_KERNELS)


#: the engine forms ``chip_smoke.jax_train_state`` writes: the engine
#: slice's solver block, and Adam alone, with L2 decay, under the clip
JAX_FORMS = {
    "slice_solver": {},
    "adam": dict(solver=None),
    "adam_l2": dict(solver=None, learn=dict(opt="adam", lr=3e-3,
                                            weight_decay=1e-4, gamma=0.9,
                                            step_size=5)),
    "adam_clip": dict(solver=None, clip=1.0),
}


@pytest.mark.parametrize("form", list(JAX_FORMS))
def test_write_jax_checkpoint_reads_back_through_flax(form, tmp_path):
    """The bytes of ``write_jax_checkpoint`` restore through
    ``flax.serialization`` into the JAX engine's ``TrainState`` for the
    same engine block (``restore_checkpoint``: the same tree, shapes and
    dtypes), with the port engine's parameters, statistics and Adam
    moments; the port's own reader gives what flax's ``msgpack_restore``
    gives."""
    small = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
                 st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=8,
                 num_layers=1, layout="h36m", remat=True)
    ecfg = dict(configs.synthetic_h36m_engine_train()["engine"],
                **JAX_FORMS[form])
    for key in ("callbacks", "profile", "profile_steps"):
        ecfg.pop(key)
    if ecfg["solver"] is None:
        del ecfg["solver"]
    ds = Synthetic(layout="h36m", num_sequences=16, input_n=4, output_n=4,
                   mode="train")
    eng = PredictionEngine(dict(ecfg), get_model("dstdgcn", dstdgcn=small),
                           device="cpu")
    eng.init()
    for i in range(2):
        eng.train_step(*[a[i * 8:(i + 1) * 8] for a in ds.arrays()[:3]])
    payload = dict(lr=eng.lr, err=3.25, epoch=1)
    path = str(tmp_path / "jax.ckpt")
    cs.write_jax_checkpoint(path, eng, payload)

    jsmall = {k: v for k, v in small.items() if k != "remat"}
    jeng = JaxEngine(dict(ecfg), jax_get_model("dstdgcn", dstdgcn=jsmall))
    jeng.init(ds.input_seqs[:1])
    state, got_payload = restore_checkpoint(path, jeng.state)
    assert got_payload == payload
    same = jax.tree.map(lambda a, b: a.shape == b.shape and a.dtype == b.dtype,
                        state, jeng.state)
    assert all(jax.tree.leaves(same))
    flat = {name: p.detach().numpy()
            for name, p in eng.model.named_parameters()}
    for key, val in flatten_dict(jax.tree.map(np.asarray, state.params),
                                 sep=".").items():
        np.testing.assert_array_equal(val, flat[key])
    stats = eng.model.state_dict()
    for key, val in flatten_dict(jax.tree.map(
            np.asarray, state.batch_stats), sep=".").items():
        np.testing.assert_array_equal(val, stats[key].numpy())
    # every parameter's Adam moments somewhere in the optax state, at its
    # count
    opt_sd = serialization.to_state_dict(jax.device_get(state.opt_state))
    nodes = []

    def walk(tree):
        if isinstance(tree, dict):
            if set(tree) == {"count", "mu", "nu"}:
                nodes.append(tree)
            for v in tree.values():
                walk(v)

    walk(opt_sd)
    assert nodes and all(int(n["count"]) == 2 for n in nodes)
    for name, p in eng.model.named_parameters():
        found = []
        for node in nodes:
            mu, nu = node["mu"], node["nu"]
            for part in name.split("."):
                mu, nu = mu[part], nu[part]
            if not isinstance(mu, dict):
                found.append((mu, nu))
        assert len(found) == 1, name
        st = eng.optimizer.state[p]
        np.testing.assert_array_equal(found[0][0], st["exp_avg"].numpy())
        np.testing.assert_array_equal(found[0][1], st["exp_avg_sq"].numpy())
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        f.read(n)
        blob = f.read()
    flat_flax = flatten_dict(serialization.msgpack_restore(blob), sep=".")
    flat_mine = flatten_dict(read_jax_checkpoint(path)[0], sep=".")
    assert flat_flax.keys() == flat_mine.keys()
    for key, val in flat_flax.items():
        np.testing.assert_array_equal(flat_mine[key], val)
    assert msgpack_restore(blob).keys() == {"params", "batch_stats",
                                            "opt_state", "dropout_key"}
    # the port recovers its own engine's state from it, bit for bit
    back = PredictionEngine(dict(ecfg), get_model("dstdgcn", dstdgcn=small),
                            device="cpu")
    back.init(seed=4)
    assert back.recover(path) == (1, 3.25)
    for a, b in zip(eng.model.state_dict().values(),
                    back.model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", [None, "gloo"])
def test_launch_env_reaches_initialize_as_the_users_recipe(monkeypatch,
                                                          backend):
    from dstdgcn_tpu_torch.parallel import distributed
    captured = {}

    def fake_init(name, **kw):
        captured.update(kw, backend=name)

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    env = cs.launch_env("127.0.0.1:29500", 2, 1, backend)
    assert set(env) <= set(cs.LAUNCH_VARS)
    for key in cs.LAUNCH_VARS:
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    distributed.initialize(None, device="cuda")
    assert captured == dict(backend=backend or "nccl",
                            init_method="tcp://127.0.0.1:29500",
                            world_size=2, rank=1,
                            timeout=distributed.TIMEOUT)


def test_dp_config_is_the_training_slice_with_a_data_axis():
    cfg = cs.dp_config(cs.DP_STEPS)
    assert cfg.pop("parallel") == {"data": "auto"}
    assert cfg["engine"].pop("max_iter") == cs.DP_STEPS
    want = configs.synthetic_h36m_train()
    want["engine"].pop("max_iter")
    assert cfg == want
    assert cs.dp_config()["engine"]["max_iter"] == -1
    # a global batch that splits over the ranks, several steps an epoch
    assert want["train_batch_size"] % cs.DP_RANKS == 0
    assert want["dataset"]["train"]["synthetic"]["num_sequences"] >= \
        cs.DP_STEPS * want["train_batch_size"]


def test_rank_report_and_files_under(tmp_path):
    log = 'noise\ndp_rank {"rank": 1, "launches": {"dstd_spatial": 3}}\n'
    assert cs.rank_report(log) == {"rank": 1,
                                   "launches": {"dstd_spatial": 3}}
    assert cs.rank_report('axis_rank {"graph": {"rank": 0}}\n',
                          "axis_rank") == {"graph": {"rank": 0}}
    with pytest.raises(cs.SmokeFailure, match="no report"):
        cs.rank_report(log, "axis_rank")
    with pytest.raises(cs.SmokeFailure, match="no report"):
        cs.rank_report("Traceback: boom")
    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "empty").mkdir()
    (tmp_path / "checkpoints" / "last.ckpt").write_text("x")
    (tmp_path / "log.txt").write_text("x")
    assert cs.files_under(tmp_path) == [
        os.path.join("checkpoints", "last.ckpt"), "log.txt"]
    assert cs.files_under(tmp_path / "empty") == []


def test_step_numel_counts_the_flat_all_reduce():
    model = get_model("dstdgcn", dstdgcn=dict(
        input_channels=6, input_time_frame=4, output_time_frame=4,
        st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=8,
        num_layers=1, layout="h36m"))
    eng = PredictionEngine(configs.synthetic_h36m_train()["engine"], model,
                           device="cpu")
    eng.init()
    losses = eng.compute_gradients(*np.zeros((3, 2, 8, 66), np.float32))
    assert cs.step_numel(model) == sum(
        p.grad.numel() for p in model.parameters()) + len(losses)


def test_probe_outcome_reads_each_op_and_a_crash():
    log = ("probe_start all_reduce\nprobe_op {\"all_reduce\": \"ok\"}\n"
           "probe_start all_gather_into_tensor\n"
           "terminate called after throwing an instance of 'X'\n"
           "  what():  writev: Bad address\n")
    assert cs.probe_outcome(log, -6) == {
        "all_reduce": "ok",
        "all_gather_into_tensor": "process ended (-6): what():  writev: "
                                  "Bad address"}
    warn = ("host:1:1 [0] NCCL WARN Duplicate GPU detected : rank 1 and "
            "rank 0 both on CUDA device 1000\nprobe_start all_reduce\n"
            'probe_op {"all_reduce": "NCCL error: invalid usage"}\n')
    got = cs.probe_outcome(warn, 0)
    assert got["all_reduce"] == "NCCL error: invalid usage"
    assert "Duplicate GPU detected" in got["nccl_warn"]
    assert {ops for _, ops in cs.PROBES} >= {("batch_isend_irecv",)}


def test_finish_ranks_kills_what_outlives_the_deadline():
    import subprocess
    import sys
    import time
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for code in ("print('done')", "import time; time.sleep(120)")]
    t0 = time.monotonic()
    (rc0, log0), (rc1, log1) = cs.finish_ranks(procs, t0 + 5)
    assert time.monotonic() - t0 < 60
    assert (rc0, log0) == (0, "done\n")
    assert rc1 != 0 and "killed at the time limit" in log1
    assert all(p.poll() is not None for p in procs)


@pytest.mark.parametrize("name", cs.AXIS_CONFIGS)
def test_axis_configs_are_the_parallel_slices_cut_to_one_epoch(name):
    cfg = cs.axis_config(name)
    want = getattr(configs, f"synthetic_h36m_{name}_train")()
    assert cfg.pop("epoch") == 1 and want.pop("epoch") == 2
    assert cfg["engine"].pop("max_iter") == cs.AXIS_STEPS
    want["engine"].pop("max_iter")
    assert cfg == want
    axes = {k: v for k, v in cfg["parallel"].items()
            if k in ("graph", "model")}
    assert list(axes.values()) == [cs.AXIS_RANKS]
    assert cfg["dataset"]["train"]["synthetic"]["num_sequences"] >= \
        cs.AXIS_STEPS * cfg["train_batch_size"]


def test_axis_launches_are_one_an_op_a_pass_on_each_rank():
    from dstdgcn_tpu_torch.kernels import fused
    from dstdgcn_tpu_torch.utils.config import resolve
    graph = cs.axis_launches(fused, resolve(cs.axis_config("graph")), 2)
    # 3 steps of 14 ops (7 blocks, two passes), 2 eval batches of 7
    assert {k: graph[k] for k in cs.FORWARD} == dict.fromkeys(
        cs.FORWARD, 14 * 3 + 7 * 2)
    assert {k: graph[k] for k in cs.BACKWARD} == dict.fromkeys(
        cs.BACKWARD, fused.BWD_LAUNCHES * 14 * 3)
    assert cs.axis_launches(fused, resolve(cs.axis_config("model")),
                            2) == graph
    fast = cs.axis_launches(fused, resolve(cs.axis_config("fast_graph")), 2)
    assert set(fast.values()) == {0}      # the plain path
    assert set(fast) == set(graph) == set(fused.launch_counts())


def test_axis_shapes_are_what_the_model_axis_adds():
    cfg = configs.synthetic_h36m_model_train()["model"]["dstdgcn"]
    whole = set(cs.forward_shapes(cfg))
    halved = {(mode, ci, co // 2 if co % 2 == 0 else co)
              for mode, ci, co in whole}
    assert halved - whole == set(cs.AXIS_SHAPES)


def test_counted_collectives_counts_calls_and_restores():
    import types
    calls = []
    fake = types.SimpleNamespace(**{
        name: (lambda name: lambda *a, **k: calls.append(name))(name)
        for name in cs.COLLECTIVES})
    before = {name: getattr(fake, name) for name in cs.COLLECTIVES}
    with cs.CountedCollectives(fake) as counts:
        fake.all_reduce(torch.zeros(5))
        fake.all_reduce(torch.zeros(3), group=None)
        fake.all_gather_into_tensor(torch.zeros(8), torch.zeros(4))
        fake.barrier()
    assert counts == {"all_reduce": dict(calls=2, values=8),
                      "all_gather_into_tensor": dict(calls=1, values=8),
                      "barrier": dict(calls=1, values=0)}
    assert calls == ["all_reduce", "all_reduce", "all_gather_into_tensor",
                     "barrier"]
    assert {name: getattr(fake, name) for name in cs.COLLECTIVES} == before
