#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rajni_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Main paths: ViT-B/16 224 at batch 256 (K1-K3), ViT-B/16 384 at batch 128
(577 tokens: K2, K3 and the long-sequence kernels B4-B6), and the whole-block
paths at batch 256: DeiT-S/16 in bf16 (P3a: B7, B8), ViT-B/16 224 with int8
weights and dynamic scales (P3b: B14, B15) or calibrated static scales (P3c),
and DeiT-S/16 int8 dynamic (P3d: B14, B15 at hc 768); and the split int8
paths: ViT-B/16 384 int8 at batch 128 with dynamic (P4a) or calibrated static
scales (P4b: B9, B10, B12, B13 with B5 and B15), and ViT-B/16 224 with
MLP-only int8 at batch 256 (P4c: K1, K2, B9); and the paths of B11:
ViT-L/16 224 at batch 256 with int8 weights and dynamic (P5a: B11, B10, B9,
B15) or calibrated static scales (P5b), the same model in bf16 (P5c: K1-K3
at C=1024), and DeiT-S/16 384 int8 dynamic at batch 128 (P5d: B11, B14, B15
past 256 tokens); and training: ViT-B/16 224 at batch 128 in bf16 through
B16, B4, B5, B17 and B18 (T6). Steps, each of which fails the run (non-zero
exit) when it goes wrong:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``rajni_tpu_torch/csrc`` into one library
   (one ``nvcc`` per source, in parallel, then one link), and require of
   the sources of the wgmma GEMM (``gemm.cu``, ``mlp.cu``, ``attn_block.cu``)
   that ptxas reports no spill and no serialized wgmma;
3. hold each kernel against its plain PyTorch version on the card at each
   path's shapes: K1 ``fused_pruned_attn_block``, K2 ``fused_attn_block`` and
   K3 ``fused_ln_mlp_residual`` at B=256 and the 224 path's token counts; B4
   ``fused_ln_qkv``, B5 ``fused_gather_sdpa_proj_residual``, B6
   ``fused_sdpa``, K2 and K3 at B=128 and the 384 path's; B7
   ``fused_pruned_block_full`` and B8 ``fused_attn_mlp_block`` at P3a's
   shapes; B14 ``fused_pruned_block_full_int8`` and B15
   ``fused_block_full_int8`` at P3b's (dynamic and static) and B14 at P3d's;
   B9 ``fused_ln_mlp_residual_int8``, B10 ``fused_attn_block_int8``, B12
   ``fused_ln_qkv_int8``, B13 ``fused_gather_sdpa_proj_residual_int8`` and
   B15 at P4a/P4b's (dynamic and static); K1-K3, B9, B10 and B15 at
   C=1024 (ViT-L/16); B11 ``fused_pruned_attn_block_int8`` at P5a/P5b's
   (dynamic and static) and P5d's shapes; B19 ``fused_ln_qkv_select`` and
   B20 ``fused_pruned_attn_block_long``, which no path runs, at the 384
   path's first pruned block, beside the two-kernel route they stand in
   for; B16 ``train_attn_block``, B17 ``train_ln_mlp`` and B18
   ``train_sdpa_bwd`` at T6's shapes (B18 also at 577 tokens); B6 and B18
   at ragged lengths (batch 16); the GEMM of K2 and K3 on its own
   (``kernels/gemm.py``) at each bf16 path's QKV, proj, fc1 and fc2 (C =
   384, 768, 1024; M = 256·197, 256·120) and at ragged M and N, timed beside
   ``F.linear`` (cuBLAS), which the port never calls. Show that the comparison rejects
   faults planted in the plain versions (the attention for K1-B8, B16 and
   B20, the quantization, the attention's rounding and the scores' source
   for the int8 kernels, B17's GELU of the unrounded h, B18's row term from
   the rounded P and its dV from the unrounded P; for B6 and B18, P rounded
   before it is normalized, where it separates; for the GEMM, the GELU of
   the rounded sum and a K-tile skipped), and time both with CUDA
   events (B6 beside ``F.scaled_dot_product_attention``, B18 beside its
   forward and backward, which the port never calls, by their device time
   from ``torch.profiler``: the host side of that call takes longer than its
   kernels); then T6's two block ops, forward and backward, with one kernel
   at a time swapped for its plain version and for its planted fault;
4. run each path end to end through ``RAJNIViT``, pruned and with the
   identity schedule: exact token counts, launch counts per forward (every
   count set to 0 just before the forward and read just after), finite
   logits, distance to a reference forward (the ``kernels="torch"`` one;
   for int8, the same forward with the kernels' plain versions on the card,
   and the dequantized ``kernels="torch"`` one loosely), img/s and MFU;
5. train T6 through ``rajni_tpu_torch.train``: the first step's loss and
   every gradient through the kernels against the same path on the kernels'
   plain versions and against the torch-autograd route on the card (through
   the same selections; each kept set that either would choose otherwise
   must lie within what its score discrepancy explains, and the share of
   images that the torch route would select otherwise is bounded), the
   launches of one step (every
   count set to 0 first), a falling loss over 20 steps on one batch, and
   train img/s with ``train_mfu`` on both routes, pruned and identity;
6. run the eval CLI in a subprocess: at 224 and at 384, and at 224 and 384
   with ``--quantize --calibrate 1``; then the training CLI (ViT-B/16 bf16
   on the kernels, 4 steps) and the eval CLI on its checkpoint, the
   training CLI on ``vit_tiny_patch16_224`` in fp32, and ``RAJNIViT`` on
   ``vit_tiny_patch16_224`` in fp32 and bf16: the last three demoted to the
   plain route before any launch, each printing its ``route:`` line;
7. print one JSON line of per-kernel results, then the ``{"ok": true, ...}``
   line last.

It exits non-zero without printing a result when CUDA is unavailable or when
the ``rajni_tpu_torch`` package is not beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, C, HEADS, HIDDEN = 256, 768, 12, 3072
B384 = 128  # batch of the ViT-B/16 384 path
PATH224, PATH384 = "vit_base_patch16_224", "vit_base_patch16_384"
DEIT_S = "deit_small_patch16_224"
C_S, HEADS_S, HIDDEN_S = 384, 6, 1536  # DeiT-S/16 widths
# the whole-block paths, named by model and int8 mode
P3A, P3B, P3C, P3D = DEIT_S, f"{PATH224} int8", f"{PATH224} int8 static", f"{DEIT_S} int8"
P4A, P4B, P4C = f"{PATH384} int8", f"{PATH384} int8 static", f"{PATH224} int8 MLP-only"
# scripts/bench_suite.py:34 DEIT_S_DYNAMIC: blocks 3-10 keep 0.9, rescoring
DEIT_S_SCHEDULE = {i: {"keep_ratio": 0.9, "update": True} for i in range(3, 11)}
# the paths of B11: ViT-L/16 224 (scripts/bench_suite.py:121
# vit_l16_aggressive_int8, batch 256) and DeiT-S/16 384 (DEIT_S_DYNAMIC,
# batch 128)
PATH_L, DEIT_S384 = "vit_large_patch16_224", "deit_small_patch16_384"
C_L, HEADS_L, HIDDEN_L = 1024, 16, 4096  # ViT-L/16 widths
B_S384 = 128
# scripts/bench_suite.py:37 VIT_L_AGGRESSIVE: keep 0.7 at blocks 4, 8, 12, 16
VIT_L_SCHEDULE = {i: {"keep_ratio": 0.7} for i in (4, 8, 12, 16)}
P5A, P5B, P5C = f"{PATH_L} int8", f"{PATH_L} int8 static", PATH_L
P5D = f"{DEIT_S384} int8"
KERNEL_ONLY = "kernel phase only"  # B19 and B20: no path runs them
# Kernel vs its plain version. Both round the same intermediates to bf16 and
# differ only in fp32 summation order, so they disagree where a value lies
# within that order's error of a rounding edge: single-ulp flips, most of
# them in the bf16 output itself. Two gates:
#  * every bf16 output within atol 2e-2 + rtol 2e-2 (the bf16 atol of
#    tests/test_kernels.py);
#  * the block's branch, ``out - x`` in fp32, within relative L2
#    BRANCH_REL_L2. The phases' inputs make the branch the bulk of ``out``
#    (x ~ 0.1 N(0, 1)) and the attention far from uniform (qkv weights
#    N(0, 1/C): logits of std ~1), so a wrong QKᵀ, softmax or P·V moves the
#    branch by more than the limit. On an H100 the sound distance measured
#    3.3e-4 (K3) and 1.2e-3 (K2, N=197); the limit is 2.5x the larger. Each
#    attention phase shows the gate's reach by planting faults in the plain
#    version's SDPA (padded keys left unmasked; one head averaging V
#    uniformly) and requiring the gate to reject each.
ATOL, RTOL = 2e-2, 2e-2
BRANCH_REL_L2 = 3e-3
X_STD = 0.1
# Near-tie rule for rescoring selections: each side scores from its own
# bf16 qkv, so a score can move by up to ~2.4e-3 relative (measured on an
# H100) and tokens at the keep boundary may change sides. Every token that
# is kept by one side and not the other must have a plain score within
# TIE_RTOL (relative, 2x that error) of the plain boundary score.
TIE_RTOL = 5e-3
# Rescored next_scores, kernel vs plain: each side scores in fp32 from its
# OWN qkv, rounded to bf16 after a GEMM summed in another order; one bf16
# ulp (2^-8 relative) in a k or v entry moves a score by ~1e-3 relative.
SCORE_RTOL = 1e-2
# B11's rescored next_scores, kernel vs plain: the median relative error over
# the images whose kept sets agree. The int8 products are exact and their
# dequant is the same fp32 arithmetic on both sides, so most qkv rows are
# the same bits and most scores agree to fp32 summation order; a quantizer
# that a last-bit LayerNorm difference tips moves a few rows only, which the
# median ignores. Scores taken from the fp32 qkv before it is rounded to
# bf16 (a planted fault) move every score. On an H100 SXM the sound median
# read 4.5e-7 to 1.5e-6 and the fault 8.8e-4 to 1.2e-3 (ViT-L, DeiT-S/384;
# dynamic and static); the limit sits 67x over the one and 8.8x under the
# other.
SCORE_MEDIAN_RTOL = 1e-4
LOGITS_REL_L2 = 5e-2
# Training kernels vs their plain versions, each output by relative L2:
# B16's qkv and B17's h (rounded GEMM outputs: a one-ulp flip where an fp32
# sum lies at a rounding edge), B18's attn_out, dQ, dK and dV (bf16 P and
# dS rounded on both sides, flips where the fp32 recompute differs).
# On an H100 SXM the sound readings were 7.9e-5 at most (qkv, h) and 9.8e-5
# (B18, K=577); the limits are about 2.5x those. The planted faults read
# 1.4e-3 (dQ, dK: the row term from pb) and 2.6e-3 (dV from p32).
TRAIN_GATES = {"qkv": 2e-4, "h": 2e-4, "attn_out": 2.5e-4, "dQ": 2.5e-4, "dK": 2.5e-4,
               "dV": 2.5e-4}
# B17's y against its plain version, the branch by relative L2 (its sound
# reading, 3.4e-4 on an H100, is K3's; 2.5x).
B17_GATE = (ATOL, RTOL, 8.5e-4)
# The training path's first step, kernels against the torch-autograd route
# on the card, both in bf16 and through the same selections.
# On an H100 SXM the losses differed by 1.9e-4 and the worst leaf's
# gradient by 1.58e-2 relative L2 (median 1.06e-2); the limits are about
# 2.5x those.
TRAIN_LOSS_ATOL = 5e-4
TRAIN_GRAD_REL_L2 = 4e-2
# Kept sets, kernel route against the torch route's own selection. The two
# routes score from their own bf16 activations, which the blocks before
# round differently; with random weights the CLS attention is peaked, most
# patch scores lie near 0 and their order follows the rounding (on the CPU
# in bf16 the kernels' plain versions select otherwise than the torch route
# too, and in fp32 they agree exactly, as the CPU tests hold them to JAX). On
# an H100 SXM up to 26 of the 128 images differed in a block; the limit is
# 2.5x that share. The gradients are compared through the same selections.
TRAIN_SEL_DIFF = 0.5
# The same first step against the kernels' plain versions on the card (the
# same rounding points, the same kept sets). On an H100 SXM the losses
# differed by 1.18e-4 and the worst leaf's gradient by 1.46e-2 relative L2
# (median 1.04e-2), about as much as against the torch route: over twelve
# bf16 blocks each kernel's last-bit flips grow into the gradients, and the
# planted faults read the same (1.44e-2 to 1.47e-2), so this gate cannot
# see a kernel-sized fault; the block ops below can. Limits 2.5x. The score
# discrepancy of a block's selection, over the largest score, read 7.65e-3
# at most; limit 2.5x. Each kept set that differs must lie within what that
# discrepancy explains (selection_gaps).
TRAIN_PLAIN_LOSS_ATOL = 3e-4
TRAIN_PLAIN_GRAD_REL_L2 = 3.7e-2
TRAIN_SCORE_REL = 1.9e-2
# One block op at T6's shapes with one kernel swapped for its plain
# version, against the op through the kernels: relative L2 of the op's
# output y, of the input's gradient d_x and of the worst leaf gradient.
# Limits 2.5x the worst sound reading of the stock and the pruned op on an
# H100 SXM: B16 and B4 (3.06e-3, 5.44e-3, 5.50e-3), B5 (8.35e-4, 3.14e-3,
# 3.41e-3), B17 (3.24e-4, 2.59e-3, 3.05e-3), B18 (y exact: it runs in the
# backward only; 3.60e-4, 1.10e-3). The planted faults read: B18's row term
# from pb d_x 2.49e-3, its dV from p32 d_x 2.67e-3, B17's GELU of the
# unrounded h y 3.64e-3.
TRAIN_BLOCK_GATES = {"train_attn_block": (7.7e-3, 1.4e-2, 1.4e-2),
                     "fused_ln_qkv": (7.7e-3, 1.4e-2, 1.4e-2),
                     "fused_gather_sdpa_proj_residual": (2.1e-3, 7.9e-3, 8.5e-3),
                     "train_ln_mlp": (8.1e-4, 6.5e-3, 7.6e-3),
                     "train_sdpa_bwd": (0.0, 9e-4, 2.75e-3)}
BF16_GATE = (ATOL, RTOL, BRANCH_REL_L2)
# B7/B8 at DeiT-S width: the same two gates, the branch limit 2.5x their
# worst sound reading on an H100 SXM (2.27e-3, B8 N=197).
DEIT_GATE = (ATOL, RTOL, 5.7e-3)
# Int8 kernels (B14, B15) vs their plain versions. The int8 products and
# their dequant are exact on both sides. The fp32 inputs of the quantizers (a
# LayerNorm output, or an attention output whose bf16 P may round the other
# way) differ in their last bits, and so may a row's absmax; a row quantized
# with a slightly other scale is requantized wholesale, each element moving
# by up to a quantization step (1/127 of the row's absmax). So the sound
# distance is quantization noise, not rounding noise: on an H100 the branch
# read 3.1e-3 to 4.7e-3 (ViT-B, DeiT-S; dynamic and static) and the largest
# element error 0.109 (H100 SXM). Limits: about 2.5x those, rtol as
# for bf16.
INT8_BRANCH_REL_L2 = 1.2e-2
INT8_GATE = (0.25, RTOL, INT8_BRANCH_REL_L2)
# The split int8 kernels (B9, B10, B12, B13) each hold one half of a block,
# so fewer quantizers carry a last-bit difference into whole steps: on an
# H100 SXM their branch read 5.4e-5 (B12) to 1.19e-3 (B10). Limit: 2.5x the
# worst. That is tight enough to reject the subtle faults: B10's attention
# output kept fp32 instead of rounded to bf16 (6.1e-3 to 1.1e-2) and B9's h
# quantized over whole rows where hc < hidden (1.16e-2).
SPLIT_INT8_BRANCH_REL_L2 = 3e-3
SPLIT_INT8_GATE = (0.25, RTOL, SPLIT_INT8_BRANCH_REL_L2)
# Int8 logits through the kernels vs the same forward through the plain
# versions on the card (same quantization). Each block requantizes what the
# last-bit differences of the blocks before it leave, so over twelve blocks
# the two forwards differ by about as much as either differs from the
# dequantized forward: 2.7e-2 to 5.0e-2 on an H100 SXM; the
# limit is 2.5x the worst. Against the dequantized kernels="torch" forward
# the activations are not quantized at all: reported, and loosely bounded.
INT8_LOGITS_REL_L2 = 0.125
INT8_VS_DEQUANT_REL_L2 = 0.3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median per-call time of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters: int = 20, warmup: int = 5) -> tuple[float, str]:
    """Device time per call of ``fn``: its kernels' time from
    ``torch.profiler``, without the host's gaps between them (for a library
    call whose host side takes longer than its kernels). Each kernel counts
    its mean recorded duration times its launches a call (its records over
    ``iters``, rounded up), so a record that the profiler drops does not
    lower the reading; returns the time and the records kept of those
    expected."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    kernels: dict[str, list[float]] = {}
    for _ in range(3):  # again if the profiler kept no record at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                kernels.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if kernels:
            break
    per_call = {name: -(-len(t) // iters) for name, t in kernels.items()}
    us = sum(statistics.fmean(t) * per_call[name] for name, t in kernels.items())
    kept = sum(len(t) for t in kernels.values())
    return us / 1e3, f"{kept} of {iters * sum(per_call.values())} records"


def stream_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call of ``fn`` on the card, CUDA events around ``iters``
    back-to-back calls (the host enqueues ahead; a call whose host side takes
    longer than its kernels reads its host time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peaks, int8_ops: float = 0.0,
          int8_peak: float = 1.0) -> tuple[float, str]:
    """Least time (ms): the larger of the operations over their peak rates
    (bf16 FLOPs over the bf16 peak plus int8 operations over the int8 peak)
    and bytes over the memory rate."""
    t_ops = flops / (peaks[0] * 1e12) + int8_ops / (int8_peak * 1e12)
    t_mem = nbytes / (peaks[1] * 1e12)
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def make_block(gen, device, C=C, HIDDEN=HIDDEN):
    import torch

    def lin(fan_out, fan_in):
        return {"weight": torch.randn(fan_out, fan_in, generator=gen) / math.sqrt(fan_in),
                "bias": torch.randn(fan_out, generator=gen) * 0.1}

    def norm():
        return {"scale": 1 + 0.1 * torch.randn(C, generator=gen),
                "bias": 0.1 * torch.randn(C, generator=gen)}

    blk = {"norm1": norm(), "attn": {"qkv": lin(3 * C, C), "proj": lin(C, C)},
           "norm2": norm(), "mlp": {"fc1": lin(HIDDEN, C), "fc2": lin(C, HIDDEN)}}
    from rajni_tpu_torch.models.vit import tree_to

    return tree_to(blk, dtype=torch.bfloat16, device=device)


@contextlib.contextmanager
def planted(fault: str):
    """Swap the plain versions' SDPA (the blocks' ``_mha`` and B6's per-head
    form) for a faulty one while the plain version runs."""
    import torch

    from rajni_tpu_torch.kernels import attention as ka
    from rajni_tpu_torch.kernels import block as kb

    sound = {(kb, "_mha"): kb._mha, (ka, "_sdpa_perhead"): ka._sdpa_perhead}

    def faulty(fn):
        def mha(qkv, num_heads, scale, out_dtype):
            n = qkv.shape[1]
            if fault == "uniform head":  # head 0's q zeroed: its logits are all 0
                qkv = qkv.clone()
                qkv[..., : qkv.shape[-1] // (3 * num_heads)] = 0
                return fn(qkv, num_heads, scale, out_dtype)
            # "padded keys": the sequence padded to a multiple of 16 with zero
            # rows that the softmax does not mask
            padded = torch.nn.functional.pad(qkv, (0, 0, 0, -n % 16))
            return fn(padded, num_heads, scale, out_dtype)[:, :n]
        return mha

    for (mod, name), fn in sound.items():
        setattr(mod, name, faulty(fn))
    try:
        yield
    finally:
        for (mod, name), fn in sound.items():
            setattr(mod, name, fn)


FAULTS = ("padded keys", "uniform head")


def branch_rel(got, want, x):
    """Relative L2 distance of the branches ``got - x`` and ``want - x``."""
    x = x.float()
    gb, wb = got.float() - x, want.float() - x
    return ((gb - wb).norm() / wb.norm()).item()


def compare(name, got, want, x, gate=BF16_GATE):
    """Hold a kernel's bf16 output against its plain version's, every element
    within ``gate``'s atol and rtol and the branch within its relative L2;
    return ``(max abs err, branch rel L2)``."""
    import torch

    atol, rtol, limit = gate
    err = (got.float() - want.float()).abs().max().item()
    rel = branch_rel(got, want, x)
    print(f"{name}: max_abs_err {err:.3e}, branch rel L2 {rel:.3e}")
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    check(ok, f"{name}: kernel disagrees with its plain version (max abs {err})")
    check(rel <= limit, f"{name}: branch rel L2 {rel} > {limit}")
    return err, rel


def reject_planted(name, got, plain, x, faults=FAULTS, plant=planted, limit=BRANCH_REL_L2):
    """The branch gate must reject each planted fault of the plain version."""
    for fault in faults:
        with plant(fault):
            bad = plain()
        rel = branch_rel(got, bad, x)
        print(f"{name}: planted fault '{fault}': branch rel L2 {rel:.3e}")
        check(rel > limit, f"{name}: the gate missed the planted fault '{fault}'")


@contextlib.contextmanager
def swapped(name: str, fn):
    """Replace ``name`` in every kernel module of the port that holds it (the
    plain versions look their helpers up there) while the block runs."""
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.kernels import wholeblock as wb

    mods = [m for m in (kb, km, wb) if hasattr(m, name)]
    sound = [getattr(m, name) for m in mods]
    for m in mods:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, f in zip(mods, sound):
            setattr(m, name, f)


@contextlib.contextmanager
def planted_int8(fault: str):
    """Swap a quantization helper of the int8 plain versions for a faulty
    one while the plain version runs."""
    import torch

    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import math as kmath

    def per_tensor(y32):  # one scale for the whole tensor instead of one a row
        a = torch.clamp_min(y32.abs().amax(), 1e-8)
        q = torch.clamp(torch.round(y32 * (127.0 / a)), -127, 127).to(torch.int8)
        return q, (a * (1.0 / 127.0)).expand(*y32.shape[:-1], 1)

    def shifted(y32):  # each row dequantized with its neighbour's scale
        q, a = kmath.quantize_rows(y32)
        return q, torch.roll(a, 1, dims=-2)

    def no_bias_fold(lns, lnb, sqkv, sproj, bqkv, aq, ap):  # V-fold left out of bqkv
        out = kmath.fold_static_attn(lns, lnb, sqkv, sproj, bqkv, aq, ap)
        return (*out[:4], bqkv.float())

    def no_v_fold(lns, lnb, sqkv, sproj, bqkv, aq, ap):  # 1/a_proj folded nowhere
        return kmath.fold_static_attn(lns, lnb, sqkv, sproj, bqkv, aq, 1.0)

    def no_sinv(lns, lnb, s1, s2, hidden, a1, a2):  # h quantized without 1/a_fc2
        out = kmath.fold_static_mlp(lns, lnb, s1, s2, hidden, a1, a2)
        return (*out[:4], torch.ones_like(out[4]))

    sound_proj = kb._int8_proj_operands

    def no_a_proj(proj_params, act_scale):  # B13's sproj without the a_proj fold
        return sound_proj(proj_params, None)

    sound_mha = kb._mha

    def mha_fp32(qkv, num_heads, scale, out_dtype):  # B10's attention output not rounded
        return sound_mha(qkv, num_heads, scale, torch.float32)

    name, fn = {"per-tensor scale": ("quantize_rows", per_tensor),
                "row scales shifted": ("quantize_rows", shifted),
                "bqkv without V-fold": ("fold_static_attn", no_bias_fold),
                "no V-fold": ("fold_static_attn", no_v_fold),
                "h without 1/a_fc2": ("fold_static_mlp", no_sinv),
                "sproj without a_proj": ("_int8_proj_operands", no_a_proj),
                "attention output fp32": ("_mha", mha_fp32),
                "h over whole rows": ("_hidden_chunk", lambda C_, hidden, itemsize: hidden),
                }[fault]
    with swapped(name, fn):
        yield


INT8_FAULTS = {False: ("per-tensor scale", "row scales shifted"),
               True: ("bqkv without V-fold", "h without 1/a_fc2")}


def check_rescored(name, got, want, s, keep, x, gate=BF16_GATE, median_rtol=None):
    """Rescoring ``(out, next_scores, keep_idx)`` of a kernel against its
    plain version's: kept sets equal except at near-ties of the plain scores
    ``s``; next_scores (their median relative error too, when
    ``median_rtol`` is given) and the outputs of the images whose sets
    agree within their limits. Returns ``(max abs err, branch rel L2)``."""
    import torch

    B_, n = s.shape
    edge = torch.sort(s[:, 1:], dim=1, descending=True).values[:, keep - 1 : keep]
    near = (s - edge).abs() <= TIE_RTOL * edge.abs()
    kept = [torch.zeros(B_, n, dtype=torch.bool, device=s.device).scatter_(1, r[2], True)
            for r in (got, want)]
    moved = kept[0] != kept[1]
    check(not bool((moved & ~near).any()),
          f"{name}: {int((moved & ~near).sum())} tokens changed sides away from the keep boundary")
    same = ~moved.any(dim=1)
    flips = int((~same).sum())
    if flips:
        print(f"{name} with_scores=True: {flips} images with near-tie swaps at the boundary (allowed)")
    rels = (got[1][same] - want[1][same]).abs() / want[1][same].abs()
    srel = rels.max().item()
    print(f"{name} with_scores=True: next_scores rel err max {srel:.3e}, "
          f"median {rels.median().item():.3e}")
    check(srel <= SCORE_RTOL, f"{name}: next_scores rel err {srel} > {SCORE_RTOL}")
    if median_rtol is not None:
        med = rels.median().item()
        check(med <= median_rtol, f"{name}: next_scores median rel err {med} > {median_rtol}")
    x_kept = torch.take_along_dim(x, want[2][..., None], dim=1)[same]
    return compare(f"{name} with_scores=True", got[0][same], want[0][same], x_kept, gate)


# Each kernel's source and the TPU kernel it replaces (def line).
KERNELS = {
    "fused_pruned_attn_block": ("csrc/pruned_attn_block.cu", "rajni_tpu/kernels/block.py:1516"),
    "fused_attn_block": ("csrc/attn_block.cu", "rajni_tpu/kernels/block.py:539"),
    "fused_ln_mlp_residual": ("csrc/mlp.cu", "rajni_tpu/kernels/mlp.py:131"),
    "fused_ln_qkv": ("csrc/ln_qkv.cu", "rajni_tpu/kernels/block.py:647"),
    "fused_gather_sdpa_proj_residual": ("csrc/gather_attn.cu", "rajni_tpu/kernels/block.py:985"),
    "fused_sdpa": ("csrc/sdpa.cu", "rajni_tpu/kernels/attention.py:71"),
    "fused_pruned_block_full": ("csrc/pruned_block_full.cu", "rajni_tpu/kernels/block.py:2060"),
    "fused_attn_mlp_block": ("csrc/attn_mlp_block.cu", "rajni_tpu/kernels/block.py:2198"),
    "fused_pruned_block_full_int8": ("csrc/pruned_block_full_int8.cu",
                                     "rajni_tpu/kernels/block.py:1770"),
    "fused_block_full_int8": ("csrc/block_full_int8.cu", "rajni_tpu/kernels/block.py:2403"),
    "fused_ln_mlp_residual_int8": ("csrc/ln_mlp_int8.cu", "rajni_tpu/kernels/mlp.py:340"),
    "fused_attn_block_int8": ("csrc/attn_block_int8.cu", "rajni_tpu/kernels/block.py:1268"),
    "fused_ln_qkv_int8": ("csrc/ln_qkv_int8.cu", "rajni_tpu/kernels/block.py:1370"),
    "fused_gather_sdpa_proj_residual_int8": ("csrc/gather_attn_int8.cu",
                                             "rajni_tpu/kernels/block.py:1132"),
    "fused_pruned_attn_block_int8": ("csrc/pruned_attn_block_int8.cu",
                                     "rajni_tpu/kernels/block.py:2580"),
    "fused_ln_qkv_select": ("csrc/ln_qkv_select.cu", "rajni_tpu/kernels/block.py:805"),
    "fused_pruned_attn_block_long": ("csrc/pruned_attn_block.cu",
                                     "rajni_tpu/kernels/longseq.py:270"),
    "train_attn_block": ("csrc/attn_block.cu", "rajni_tpu/kernels/train.py:89"),
    "train_ln_mlp": ("csrc/train_mlp.cu", "rajni_tpu/kernels/train.py:347"),
    "train_sdpa_bwd": ("csrc/sdpa_bwd.cu", "rajni_tpu/kernels/train.py:295"),
}


def record(results, name, path, shape, ms, plain_ms, bnd, err, rel, library=None,
           device=None):
    """Keep a kernel's numbers on one path: the times and bound of its first
    shape there, the worst error over all its shapes. ``library``: its
    library yardstick's ``device_ms`` reading; ``device``: the kernel's own,
    so that the two are read the same way."""
    library_ms = None if library is None else library[0]
    r = results.setdefault((name, path), dict(
        name=name, path=path, shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
        bound_by=bnd[1], library_ms=library_ms, max_abs_err=0.0, branch_rel_l2=0.0,
        **({} if device is None else {"device_ms": device[0]})))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["branch_rel_l2"] = max(r["branch_rel_l2"], rel)
    dev = "" if device is None else f" (device {device[0]:.3f} ms, {device[1]})"
    lib = "" if library is None else f" | library {library_ms:.3f} ms (device, {library[1]})"
    print(f"{name} {shape}: kernel {ms:.3f} ms{dev} | plain {plain_ms:.3f} ms{lib} | "
          f"bound {bnd[0]:.3f} ms ({bnd[1]})")


def kernel_phases(device, peaks, results, path=PATH224, C=C, HEADS=HEADS, HIDDEN=HIDDEN,
                  tokens=(197, 120), k1_cases=((197, 186), (150, 126)), seed=0):
    """K1, K2 and K3 at B=256 and a bf16 path's widths and token counts:
    ViT-B/16 224 (the defaults) or ViT-L/16 224 (P5c, C=1024)."""
    import torch

    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km

    gen = torch.Generator().manual_seed(seed)
    blk = make_block(gen, device, C, HIDDEN)
    scale = (C // HEADS) ** -0.5

    def x_of(n):
        return (X_STD * torch.randn(B, n, C, generator=gen)).to(device, torch.bfloat16)

    for n in tokens:  # K3
        x = x_of(n)
        args = (x, blk["norm2"], blk["mlp"], None, 1e-6)
        err, rel = compare(f"K3 N={n} C={C}", km.fused_ln_mlp_residual(*args),
                           km.ln_mlp_residual_plain(*args), x)
        ms = cuda_ms(lambda: km.fused_ln_mlp_residual(*args))
        plain_ms = cuda_ms(lambda: km.ln_mlp_residual_plain(*args), iters=5)
        M = B * n
        bnd = bound(4.0 * M * C * HIDDEN, 2 * M * C * 2 + 2 * C * HIDDEN * 2, peaks)
        record(results, "fused_ln_mlp_residual", path, f"B={B} N={n} C={C}", ms, plain_ms,
               bnd, err, rel)

    for n in tokens:  # K2
        x = x_of(n)
        args = (x, blk["norm1"], blk["attn"], None, HEADS, scale, 1e-6)
        got = kb.fused_attn_block(*args)
        err, rel = compare(f"K2 N={n} C={C}", got, kb.attn_block_plain(*args), x)
        reject_planted(f"K2 N={n} C={C}", got, lambda: kb.attn_block_plain(*args), x)
        ms = cuda_ms(lambda: kb.fused_attn_block(*args))
        plain_ms = cuda_ms(lambda: kb.attn_block_plain(*args), iters=5)
        M = B * n
        flops = 2.0 * M * C * 4 * C + 4.0 * B * n * n * C
        bnd = bound(flops, 2 * M * C * 2 + 4 * C * C * 2, peaks)
        record(results, "fused_attn_block", path, f"B={B} N={n} C={C}", ms, plain_ms, bnd,
               err, rel)

    for n, keep in k1_cases:  # K1
        K = keep + 1
        x = x_of(n)
        tag = f"K1 N={n} C={C}"
        common = (x, blk["norm1"], blk["attn"], None)
        # threaded scores: selection and next_scores must be exact
        threaded = (*common, torch.rand(B, n, generator=gen).to(device), HEADS, keep, scale,
                    1e-6, False)
        got = kb.fused_pruned_attn_block(*threaded)
        want = kb.pruned_attn_block_plain(*threaded)
        check(torch.equal(got[2], want[2]), f"{tag} with_scores=False: kept sets differ")
        check(torch.equal(got[1], want[1]), f"{tag} with_scores=False: next_scores differ")
        x_kept = torch.take_along_dim(x, want[2][..., None], dim=1)
        err, rel = compare(f"{tag} with_scores=False", got[0], want[0], x_kept)
        reject_planted(tag, got[0], lambda: kb.pruned_attn_block_plain(*threaded)[0], x_kept)

        # rescoring: kept sets must match except at near-ties
        rescored = (*common, None, HEADS, keep, scale, 1e-6, True)
        got = kb.fused_pruned_attn_block(*rescored)
        want = kb.pruned_attn_block_plain(*rescored)
        e2, r2 = check_rescored(tag, got, want, bf16_scores(x, blk, HEADS), keep, x)

        ms = cuda_ms(lambda: kb.fused_pruned_attn_block(*rescored))
        plain_ms = cuda_ms(lambda: kb.pruned_attn_block_plain(*rescored), iters=5)
        flops = 2.0 * B * n * C * 3 * C + 2.0 * B * K * C * C + 4.0 * B * K * K * C
        nbytes = B * n * C * 2 + 4 * C * C * 2 + B * K * C * 2 + B * K * 4
        record(results, "fused_pruned_attn_block", path, f"B={B} N={n} K={K} C={C}", ms,
               plain_ms, bound(flops, nbytes, peaks), max(err, e2), max(rel, r2))


def bf16_scores(x, blk, heads):
    """The plain path's RAJNI scores of x (LN1, bf16 qkv, fp32 scores)."""
    from rajni_tpu_torch.kernels import block as kb

    y = kb._layer_norm_f32(x.float(), blk["norm1"]["scale"], blk["norm1"]["bias"], 1e-6)
    qkv = (kb._mm(y.to(x.dtype), blk["attn"]["qkv"]["weight"])
           + blk["attn"]["qkv"]["bias"].float()).to(x.dtype)
    return kb._importance_f32(qkv.float(), heads)


def long_phases(device, peaks, results):
    """B4, B5, B6, K2 and K3 at the ViT-B/16 384 path's shapes (B=128)."""
    import torch
    import torch.nn.functional as Fnn

    from rajni_tpu_torch.kernels import attention as ka
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.ops.pruning import select_tokens_dense

    Bl = B384
    gen = torch.Generator().manual_seed(2)
    blk = make_block(gen, device)
    scale = (C // HEADS) ** -0.5

    def x_of(n):
        return (X_STD * torch.randn(Bl, n, C, generator=gen)).to(device, torch.bfloat16)

    def qkv_of(x):
        return kb.ln_qkv_plain(x, blk["norm1"], blk["attn"]["qkv"], HEADS, 1e-6, False)[0]

    x = x_of(577)  # B4, at the first pruned block's token count
    for with_scores in (False, True):
        args = (x, blk["norm1"], blk["attn"]["qkv"], HEADS, 1e-6, with_scores)
        gq, gs = kb.fused_ln_qkv(*args)
        wq, ws = kb.ln_qkv_plain(*args)
        err, rel = compare(f"B4 N=577 with_scores={with_scores}", gq, wq, torch.zeros_like(wq))
        if with_scores:
            srel = ((gs - ws).abs() / ws.abs()).max().item()
            print(f"B4 N=577: scores rel err max {srel:.3e}")
            check(srel <= SCORE_RTOL, f"B4 N=577: scores rel err {srel} > {SCORE_RTOL}")
        else:
            check(not bool(gs.any()), "B4 N=577 with_scores=False: scores are not all zero")
    ms = cuda_ms(lambda: kb.fused_ln_qkv(*args))
    plain_ms = cuda_ms(lambda: kb.ln_qkv_plain(*args), iters=5)
    M = Bl * 577
    bnd = bound(2.0 * M * C * 3 * C, M * C * 2 + 3 * C * C * 2 + M * 3 * C * 2 + M * 4, peaks)
    record(results, "fused_ln_qkv", PATH384, f"B={Bl} N=577 C={C}", ms, plain_ms, bnd, err, rel)

    for n in (577, 356):  # B6
        qkv = qkv_of(x_of(n))
        got = ka.fused_sdpa(qkv, HEADS, scale)
        zero = torch.zeros_like(got)
        err, rel = compare(f"B6 N={n}", got, ka.fused_sdpa_plain(qkv, HEADS, scale), zero)
        reject_planted(f"B6 N={n}", got, lambda: ka.fused_sdpa_plain(qkv, HEADS, scale), zero)
        rounding_point(f"B6 N={n}", {"out": got}, {"out": ka.fused_sdpa_plain(qkv, HEADS, scale)},
                       {"out": b6_unnormalized(qkv, HEADS, scale)}, {"out": B6_REL_L2})
        ms = cuda_ms(lambda: ka.fused_sdpa(qkv, HEADS, scale))
        dev = device_ms(lambda: ka.fused_sdpa(qkv, HEADS, scale))
        plain_ms = cuda_ms(lambda: ka.fused_sdpa_plain(qkv, HEADS, scale), iters=5)
        q, k, v = qkv.view(Bl, n, 3, HEADS, C // HEADS).permute(2, 0, 3, 1, 4).contiguous()
        # device time, as B18's: under CUDA events the library call's host side is timed
        lib = device_ms(lambda: Fnn.scaled_dot_product_attention(q, k, v, scale=scale))
        bnd = bound(4.0 * Bl * n * n * C, Bl * n * 3 * C * 2 + Bl * n * C * 2, peaks)
        record(results, "fused_sdpa", PATH384, f"B={Bl} N={n} C={C}", ms, plain_ms, bnd, err,
               rel, lib, dev)

    for n in (577, 356):  # K2 past ATTN_MAX_N
        x = x_of(n)
        args = (x, blk["norm1"], blk["attn"], None, HEADS, scale, 1e-6)
        got = kb.fused_attn_block(*args)
        err, rel = compare(f"K2 N={n}", got, kb.attn_block_plain(*args), x)
        reject_planted(f"K2 N={n}", got, lambda: kb.attn_block_plain(*args), x)
        ms = cuda_ms(lambda: kb.fused_attn_block(*args))
        plain_ms = cuda_ms(lambda: kb.attn_block_plain(*args), iters=5)
        M = Bl * n
        flops = 2.0 * M * C * 4 * C + 4.0 * Bl * n * n * C
        bnd = bound(flops, 2 * M * C * 2 + 4 * C * C * 2, peaks)
        record(results, "fused_attn_block", PATH384, f"B={Bl} N={n} C={C}", ms, plain_ms, bnd,
               err, rel)

    for n, K in ((577, 548), (520, 442)):  # B5: one qkv and one selection for both sides
        x = x_of(n)
        qkv = qkv_of(x)
        keep_idx, _ = select_tokens_dense(torch.rand(Bl, n, generator=gen).to(device), K - 1,
                                          torch.bool)
        args = (qkv, keep_idx, x, blk["attn"]["proj"], None, HEADS, scale)
        got = kb.fused_gather_sdpa_proj_residual(*args)
        x_kept = torch.take_along_dim(x, keep_idx[..., None], dim=1)
        err, rel = compare(f"B5 N={n} K={K}", got, kb.gather_sdpa_proj_residual_plain(*args),
                           x_kept)
        reject_planted(f"B5 N={n} K={K}", got,
                       lambda: kb.gather_sdpa_proj_residual_plain(*args), x_kept)
        ms = cuda_ms(lambda: kb.fused_gather_sdpa_proj_residual(*args))
        plain_ms = cuda_ms(lambda: kb.gather_sdpa_proj_residual_plain(*args), iters=5)
        flops = 4.0 * Bl * K * K * C + 2.0 * Bl * K * C * C
        nbytes = Bl * K * 3 * C * 2 + Bl * K * C * 2 + Bl * K * 8 + C * C * 2 + Bl * K * C * 2
        record(results, "fused_gather_sdpa_proj_residual", PATH384, f"B={Bl} N={n} K={K} C={C}",
               ms, plain_ms, bound(flops, nbytes, peaks), err, rel)

    for n in (577, 356):  # K3
        x = x_of(n)
        args = (x, blk["norm2"], blk["mlp"], None, 1e-6)
        err, rel = compare(f"K3 N={n}", km.fused_ln_mlp_residual(*args),
                           km.ln_mlp_residual_plain(*args), x)
        ms = cuda_ms(lambda: km.fused_ln_mlp_residual(*args))
        plain_ms = cuda_ms(lambda: km.ln_mlp_residual_plain(*args), iters=5)
        M = Bl * n
        bnd = bound(4.0 * M * C * HIDDEN, 2 * M * C * 2 + 2 * C * HIDDEN * 2, peaks)
        record(results, "fused_ln_mlp_residual", PATH384, f"B={Bl} N={n} C={C}", ms, plain_ms,
               bnd, err, rel)


def wholeblock_phases(device, peaks, results):
    """B7 and B8 at P3a's shapes (DeiT-S/16, B=256, bf16)."""
    import torch

    from rajni_tpu_torch.kernels import wholeblock as wb

    gen = torch.Generator().manual_seed(3)
    blk = make_block(gen, device, C_S, HIDDEN_S)
    scale = (C_S // HEADS_S) ** -0.5
    wbytes = (4 * C_S * C_S + 2 * C_S * HIDDEN_S) * 2

    def x_of(n):
        return (X_STD * torch.randn(B, n, C_S, generator=gen)).to(device, torch.bfloat16)

    for n in (197,):  # B8: the stock blocks run at 197 tokens
        x = x_of(n)
        args = (x, blk, HEADS_S, scale, 1e-6)
        got = wb.fused_attn_mlp_block(*args)
        err, rel = compare(f"B8 N={n}", got, wb.attn_mlp_block_plain(*args), x, DEIT_GATE)
        reject_planted(f"B8 N={n}", got, lambda: wb.attn_mlp_block_plain(*args), x,
                       limit=DEIT_GATE[2])
        ms = cuda_ms(lambda: wb.fused_attn_mlp_block(*args))
        plain_ms = cuda_ms(lambda: wb.attn_mlp_block_plain(*args), iters=5)
        M = B * n
        flops = 2.0 * M * C_S * 4 * C_S + 4.0 * B * n * n * C_S + 4.0 * M * C_S * HIDDEN_S
        record(results, "fused_attn_mlp_block", P3A, f"B={B} N={n} C={C_S}", ms, plain_ms,
               bound(flops, 2 * M * C_S * 2 + wbytes, peaks), err, rel)

    for n, keep in ((197, 176), (128, 114)):  # B7: the first pruned block and a later one
        K = keep + 1
        x = x_of(n)
        threaded = (x, blk, torch.rand(B, n, generator=gen).to(device), HEADS_S, keep, scale,
                    1e-6, False)
        got = wb.fused_pruned_block_full(*threaded)
        want = wb.pruned_block_full_plain(*threaded)
        check(torch.equal(got[2], want[2]), f"B7 N={n} with_scores=False: kept sets differ")
        check(torch.equal(got[1], want[1]), f"B7 N={n} with_scores=False: next_scores differ")
        x_kept = torch.take_along_dim(x, want[2][..., None], dim=1)
        err, rel = compare(f"B7 N={n} with_scores=False", got[0], want[0], x_kept, DEIT_GATE)
        reject_planted(f"B7 N={n}", got[0], lambda: wb.pruned_block_full_plain(*threaded)[0],
                       x_kept, limit=DEIT_GATE[2])
        rescored = (x, blk, None, HEADS_S, keep, scale, 1e-6, True)
        e2, r2 = check_rescored(f"B7 N={n}", wb.fused_pruned_block_full(*rescored),
                                wb.pruned_block_full_plain(*rescored),
                                bf16_scores(x, blk, HEADS_S), keep, x, DEIT_GATE)
        ms = cuda_ms(lambda: wb.fused_pruned_block_full(*rescored))
        plain_ms = cuda_ms(lambda: wb.pruned_block_full_plain(*rescored), iters=5)
        flops = (2.0 * B * n * C_S * 3 * C_S + 2.0 * B * K * C_S * C_S + 4.0 * B * K * K * C_S
                 + 4.0 * B * K * C_S * HIDDEN_S)
        nbytes = B * n * C_S * 2 + wbytes + B * K * C_S * 2 + B * K * 8
        record(results, "fused_pruned_block_full", P3A, f"B={B} N={n} K={K} C={C_S}", ms,
               plain_ms, bound(flops, nbytes, peaks), max(err, e2), max(rel, r2))


def quantized_block(blk):
    """The block with int8 qkv, proj, fc1 and fc2 records."""
    from rajni_tpu_torch.quant import quantize_weight

    q = {k: v for k, v in blk.items()}
    q["attn"] = {k: {**v, "weight": quantize_weight(v["weight"])} for k, v in blk["attn"].items()}
    q["mlp"] = {k: {**v, "weight": quantize_weight(v["weight"])} for k, v in blk["mlp"].items()}
    return q


def block_act_scales(blk, x, heads):
    """Static scales ``(a_qkv, a_proj, a_fc1, a_fc2)`` of one bf16 block on
    x, calibrated as ``quant.calibrate_act_scales`` does (absmax / 127)."""
    import torch

    from rajni_tpu_torch.kernels import block as kb

    scale = (x.shape[-1] // heads) ** -0.5
    eps = 1e-6
    y = kb._layer_norm_f32(x.float(), blk["norm1"]["scale"], blk["norm1"]["bias"], eps)
    qkv = (kb._mm(y.to(x.dtype), blk["attn"]["qkv"]["weight"])
           + blk["attn"]["qkv"]["bias"].float()).to(x.dtype)
    attn = kb._mha(qkv, heads, scale, torch.float32)
    mid = x.float() + kb._mm(attn, blk["attn"]["proj"]["weight"]) + blk["attn"]["proj"]["bias"].float()
    y2 = kb._layer_norm_f32(mid, blk["norm2"]["scale"], blk["norm2"]["bias"], eps)
    h = torch.nn.functional.gelu(kb._mm(y2, blk["mlp"]["fc1"]["weight"])
                                 + blk["mlp"]["fc1"]["bias"].float())
    return tuple(float(t.abs().amax()) / 127.0 for t in (y, attn, y2, h))


@contextlib.contextmanager
def ln_float64():
    """The int8 plain versions with their LayerNorm statistics taken in
    float64: a last-bit change of the LN output, to read how far the
    quantizers carry such a change."""
    def ln64(x32, scale, bias, eps):
        x64 = x32.double()
        mean = x64.mean(dim=-1, keepdim=True)
        var = (x64 - mean).square().mean(dim=-1, keepdim=True)
        return ((x64 - mean) / (var + eps).sqrt()).float() * scale.float() + bias.float()

    with swapped("_layer_norm_f32", ln64):
        yield


def int8_scores(x, qblk, heads, act_scales):
    """B14's plain RAJNI scores of x: from the int8 qkv rounded to bf16."""
    from rajni_tpu_torch.kernels import block as kb

    scales = None if act_scales is None else act_scales[:2]
    return kb.ln_qkv_int8_plain(x, qblk["norm1"], qblk["attn"]["qkv"], heads, 1e-6, True,
                                scales)[1]


# (width, heads, hidden, batch, cases, paths) of the whole-block int8 phases:
# each case (kernel, N, keep or None), each path (name, static scales)
INT8_WHOLE = (
    (C, HEADS, HIDDEN, B, [("B15", 197, None), ("B14", 197, 186), ("B14", 150, 126)],
     ((P3B, False), (P3C, True))),
    (C_S, HEADS_S, HIDDEN_S, B, [("B14", 197, 176)], ((P3D, False),)),
)
# DeiT-S/16 384 (P5d): B15 at 577 tokens (hc 768), B14 past ATTN_MAX_N
INT8_WHOLE_S384 = (
    (C_S, HEADS_S, HIDDEN_S, B_S384, [("B15", 577, None), ("B14", 519, 466)], ((P5D, False),)),
)


def int8_phases(device, peaks, int8_peak, results, configs=INT8_WHOLE, seed=4):
    """B14 and B15 at P3b/P3c's shapes (ViT-B/16 224, B=256; dynamic and
    static), and B14 at P3d's (DeiT-S/16, hc 768); or at ``configs``'."""
    import torch

    from rajni_tpu_torch.kernels import wholeblock as wb

    gen = torch.Generator().manual_seed(seed)
    for width, heads, hidden, batch, cases, paths in configs:
        blk = make_block(gen, device, width, hidden)
        qblk = quantized_block(blk)
        scale = (width // heads) ** -0.5
        wbytes = 4 * width * width + 2 * width * hidden + (8 * width + 2 * hidden) * 4
        for name, n, keep in cases:
            x = (X_STD * torch.randn(batch, n, width, generator=gen)).to(device, torch.bfloat16)
            for path, static in paths:
                scales = block_act_scales(blk, x, heads) if static else None
                tag = f"{name} N={n} C={width} {'static' if static else 'dynamic'}"
                K = n if keep is None else keep + 1
                hc = (wb._block_full_int8_plan(n, width, hidden, 2) if keep is None
                      else wb._pruned_full_int8_plan(n, K, width, hidden, 2))[1]
                print(f"{tag}: hc {hc}")
                faults = dict(faults=INT8_FAULTS[static], plant=planted_int8,
                              limit=INT8_BRANCH_REL_L2)
                if keep is None:
                    args = (x, qblk, heads, scale, 1e-6, scales)
                    got = wb.fused_block_full_int8(*args)
                    want = wb.block_full_int8_plain(*args)
                    err, rel = compare(tag, got, want, x, INT8_GATE)
                    with ln_float64():
                        alt = wb.block_full_int8_plain(*args)
                    print(f"{tag}: plain vs plain with float64 LayerNorm statistics: "
                          f"branch rel L2 {branch_rel(alt, want, x):.3e}")
                    reject_planted(tag, got, lambda: wb.block_full_int8_plain(*args), x, **faults)
                    timed = (lambda: wb.fused_block_full_int8(*args),
                             lambda: wb.block_full_int8_plain(*args))
                    kname = "fused_block_full_int8"
                else:
                    prev = torch.rand(batch, n, generator=gen).to(device)
                    threaded = (x, qblk, prev, heads, keep, scale, 1e-6, False, scales)
                    got = wb.fused_pruned_block_full_int8(*threaded)
                    want = wb.pruned_block_full_int8_plain(*threaded)
                    check(torch.equal(got[2], want[2]), f"{tag} with_scores=False: kept sets differ")
                    check(torch.equal(got[1], want[1]),
                          f"{tag} with_scores=False: next_scores differ")
                    x_kept = torch.take_along_dim(x, want[2][..., None], dim=1)
                    err, rel = compare(f"{tag} with_scores=False", got[0], want[0], x_kept,
                                       INT8_GATE)
                    reject_planted(tag, got[0],
                                   lambda: wb.pruned_block_full_int8_plain(*threaded)[0], x_kept,
                                   **faults)
                    rescored = (x, qblk, None, heads, keep, scale, 1e-6, True, scales)
                    e2, r2 = check_rescored(tag, wb.fused_pruned_block_full_int8(*rescored),
                                            wb.pruned_block_full_int8_plain(*rescored),
                                            int8_scores(x, qblk, heads, scales), keep, x,
                                            INT8_GATE)
                    err, rel = max(err, e2), max(rel, r2)
                    timed = (lambda: wb.fused_pruned_block_full_int8(*rescored),
                             lambda: wb.pruned_block_full_int8_plain(*rescored))
                    kname = "fused_pruned_block_full_int8"
                ms = cuda_ms(timed[0])
                plain_ms = cuda_ms(timed[1], iters=3, warmup=1)
                int8_ops = 2.0 * batch * (n * width * 3 * width + K * width * width
                                      + 2 * K * width * hidden)
                nbytes = (batch * n * width * 2 + wbytes + batch * K * width * 2
                          + (batch * K * 8 if keep else 0))
                record(results, kname, path, f"B={batch} N={n} K={K} C={width} hc={hc}", ms,
                       plain_ms,
                       bound(4.0 * batch * K * K * width, nbytes, peaks, int8_ops, int8_peak),
                       err, rel)


@contextlib.contextmanager
def forced_hc(hc):
    """B9's hidden chunk forced to ``hc`` in the wrapper and the plain
    version alike (``None``: the JAX rule's own)."""
    from rajni_tpu_torch.kernels import mlp as km

    if hc is None:
        yield
        return
    sound = km._hidden_chunk
    km._hidden_chunk = lambda C, hidden, itemsize: hc
    try:
        yield
    finally:
        km._hidden_chunk = sound


def mlp_act_scales(blk, x):
    """Static ``(a_fc1, a_fc2)`` of one bf16 MLP on its input x, calibrated
    as ``quant.calibrate_act_scales`` does (absmax / 127)."""
    import torch

    from rajni_tpu_torch.kernels import mlp as km

    y = km._layer_norm_f32(x.float(), blk["norm2"]["scale"], blk["norm2"]["bias"], 1e-6)
    h = torch.nn.functional.gelu(km._mm(y, blk["mlp"]["fc1"]["weight"])
                                 + blk["mlp"]["fc1"]["bias"].float())
    return tuple(float(t.abs().amax()) / 127.0 for t in (y, h))


def split_int8_phases(device, peaks, int8_peak, results):
    """B9, B10, B12, B13 and B15 at the shapes of the int8 ViT-B/16 384 path
    (B=128; P4a dynamic, P4b static): B10 at 577 (two-pass attention) and
    197 (register), B12 at 577 and 442 with and without scores, B13 at
    442→375 and 375→356, B9 at 577 and 356 rows with hc = hidden and
    hidden/2, B15 at 356 (hc 1536)."""
    import torch

    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.kernels import wholeblock as wb
    from rajni_tpu_torch.ops.pruning import select_tokens_dense

    Bl = B384
    gen = torch.Generator().manual_seed(5)
    blk = make_block(gen, device)
    qblk = quantized_block(blk)
    scale = (C // HEADS) ** -0.5
    a_bytes = 4 * C * C + (9 * C) * 4  # int8 qkv + proj weights, fp32 vectors

    def x_of(n):
        return (X_STD * torch.randn(Bl, n, C, generator=gen)).to(device, torch.bfloat16)

    def gate(tag, got, plain, x, faults, g=SPLIT_INT8_GATE):
        """Hold got against plain(); each planted fault must be rejected."""
        err, rel = compare(tag, got, plain(), x, g)
        reject_planted(tag, got, plain, x, faults=faults, plant=planted_int8, limit=g[2])
        return err, rel

    def timed(name, path, shape, kernel, plain, bnd, err, rel):
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        record(results, name, path, shape, ms, plain_ms, bnd, err, rel)

    for static in (False, True):
        path, mode = (P4B, "static") if static else (P4A, "dynamic")

        for n in (577, 197):  # B10
            x = x_of(n)
            sc = block_act_scales(blk, x, HEADS)[:2] if static else None
            args = (x, qblk["norm1"], qblk["attn"], None, HEADS, scale, 1e-6, sc)
            tag = f"B10 N={n} {mode}"
            got = kb.fused_attn_block_int8(*args)
            err, rel = gate(tag, got, lambda: kb.attn_block_int8_plain(*args), x,
                            ("bqkv without V-fold" if static else "row scales shifted",
                             "attention output fp32"))
            M = Bl * n
            bnd = bound(4.0 * Bl * n * n * C, 2 * M * C * 2 + a_bytes, peaks, 8.0 * M * C * C,
                        int8_peak)
            timed("fused_attn_block_int8", path, f"B={Bl} N={n} C={C}",
                  lambda: kb.fused_attn_block_int8(*args), lambda: kb.attn_block_int8_plain(*args),
                  bnd, err, rel)

        for n in (577, 442):  # B12
            x = x_of(n)
            sc = block_act_scales(blk, x, HEADS)[:2] if static else None
            for with_scores in (True, False):
                args = (x, qblk["norm1"], qblk["attn"]["qkv"], HEADS, 1e-6, with_scores, sc)
                tag = f"B12 N={n} {mode} with_scores={with_scores}"
                gq, gs = kb.fused_ln_qkv_int8(*args)
                wq, ws = kb.ln_qkv_int8_plain(*args)
                # compared with V in its own units: static V carries 1/a_proj
                col = torch.ones(3 * C, device=device)
                if static:
                    col[2 * C:] = sc[1]
                err, rel = gate(tag, gq.float() * col,
                                lambda: kb.ln_qkv_int8_plain(*args)[0].float() * col,
                                torch.zeros_like(wq), ("no V-fold" if static
                                                       else "row scales shifted",))
                if with_scores:
                    # the score kernel against the plain scoring of the kernel's
                    # own qkv (held above); against the plain version's scores
                    # a reading only: a quantizer flip in a k or v row moves a
                    # score by more than a bf16 ulp does (1.1e-2 static, H100)
                    own = kb._importance_f32(gq.float(), HEADS)
                    srel = ((gs - own).abs() / own.abs()).max().item()
                    prel = ((gs - ws).abs() / ws.abs()).max().item()
                    print(f"{tag}: scores rel err max {srel:.3e} against its own qkv's, "
                          f"{prel:.3e} against the plain version's")
                    check(srel <= SCORE_RTOL, f"{tag}: scores rel err {srel} > {SCORE_RTOL}")
                else:
                    check(not bool(gs.any()), f"{tag}: scores are not all zero")
                M = Bl * n
                bnd = bound(0.0, M * C * 2 + 3 * C * C + 6 * C * 4 + M * 3 * C * 2 + M * 4, peaks,
                            6.0 * M * C * C, int8_peak)
                timed("fused_ln_qkv_int8", path, f"B={Bl} N={n} C={C} scores={with_scores}",
                      lambda: kb.fused_ln_qkv_int8(*args), lambda: kb.ln_qkv_int8_plain(*args),
                      bnd, err, rel)

        for n, K in ((442, 375), (375, 356)):  # B13, on B12's (folded) qkv
            x = x_of(n)
            sc = block_act_scales(blk, x, HEADS)[:2] if static else None
            qkv = kb.ln_qkv_int8_plain(x, qblk["norm1"], qblk["attn"]["qkv"], HEADS, 1e-6, False,
                                       sc)[0]
            keep_idx, _ = select_tokens_dense(torch.rand(Bl, n, generator=gen).to(device), K - 1,
                                              torch.bool)
            args = (qkv, keep_idx, x, qblk["attn"]["proj"], None, HEADS, scale,
                    None if sc is None else sc[1])
            tag = f"B13 N={n} K={K} {mode}"
            x_kept = torch.take_along_dim(x, keep_idx[..., None], dim=1)
            got = kb.fused_gather_sdpa_proj_residual_int8(*args)
            err, rel = gate(tag, got, lambda: kb.gather_sdpa_proj_residual_int8_plain(*args),
                            x_kept, ("sproj without a_proj" if static else "row scales shifted",))
            bnd = bound(4.0 * Bl * K * K * C,
                        Bl * K * (3 * C * 2 + C * 2 + 8 + C * 2) + C * C + 2 * C * 4, peaks,
                        2.0 * Bl * K * C * C, int8_peak)
            timed("fused_gather_sdpa_proj_residual_int8", path, f"B={Bl} N={n} K={K} C={C}",
                  lambda: kb.fused_gather_sdpa_proj_residual_int8(*args),
                  lambda: kb.gather_sdpa_proj_residual_int8_plain(*args), bnd, err, rel)

        for n in (577, 356):  # B9
            x = x_of(n)
            sc = mlp_act_scales(blk, x) if static else None
            args = (x, qblk["norm2"], qblk["mlp"], None, 1e-6, True, sc)
            for hc in (None, HIDDEN // 2):
                with forced_hc(hc):
                    hc_now = km._hidden_chunk(C, HIDDEN, 1)
                    tag = f"B9 rows={Bl}x{n} hc={hc_now} {mode}"
                    got = km.fused_ln_mlp_residual_int8(*args)
                    faults = ("h without 1/a_fc2" if static else "row scales shifted",)
                    if hc is not None and not static:  # dynamic chunks: hc is numerics
                        faults += ("h over whole rows",)
                    err, rel = gate(tag, got, lambda: km.ln_mlp_residual_int8_plain(*args), x,
                                    faults)
                    M = Bl * n
                    bnd = bound(0.0, 2 * M * C * 2 + 2 * C * HIDDEN + (5 * C + 2 * HIDDEN) * 4,
                                peaks, 4.0 * M * C * HIDDEN, int8_peak)
                    timed("fused_ln_mlp_residual_int8", path, f"B={Bl} N={n} C={C} hc={hc_now}",
                          lambda: km.fused_ln_mlp_residual_int8(*args),
                          lambda: km.ln_mlp_residual_int8_plain(*args), bnd, err, rel)

        n = 356  # B15 past ATTN_MAX_N tokens (blocks 8-11)
        x = x_of(n)
        sc = block_act_scales(blk, x, HEADS) if static else None
        args = (x, qblk, HEADS, scale, 1e-6, sc)
        hc = wb._block_full_int8_plan(n, C, HIDDEN, 2)[1]
        tag = f"B15 N={n} hc={hc} {mode}"
        got = wb.fused_block_full_int8(*args)
        err, rel = gate(tag, got, lambda: wb.block_full_int8_plain(*args), x,
                        INT8_FAULTS[static], INT8_GATE)
        M = Bl * n
        bnd = bound(4.0 * Bl * n * n * C,
                    2 * M * C * 2 + 4 * C * C + 2 * C * HIDDEN + (8 * C + 2 * HIDDEN) * 4, peaks,
                    2.0 * M * (4 * C * C + 2 * C * HIDDEN), int8_peak)
        timed("fused_block_full_int8", path, f"B={Bl} N={n} C={C} hc={hc}",
              lambda: wb.fused_block_full_int8(*args), lambda: wb.block_full_int8_plain(*args),
              bnd, err, rel)


def b11_unrounded_scores(args):
    """B11's plain version with its scores taken from the fp32 qkv before it
    is rounded to bf16 (a planted fault; the TPU kernel scores the rounded
    qkv, block.py:2548-2551)."""
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km

    x, ln, attn, ls, _, heads, keep, scale, eps, _, act = args
    ops = kb.int8_attn_operands(ln, attn, act)
    y = kb._layer_norm_f32(x.float(), ops["ln1s"], ops["ln1b"], eps)
    qkv32 = km._int8_matmul(y, attn["qkv"]["weight"]["int8"], ops["sqkv"], act is not None)
    s = kb._importance_f32(qkv32 + ops["bqkv"], heads)
    return kb.pruned_attn_block_int8_plain(x, ln, attn, ls, s, heads, keep, scale, eps, False, act)


def check_b11(tag, x, qblk, heads, keep, scale, act, gen, faults):
    """B11 against its plain version, threaded (kept sets and next_scores
    exact, the output under the split-int8 gate, ``faults`` planted in the
    plain version rejected) and rescored (``check_rescored`` with the median
    score gate; scores from the unrounded qkv rejected). Returns ``(max abs
    err, branch rel L2, timed kernel, timed plain)``."""
    import torch

    from rajni_tpu_torch.kernels import block as kb

    B_, n, _ = x.shape
    common = (x, qblk["norm1"], qblk["attn"], None)
    threaded = (*common, torch.rand(B_, n, generator=gen).to(x.device), heads, keep, scale, 1e-6,
                False, act)
    got = kb.fused_pruned_attn_block_int8(*threaded)
    want = kb.pruned_attn_block_int8_plain(*threaded)
    check(torch.equal(got[2], want[2]), f"{tag} with_scores=False: kept sets differ")
    check(torch.equal(got[1], want[1]), f"{tag} with_scores=False: next_scores differ")
    x_kept = torch.take_along_dim(x, want[2][..., None], dim=1)
    err, rel = compare(f"{tag} with_scores=False", got[0], want[0], x_kept, SPLIT_INT8_GATE)
    reject_planted(tag, got[0], lambda: kb.pruned_attn_block_int8_plain(*threaded)[0], x_kept,
                   faults=faults, plant=planted_int8, limit=SPLIT_INT8_GATE[2])

    rescored = (*common, None, heads, keep, scale, 1e-6, True, act)
    got = kb.fused_pruned_attn_block_int8(*rescored)
    s = int8_scores(x, qblk, heads, act)
    e2, r2 = check_rescored(tag, got, kb.pruned_attn_block_int8_plain(*rescored), s, keep, x,
                            SPLIT_INT8_GATE, SCORE_MEDIAN_RTOL)
    try:
        check_rescored(f"{tag} planted fault 'scores from the fp32 qkv'", got,
                       b11_unrounded_scores(rescored), s, keep, x, SPLIT_INT8_GATE,
                       SCORE_MEDIAN_RTOL)
    except SmokeFailure as e:
        print(f"{tag}: planted fault 'scores from the fp32 qkv' rejected: {e}")
    else:
        raise SmokeFailure(f"{tag}: the gate missed the planted fault 'scores from the fp32 qkv'")
    return (max(err, e2), max(rel, r2), lambda: kb.fused_pruned_attn_block_int8(*rescored),
            lambda: kb.pruned_attn_block_int8_plain(*rescored))


def b11_phases(device, peaks, int8_peak, results):
    """The int8 kernels of the B11 paths. At ViT-L/16's widths (C=1024, 16
    heads, hidden 4096; B=256), dynamic (P5a) and static (P5b): B11 at
    197→138 (block 4) and 67→47 (block 16), B10 at 197 tokens, B9 at 197 rows
    (hc from ``_hidden_chunk``: 4096), B15 at 67 (hc 2048) and 47 (hc 4096).
    At DeiT-S/16 384's (C=384, B=128), dynamic (P5d): B11 at 577→519 (block
    3), its attention past ATTN_MAX_N."""
    import torch

    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.kernels import wholeblock as wb

    gen = torch.Generator().manual_seed(6)

    def timed(name, path, shape, kernel, plain, bnd, err, rel):
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        record(results, name, path, shape, ms, plain_ms, bnd, err, rel)

    def b11_bound(B_, n, K, width):
        return bound(4.0 * B_ * K * K * width,
                     B_ * n * width * 2 + 4 * width * width + 9 * width * 4 + B_ * K * (width * 2 + 8),
                     peaks, 2.0 * B_ * (n * 3 * width * width + K * width * width), int8_peak)

    for width, heads, hidden, Bl, cases, paths in (
        (C_L, HEADS_L, HIDDEN_L, B, ((197, 137), (67, 46)), ((P5A, False), (P5B, True))),
        (C_S, HEADS_S, HIDDEN_S, B_S384, ((577, 518),), ((P5D, False),)),
    ):
        blk = make_block(gen, device, width, hidden)
        qblk = quantized_block(blk)
        scale = (width // heads) ** -0.5
        a_bytes = 4 * width * width + 9 * width * 4
        for path, static in paths:
            mode = "static" if static else "dynamic"
            for n, keep in cases:  # B11
                K = keep + 1
                x = (X_STD * torch.randn(Bl, n, width, generator=gen)).to(device, torch.bfloat16)
                sc = block_act_scales(blk, x, heads)[:2] if static else None
                tag = f"B11 N={n} K={K} C={width} {mode}"
                faults = ("attention output fp32",) + (("no V-fold",) if static else ())
                err, rel, kern, plain = check_b11(tag, x, qblk, heads, keep, scale, sc, gen, faults)
                timed("fused_pruned_attn_block_int8", path, f"B={Bl} N={n} K={K} C={width}", kern,
                      plain, b11_bound(Bl, n, K, width), err, rel)
            if width != C_L:
                continue

            n = 197  # B10, at the stock blocks' first token count
            x = (X_STD * torch.randn(B, n, width, generator=gen)).to(device, torch.bfloat16)
            sc = block_act_scales(blk, x, heads) if static else None
            args = (x, qblk["norm1"], qblk["attn"], None, heads, scale, 1e-6,
                    None if sc is None else sc[:2])
            tag = f"B10 N={n} C={width} {mode}"
            got = kb.fused_attn_block_int8(*args)
            err, rel = compare(tag, got, kb.attn_block_int8_plain(*args), x, SPLIT_INT8_GATE)
            reject_planted(tag, got, lambda: kb.attn_block_int8_plain(*args), x,
                           faults=("bqkv without V-fold" if static else "row scales shifted",
                                   "attention output fp32"),
                           plant=planted_int8, limit=SPLIT_INT8_GATE[2])
            M = B * n
            timed("fused_attn_block_int8", path, f"B={B} N={n} C={width}",
                  lambda: kb.fused_attn_block_int8(*args), lambda: kb.attn_block_int8_plain(*args),
                  bound(4.0 * B * n * n * width, 2 * M * width * 2 + a_bytes, peaks,
                        8.0 * M * width * width, int8_peak), err, rel)

            # B9 on the same rows
            mas = mlp_act_scales(blk, x) if static else None
            args = (x, qblk["norm2"], qblk["mlp"], None, 1e-6, True, mas)
            hc = km._hidden_chunk(width, hidden, 1)
            tag = f"B9 rows={B}x{n} hc={hc} C={width} {mode}"
            got = km.fused_ln_mlp_residual_int8(*args)
            err, rel = compare(tag, got, km.ln_mlp_residual_int8_plain(*args), x, SPLIT_INT8_GATE)
            reject_planted(tag, got, lambda: km.ln_mlp_residual_int8_plain(*args), x,
                           faults=("h without 1/a_fc2" if static else "row scales shifted",),
                           plant=planted_int8, limit=SPLIT_INT8_GATE[2])
            timed("fused_ln_mlp_residual_int8", path, f"B={B} N={n} C={width} hc={hc}",
                  lambda: km.fused_ln_mlp_residual_int8(*args),
                  lambda: km.ln_mlp_residual_int8_plain(*args),
                  bound(0.0, 2 * M * width * 2 + 2 * width * hidden + (5 * width + 2 * hidden) * 4,
                        peaks, 4.0 * M * width * hidden, int8_peak), err, rel)

            for n in (67, 47):  # B15, blocks 13-15 and 17-23
                x = (X_STD * torch.randn(B, n, width, generator=gen)).to(device, torch.bfloat16)
                sc = block_act_scales(blk, x, heads) if static else None
                args = (x, qblk, heads, scale, 1e-6, sc)
                hc = wb._block_full_int8_plan(n, width, hidden, 2)[1]
                tag = f"B15 N={n} hc={hc} C={width} {mode}"
                got = wb.fused_block_full_int8(*args)
                err, rel = compare(tag, got, wb.block_full_int8_plain(*args), x, INT8_GATE)
                reject_planted(tag, got, lambda: wb.block_full_int8_plain(*args), x,
                               faults=INT8_FAULTS[static], plant=planted_int8,
                               limit=INT8_GATE[2])
                M = B * n
                timed("fused_block_full_int8", path, f"B={B} N={n} C={width} hc={hc}",
                      lambda: wb.fused_block_full_int8(*args),
                      lambda: wb.block_full_int8_plain(*args),
                      bound(4.0 * B * n * n * width,
                            2 * M * width * 2 + 4 * width * width + 2 * width * hidden
                            + (8 * width + 2 * hidden) * 4,
                            peaks, 2.0 * M * (4 * width * width + 2 * width * hidden), int8_peak),
                      err, rel)


def alternative_phases(device, peaks, results):
    """B19 and B20, which no path runs (nor does the JAX package), at the
    ViT-B/16 384 path's first pruned block (B=128, N=577, keep 547), each
    beside the two-kernel route it stands in for: B4, the torch selection,
    B5."""
    import torch

    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import longseq as kl
    from rajni_tpu_torch.ops.pruning import select_tokens_dense

    Bl, n, keep = B384, 577, 547
    K = keep + 1
    gen = torch.Generator().manual_seed(7)
    blk = make_block(gen, device)
    scale = (C // HEADS) ** -0.5
    x = (X_STD * torch.randn(Bl, n, C, generator=gen)).to(device, torch.bfloat16)
    ln, attn = blk["norm1"], blk["attn"]

    def two_kernel():
        qkv, s = kb.fused_ln_qkv(x, ln, attn["qkv"], HEADS, 1e-6, True)
        idx, sel = select_tokens_dense(s, keep, x.dtype)
        return qkv, sel, idx, torch.take_along_dim(s, idx, dim=1)

    # B19 against B4 and the plain selection of B4's scores: the same
    # launches give the same qkv and scores, so all four outputs are exact
    args = (x, ln, attn["qkv"], HEADS, keep, 1e-6)
    got, want = kb.fused_ln_qkv_select(*args), two_kernel()
    for i, what in enumerate(("qkv", "sel", "keep_idx", "next_scores")):
        check(torch.equal(got[i], want[i].to(got[i].dtype)), f"B19 N={n} K={K}: {what} differs "
              "from B4 with the plain selection")
    plain = kb.ln_qkv_select_plain(*args)
    err, rel = compare(f"B19 N={n} K={K} qkv", got[0], plain[0], torch.zeros_like(plain[0]))
    ms, two_ms = cuda_ms(lambda: kb.fused_ln_qkv_select(*args)), cuda_ms(two_kernel)
    plain_ms = cuda_ms(lambda: kb.ln_qkv_select_plain(*args), iters=3, warmup=1)
    M = Bl * n
    record(results, "fused_ln_qkv_select", KERNEL_ONLY, f"B={Bl} N={n} K={K} C={C}", ms, plain_ms,
           bound(2.0 * M * C * 3 * C, M * C * 2 + 3 * C * C * 2 + 3 * C * 2 + M * 3 * C * 2
                 + Bl * K * n * 2 + Bl * K * 8, peaks), err, rel)
    results[("fused_ln_qkv_select", KERNEL_ONLY)]["two_kernel_ms"] = two_ms
    print(f"B19 N={n} K={K}: {ms:.3f} ms against B4 + torch selection {two_ms:.3f} ms")

    # B20, threaded (exact selection) and rescored, against its plain version
    threaded = (x, ln, attn, None, torch.rand(Bl, n, generator=gen).to(device), HEADS, keep,
                scale, 1e-6, False)
    got = kl.fused_pruned_attn_block_long(*threaded)
    want = kl.pruned_attn_block_long_plain(*threaded)
    tag = f"B20 N={n} K={K}"
    check(torch.equal(got[2], want[2]), f"{tag} with_scores=False: kept sets differ")
    check(torch.equal(got[1], want[1]), f"{tag} with_scores=False: next_scores differ")
    x_kept = torch.take_along_dim(x, want[2][..., None], dim=1)
    err, rel = compare(f"{tag} with_scores=False", got[0], want[0], x_kept)
    reject_planted(tag, got[0], lambda: kl.pruned_attn_block_long_plain(*threaded)[0], x_kept)
    rescored = (x, ln, attn, None, None, HEADS, keep, scale, 1e-6, True)
    got = kl.fused_pruned_attn_block_long(*rescored)
    e2, r2 = check_rescored(tag, got, kl.pruned_attn_block_long_plain(*rescored),
                            bf16_scores(x, blk, HEADS), keep, x)

    # ... and against the two-kernel route it stands in for: the same
    # launches but for the selection, so the same kept tokens and bits
    def route():
        qkv, _, idx, ns = two_kernel()
        return (kb.fused_gather_sdpa_proj_residual(qkv, idx, x, attn["proj"], None, HEADS, scale),
                ns, idx)

    two = route()
    check(torch.equal(got[2], two[2]) and torch.equal(got[1], two[1]),
          f"{tag}: kept tokens or next_scores differ from the two-kernel route")
    check(torch.equal(got[0], two[0]), f"{tag}: output differs from the two-kernel route")
    ms, two_ms = cuda_ms(lambda: kl.fused_pruned_attn_block_long(*rescored)), cuda_ms(route)
    plain_ms = cuda_ms(lambda: kl.pruned_attn_block_long_plain(*rescored), iters=3, warmup=1)
    flops = 2.0 * Bl * n * C * 3 * C + 4.0 * Bl * K * K * C + 2.0 * Bl * K * C * C
    nbytes = Bl * n * C * 2 + 4 * C * C * 2 + Bl * K * C * 2 + Bl * K * 8
    record(results, "fused_pruned_attn_block_long", KERNEL_ONLY, f"B={Bl} N={n} K={K} C={C}", ms,
           plain_ms, bound(flops, nbytes, peaks), max(err, e2), max(rel, r2))
    results[("fused_pruned_attn_block_long", KERNEL_ONLY)]["two_kernel_ms"] = two_ms
    print(f"{tag}: {ms:.3f} ms against B4 + torch selection + B5 {two_ms:.3f} ms")


TRAIN = f"train {PATH224}"  # the training path: ViT-B/16 224, batch 128
B_TRAIN = 128


def rel_l2(got, want) -> float:
    """Relative L2 distance of two tensors, in fp32."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def b18_faulty(fault: str):
    """B18's plain version with one planted fault: the row term taken from
    the rounded pb instead of p32, dV from p32 instead of pb, or P rounded
    before normalization (attn_out and dV from bf16(e), scaled by 1/Σe
    after the product)."""
    import torch

    from rajni_tpu_torch.kernels import train as kt

    def fn(qkv, dout, num_heads, scale):
        C = qkv.shape[-1] // 3
        q, k, v = (kt._heads(qkv[..., i * C:(i + 1) * C], num_heads).float() for i in range(3))
        do = kt._heads(dout, num_heads).float()
        logits = (q @ k.transpose(-1, -2)) * scale
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        inv = 1.0 / e.sum(dim=-1, keepdim=True)
        p32 = e * inv
        pb = p32.to(qkv.dtype).float()
        dv = (p32 if fault == "dV from p32" else pb).transpose(-1, -2) @ do
        if fault == ROUNDED_FIRST:  # the online-softmax rounding point
            dv = e.to(qkv.dtype).float().transpose(-1, -2) @ (do * inv)
        dp = do @ v.transpose(-1, -2)
        row = pb if fault == "row term from pb" else p32
        ds = p32 * (dp - (dp * row).sum(dim=-1, keepdim=True))
        dsb = (ds * scale).to(qkv.dtype).float()
        d_qkv = torch.cat([kt._merge(dsb @ k), kt._merge(dsb.transpose(-1, -2) @ q),
                           kt._merge(dv)], dim=-1)
        out = (e.to(qkv.dtype).float() @ v) * inv if fault == ROUNDED_FIRST else pb @ v
        return kt._merge(out).to(qkv.dtype), d_qkv.to(qkv.dtype)

    return fn


B18_FAULTS = ("row term from pb", "dV from p32")
ROUNDED_FIRST = "P rounded before normalization"
# The online-softmax rounding point (P rounded, then scaled by 1/Σ after
# P·V) reads about 2e-3 from the sound plain version: under the branch gate
# that B6's output shares with every bf16 kernel (BRANCH_REL_L2), so B6's
# output is also held to its plain version by relative L2 at B6_REL_L2,
# 2.5x its worst sound reading on an H100 SXM (1.15e-4 at N=848, batch 4;
# 5.9e-5 to 6.7e-5 at the path's shapes). B18's outputs keep TRAIN_GATES.
# The fault is gated where the two plain versions alone lie apart by at
# least the output's limit (2.5x its sound reading); the kernel's own
# reading never decides that.
B6_REL_L2 = 2.9e-4


def b6_unnormalized(qkv, num_heads: int, scale: float):
    """B6's plain version with P rounded before it is normalized: O =
    (bf16(e)·V)·(1/Σe)."""
    B, N, three_c = qkv.shape
    C = three_c // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4).float()
    logits = (q @ k.transpose(-1, -2)) * scale
    e = (logits - logits.amax(dim=-1, keepdim=True)).exp()
    out = (e.to(qkv.dtype).float() @ v) * (1.0 / e.sum(dim=-1, keepdim=True))
    return out.permute(0, 2, 1, 3).reshape(B, N, C).to(qkv.dtype)


def rel_or_zero(got, want) -> float:
    """Relative L2 distance, 0 where both are exactly zero (dQ and dK at K=1)."""
    if not bool(want.float().norm()) and not bool(got.float().norm()):
        return 0.0
    return rel_l2(got, want)


def rounding_point(tag, got: dict, sound: dict, fault: dict, limits: dict) -> None:
    """Hold each output of a kernel to its plain version by relative L2
    within ``limits``, and print the rounding-point fault's reading: where
    the faulty plain version lies at least the limit from the sound one, the
    limit rejects a kernel with that fault."""
    for key in got:
        s = rel_or_zero(got[key], sound[key])
        f = rel_or_zero(got[key], fault[key])
        sep = rel_or_zero(fault[key], sound[key])
        print(f"{tag} {key}: planted fault '{ROUNDED_FIRST}': rel L2 {f:.3e} (sound {s:.3e}, "
              f"plain versions apart {sep:.3e}, limit {limits[key]:.1e}): "
              + ("separates, gated" if sep >= limits[key] else "does not separate"))
        check(s <= limits[key], f"{tag} {key}: rel L2 {s} > {limits[key]}")


def train_kernel_phases(device, peaks, results):
    """B16, B17 and B18 at the ViT-B/16 224 training path's shapes (B=128):
    B16 at 197 tokens, B17 at 197 and 120, B18 at K = 197, 187 and 120, and
    B18 at K=577 (B=32), past the JAX package's fit rule. Each output is held
    to the plain version separately, and the planted faults must be
    rejected: B17's GELU on the unrounded h (K3's plain version, which
    computes exactly that), and B18's two above; B18's rounding-point fault
    is gated where it separates (``rounding_point``), and two calls of B18
    on the same input must be bitwise equal."""
    import torch
    import torch.nn.functional as Fn

    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.kernels import train as kt
    from rajni_tpu_torch.kernels.block import attn_block_qkv_plain

    gen = torch.Generator().manual_seed(11)
    blk = make_block(gen, device)
    scale = (C // HEADS) ** -0.5

    def x_of(b, n):
        return (X_STD * torch.randn(b, n, C, generator=gen)).to(device, torch.bfloat16)

    x = x_of(B_TRAIN, 197)  # B16
    args = (x, blk["norm1"], blk["attn"], None, HEADS, scale, 1e-6)
    x1, qkv = kt.train_attn_block(*args)
    px1, pqkv = attn_block_qkv_plain(*args)
    err, rel = compare("B16 x1 N=197", x1, px1, x)
    qrel = rel_l2(qkv, pqkv)
    print(f"B16 qkv N=197: rel L2 {qrel:.3e}")
    check(qrel <= TRAIN_GATES["qkv"], f"B16 qkv rel L2 {qrel} > {TRAIN_GATES['qkv']}")
    reject_planted("B16 x1 N=197", x1, lambda: attn_block_qkv_plain(*args)[0], x)
    M = B_TRAIN * 197
    bnd = bound(2.0 * M * C * 4 * C + 4.0 * B_TRAIN * 197 * 197 * C,
                M * C * 2 * 2 + M * 3 * C * 2 + 4 * C * C * 2, peaks)
    record(results, "train_attn_block", TRAIN, f"B={B_TRAIN} N=197 C={C}",
           cuda_ms(lambda: kt.train_attn_block(*args)),
           cuda_ms(lambda: attn_block_qkv_plain(*args), iters=5), bnd, err, max(rel, qrel))

    for n in (197, 120):  # B17
        x = x_of(B_TRAIN, n)
        args = (x, blk["norm2"], blk["mlp"], None, 1e-6)
        y, h = kt.train_ln_mlp(*args)
        py, ph = kt.train_ln_mlp_plain(*args)
        err, rel = compare(f"B17 y N={n}", y, py, x, B17_GATE)
        hrel = rel_l2(h, ph)
        print(f"B17 h N={n}: rel L2 {hrel:.3e}")
        check(hrel <= TRAIN_GATES["h"], f"B17 h rel L2 {hrel} > {TRAIN_GATES['h']}")
        bad = branch_rel(y, km.ln_mlp_residual_plain(*args), x)
        print(f"B17 y N={n}: planted fault 'GELU on the unrounded h': branch rel L2 {bad:.3e}")
        check(bad > B17_GATE[2], f"B17 N={n}: the gate missed the GELU on the unrounded h")
        M = B_TRAIN * n
        bnd = bound(4.0 * M * C * HIDDEN, 2 * M * C * 2 + M * HIDDEN * 2 + 2 * C * HIDDEN * 2,
                    peaks)
        record(results, "train_ln_mlp", TRAIN, f"B={B_TRAIN} N={n} C={C}",
               cuda_ms(lambda: kt.train_ln_mlp(*args)),
               cuda_ms(lambda: kt.train_ln_mlp_plain(*args), iters=5), bnd, err, max(rel, hrel))

    for b, n in ((B_TRAIN, 197), (B_TRAIN, 187), (B_TRAIN, 120), (32, 577)):  # B18
        qkv = torch.randn(b, n, 3 * C, generator=gen).to(device, torch.bfloat16)
        dout = torch.randn(b, n, C, generator=gen).to(device, torch.bfloat16)
        got = kt.train_sdpa_bwd(qkv, dout, HEADS, scale)
        want = kt.train_sdpa_bwd_plain(qkv, dout, HEADS, scale)

        def parts(r):
            return {"attn_out": r[0], "dQ": r[1][..., :C], "dK": r[1][..., C:2 * C],
                    "dV": r[1][..., 2 * C:]}

        g, w = parts(got), parts(want)
        rels = {k: rel_l2(g[k], w[k]) for k in g}
        err = max((g[k].float() - w[k].float()).abs().max().item() for k in g)
        print(f"B18 B={b} K={n}: max_abs_err {err:.3e}, rel L2 "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()))
        for k, v in rels.items():
            check(v <= TRAIN_GATES[k], f"B18 K={n} {k} rel L2 {v} > {TRAIN_GATES[k]}")
        for fault in B18_FAULTS:
            bad = parts(b18_faulty(fault)(qkv, dout, HEADS, scale))
            brels = {k: rel_l2(g[k], bad[k]) for k in g}
            print(f"B18 K={n}: planted fault '{fault}': rel L2 "
                  + ", ".join(f"{k} {v:.3e}" for k, v in brels.items()))
            check(any(v > TRAIN_GATES[k] for k, v in brels.items()),
                  f"B18 K={n}: the gates missed the planted fault '{fault}'")
        rounding_point(f"B18 K={n}", g, w,
                       parts(b18_faulty(ROUNDED_FIRST)(qkv, dout, HEADS, scale)), TRAIN_GATES)
        again = kt.train_sdpa_bwd(qkv, dout, HEADS, scale)
        check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
              f"B18 K={n}: two calls on the same input differ")
        ms = cuda_ms(lambda: kt.train_sdpa_bwd(qkv, dout, HEADS, scale))
        dev = device_ms(lambda: kt.train_sdpa_bwd(qkv, dout, HEADS, scale))
        plain_ms = cuda_ms(lambda: kt.train_sdpa_bwd_plain(qkv, dout, HEADS, scale), iters=5)
        q, k, v = (kt._heads(qkv[..., i * C:(i + 1) * C], HEADS).contiguous().requires_grad_()
                   for i in range(3))
        do = kt._heads(dout, HEADS).contiguous()

        def library():
            out = Fn.scaled_dot_product_attention(q, k, v)
            return torch.autograd.grad(out, (q, k, v), do)

        lib = device_ms(library)  # under CUDA events its host side is timed
        bnd = bound(12.0 * b * n * n * C, 8 * b * n * C * 2, peaks)
        record(results, "train_sdpa_bwd", TRAIN, f"B={b} K={n} C={C}", ms, plain_ms, bnd, err,
               max(rels.values()), library=lib, device=dev)


# The GEMM of K2 and K3 (csrc/gemm_sm90.cuh, through its own entry point
# kernels/gemm.py:gemm) against gemm_plain, by relative L2 of the output, or
# of the branch ``out - res`` where the epilogue adds a residual. Both round
# once from fp32 sums taken in another order, so they differ by one-ulp flips
# where a sum lies within that order's error of a rounding edge. On an H100
# SXM the sound readings were at most GEMM_SOUND (fc2 at K=4096, the longest
# sums; 1.9e-5 to 1.5e-4 over the path and ragged shapes); the limit is 2.5x
# that. It must reject two planted faults of the plain version: the GELU of
# the bf16-rounded sum (B17's rounding point, not K3's; it read 3.0e-3 to
# 3.1e-3) at every fc1 shape, and the last K-tile skipped (0.2 and up) at
# every ragged one.
GEMM_SOUND = 1.533e-4
GEMM_SOURCES = ("gemm.cu", "mlp.cu", "attn_block.cu")  # the sources that build it
GEMM_REL_L2 = 2.5 * GEMM_SOUND
# (label, width, hidden) of the bf16 paths whose products the GEMM runs:
# DeiT-S (P3a: B7's MLP half, B8), ViT-B (K2, K3, B16), ViT-L (P5c)
GEMM_WIDTHS = ((DEIT_S, C_S, HIDDEN_S), (PATH224, C, HIDDEN), (PATH_L, C_L, HIDDEN_L))


def gemm_faulty(fault: str):
    """gemm_plain with a planted fault."""
    from rajni_tpu_torch.kernels import gemm as kg
    from rajni_tpu_torch.kernels.math import gelu_fast

    def fn(a, w, bias, epi, ls=None, res=None):
        if fault == "K-tile skipped":  # the last 64 of K left out of the sum
            return kg.gemm_plain(a[..., :-kg.BLOCK_K], w[:, :-kg.BLOCK_K], bias, epi, ls, res)
        # "GELU of the rounded sum"
        h = (a.float() @ w.float().t() + bias.float()).to(a.dtype)
        return gelu_fast(h.float()).to(a.dtype)
    return fn


def gemm_rel(got, want, res) -> float:
    """Relative L2 of the outputs, or of the branches when ``res`` is added."""
    if res is None:
        return rel_l2(got, want)
    return branch_rel(got, want, res)


def gemm_phases(device, peaks):
    """The GEMM of K2 and K3 on its own at each product of the bf16 paths
    (QKV, proj, fc1 and fc2 at C = 384, 768 and 1024, M = 256·197 and
    256·120), each timed beside ``F.linear`` (cuBLAS, which the port never
    calls) by device time; and at ragged shapes, M in {1, 77, 128·394 + 1}
    and N not a multiple of the tile, which no path runs. Every epilogue,
    with and without the layer scale and the residual."""
    import torch
    import torch.nn.functional as Fnn

    from rajni_tpu_torch.kernels import gemm as kg
    from rajni_tpu_torch.kernels.math import gelu_fast

    gen = torch.Generator().manual_seed(14)

    def operands(M, N, K, epi, name, with_ls, with_res):
        a = torch.randn(M, K, generator=gen)
        if name == "fc2":  # fc2 reads the GELU of fc1's output
            a = gelu_fast(a)
        a = a.to(device, torch.bfloat16)
        w = (torch.randn(N, K, generator=gen) / math.sqrt(K)).to(device, torch.bfloat16)
        bias = (0.1 * torch.randn(N, generator=gen)).to(device, torch.bfloat16)
        ls = (1 + 0.1 * torch.randn(N, generator=gen)).to(device, torch.bfloat16) \
            if with_ls else None
        res = (X_STD * torch.randn(M, N, generator=gen)).to(device, torch.bfloat16) \
            if with_res else None
        return a, w, bias, epi, ls, res

    def held(tag, args, faults=()):
        got = kg.gemm(*args)
        rel = gemm_rel(got, kg.gemm_plain(*args), args[5])
        print(f"GEMM {tag}: rel L2 {rel:.3e}")
        check(bool(torch.isfinite(got.float()).all()), f"GEMM {tag}: output not finite")
        check(rel <= GEMM_REL_L2, f"GEMM {tag}: rel L2 {rel} > {GEMM_REL_L2}")
        for fault in faults:
            bad = gemm_rel(got, gemm_faulty(fault)(*args), args[5])
            print(f"GEMM {tag}: planted fault '{fault}': rel L2 {bad:.3e}")
            check(bad > GEMM_REL_L2, f"GEMM {tag}: the gate missed the planted fault '{fault}'")
        return got

    for label, width, hidden in GEMM_WIDTHS:
        products = (("qkv", 3 * width, width, kg.EPI_BIAS, False, False),
                    ("proj", width, width, kg.EPI_RESIDUAL, True, True),
                    ("fc1", hidden, width, kg.EPI_GELU, False, False),
                    ("fc2", width, hidden, kg.EPI_RESIDUAL, False, True))
        for n in (197, 120):
            M = B * n
            for name, N, K, epi, with_ls, with_res in products:
                args = operands(M, N, K, epi, name, with_ls, with_res)
                tag = f"{label} {name} M={M} N={N} K={K}"
                held(tag, args, ("GELU of the rounded sum",) if epi == kg.EPI_GELU else ())
                # device time, as B6's and B18's yardsticks; and CUDA events
                # over back-to-back calls, which the profiler's dropped
                # records cannot move
                ms = device_ms(lambda: kg.gemm(*args), iters=10)
                lib = device_ms(lambda: Fnn.linear(args[0], args[1], args[2]), iters=10)
                ev = stream_ms(lambda: kg.gemm(*args))
                ev_lib = stream_ms(lambda: Fnn.linear(args[0], args[1], args[2]))
                nbytes = (M * K + N * K + M * N * (2 if with_res else 1)) * 2
                bnd = bound(2.0 * M * N * K, nbytes, peaks)
                print(f"GEMM {tag}: {ms[0]:.3f} ms ({ms[1]}; events {ev:.3f}) | cuBLAS "
                      f"{lib[0]:.3f} ms ({lib[1]}; events {ev_lib:.3f}) | bound {bnd[0]:.3f} ms "
                      f"({bnd[1]})")

    # ragged: M past the 128-row tile (1, 77, 128·394 + 1), N past the
    # 128-column tile (200, 776), K of one or three 64-deep steps
    ragged = [(M, N, K, epi, with_ls, with_res)
              for M in (1, 77, 128 * 394 + 1)
              for N, K, epi, with_ls, with_res in (
                  (3 * C_S, C_S, kg.EPI_BIAS, False, False),
                  (C_S, HIDDEN_S, kg.EPI_RESIDUAL, True, True),
                  (C, C, kg.EPI_RESIDUAL, False, True),
                  (HIDDEN_S, C_S, kg.EPI_GELU, False, False))]
    ragged += [(300, 200, 64, kg.EPI_GELU, False, False),
               (129, 776, 192, kg.EPI_RESIDUAL, True, True),
               (77, 776, 192, kg.EPI_RESIDUAL, False, False),
               (1, 8, 64, kg.EPI_BIAS, False, False)]
    for M, N, K, epi, with_ls, with_res in ragged:
        args = operands(M, N, K, epi, "", with_ls, with_res)
        faults = ("K-tile skipped",) + (("GELU of the rounded sum",) if epi == kg.EPI_GELU else ())
        held(f"ragged M={M} N={N} K={K} epi={epi} ls={with_ls} res={with_res}", args, faults)


def ragged_phases(device):
    """B6 and B18 at ragged lengths, batch 16 (192 (head, image) units, more
    than the 132 SMs, so a persistent B6 block takes a second unit on the
    slots and parities the first left): B6 at N = 1, 17, 64, 65, 257, 448,
    577 and 848 (one tile, partial tiles, odd and even tile counts in the
    one-pass kernel, and past 640 tokens the two-pass form), B18 at K = 1,
    63, 65, 197, 577 and 848 (the one-launch kernel to 256, two launches
    past it), each held to its plain version with the gates of the path
    shapes, the rounding-point fault's among them, B18 also bitwise equal
    over two calls. Not timed."""
    import torch

    from rajni_tpu_torch.kernels import attention as ka
    from rajni_tpu_torch.kernels import train as kt

    gen = torch.Generator().manual_seed(13)
    Br, scale = 16, (C // HEADS) ** -0.5
    for n in (1, 17, 64, 65, 257, 448, 577, 848):
        qkv = torch.randn(Br, n, 3 * C, generator=gen).to(device, torch.bfloat16)
        got = ka.fused_sdpa(qkv, HEADS, scale)
        want = ka.fused_sdpa_plain(qkv, HEADS, scale)
        compare(f"B6 ragged N={n}", got, want, torch.zeros_like(got))
        rounding_point(f"B6 ragged N={n}", {"out": got}, {"out": want},
                       {"out": b6_unnormalized(qkv, HEADS, scale)}, {"out": B6_REL_L2})
    for n in (1, 63, 65, 197, 577, 848):
        qkv = torch.randn(Br, n, 3 * C, generator=gen).to(device, torch.bfloat16)
        dout = torch.randn(Br, n, C, generator=gen).to(device, torch.bfloat16)
        got = kt.train_sdpa_bwd(qkv, dout, HEADS, scale)
        want = kt.train_sdpa_bwd_plain(qkv, dout, HEADS, scale)
        g = {"attn_out": got[0], "dQ": got[1][..., :C], "dK": got[1][..., C:2 * C],
             "dV": got[1][..., 2 * C:]}
        w = {"attn_out": want[0], "dQ": want[1][..., :C], "dK": want[1][..., C:2 * C],
             "dV": want[1][..., 2 * C:]}
        rels = {k: rel_or_zero(g[k], w[k]) for k in g}
        again = kt.train_sdpa_bwd(qkv, dout, HEADS, scale)
        same = torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
        print(f"B18 ragged K={n}: rel L2 " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f", two calls bitwise equal {same}")
        for k, v in rels.items():
            check(v <= TRAIN_GATES[k], f"B18 ragged K={n} {k} rel L2 {v} > {TRAIN_GATES[k]}")
        check(same, f"B18 ragged K={n}: two calls on the same input differ")


def selection_gaps(own, forced, scores, ref_scores) -> dict:
    """How a route's own selection (``own``, top-k of its ``scores``) departs
    from the kept sets it was given (``forced``, the kernel route's, chosen
    from ``ref_scores`` over the same tokens): the images and patch tokens
    that differ, the largest absolute distance of such a token's score from
    the own selection's boundary (its lowest kept score), the per-image score
    discrepancy delta = max |scores - ref_scores| (its largest value, also
    over the largest |ref_scores|), and the largest ratio of a differing
    token's distance to 2 delta of its image. The k-th largest score moves by
    at most delta, so top-k of either vector keeps a token only within 2 delta
    of the other's boundary: a ratio above 1 is a selection that the scores
    do not explain."""
    import torch

    B, N = scores.shape
    s, r = scores.float()[:, 1:], ref_scores.float().to(scores.device)[:, 1:]

    def mask(idx):
        m = torch.zeros(B, N, dtype=torch.bool, device=scores.device)
        return m.scatter_(1, idx.to(scores.device).long(), True)[:, 1:]

    mo, mf = mask(own), mask(forced)
    diff = mo ^ mf
    edge = s.masked_fill(~mo, float("inf")).amin(dim=1, keepdim=True)
    gap = (s - edge).abs().masked_fill(~diff, 0.0)
    delta = (s - r).abs().amax(dim=1, keepdim=True)
    ratio = torch.where(gap > 0, gap / (2 * delta), torch.zeros_like(gap))
    return {"images": int(diff.any(dim=1).sum()), "tokens": int(diff.sum()),
            "gap": gap.max().item(), "delta": delta.max().item(),
            "delta_rel": (delta.max() / r.abs().max()).item(), "ratio": ratio.max().item()}


@contextlib.contextmanager
def train_path_swapped(subs: dict):
    """Names of ``rajni_tpu_torch.models.train_path`` replaced for the
    duration (kernel wrappers by their plain versions or a planted fault, the
    selection by a tap)."""
    from rajni_tpu_torch.models import train_path as tp

    sound = {n: getattr(tp, n) for n in subs}
    for n, fn in subs.items():
        setattr(tp, n, fn)
    try:
        yield
    finally:
        for n, fn in sound.items():
            setattr(tp, n, fn)


def plain_train_kernels() -> dict:
    """The training path's kernels (B4, B5, B16, B17, B18) by their plain
    versions, which keep the kernels' rounding points: the reference route on
    the card."""
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import train as kt

    return {"fused_ln_qkv": kb.ln_qkv_plain,
            "fused_gather_sdpa_proj_residual": kb.gather_sdpa_proj_residual_plain,
            "train_attn_block": kb.attn_block_qkv_plain, "train_ln_mlp": kt.train_ln_mlp_plain,
            "train_sdpa_bwd": kt.train_sdpa_bwd_plain}


def b17_unrounded_gelu(x, ln_params, mlp_params, ls=None, eps=1e-6, add_residual=True):
    """B17's plain version with the planted fault: the GELU of the unrounded
    h (K3's chain), h itself as B17 stores it."""
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.kernels import train as kt

    y = km.ln_mlp_residual_plain(x, ln_params, mlp_params, ls, eps, add_residual)
    return y, kt.train_ln_mlp_plain(x, ln_params, mlp_params, ls, eps, add_residual)[1]


# The planted faults of the training path, each on the plain route: one
# kernel's plain version swapped for its faulty one.
TRAIN_FAULTS = {"B18 row term from pb": lambda: {"train_sdpa_bwd": b18_faulty("row term from pb")},
                "B18 dV from p32": lambda: {"train_sdpa_bwd": b18_faulty("dV from p32")},
                "B17 GELU on the unrounded h": lambda: {"train_ln_mlp": b17_unrounded_gelu}}


class Selections:
    """Taps on the training path's selection. :meth:`record` keeps the
    scores and kept indices of each call (the kernel route's); :meth:`forced`
    makes a later route select those same indices, call by call, and reports
    its own selection's gaps to them (:func:`selection_gaps`), so that two
    routes' gradients are compared through the same tokens."""

    def __init__(self):
        self.scores: list = []
        self.kept: list = []

    def record(self) -> dict:
        from rajni_tpu_torch.models import train_path as tp

        dense = tp.select_tokens_dense

        def select(scores, keep, dtype=None, num_prefix=1):
            idx, sel = dense(scores, keep, dtype, num_prefix)
            self.scores.append(scores.detach().clone())
            self.kept.append(idx)
            return idx, sel

        return {"select_tokens_dense": select}

    def forced(self, report: dict):
        """``select(scores, keep, num_prefix)`` returning the recorded kept
        indices; ``report`` gets the gaps by call."""
        from rajni_tpu_torch.ops.pruning import select_tokens

        calls = iter(range(len(self.kept)))

        def select(scores, keep, num_prefix=1):
            i = next(calls)
            own = select_tokens(scores, keep, num_prefix)
            report[i] = selection_gaps(own, self.kept[i], scores, self.scores[i])
            return self.kept[i].to(scores.device)

        return select

    def forced_dense(self, report: dict) -> dict:
        select = self.forced(report)
        return {"select_tokens_dense": lambda s, k, d=None, n=1: (select(s, k, n), None)}


def gap_line(report: dict, names) -> str:
    """One line of :func:`selection_gaps` readings, by block."""
    return "; ".join(f"{names[i]}: {g['images']}, {g['tokens']}; {g['gap']:.3e}; "
                     f"{g['delta']:.3e}, {g['delta_rel']:.3e}; {g['ratio']:.3f}"
                     for i, g in report.items())


GAP_HEAD = ("its own selection against the kernel route's kept sets (images, tokens that "
            "differ; largest gap to the boundary; score delta, relative; gap/2 delta)")


def check_gaps(tag: str, report: dict, n_calls: int) -> None:
    check(sorted(report) == list(range(n_calls)), f"{tag}: selections {sorted(report)}")
    for i, g in report.items():
        check(g["ratio"] <= 1.0, f"{tag}, selection {i}: a kept set differs beyond what the "
              f"scores explain: {g}")


def train_block_ops(device):
    """The training path's two block ops at T6's shapes (B=128, 197 tokens,
    C=768; the pruned op keeps 187 as the first pruned block does), forward
    and backward: the stock op (B16, B17, B18) and the pruned op (B4, the
    selection, B5, B17, B18). Against the op through the kernels, the same op
    with one kernel at a time swapped for its plain version, on the same
    inputs and cotangent and with the same kept sets: the op's output, the
    input's gradient and every leaf gradient by relative L2, each against the
    gate of the kernel swapped. Each planted fault of ``TRAIN_FAULTS``, swapped
    in the same way, must be rejected. One kernel in one block is where its
    fault is not drowned by the rounding of the others, as it is end to end
    (:func:`first_step`)."""
    import torch

    from rajni_tpu_torch.models import train_path as tp

    gen = torch.Generator().manual_seed(12)
    blk = make_block(gen, device)
    scale = (C // HEADS) ** -0.5
    paths = tp._paths(blk)
    leaves = [t.requires_grad_(True) for t in tp._flatten(blk, paths)]
    x = (X_STD * torch.randn(B_TRAIN, 197, C, generator=gen)).to(device, torch.bfloat16)
    x.requires_grad_(True)
    keep = 186
    g = {"stock": torch.randn(B_TRAIN, 197, C, generator=gen).to(device, torch.bfloat16),
         "pruned": torch.randn(B_TRAIN, keep + 1, C, generator=gen).to(device, torch.bfloat16)}
    ops = {"stock": (lambda: tp._StockBlock.apply((HEADS, scale, 1e-6, paths), x, *leaves),
                     ("train_attn_block", "train_ln_mlp", "train_sdpa_bwd")),
           "pruned": (lambda: tp._PrunedBlock.apply((HEADS, scale, 1e-6, keep, True, paths), x,
                                                    None, *leaves)[0],
                      ("fused_ln_qkv", "fused_gather_sdpa_proj_residual", "train_ln_mlp",
                       "train_sdpa_bwd"))}
    plain = plain_train_kernels()
    for name, (op, kernels) in ops.items():
        def run(subs):
            with train_path_swapped(subs):
                y = op()
                return [y, *torch.autograd.grad(y, [x, *leaves], g[name])]

        def readings(subs) -> tuple:
            """(y, d_x, worst leaf) relative L2 against the kernels."""
            rels = [rel_l2(a, b) for a, b in zip(got, run(subs))]
            return rels[0], rels[1], max(rels[2:])

        sel = Selections()
        got = run(sel.record())
        for kernel in kernels:
            report: dict = {}
            r = readings({kernel: plain[kernel], **sel.forced_dense(report)})
            print(f"{TRAIN} {name} block op, {kernel} swapped for its plain version: rel L2 of "
                  f"y {r[0]:.3e}, d_x {r[1]:.3e}, worst leaf gradient {r[2]:.3e}"
                  + (f"; {GAP_HEAD}: {gap_line(report, ['selection'])}" if report else ""))
            check_gaps(f"{name} block op, {kernel} plain", report, len(sel.kept))
            check(all(v <= lim for v, lim in zip(r, TRAIN_BLOCK_GATES[kernel])),
                  f"{name} block op, {kernel} plain: rel L2 {r} > {TRAIN_BLOCK_GATES[kernel]}")
        for fault, subs in TRAIN_FAULTS.items():
            (kernel,) = subs()
            r = readings({**subs(), **sel.forced_dense({})})
            print(f"{TRAIN} {name} block op: planted fault '{fault}': rel L2 of y {r[0]:.3e}, "
                  f"d_x {r[1]:.3e}, worst leaf gradient {r[2]:.3e}")
            check(any(v > lim for v, lim in zip(r, TRAIN_BLOCK_GATES[kernel])),
                  f"{name} block op: the gates missed the planted fault '{fault}'")
    for t in leaves:
        t.requires_grad_(False)


def first_step(device) -> dict:
    """The training path's first step at ViT-B/16 224, batch 128, bf16
    params, ``REFERENCE_SCHEDULE``: loss and gradients through the kernels
    against (1) the same path with the kernels' plain versions on the card,
    (2) the torch-autograd route (``vit_forward(..., "torch")``, its own
    rounding points), and (3) the plain route with each planted fault of
    ``TRAIN_FAULTS``, which is printed only: over twelve bf16 blocks the
    sound reading is as large as a fault's (:func:`train_block_ops` holds
    them). (1)-(3) take the kernel route's kept sets; each reports how its own
    selection departs from them. Returns the readings; prints them."""
    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE
    from rajni_tpu_torch import train as tt
    from rajni_tpu_torch.models import train_path as tp
    from rajni_tpu_torch.models import vit as tvit
    from rajni_tpu_torch.ops import attention as oa

    config = tvit.get_config(PATH224)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(B_TRAIN, config.img_size, config.img_size, 3, generator=gen).to(device)
    labels = torch.randint(0, config.num_classes, (B_TRAIN,), generator=gen).to(device)
    params = tvit.init_params(torch.Generator().manual_seed(0), config, torch.bfloat16, device)
    leaves = tt.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    sel = Selections()
    blocks: dict = {}  # the pruned blocks, in order

    def run(forward, subs: dict) -> tuple:
        with train_path_swapped(subs):
            loss = tt.cross_entropy(forward(), labels)
            return loss.item(), torch.autograd.grad(loss, leaves)

    def train_forward():
        return tp.vit_forward_train(params, images, config, REFERENCE_SCHEDULE,
                                    _sel_tap=lambda i, k: blocks.setdefault(i))

    loss_k, grads_k = run(train_forward, sel.record())

    def versus(tag, forward, subs, report):
        loss, grads = run(forward, subs)
        rels = [rel_l2(a, b) for a, b in zip(grads_k, grads)]
        worst = max(range(len(rels)), key=rels.__getitem__)
        print(f"{TRAIN}: first step, kernels against {tag}: loss {loss_k:.6f} vs {loss:.6f}; "
              f"gradient rel L2 median {statistics.median(rels):.3e}, worst {rels[worst]:.3e} "
              f"(leaf {worst} of {len(rels)})")
        print(f"{TRAIN}: {tag}, {GAP_HEAD}, by block: {gap_line(report, list(blocks))}")
        return {"loss": abs(loss - loss_k), "worst": rels[worst], "sel": report}

    def torch_forward():
        sound = oa.select_tokens
        oa.select_tokens = sel.forced(torch_report)
        try:
            return tvit.vit_forward(params, images, config, REFERENCE_SCHEDULE, "torch")
        finally:
            oa.select_tokens = sound

    readings = {"calls": len(sel.kept)}
    report: dict = {}
    readings["plain"] = versus("their plain versions", train_forward,
                               {**plain_train_kernels(), **sel.forced_dense(report)}, report)
    torch_report: dict = {}
    readings["torch"] = versus("the torch-autograd route", torch_forward, {}, torch_report)
    for fault, subs in TRAIN_FAULTS.items():
        report = {}
        versus(f"the plain versions with '{fault}' (printed only)", train_forward,
               {**plain_train_kernels(), **subs(), **sel.forced_dense(report)}, report)
    for p in leaves:
        p.requires_grad_(False)
    return readings


def train_end_to_end(device, device_name, results, counters):
    """The training path at ViT-B/16 224, batch 128, bf16 params, pruned
    (``REFERENCE_SCHEDULE``) and identity: the first step's loss and
    gradients through the kernels against their plain versions and against
    the torch-autograd route on the card (:func:`first_step`), the planted
    faults rejected, the launches of one step, the loss over 20 steps on one fixed
    batch, and train img/s with ``train_mfu`` for both routes."""
    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE
    from rajni_tpu_torch import train as tt
    from rajni_tpu_torch.models import vit as tvit
    from rajni_tpu_torch.utils.flops import train_mfu
    from rajni_tpu_torch.utils.timing import measure_throughput

    config = tvit.get_config(PATH224)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(B_TRAIN, config.img_size, config.img_size, 3, generator=gen).to(device)
    labels = torch.randint(0, config.num_classes, (B_TRAIN,), generator=gen).to(device)
    scheds = {"pruned": REFERENCE_SCHEDULE, "identity": None}

    def fresh_params():
        return tvit.init_params(torch.Generator().manual_seed(0), config, torch.bfloat16, device)

    r = first_step(device)
    for tag in ("plain", "torch"):
        check_gaps(f"first step, {tag}", r[tag]["sel"], r["calls"])
    for i, g in r["plain"]["sel"].items():
        check(g["delta_rel"] <= TRAIN_SCORE_REL,
              f"selection {i}: scores vs their plain versions' {g['delta_rel']} > "
              f"{TRAIN_SCORE_REL}")
    worst_sel = max(g["images"] for g in r["torch"]["sel"].values()) / B_TRAIN
    check(worst_sel <= TRAIN_SEL_DIFF,
          f"{worst_sel:.3f} of the images select otherwise than the torch route (> "
          f"{TRAIN_SEL_DIFF})")
    for tag, (loss_atol, grad_gate) in (("plain", (TRAIN_PLAIN_LOSS_ATOL, TRAIN_PLAIN_GRAD_REL_L2)),
                                        ("torch", (TRAIN_LOSS_ATOL, TRAIN_GRAD_REL_L2))):
        check(r[tag]["loss"] <= loss_atol, f"first-step loss vs {tag}: {r[tag]['loss']} > "
              f"{loss_atol}")
        check(r[tag]["worst"] <= grad_gate, f"gradient rel L2 vs {tag}: {r[tag]['worst']} > "
              f"{grad_gate}")

    for sched, expected in TRAIN_LAUNCHES.items():  # launches of one train step
        tx = tt.build_optimizer(1e-4, 20, 0.05)
        state = tt.create_train_state(fresh_params(), tx)
        step = tt.make_train_step(config, scheds[sched], tx, impl="cuda")
        for k in counters.values():
            k.launches = 0
        losses = [step(state, images, labels)["loss"]]
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in counters.items()}
        print(f"{TRAIN}: launches per {sched} train step: { {n: v for n, v in got.items() if v} }")
        check(got == expected, f"{TRAIN} {sched} launches {got} != {expected}")
        if sched == "pruned":
            for n, v in got.items():
                if (n, TRAIN) in results:
                    results[(n, TRAIN)]["launches"] = v
        losses += [step(state, images, labels)["loss"] for _ in range(19)]
        losses = [float(l) for l in losses]
        print(f"{TRAIN} {sched}: loss over 20 steps on one batch {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
        check(all(math.isfinite(l) for l in losses) and losses[-1] < losses[0],
              f"{TRAIN} {sched}: the loss did not fall: {losses}")
        del state, step

    for sched, schedule in scheds.items():  # scripts/bench_train.py's protocol
        trace = tvit.model_stats(config, schedule)["token_counts"]
        for impl in ("cuda", "torch"):
            tx = tt.build_optimizer(1e-4, 100, 0.05)
            state = tt.create_train_state(fresh_params(), tx)
            step = tt.make_train_step(config, schedule, tx, impl=impl)
            ips = measure_throughput(step, state, images, labels, batch=B_TRAIN, device=device,
                                     iters=10, warmup=2, repeats=3)
            print(f"{TRAIN} train img/s {sched} kernels={impl}: {ips:.1f} | "
                  f"train MFU {train_mfu(config, trace, ips, device_name):.4f}")
            del state, step


def train_cli(device):
    """The training and eval CLIs round-trip a checkpoint (ViT-B/16 224 bf16
    on the kernels); vit_tiny trains in fp32 (the CLI's default dtype) and
    runs through ``RAJNIViT``, each on its demoted route, printed."""
    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT

    with tempfile.TemporaryDirectory() as tmp:
        sched = Path(tmp) / "schedule.json"
        sched.write_text(json.dumps({str(k): v for k, v in REFERENCE_SCHEDULE.items()}))
        out = str(Path(tmp) / "trained.msgpack")
        runs = [
            (["rajni_tpu_torch.train", "--synthetic", "--model", PATH224, "--schedule", str(sched),
              "--steps", "4", "--batch_size", "32", "--dtype", "bfloat16", "--kernels", "cuda",
              "--output", out, "--log_every", "1"], "route: cuda"),
            (["rajni_tpu_torch.run", "--synthetic", "2", "--batch_size", "32", "--model", PATH224,
              "--schedule", str(sched), "--checkpoint", out], "route: cuda"),
            (["rajni_tpu_torch.train", "--synthetic", "--model", "vit_tiny_patch16_224",
              "--schedule", str(sched), "--steps", "2", "--batch_size", "16", "--output",
              str(Path(tmp) / "tiny.msgpack")],
             "route: torch (float32 activations (the kernels take bfloat16))"),
        ]
        for argv, route in runs:
            p = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True,
                               text=True, timeout=600)
            tail = [l for l in p.stdout.splitlines()
                    if l.startswith(("route:", "step", "RAJNI -", "saved"))]
            print(f"CLI {argv[0]} {argv[argv.index('--model') + 1]}: " + " | ".join(tail))
            check(p.returncode == 0,
                  f"{argv[0]} exited {p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
            check(route in p.stdout.splitlines(), f"{argv[0]}: no '{route}' line")
    gen = torch.Generator().manual_seed(2)
    images = torch.randn(8, 224, 224, 3, generator=gen)
    for dtype, route in ((torch.float32, "route: torch (float32 activations (the kernels take "
                                         "bfloat16))"),
                         (torch.bfloat16, "route: torch (C=192 is not a multiple of 128)")):
        model = RAJNIViT("vit_tiny_patch16_224", REFERENCE_SCHEDULE, dtype=dtype, device=device)
        out = model(images)
        print(f"RAJNIViT vit_tiny_patch16_224 {dtype}: {model.route}, logits {tuple(out.shape)}")
        check(model.route == route, f"vit_tiny {dtype}: {model.route} != {route}")
        check(out.is_cuda and bool(torch.isfinite(out).all()), "vit_tiny logits not finite")


# Per path: model, weights, batch, image side, schedule, token counts, and
# the launches of each kernel in one pruned and one identity forward.
def launches(**counts):
    """Launches of every counted kernel in one forward (0 unless given)."""
    return {n: counts.get(n, 0) for n in COUNTED}


COUNTED = ("fused_pruned_attn_block", "fused_attn_block", "fused_ln_mlp_residual", "fused_ln_qkv",
           "fused_gather_sdpa_proj_residual", "fused_sdpa", "fused_pruned_block_full",
           "fused_attn_mlp_block", "fused_pruned_block_full_int8", "fused_block_full_int8",
           "fused_ln_mlp_residual_int8", "fused_attn_block_int8", "fused_ln_qkv_int8",
           "fused_gather_sdpa_proj_residual_int8", "fused_pruned_attn_block_int8",
           "fused_ln_qkv_select", "fused_pruned_attn_block_long", "train_attn_block",
           "train_ln_mlp", "train_sdpa_bwd")
# the training path: B16 in every stock block, B4 + B5 in every pruned
# block, B17 and B18 in every block; no inference kernel
TRAIN_LAUNCHES = {
    "pruned": launches(train_attn_block=7, fused_ln_qkv=5, fused_gather_sdpa_proj_residual=5,
                       train_ln_mlp=12, train_sdpa_bwd=12),
    "identity": launches(train_attn_block=12, train_ln_mlp=12, train_sdpa_bwd=12)}
VIT_B384_COUNTS = [577, 577, 577, 577, 548, 520, 442, 375, 356, 356, 356, 356]
VIT_B_COUNTS = [197, 197, 197, 197, 187, 177, 150, 127, 120, 120, 120, 120]
DEIT_S_COUNTS = [197, 197, 197, 197, 177, 159, 143, 128, 115, 103, 92, 82]
VIT_L_COUNTS = [197] * 5 + [138] * 4 + [96] * 4 + [67] * 4 + [47] * 7
DEIT_S384_COUNTS = [577, 577, 577, 577, 519, 467, 420, 378, 340, 306, 275, 247]
# ViT-L/16 int8: the pruned blocks 4, 8, 12, 16 take B11 + B9; the stock
# blocks at 197, 138 and 96 tokens B10 + B9 (no whole-block plan), at 67 and
# 47 tokens B15
VIT_L_INT8_LAUNCHES = {
    "pruned": launches(fused_pruned_attn_block_int8=4, fused_attn_block_int8=10,
                       fused_ln_mlp_residual_int8=14, fused_block_full_int8=10),
    "identity": launches(fused_attn_block_int8=24, fused_ln_mlp_residual_int8=24)}
INT8_LAUNCHES = {"pruned": launches(fused_pruned_block_full_int8=5, fused_block_full_int8=7),
                 "identity": launches(fused_block_full_int8=12)}
INT8_384_LAUNCHES = {
    "pruned": launches(fused_attn_block_int8=3, fused_ln_mlp_residual_int8=8, fused_ln_qkv_int8=5,
                       fused_gather_sdpa_proj_residual=3, fused_gather_sdpa_proj_residual_int8=2,
                       fused_block_full_int8=4, fused_sdpa=12),
    "identity": launches(fused_attn_block_int8=12, fused_ln_mlp_residual_int8=12, fused_sdpa=12)}
PATHS = {
    PATH224: dict(
        model=PATH224, quant=None, batch=B, img=224, schedule="reference", counts=VIT_B_COUNTS,
        launches={
            "pruned": launches(fused_pruned_attn_block=5, fused_attn_block=7,
                               fused_ln_mlp_residual=12),
            "identity": launches(fused_attn_block=12, fused_ln_mlp_residual=12)}),
    # every block runs past ATTN_MAX_N tokens: B6's two-pass kernel is the
    # attention inside each K2 (7) and each B5 (5)
    PATH384: dict(
        model=PATH384, quant=None, batch=B384, img=384, schedule="reference",
        counts=VIT_B384_COUNTS,
        launches={
            "pruned": launches(fused_attn_block=7, fused_ln_mlp_residual=12, fused_ln_qkv=5,
                               fused_gather_sdpa_proj_residual=5, fused_sdpa=12),
            "identity": launches(fused_attn_block=12, fused_ln_mlp_residual=12, fused_sdpa=12)}),
    # the whole-block paths: no K1, K2 or K3 launch
    P3A: dict(
        model=DEIT_S, quant=None, batch=B, img=224, schedule="deit", counts=DEIT_S_COUNTS,
        launches={"pruned": launches(fused_pruned_block_full=8, fused_attn_mlp_block=4),
                  "identity": launches(fused_attn_mlp_block=12)}),
    P3B: dict(model=PATH224, quant="dynamic", batch=B, img=224, schedule="reference",
              counts=VIT_B_COUNTS, launches=INT8_LAUNCHES),
    P3C: dict(model=PATH224, quant="static", batch=B, img=224, schedule="reference",
              counts=VIT_B_COUNTS, launches=INT8_LAUNCHES),
    P3D: dict(
        model=DEIT_S, quant="dynamic", batch=B, img=224, schedule="deit", counts=DEIT_S_COUNTS,
        launches={"pruned": launches(fused_pruned_block_full_int8=8, fused_block_full_int8=4),
                  "identity": launches(fused_block_full_int8=12)}),
    # the split int8 kernels: blocks 0-2 B10 + B9, 3-5 B12 + bf16 B5 + B9, 6-7
    # B12 + B13 + B9, 8-11 B15 at 356 tokens; the two-pass attention inside
    # B10 (577), B5 (548, 520, 442), B13 (375, 356) and B15 (356)
    P4A: dict(model=PATH384, quant="dynamic", batch=B384, img=384, schedule="reference",
              counts=VIT_B384_COUNTS, launches=INT8_384_LAUNCHES),
    P4B: dict(model=PATH384, quant="static", batch=B384, img=384, schedule="reference",
              counts=VIT_B384_COUNTS, launches=INT8_384_LAUNCHES),
    P4C: dict(
        model=PATH224, quant="mlp", batch=B, img=224, schedule="reference", counts=VIT_B_COUNTS,
        launches={"pruned": launches(fused_pruned_attn_block=5, fused_attn_block=7,
                                     fused_ln_mlp_residual_int8=12),
                  "identity": launches(fused_attn_block=12, fused_ln_mlp_residual_int8=12)}),
    P5A: dict(model=PATH_L, quant="dynamic", batch=B, img=224, schedule="vit_l",
              counts=VIT_L_COUNTS, launches=VIT_L_INT8_LAUNCHES),
    P5B: dict(model=PATH_L, quant="static", batch=B, img=224, schedule="vit_l",
              counts=VIT_L_COUNTS, launches=VIT_L_INT8_LAUNCHES),
    P5C: dict(
        model=PATH_L, quant=None, batch=B, img=224, schedule="vit_l", counts=VIT_L_COUNTS,
        launches={"pruned": launches(fused_pruned_attn_block=4, fused_attn_block=20,
                                     fused_ln_mlp_residual=24),
                  "identity": launches(fused_attn_block=24, fused_ln_mlp_residual=24)}),
    # DeiT-S/16 384 int8: blocks 0-2 B15 at 577 tokens, block 3 B11 + B9
    # (577→519), blocks 4-10 B14 (519→247), block 11 B15; the two-pass
    # attention inside B15 at 577 (3), B11 (1) and B14 past 256 kept tokens (6)
    P5D: dict(
        model=DEIT_S384, quant="dynamic", batch=B_S384, img=384, schedule="deit",
        counts=DEIT_S384_COUNTS,
        launches={"pruned": launches(fused_pruned_attn_block_int8=1,
                                     fused_ln_mlp_residual_int8=1,
                                     fused_pruned_block_full_int8=7, fused_block_full_int8=4,
                                     fused_sdpa=10),
                  "identity": launches(fused_block_full_int8=12, fused_sdpa=12)}),
}


@contextlib.contextmanager
def plain_int8_blocks():
    """Route the forward's int8 kernels (B9-B15) to their plain versions (the
    reference forward of the int8 paths, on the card)."""
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.kernels import wholeblock as wb
    from rajni_tpu_torch.models import vit as tvit

    plain = {"fused_pruned_block_full_int8": wb.pruned_block_full_int8_plain,
             "fused_block_full_int8": wb.block_full_int8_plain,
             "fused_ln_mlp_residual_int8": km.ln_mlp_residual_int8_plain,
             "fused_attn_block_int8": kb.attn_block_int8_plain,
             "fused_ln_qkv_int8": kb.ln_qkv_int8_plain,
             "fused_gather_sdpa_proj_residual_int8": kb.gather_sdpa_proj_residual_int8_plain,
             "fused_pruned_attn_block_int8": kb.pruned_attn_block_int8_plain}
    sound = {name: getattr(tvit, name) for name in plain}
    for name, fn in plain.items():
        setattr(tvit, name, fn)
    try:
        yield
    finally:
        for name, fn in sound.items():
            setattr(tvit, name, fn)


def kernel_counters() -> dict:
    """Every counted kernel's wrapper counter, by name."""
    from rajni_tpu_torch.kernels import attention as ka
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import longseq as kl
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.kernels import train as kt
    from rajni_tpu_torch.kernels import wholeblock as wb

    return {"fused_pruned_attn_block": kb.PRUNED_KERNEL,
            "fused_attn_block": kb.ATTN_KERNEL,
            "fused_ln_mlp_residual": km.KERNEL,
            "fused_ln_qkv": kb.LN_QKV_KERNEL,
            "fused_gather_sdpa_proj_residual": kb.GATHER_KERNEL,
            "fused_sdpa": ka.SDPA_KERNEL,
            "fused_pruned_block_full": wb.PRUNED_FULL_KERNEL,
            "fused_attn_mlp_block": wb.ATTN_MLP_KERNEL,
            "fused_pruned_block_full_int8": wb.PRUNED_FULL_INT8_KERNEL,
            "fused_block_full_int8": wb.BLOCK_FULL_INT8_KERNEL,
            "fused_ln_mlp_residual_int8": km.INT8_KERNEL,
            "fused_attn_block_int8": kb.ATTN_INT8_KERNEL,
            "fused_ln_qkv_int8": kb.LN_QKV_INT8_KERNEL,
            "fused_gather_sdpa_proj_residual_int8": kb.GATHER_INT8_KERNEL,
            "fused_pruned_attn_block_int8": kb.PRUNED_INT8_KERNEL,
            "fused_ln_qkv_select": kb.LN_QKV_SELECT_KERNEL,
            "fused_pruned_attn_block_long": kl.LONG_KERNEL,
            "train_attn_block": kt.TRAIN_ATTN_KERNEL,
            "train_ln_mlp": kt.TRAIN_MLP_KERNEL,
            "train_sdpa_bwd": kt.SDPA_BWD_KERNEL}


def end_to_end(device, device_name, results, path):
    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT
    from rajni_tpu_torch.quant import calibrate_act_scales, quantize_params
    from rajni_tpu_torch.utils.flops import mfu
    from rajni_tpu_torch.utils.timing import measure_throughput

    counters = kernel_counters()
    spec = PATHS[path]
    batch, model_name = spec["batch"], spec["model"]
    schedule = {"reference": REFERENCE_SCHEDULE, "deit": DEIT_S_SCHEDULE,
                "vit_l": VIT_L_SCHEDULE}[spec["schedule"]]
    scheds = {"pruned": schedule, "identity": None}
    raw = RAJNIViT(model_name, schedule, kernels="cuda", seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(batch, spec["img"], spec["img"], 3, generator=gen).to(device)
    params, scales = raw.params, {"pruned": None, "identity": None}
    if spec["quant"]:
        params = quantize_params(raw.params, attn=spec["quant"] != "mlp")
        if spec["quant"] == "static":  # calibrated on this batch, before quantization
            scales = {k: calibrate_act_scales(raw.params, images, raw.config, v)
                      for k, v in scheds.items()}
    models = {(k, impl): RAJNIViT(model_name, v, params=params, kernels=impl, device=device,
                                  act_scales=scales[k])
              for k, v in scheds.items() for impl in ("cuda", "torch")}
    counts = models[("pruned", "cuda")].get_last_stats()["token_counts"]
    check(counts == spec["counts"], f"{path}: token counts {counts} != {spec['counts']}")
    print(f"{path}: token_counts {counts}")

    for sched, expected in spec["launches"].items():
        for k in counters.values():
            k.launches = 0
        out = models[(sched, "cuda")](images)
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in counters.items()}
        print(f"{path}: launches per {sched} forward: {got}")
        check(got == expected, f"{path} {sched} launches {got} != {expected}")
        for n, v in got.items():
            if sched == "pruned" and (n, path) in results:
                results[(n, path)]["launches"] = v
            if (n, KERNEL_ONLY) in results:  # B19, B20: the most any path's forward launched
                r = results[(n, KERNEL_ONLY)]
                r["launches"] = max(r.get("launches", 0), v)
        check(tuple(out.shape) == (batch, 1000), f"logits shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{path} {sched} logits not finite")
        ref = models[(sched, "torch")](images)
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        if not spec["quant"]:
            print(f"{path} {sched}: logits rel L2 (cuda vs torch on the card) {rel:.3e}")
            check(rel <= LOGITS_REL_L2, f"{path} {sched} logits rel L2 {rel} > {LOGITS_REL_L2}")
            continue
        with plain_int8_blocks():
            plain = models[(sched, "cuda")](images)
        prel = ((out.float() - plain.float()).norm() / plain.float().norm()).item()
        print(f"{path} {sched}: logits rel L2, kernels vs plain versions on the card {prel:.3e}; "
              f"vs the dequantized kernels=\"torch\" forward {rel:.3e}")
        check(prel <= INT8_LOGITS_REL_L2,
              f"{path} {sched} logits rel L2 vs plain {prel} > {INT8_LOGITS_REL_L2}")
        check(rel <= INT8_VS_DEQUANT_REL_L2,
              f"{path} {sched} logits rel L2 vs dequantized {rel} > {INT8_VS_DEQUANT_REL_L2}")

    # the torch route's img/s on the two bf16 ViT-B paths only (the eager
    # baseline); every path's kernel route
    impls = ("cuda", "torch") if path in (PATH224, PATH384) else ("cuda",)
    for (sched, impl), model in models.items():
        if impl not in impls:
            continue
        ips = measure_throughput(model, images, batch=batch, device=device, iters=10, warmup=2,
                                 repeats=3)
        trace = model.get_last_stats()["token_counts"]
        print(f"{path} img/s {sched} kernels={impl}: {ips:.1f} | "
              f"MFU {mfu(model.config, trace, ips, device_name):.4f}")


def eval_cli():
    from rajni_tpu_torch import REFERENCE_SCHEDULE

    with tempfile.TemporaryDirectory() as tmp:
        sched = Path(tmp) / "schedule.json"
        sched.write_text(json.dumps({str(k): v for k, v in REFERENCE_SCHEDULE.items()}))
        for model, batch, extra in ((PATH224, 64, []), (PATH384, 32, []),
                                    (PATH224, 64, ["--quantize", "--calibrate", "1"]),
                                    (PATH384, 32, ["--quantize", "--calibrate", "1"])):
            cmd = [sys.executable, "-m", "rajni_tpu_torch.run", "--synthetic", "3",
                   "--batch_size", str(batch), "--model", model, "--schedule", str(sched), *extra]
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            tail = [l for l in p.stdout.splitlines() if "RAJNI -" in l or "Token counts" in l]
            print(f"eval CLI {model} batch {batch} {' '.join(extra)}: " + " | ".join(tail))
            check(p.returncode == 0,
                  f"eval CLI exited {p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
            want = f"Token counts per block: {PATHS[model]['counts']}"
            if extra:
                check("Calibrated static int8 activation scales" in p.stdout,
                      "eval CLI --calibrate: no calibration line")
            check(want in p.stdout, f"eval CLI {model}: no '{want}' line")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "rajni_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the rajni_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    from rajni_tpu_torch.kernels import build
    from rajni_tpu_torch.utils.flops import device_int8_peak, device_peaks

    t0 = time.perf_counter()
    reports = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(reports)} sources compiled)")
    for src, rep in reports.items():
        spills = [l.strip() for l in rep.splitlines()
                  if "spill" in l and not l.strip().startswith("0 bytes stack frame, 0 bytes spill")]
        regs = [l.split("Used")[1].strip() for l in rep.splitlines() if "Used" in l]
        print(f"  {src}: ptxas {regs}")
        for l in spills:
            print(f"  {src}: {l}")
        if src in GEMM_SOURCES:
            check(not re.search(r"[1-9][0-9]* bytes spill", rep), f"{src}: ptxas reports spills")
            check("C7520" not in rep and "C7515" not in rep, f"{src}: ptxas serialized wgmma")

    peaks, int8_peak = device_peaks(device_name), device_int8_peak(device_name)
    results: dict = {}
    phases = [("kernel phases 224", lambda: kernel_phases(device, peaks, results)),
              ("kernel phases 384", lambda: long_phases(device, peaks, results)),
              ("kernel phases B7/B8", lambda: wholeblock_phases(device, peaks, results)),
              ("kernel phases B14/B15", lambda: int8_phases(device, peaks, int8_peak, results)),
              ("kernel phases B9/B10/B12/B13",
               lambda: split_int8_phases(device, peaks, int8_peak, results)),
              ("kernel phases K1-K3 at C=1024",
               lambda: kernel_phases(device, peaks, results, P5C, C_L, HEADS_L, HIDDEN_L, (197,),
                                     ((197, 137),), seed=8)),
              ("kernel phases B11 (with B9, B10, B15 at C=1024)",
               lambda: b11_phases(device, peaks, int8_peak, results)),
              ("kernel phases B14/B15 at 577 tokens",
               lambda: int8_phases(device, peaks, int8_peak, results, INT8_WHOLE_S384, seed=9)),
              ("kernel phases B19/B20", lambda: alternative_phases(device, peaks, results)),
              ("kernel phases B16/B17/B18 (training)",
               lambda: train_kernel_phases(device, peaks, results)),
              ("kernel phases B6/B18 at ragged lengths", lambda: ragged_phases(device)),
              ("GEMM of K2/K3 (csrc/gemm_sm90.cuh) beside cuBLAS",
               lambda: gemm_phases(device, peaks)),
              ("training block ops", lambda: train_block_ops(device))]
    phases += [(f"end to end {path}", lambda path=path: end_to_end(device, device_name, results, path))
               for path in PATHS]
    phases += [("training end to end",
                lambda: train_end_to_end(device, device_name, results, kernel_counters())),
               ("eval CLI", eval_cli), ("training and eval CLIs", lambda: train_cli(device))]
    for label, phase in phases:
        t0 = time.perf_counter()
        phase()
        print(f"{label}: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for r in results.values():
        source, replaces = KERNELS[r["name"]]
        kernels.append({"name": r["name"], "route": "cuda", "source": f"rajni_tpu_torch/{source}",
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "path": r["path"], "shape": r["shape"],
                        "branch_rel_l2": r["branch_rel_l2"],
                        **({"two_kernel_ms": r["two_kernel_ms"]} if "two_kernel_ms" in r else {}),
                        **({"device_ms": r["device_ms"]} if "device_ms" in r else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
