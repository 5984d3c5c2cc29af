#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rajni_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Main paths: ViT-B/16 224 at batch 256 (K1-K3), ViT-B/16 384 at batch 128
(577 tokens: K2, K3 and the long-sequence kernels B4-B6), and the whole-block
paths at batch 256: DeiT-S/16 in bf16 (P3a: B7, B8), ViT-B/16 224 with int8
weights and dynamic scales (P3b: B14, B15) or calibrated static scales (P3c),
and DeiT-S/16 int8 dynamic (P3d: B14, B15 at hc 768). Steps, each of which
fails the run (non-zero exit) when it goes wrong:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``rajni_tpu_torch/csrc`` into one library
   (one ``nvcc`` per source, in parallel, then one link);
3. hold each kernel against its plain PyTorch version on the card at each
   path's shapes: K1 ``fused_pruned_attn_block``, K2 ``fused_attn_block`` and
   K3 ``fused_ln_mlp_residual`` at B=256 and the 224 path's token counts; B4
   ``fused_ln_qkv``, B5 ``fused_gather_sdpa_proj_residual``, B6
   ``fused_sdpa``, K2 and K3 at B=128 and the 384 path's; B7
   ``fused_pruned_block_full`` and B8 ``fused_attn_mlp_block`` at P3a's
   shapes; B14 ``fused_pruned_block_full_int8`` and B15
   ``fused_block_full_int8`` at P3b's (dynamic and static) and B14 at P3d's.
   Show that the comparison rejects faults planted in the plain versions
   (the attention for K1-B8, the quantization for B14/B15), and time both
   with CUDA events (B6 also beside ``F.scaled_dot_product_attention``,
   which the port never calls);
4. run each path end to end through ``RAJNIViT``, pruned and with the
   identity schedule: exact token counts, launch counts per forward (every
   count set to 0 just before the forward and read just after), finite
   logits, distance to a reference forward (the ``kernels="torch"`` one;
   for int8, the same forward with the kernels' plain versions on the card,
   and the dequantized ``kernels="torch"`` one loosely), img/s and MFU;
5. run the eval CLI in a subprocess: at 224 and at 384, and at 224 with
   ``--quantize --calibrate 1``;
6. print one JSON line of per-kernel results, then the ``{"ok": true, ...}``
   line last.

It exits non-zero without printing a result when CUDA is unavailable or when
the ``rajni_tpu_torch`` package is not beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
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
# scripts/bench_suite.py:34 DEIT_S_DYNAMIC: blocks 3-10 keep 0.9, rescoring
DEIT_S_SCHEDULE = {i: {"keep_ratio": 0.9, "update": True} for i in range(3, 11)}
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
LOGITS_REL_L2 = 5e-2
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
def planted_int8(fault: str):
    """Swap a quantization helper of the int8 plain versions for a faulty
    one while the plain version runs."""
    import torch

    from rajni_tpu_torch.kernels import wholeblock as wb

    sound = {name: getattr(wb, name)
             for name in ("quantize_rows", "fold_static_attn", "fold_static_mlp")}

    def per_tensor(y32):  # one scale for the whole tensor instead of one a row
        a = torch.clamp_min(y32.abs().amax(), 1e-8)
        q = torch.clamp(torch.round(y32 * (127.0 / a)), -127, 127).to(torch.int8)
        return q, (a * (1.0 / 127.0)).expand(*y32.shape[:-1], 1)

    def shifted(y32):  # each row dequantized with its neighbour's scale
        q, a = sound["quantize_rows"](y32)
        return q, torch.roll(a, 1, dims=-2)

    def no_bias_fold(lns, lnb, sqkv, sproj, bqkv, aq, ap):  # V-fold left out of bqkv
        out = sound["fold_static_attn"](lns, lnb, sqkv, sproj, bqkv, aq, ap)
        return (*out[:4], bqkv.float())

    def no_sinv(lns, lnb, s1, s2, hidden, a1, a2):  # h quantized without 1/a_fc2
        out = sound["fold_static_mlp"](lns, lnb, s1, s2, hidden, a1, a2)
        return (*out[:4], torch.ones_like(out[4]))

    name, fn = {"per-tensor scale": ("quantize_rows", per_tensor),
                "row scales shifted": ("quantize_rows", shifted),
                "bqkv without V-fold": ("fold_static_attn", no_bias_fold),
                "h without 1/a_fc2": ("fold_static_mlp", no_sinv)}[fault]
    setattr(wb, name, fn)
    try:
        yield
    finally:
        setattr(wb, name, sound[name])


INT8_FAULTS = {False: ("per-tensor scale", "row scales shifted"),
               True: ("bqkv without V-fold", "h without 1/a_fc2")}


def check_rescored(name, got, want, s, keep, x, gate=BF16_GATE):
    """Rescoring ``(out, next_scores, keep_idx)`` of a kernel against its
    plain version's: kept sets equal except at near-ties of the plain scores
    ``s``; next_scores and the outputs of the images whose sets agree within
    their limits. Returns ``(max abs err, branch rel L2)``."""
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
}


def record(results, name, path, shape, ms, plain_ms, bnd, err, rel, library_ms=None):
    """Keep a kernel's numbers on one path: the times and bound of its first
    shape there, the worst error over all its shapes."""
    r = results.setdefault((name, path), dict(
        name=name, path=path, shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
        bound_by=bnd[1], library_ms=library_ms, max_abs_err=0.0, branch_rel_l2=0.0))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["branch_rel_l2"] = max(r["branch_rel_l2"], rel)
    lib = "" if library_ms is None else f" | library {library_ms:.3f} ms"
    print(f"{name} {shape}: kernel {ms:.3f} ms | plain {plain_ms:.3f} ms{lib} | "
          f"bound {bnd[0]:.3f} ms ({bnd[1]})")


def kernel_phases(device, peaks, results):
    import torch

    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km

    gen = torch.Generator().manual_seed(0)
    blk = make_block(gen, device)
    scale = (C // HEADS) ** -0.5

    def x_of(n):
        return (X_STD * torch.randn(B, n, C, generator=gen)).to(device, torch.bfloat16)

    for n in (197, 120):  # K3
        x = x_of(n)
        args = (x, blk["norm2"], blk["mlp"], None, 1e-6)
        err, rel = compare(f"K3 N={n}", km.fused_ln_mlp_residual(*args),
                           km.ln_mlp_residual_plain(*args), x)
        ms = cuda_ms(lambda: km.fused_ln_mlp_residual(*args))
        plain_ms = cuda_ms(lambda: km.ln_mlp_residual_plain(*args), iters=5)
        M = B * n
        bnd = bound(4.0 * M * C * HIDDEN, 2 * M * C * 2 + 2 * C * HIDDEN * 2, peaks)
        record(results, "fused_ln_mlp_residual", PATH224, f"B={B} N={n} C={C}", ms, plain_ms,
               bnd, err, rel)

    for n in (197, 120):  # K2
        x = x_of(n)
        args = (x, blk["norm1"], blk["attn"], None, HEADS, scale, 1e-6)
        got = kb.fused_attn_block(*args)
        err, rel = compare(f"K2 N={n}", got, kb.attn_block_plain(*args), x)
        reject_planted(f"K2 N={n}", got, lambda: kb.attn_block_plain(*args), x)
        ms = cuda_ms(lambda: kb.fused_attn_block(*args))
        plain_ms = cuda_ms(lambda: kb.attn_block_plain(*args), iters=5)
        M = B * n
        flops = 2.0 * M * C * 4 * C + 4.0 * B * n * n * C
        bnd = bound(flops, 2 * M * C * 2 + 4 * C * C * 2, peaks)
        record(results, "fused_attn_block", PATH224, f"B={B} N={n} C={C}", ms, plain_ms, bnd,
               err, rel)

    for n, keep in ((197, 186), (150, 126)):  # K1
        K = keep + 1
        x = x_of(n)
        common = (x, blk["norm1"], blk["attn"], None)
        # threaded scores: selection and next_scores must be exact
        threaded = (*common, torch.rand(B, n, generator=gen).to(device), HEADS, keep, scale,
                    1e-6, False)
        got = kb.fused_pruned_attn_block(*threaded)
        want = kb.pruned_attn_block_plain(*threaded)
        check(torch.equal(got[2], want[2]), f"K1 N={n} with_scores=False: kept sets differ")
        check(torch.equal(got[1], want[1]), f"K1 N={n} with_scores=False: next_scores differ")
        x_kept = torch.take_along_dim(x, want[2][..., None], dim=1)
        err, rel = compare(f"K1 N={n} with_scores=False", got[0], want[0], x_kept)
        reject_planted(f"K1 N={n}", got[0], lambda: kb.pruned_attn_block_plain(*threaded)[0],
                       x_kept)

        # rescoring: kept sets must match except at near-ties
        rescored = (*common, None, HEADS, keep, scale, 1e-6, True)
        got = kb.fused_pruned_attn_block(*rescored)
        want = kb.pruned_attn_block_plain(*rescored)
        e2, r2 = check_rescored(f"K1 N={n}", got, want, bf16_scores(x, blk, HEADS), keep, x)

        ms = cuda_ms(lambda: kb.fused_pruned_attn_block(*rescored))
        plain_ms = cuda_ms(lambda: kb.pruned_attn_block_plain(*rescored), iters=5)
        flops = 2.0 * B * n * C * 3 * C + 2.0 * B * K * C * C + 4.0 * B * K * K * C
        nbytes = B * n * C * 2 + 4 * C * C * 2 + B * K * C * 2 + B * K * 4
        record(results, "fused_pruned_attn_block", PATH224, f"B={B} N={n} K={K} C={C}", ms,
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
        ms = cuda_ms(lambda: ka.fused_sdpa(qkv, HEADS, scale))
        plain_ms = cuda_ms(lambda: ka.fused_sdpa_plain(qkv, HEADS, scale), iters=5)
        q, k, v = qkv.view(Bl, n, 3, HEADS, C // HEADS).permute(2, 0, 3, 1, 4).contiguous()
        lib_ms = cuda_ms(lambda: Fnn.scaled_dot_product_attention(q, k, v, scale=scale))
        bnd = bound(4.0 * Bl * n * n * C, Bl * n * 3 * C * 2 + Bl * n * C * 2, peaks)
        record(results, "fused_sdpa", PATH384, f"B={Bl} N={n} C={C}", ms, plain_ms, bnd, err,
               rel, lib_ms)

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
    from rajni_tpu_torch.kernels import wholeblock as wb

    sound = wb._layer_norm_f32

    def ln64(x32, scale, bias, eps):
        x64 = x32.double()
        mean = x64.mean(dim=-1, keepdim=True)
        var = (x64 - mean).square().mean(dim=-1, keepdim=True)
        return ((x64 - mean) / (var + eps).sqrt()).float() * scale.float() + bias.float()

    wb._layer_norm_f32 = ln64
    try:
        yield
    finally:
        wb._layer_norm_f32 = sound


def int8_scores(x, qblk, heads, act_scales):
    """B14's plain RAJNI scores of x: from the int8 qkv rounded to bf16."""
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import wholeblock as wb

    ops = wb.int8_operands(qblk, act_scales)
    y = kb._layer_norm_f32(x.float(), ops["ln1s"], ops["ln1b"], 1e-6)
    qkv = wb._int8_matmul(y, qblk["attn"]["qkv"]["weight"]["int8"], ops["sqkv"],
                          act_scales is not None)
    return kb._importance_f32((qkv + ops["bqkv"]).to(x.dtype).float(), heads)


def int8_phases(device, peaks, int8_peak, results):
    """B14 and B15 at P3b/P3c's shapes (ViT-B/16 224, B=256; dynamic and
    static), and B14 at P3d's (DeiT-S/16, hc 768)."""
    import torch

    from rajni_tpu_torch.kernels import wholeblock as wb

    gen = torch.Generator().manual_seed(4)
    for width, heads, hidden, cases in (
        (C, HEADS, HIDDEN, [("B15", 197, None), ("B14", 197, 186), ("B14", 150, 126)]),
        (C_S, HEADS_S, HIDDEN_S, [("B14", 197, 176)]),
    ):
        blk = make_block(gen, device, width, hidden)
        qblk = quantized_block(blk)
        scale = (width // heads) ** -0.5
        wbytes = 4 * width * width + 2 * width * hidden + (8 * width + 2 * hidden) * 4
        modes = (False, True) if width == C else (False,)
        for name, n, keep in cases:
            x = (X_STD * torch.randn(B, n, width, generator=gen)).to(device, torch.bfloat16)
            for static in modes:
                scales = block_act_scales(blk, x, heads) if static else None
                path = (P3C if static else P3B) if width == C else P3D
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
                    prev = torch.rand(B, n, generator=gen).to(device)
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
                int8_ops = 2.0 * B * (n * width * 3 * width + K * width * width
                                      + 2 * K * width * hidden)
                nbytes = B * n * width * 2 + wbytes + B * K * width * 2 + (B * K * 8 if keep else 0)
                record(results, kname, path, f"B={B} N={n} K={K} C={width} hc={hc}", ms, plain_ms,
                       bound(4.0 * B * K * K * width, nbytes, peaks, int8_ops, int8_peak),
                       err, rel)


# Per path: model, weights, batch, image side, schedule, token counts, and
# the launches of each kernel in one pruned and one identity forward.
def launches(**counts):
    """Launches of every counted kernel in one forward (0 unless given)."""
    return {n: counts.get(n, 0) for n in COUNTED}


COUNTED = ("fused_pruned_attn_block", "fused_attn_block", "fused_ln_mlp_residual", "fused_ln_qkv",
           "fused_gather_sdpa_proj_residual", "fused_sdpa", "fused_pruned_block_full",
           "fused_attn_mlp_block", "fused_pruned_block_full_int8", "fused_block_full_int8")
VIT_B_COUNTS = [197, 197, 197, 197, 187, 177, 150, 127, 120, 120, 120, 120]
DEIT_S_COUNTS = [197, 197, 197, 197, 177, 159, 143, 128, 115, 103, 92, 82]
INT8_LAUNCHES = {"pruned": launches(fused_pruned_block_full_int8=5, fused_block_full_int8=7),
                 "identity": launches(fused_block_full_int8=12)}
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
        counts=[577, 577, 577, 577, 548, 520, 442, 375, 356, 356, 356, 356],
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
}


@contextlib.contextmanager
def plain_int8_blocks():
    """Route the forward's B14/B15 calls to their plain versions (the
    reference forward of the int8 paths, on the card)."""
    from rajni_tpu_torch.kernels import wholeblock as wb
    from rajni_tpu_torch.models import vit as tvit

    sound = (tvit.fused_pruned_block_full_int8, tvit.fused_block_full_int8)
    tvit.fused_pruned_block_full_int8 = wb.pruned_block_full_int8_plain
    tvit.fused_block_full_int8 = wb.block_full_int8_plain
    try:
        yield
    finally:
        tvit.fused_pruned_block_full_int8, tvit.fused_block_full_int8 = sound


def end_to_end(device, device_name, results, path):
    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT
    from rajni_tpu_torch.kernels import attention as ka
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.kernels import wholeblock as wb
    from rajni_tpu_torch.quant import calibrate_act_scales, quantize_params
    from rajni_tpu_torch.utils.flops import mfu
    from rajni_tpu_torch.utils.timing import measure_throughput

    counters = {"fused_pruned_attn_block": kb.PRUNED_KERNEL,
                "fused_attn_block": kb.ATTN_KERNEL,
                "fused_ln_mlp_residual": km.KERNEL,
                "fused_ln_qkv": kb.LN_QKV_KERNEL,
                "fused_gather_sdpa_proj_residual": kb.GATHER_KERNEL,
                "fused_sdpa": ka.SDPA_KERNEL,
                "fused_pruned_block_full": wb.PRUNED_FULL_KERNEL,
                "fused_attn_mlp_block": wb.ATTN_MLP_KERNEL,
                "fused_pruned_block_full_int8": wb.PRUNED_FULL_INT8_KERNEL,
                "fused_block_full_int8": wb.BLOCK_FULL_INT8_KERNEL}
    spec = PATHS[path]
    batch, model_name = spec["batch"], spec["model"]
    schedule = REFERENCE_SCHEDULE if spec["schedule"] == "reference" else DEIT_S_SCHEDULE
    scheds = {"pruned": schedule, "identity": None}
    raw = RAJNIViT(model_name, schedule, kernels="cuda", seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(batch, spec["img"], spec["img"], 3, generator=gen).to(device)
    params, scales = raw.params, {"pruned": None, "identity": None}
    if spec["quant"]:
        params = quantize_params(raw.params)
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
        if sched == "pruned":
            for n, v in got.items():
                if (n, path) in results:
                    results[(n, path)]["launches"] = v
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
                                    (PATH224, 64, ["--quantize", "--calibrate", "1"])):
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

    peaks, int8_peak = device_peaks(device_name), device_int8_peak(device_name)
    results: dict = {}
    phases = [("kernel phases 224", lambda: kernel_phases(device, peaks, results)),
              ("kernel phases 384", lambda: long_phases(device, peaks, results)),
              ("kernel phases B7/B8", lambda: wholeblock_phases(device, peaks, results)),
              ("kernel phases B14/B15", lambda: int8_phases(device, peaks, int8_peak, results))]
    phases += [(f"end to end {path}", lambda path=path: end_to_end(device, device_name, results, path))
               for path in PATHS]
    for label, phase in phases + [("eval CLI", eval_cli)]:
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
                        "branch_rel_l2": r["branch_rel_l2"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
