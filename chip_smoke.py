#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rajni_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Two main paths: ViT-B/16 224 at batch 256 (K1-K3) and ViT-B/16 384 at
batch 128 (577 tokens: K2, K3 and the long-sequence kernels B4-B6). Steps,
each of which fails the run (non-zero exit) when it goes wrong:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``rajni_tpu_torch/csrc`` into one library
   (one ``nvcc`` per source, in parallel, then one link);
3. hold each kernel against its plain PyTorch version on the card at each
   path's shapes (C=768, H=12, bf16): K1 ``fused_pruned_attn_block``, K2
   ``fused_attn_block`` and K3 ``fused_ln_mlp_residual`` at B=256 and the
   224 path's token counts; B4 ``fused_ln_qkv``, B5
   ``fused_gather_sdpa_proj_residual``, B6 ``fused_sdpa``, K2 and K3 at
   B=128 and the 384 path's. Show that the comparison rejects faults planted
   in the plain attention, and time both with CUDA events (B6 also beside
   ``F.scaled_dot_product_attention``, which the port never calls);
4. run each path end to end through ``RAJNIViT`` with ``REFERENCE_SCHEDULE``
   and the identity schedule: exact token counts, launch counts per forward
   (every count set to 0 just before the forward and read just after),
   finite logits, distance to the ``kernels="torch"`` forward, img/s and
   MFU;
5. run the eval CLI in a subprocess, at 224 and at 384;
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


def bound(flops: float, nbytes: float, peaks) -> tuple[float, str]:
    """Least time (ms): the larger of FLOPs over the bf16 peak and bytes over
    the memory rate."""
    t_ops = flops / (peaks[0] * 1e12)
    t_mem = nbytes / (peaks[1] * 1e12)
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def make_block(gen, device):
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


def compare(name, got, want, x):
    """Hold a kernel's bf16 output against its plain version's; return
    ``(max abs err, branch rel L2)``."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    rel = branch_rel(got, want, x)
    print(f"{name}: max_abs_err {err:.3e}, branch rel L2 {rel:.3e}")
    ok = torch.allclose(got.float(), want.float(), atol=ATOL, rtol=RTOL)
    check(ok, f"{name}: kernel disagrees with its plain version (max abs {err})")
    check(rel <= BRANCH_REL_L2, f"{name}: branch rel L2 {rel} > {BRANCH_REL_L2}")
    return err, rel


def reject_planted(name, got, plain, x):
    """The branch gate must reject each planted fault of the plain version."""
    for fault in FAULTS:
        with planted(fault):
            bad = plain()
        rel = branch_rel(got, bad, x)
        print(f"{name}: planted fault '{fault}': branch rel L2 {rel:.3e}")
        check(rel > BRANCH_REL_L2, f"{name}: the gate missed the planted fault '{fault}'")


# Each kernel's source and the TPU kernel it replaces (def line).
KERNELS = {
    "fused_pruned_attn_block": ("csrc/pruned_attn_block.cu", "rajni_tpu/kernels/block.py:1516"),
    "fused_attn_block": ("csrc/attn_block.cu", "rajni_tpu/kernels/block.py:539"),
    "fused_ln_mlp_residual": ("csrc/mlp.cu", "rajni_tpu/kernels/mlp.py:131"),
    "fused_ln_qkv": ("csrc/ln_qkv.cu", "rajni_tpu/kernels/block.py:647"),
    "fused_gather_sdpa_proj_residual": ("csrc/gather_attn.cu", "rajni_tpu/kernels/block.py:985"),
    "fused_sdpa": ("csrc/sdpa.cu", "rajni_tpu/kernels/attention.py:71"),
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
        y = kb._layer_norm_f32(x.float(), blk["norm1"]["scale"], blk["norm1"]["bias"], 1e-6)
        qkv = (kb._mm(y.to(x.dtype), blk["attn"]["qkv"]["weight"])
               + blk["attn"]["qkv"]["bias"].float()).to(x.dtype)
        s = kb._importance_f32(qkv.float(), HEADS)
        edge = torch.sort(s[:, 1:], dim=1, descending=True).values[:, keep - 1 : keep]
        near = (s - edge).abs() <= TIE_RTOL * edge.abs()
        kept = [torch.zeros(B, n, dtype=torch.bool, device=device).scatter_(1, r[2], True)
                for r in (got, want)]
        moved = kept[0] != kept[1]
        check(not bool((moved & ~near).any()),
              f"K1 N={n}: {int((moved & ~near).sum())} tokens changed sides away from the keep boundary")
        same = ~moved.any(dim=1)
        flips = int((~same).sum())
        if flips:
            print(f"K1 N={n} with_scores=True: {flips} images with near-tie swaps at the boundary (allowed)")
        rels = (got[1][same] - want[1][same]).abs() / want[1][same].abs()
        srel = rels.max().item()
        print(f"K1 N={n} with_scores=True: next_scores rel err max {srel:.3e}, "
              f"median {rels.median().item():.3e}")
        check(srel <= SCORE_RTOL, f"K1 N={n}: next_scores rel err {srel} > {SCORE_RTOL}")
        x_kept = torch.take_along_dim(x, want[2][..., None], dim=1)[same]
        e2, r2 = compare(f"K1 N={n} with_scores=True", got[0][same], want[0][same], x_kept)

        ms = cuda_ms(lambda: kb.fused_pruned_attn_block(*rescored))
        plain_ms = cuda_ms(lambda: kb.pruned_attn_block_plain(*rescored), iters=5)
        flops = 2.0 * B * n * C * 3 * C + 2.0 * B * K * C * C + 4.0 * B * K * K * C
        nbytes = B * n * C * 2 + 4 * C * C * 2 + B * K * C * 2 + B * K * 4
        record(results, "fused_pruned_attn_block", PATH224, f"B={B} N={n} K={K} C={C}", ms,
               plain_ms, bound(flops, nbytes, peaks), max(err, e2), max(rel, r2))


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


# Per path: batch, image side, token counts under REFERENCE_SCHEDULE, and
# the launches of each kernel in one pruned and one identity forward.
PATHS = {
    PATH224: dict(
        batch=B, img=224, counts=[197, 197, 197, 197, 187, 177, 150, 127, 120, 120, 120, 120],
        launches={
            "pruned": {"fused_pruned_attn_block": 5, "fused_attn_block": 7,
                       "fused_ln_mlp_residual": 12, "fused_ln_qkv": 0,
                       "fused_gather_sdpa_proj_residual": 0, "fused_sdpa": 0},
            "identity": {"fused_pruned_attn_block": 0, "fused_attn_block": 12,
                         "fused_ln_mlp_residual": 12, "fused_ln_qkv": 0,
                         "fused_gather_sdpa_proj_residual": 0, "fused_sdpa": 0}}),
    # every block runs past ATTN_MAX_N tokens: B6's two-pass kernel is the
    # attention inside each K2 (7) and each B5 (5)
    PATH384: dict(
        batch=B384, img=384, counts=[577, 577, 577, 577, 548, 520, 442, 375, 356, 356, 356, 356],
        launches={
            "pruned": {"fused_pruned_attn_block": 0, "fused_attn_block": 7,
                       "fused_ln_mlp_residual": 12, "fused_ln_qkv": 5,
                       "fused_gather_sdpa_proj_residual": 5, "fused_sdpa": 12},
            "identity": {"fused_pruned_attn_block": 0, "fused_attn_block": 12,
                         "fused_ln_mlp_residual": 12, "fused_ln_qkv": 0,
                         "fused_gather_sdpa_proj_residual": 0, "fused_sdpa": 12}}),
}


def end_to_end(device, device_name, results, path):
    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT
    from rajni_tpu_torch.kernels import attention as ka
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.utils.flops import mfu
    from rajni_tpu_torch.utils.timing import measure_throughput

    counters = {"fused_pruned_attn_block": kb.PRUNED_KERNEL,
                "fused_attn_block": kb.ATTN_KERNEL,
                "fused_ln_mlp_residual": km.KERNEL,
                "fused_ln_qkv": kb.LN_QKV_KERNEL,
                "fused_gather_sdpa_proj_residual": kb.GATHER_KERNEL,
                "fused_sdpa": ka.SDPA_KERNEL}
    spec = PATHS[path]
    batch = spec["batch"]
    pruned = RAJNIViT(path, REFERENCE_SCHEDULE, kernels="cuda", seed=0, device=device)
    models = {
        ("pruned", "cuda"): pruned,
        ("identity", "cuda"): RAJNIViT(path, None, params=pruned.params, kernels="cuda", device=device),
        ("pruned", "torch"): RAJNIViT(path, REFERENCE_SCHEDULE, params=pruned.params, kernels="torch", device=device),
        ("identity", "torch"): RAJNIViT(path, None, params=pruned.params, kernels="torch", device=device),
    }
    counts = pruned.get_last_stats()["token_counts"]
    check(counts == spec["counts"], f"{path}: token counts {counts} != {spec['counts']}")
    print(f"{path}: token_counts {counts}")

    gen = torch.Generator().manual_seed(1)
    images = torch.randn(batch, spec["img"], spec["img"], 3, generator=gen).to(device)

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
        print(f"{path} {sched}: logits rel L2 (cuda vs torch on the card) {rel:.3e}")
        check(rel <= LOGITS_REL_L2, f"{path} {sched} logits rel L2 {rel} > {LOGITS_REL_L2}")

    for (sched, impl), model in models.items():
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
        for model, batch in ((PATH224, 64), (PATH384, 32)):
            cmd = [sys.executable, "-m", "rajni_tpu_torch.run", "--synthetic", "3",
                   "--batch_size", str(batch), "--model", model, "--schedule", str(sched)]
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            tail = [l for l in p.stdout.splitlines() if "RAJNI -" in l or "Token counts" in l]
            print(f"eval CLI {model} batch {batch}: " + " | ".join(tail))
            check(p.returncode == 0,
                  f"eval CLI exited {p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
            want = f"Token counts per block: {PATHS[model]['counts']}"
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
    from rajni_tpu_torch.utils.flops import device_peaks

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

    peaks = device_peaks(device_name)
    results: dict = {}
    for label, phase in (("kernel phases 224", lambda: kernel_phases(device, peaks, results)),
                         ("kernel phases 384", lambda: long_phases(device, peaks, results)),
                         ("end to end 224", lambda: end_to_end(device, device_name, results, PATH224)),
                         ("end to end 384", lambda: end_to_end(device, device_name, results, PATH384)),
                         ("eval CLI", eval_cli)):
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
