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
past 256 tokens); ViT-H/14 in bf16 at batch 128 through ``kernels="auto"``
(``VIT_H_PROBE``: K2, K3, B4 + selection + B5 and K1 at C = 1280 and head_dim
80), and with int8 weights, dynamic (P14i) and static (B10, B9, B12 +
selection + B13 at C = 1280, head_dim 80); and training: ViT-B/16 224 at batch 128 in bf16 through B16, B4, B5,
B17 and B18 (T6), and ViT-H/14 at batch 64 through VIT_H_PROBE on the same
kernels at C = 1280 and head_dim 80 (T14). Steps, each of which fails the
run (non-zero exit) when it goes wrong:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``rajni_tpu_torch/csrc`` into one library
   (one ``nvcc`` per source, in parallel, then one link), and require of
   the sources of the wgmma GEMM (``GEMM_SOURCES``: ``gemm.cu``, the bf16
   sources of K1-K3, B4 and B5, and the seven int8 sources) that ptxas
   reports no spill and no serialized wgmma, and of every head_dim-80
   instantiation (the short-row kernel, B6's body, B18's three kernels,
   the score kernel), the score kernel at head_dim 64 and C = 1280 (C5) and
   the C = 1280 LayerNorms (bf16, and to int8) that it was compiled with 0
   spill bytes;
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
   for; at ViT-H/14's shapes (B=128, C=1280, head_dim 80) the LayerNorm
   (B4 through an identity projection), K3 at 257 rows, K2 at 257 and 180
   tokens, B4 at 257, the score kernel at 257, 180, 126 and 88, B6's body
   at 257 beside the library's SDPA, the selection and B5 at 257→180 and K1
   at 180→126; at ViT-H/14's int8 shapes (B=128, dynamic and static) the
   int8 tails' attention with its row absmax at head_dim 80 (61 and 180
   tokens phased, 257 per-head), LN1 → int8 at C=1280 (0 int8 elements
   apart), B12 at 257 and 180, B13 at 257→180, 88→61 and 257→257, B10 at
   257, 180 and 61, B9 at 257 and 61 rows, B11 at 30→21, and B10's proj on
   the row-band GEMM beside ``gemm_s8q`` at its five shapes; B16 ``train_attn_block``, B17 ``train_ln_mlp`` and B18
   ``train_sdpa_bwd`` at T6's shapes (B18 also at 577 tokens) and at T14's
   (B=64, C=1280: B16 at 257 and 180 tokens, B17 at 257 and 61, B18 at 257,
   180, 126, 88 and 61, head_dim 80); B6 and B18
   at ragged lengths (batch 16); the GEMM of K1, K2, K3, B4 and B5 on its
   own (``kernels/gemm.py``) at each bf16 path's QKV, proj, fc1 and fc2 (C =
   384, 768, 1024; M = 256·197, 256·120), at K1's and B5's proj with the
   residual gathered through the kept indices, and at ragged M and N, timed
   beside ``F.linear`` (cuBLAS), which the port never calls; the int8
   GEMM of B9-B15 on its own (``kernels/gemm.py:gemm_s8``) at each int8
   path's qkv, proj (contiguous and gathered residual), fc1 and fc2
   (grouped and not; C = 384, 768, 1024; M of P3b, P4a and P5a) and at
   ragged M, N and K, bitwise equal to ``gemm_s8_plain`` but for the GELU,
   timed beside ``torch._int_mm``, which the port never calls; fc1 with its
   GELU quantized (``gelu_quant``) at every B9 and B15 shape, the entry
   points' route bitwise equal to the two-launch route, both timed, and the
   plain quantizer of the kernel's own h bitwise equal to both (C2); the int8
   attention tail of B10, B11 and B13-B15 (the attention taking each row's
   absmax, proj quantizing its input as it loads it) bitwise equal to its
   two-launch route at every path shape, dynamic and static, both timed,
   the attention each took read from the launch counts of B6's body and the
   short-row kernel (each kernel one range of n), the launches by device time at
   one shape of each, and the quantize-on-load proj
   (``gemm_s8q``) bitwise equal to ``quantize_rows`` + ``gemm_s8``; B17's fc1
   (``EPI_GELU_SAVE``) with its hidden bitwise PyTorch's ``gelu_fast`` of its
   own h, at T6's and ragged shapes, and B17 timed beside K3 and cuBLAS; the
   weight quantizer on the card against the CPU at ViT-B's and ViT-L's weights
   (C3: 0 scales and 0 int8 values apart); the short-row attention
   (``csrc/short_attn.cu``, every attention up to 256 tokens) at every path
   shape up to 256 tokens, gathered and contiguous, bf16 and fp32 out, its
   row absmax exact; the score
   kernel (B4's scores at 197 and 577 tokens) against ``_importance_f32`` of
   the same qkv, and its device time at ViT-B/16 224's five pruned blocks
   against its byte bound, and (C5) at C = 1280 with 20 heads of 64 (B =
   128, 197 and 257 tokens); K1's six launches, B7's nine and B14's eleven (nine
   static), each by device time; B6's wgmma body beside K2's attention at 197,
   187 and 120 tokens and, for the crossover, the short-row kernel beside B6's
   body, the byte bound and ``scaled_dot_product_attention`` (which the port
   never calls) at 47-197 tokens, C = 768 and 1024, contiguous and gathered; and
   B20 beside B4 + torch selection + B5 at the 384 path's five pruned
   blocks, measured for their routing. Show that the comparison rejects
   faults planted in the plain versions (the attention for K1-B8, B16 and
   B20, the quantization, the attention's rounding and the scores' source
   for the int8 kernels, B17's GELU of the unrounded h, B18's row term from
   the rounded P and its dV from the unrounded P, and at head_dim 80 its
   phased form and its 16-column parts left out; for B6 and B18, P rounded
   before it is normalized, where it separates; for the GEMM, the GELU of
   the rounded sum, a K-tile skipped, the residual added ungathered and its
   index shifted by one row, and for B17's fc1 the GELU of the unrounded
   sum; for the int8 GEMM, the last k-tile skipped, a group's flush scaled
   by its neighbour's row scale, the residual ungathered; for fc1's
   quantized GELU, the tile's absmax for the group's and the neighbouring
   column's sinv; for the int8 tail's proj, the absmax of one head's
   columns only and the scale of the neighbouring row; for the scores, the biased
   value norms; for the short-row attention, the gather ignored, keys past n
   unmasked, P rounded before it is normalized; for C3, the weight scale
   taken as absmax / 127.0), and time both with CUDA
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
5. train T6 and T14 through ``rajni_tpu_torch.train``: the first step's loss and
   every gradient through the kernels against the same path on the kernels'
   plain versions and against the torch-autograd route on the card (through
   the same selections; each kept set that either would choose otherwise
   must lie within what its score discrepancy explains, and the share of
   images that the torch route would select otherwise is bounded), the
   launches and selections of one step (every
   count set to 0 first), a falling loss over 20 steps (T14: 8) on one
   batch, and train img/s with ``train_mfu`` on both routes, pruned and
   identity; and (C5) C5's config (20 heads of 64 at C = 1280, depth 8, keep 0.9 at blocks
   3-5, batch 128) through K1-K3 against its plain route, its launches and
   token counts, and one training step of it through B16, B4 + selection +
   B5, B17 and B18, held as T6's first step is;
6. run the eval CLI in a subprocess: at 224 and at 384, and at 224 and 384
   with ``--quantize --calibrate 1``, and ViT-H/14 with ``--quantize`` and
   ``--quantize --calibrate 1``, each on the kernels; then the training CLI (ViT-B/16 bf16
   on the kernels, 4 steps) and the eval CLI on its checkpoint, the
   training CLI on ``vit_tiny_patch16_224`` in fp32, and ``RAJNIViT`` on
   ``vit_tiny_patch16_224`` in fp32 and bf16: the last three demoted to the
   plain route before any launch, each printing its ``route:`` line; and
   ViT-H/14 in training through the training CLI on the kernels; and
   ``rajni_tpu_torch.run.main`` on a folder of 1000 procedural JPEG images
   in 10 classes of ImageNet-val's sizes at ViT-B/16 224, batch 256 (the
   last batch 232), ``--compare_base``, once a preprocessing tier (host with
   the C++ library, host with PIL, device, device-full): ``route: cuda``,
   the tier's ``preprocess:`` line, the token counts and every launch
   through K1-K3, each tier's img/s, the host (PIL) and device tiers'
   logits equal; the device tier's normalized batch bitwise the host PIL
   tier's, device-full within a uint8 level a pass of host PIL on images
   that fit the canvas (larger ones reported), ``preprocess_on_device`` on
   the card against the CPU, the C++ tier against PIL; then a timm-layout
   ViT-B/16 224 ``.pth`` (``{"model": ...}``, ``module.`` keys) through the
   eval CLI's ``--checkpoint``, its patch embedding against ``F.conv2d``,
   and its logits through the kernels at 224 and (pos-embed resampled to
   577 tokens) at 384 against the plain route;
7. export, serve and attest (``rajni_tpu_torch.export``, ``.serving``,
   ``.attest``): ViT-B/16 224 bf16 artifacts (buckets 8, 32, 256 with
   ``REFERENCE_SCHEDULE`` and the identity schedule; dynamic; int8 with
   calibrated static scales baked, buckets 8, 32, 64) loaded on the card,
   each request's launches (K1 ×5, K2 ×7, K3 ×12 a bucket call; B14 ×5, B15
   ×7) and its real rows bitwise the eager forward on the same padded batch,
   against the images at their own batch (printed, gated at
   ``LOGITS_REL_L2``), a cpu artifact refused; ``run.main(["--artifact",
   ...])``; ``serving.make_server`` over the three-model registry with 64
   concurrent clients (raw crops and JPEG bodies), each answer against the
   eager forward of its image, coalesced batches, p50/p99, the endpoints and
   the registry's peak memory; the committed reference fixture and a bf16
   ViT-B self-fixture through the kernels at top-1 agreement 1.0, and the
   attestation CLI's non-zero exit above it; the extended timm variants: a
   DeiT-3-layout and an MAE-layout ``.pth`` through the eval CLI and K1-K3
   against the plain route, and registers, the distillation token and
   qk-norm on the torch route with their token counts;
8. print one JSON line of per-kernel results, then the ``{"ok": true, ...}``
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
# ViT-H/14 in bf16 (scripts/bench_suite.py:97 vit_h14_probe, batch 128): C =
# 1280, 16 heads of 80, hidden 5120, 257 tokens, 32 blocks; VIT_H_PROBE
# (scripts/bench_suite.py:46-49) keeps 0.7 at blocks 5, 10, 15 and 20
PATH_H = "vit_huge_patch14_224"
C_H, HEADS_H, HIDDEN_H = 1280, 16, 5120
B_H = 128
VIT_H_SCHEDULE = {i: {"keep_ratio": 0.7} for i in (5, 10, 15, 20)}
VIT_H_TRAIN_K = (257, 180, 126, 88, 61)  # B18's lengths on T14: 257 stock, then each kept count
KERNEL_ONLY = "kernel phase only"  # B19 and B20: no path runs them
TRAIN = f"train {PATH224}"  # the training path: ViT-B/16 224, batch 128
B_TRAIN = 128
# T14, ViT-H/14 training (C = 1280, head_dim 80) through VIT_H_PROBE, batch 64
TRAIN_H = f"train {PATH_H}"
B_TRAIN_H = 64
# C5: 20 heads of 64 at C = 1280 (ViT-B/16 224's tokens, hidden 5120), depth
# cut to 8, keep 0.9 at blocks 3-5: the score kernel's fifth 16-byte piece a
# lane, through K1-K3 in inference and B16, B4 + selection + B5, B17, B18 in
# one training step
C5_MODEL = dict(embed_dim=1280, num_heads=20, depth=8)
C5_SCHEDULE = {i: {"keep_ratio": 0.9} for i in (3, 4, 5)}
C5 = "C=1280 head_dim 64"
B_C5 = 128
TRAIN_C5 = f"train {C5}"
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
# T14 (32 blocks, the pruned blocks 5 to 20 deep) against the plain versions
# on an H100 SXM: the losses differed by 6.77e-4 and a selection's score
# discrepancy grew with depth, 6.5e-3 (block 5), 1.05e-2, 1.38e-2, 1.94e-2
# (block 20), over T6's limits; limits 2.5x those readings. Its gradients
# (1.87e-2 against the plain versions, 1.94e-2 against torch autograd), its
# loss against torch autograd (2.3e-4) and its share of images selecting
# otherwise (30 of 64) read within T6's limits, which hold them.
TRAIN_H_PLAIN_LOSS_ATOL = 1.7e-3
TRAIN_H_SCORE_REL = 4.9e-2
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


def kernel_records(fn, iters: int, warmup: int) -> dict[str, list[float]]:
    """Each device kernel's recorded durations (us) over ``iters`` calls of
    ``fn`` under ``torch.profiler``, after ``warmup`` calls."""
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
    return kernels


def launch_ms(fn, iters: int = 10, warmup: int = 3) -> dict:
    """Device time per call of each kernel that ``fn`` launches, by name:
    its mean recorded duration times its launches a call (its records over
    ``iters``, rounded up), so a record that the profiler drops does not
    lower the reading."""
    kernels = kernel_records(fn, iters, warmup)
    return {name: statistics.fmean(t) * -(-len(t) // iters) / 1e3 for name, t in kernels.items()}


def device_ms(fn, iters: int = 20, warmup: int = 5) -> tuple[float, str]:
    """Device time per call of ``fn``: its kernels' time (:func:`launch_ms`,
    summed), without the host's gaps between them (for a library call whose
    host side takes longer than its kernels); returns the time and the
    records kept of those expected."""
    kernels = kernel_records(fn, iters, warmup)
    per_call = {name: -(-len(t) // iters) for name, t in kernels.items()}
    us = sum(statistics.fmean(t) * per_call[name] for name, t in kernels.items())
    kept = sum(len(t) for t in kernels.values())
    return us / 1e3, f"{kept} of {iters * sum(per_call.values())} records"


def kernel_name(name: str) -> str:
    """A device kernel's name without its namespace and argument list."""
    return re.sub(r"^void |\(.*$|rajni::\(anonymous namespace\)::", "", name)


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
    # no TPU kernel of its own: the _mha (phased) inside the Pallas kernels
    # whose attention up to 256 tokens it runs (K1, K2, B5, B7, B8, B10, B11,
    # B13-B16)
    "short_attention": ("csrc/short_attn.cu", "rajni_tpu/kernels/block.py:130"),
    # no TPU kernel of its own: the selection JAX runs outside Pallas on the
    # two-kernel route (rajni_tpu/models/vit.py:867-928)
    "select_kept": ("csrc/select.cu", "rajni_tpu/ops/pruning.py:86"),
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
        parts = launch_ms(lambda: kb.fused_pruned_attn_block(*rescored))
        print(f"{tag} K={K}: its launches, device ms a call (sum {sum(parts.values()):.3f}): "
              + "; ".join(f"{kernel_name(k)} {v:.3f}" for k, v in parts.items()))
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


def ln_faulty(x, norm, eps=1e-6, cols=1024):
    """The LayerNorm with its statistics over the first ``cols`` columns only
    (what a row of 4 vectors a lane would take at C = 1280): a planted fault."""
    import torch

    x32 = x.float()
    part = x32[..., :cols]
    mean = part.mean(dim=-1, keepdim=True)
    var = (part - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * norm["scale"].float() + norm["bias"].float()).to(x.dtype)


def vit_h_phases(device, peaks, results):
    """ViT-H/14's kernels at its path's shapes (B=128, C=1280, head_dim 80):
    the bf16 LayerNorm at C=1280 (B4 through an identity projection, so that
    its qkv is the rounded LN output three times), K3 at 257 rows, K2 at 257
    and 180 tokens, B4 at 257 (its scores too), the score kernel at 257,
    180, 126 and 88 tokens against ``_importance_f32`` of its own qkv, B6's
    body at 257 beside the library's SDPA, the selection at 257→180, B5 at
    257→180 and K1 at 180→126, each held to its plain version under the
    bf16 gates with the planted faults rejected, timed beside its bound."""
    import torch
    import torch.nn.functional as Fnn

    from rajni_tpu_torch.kernels import attention as ka
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.ops.pruning import select_tokens_dense

    Bh, Cw, Hh, hid = B_H, C_H, HEADS_H, HIDDEN_H
    gen = torch.Generator().manual_seed(23)
    blk = make_block(gen, device, Cw, hid)
    scale = (Cw // Hh) ** -0.5

    def x_of(n):
        return (X_STD * torch.randn(Bh, n, Cw, generator=gen)).to(device, torch.bfloat16)

    def qkv_of(x):
        return kb.ln_qkv_plain(x, blk["norm1"], blk["attn"]["qkv"], Hh, 1e-6, False)[0]

    # the LayerNorm at C=1280 (LN_MAXV_WIDE): B4's qkv through [I; I; I]
    x = x_of(257)
    eye = torch.eye(Cw, dtype=torch.bfloat16, device=device)
    ident = {"weight": torch.cat([eye, eye, eye]),
             "bias": torch.zeros(3 * Cw, dtype=torch.bfloat16, device=device)}
    got = kb.fused_ln_qkv(x, blk["norm1"], ident, Hh, 1e-6, False)[0]
    y = kb._layer_norm_f32(x.float(), blk["norm1"]["scale"], blk["norm1"]["bias"], 1e-6)
    want = y.to(torch.bfloat16).repeat(1, 1, 3)
    zero = torch.zeros_like(want)
    compare(f"LayerNorm C={Cw} (B4, identity projection)", got, want, zero)
    bad = ln_faulty(x, blk["norm1"]).repeat(1, 1, 3)
    rel = branch_rel(got, bad, zero)
    print(f"LayerNorm C={Cw}: planted fault 'statistics of the first 1024 columns': "
          f"branch rel L2 {rel:.3e}")
    check(rel > BRANCH_REL_L2, "LayerNorm C=1280: the gate missed the planted fault")

    args = (x, blk["norm2"], blk["mlp"], None, 1e-6)  # K3
    err, rel = compare(f"K3 N=257 C={Cw}", km.fused_ln_mlp_residual(*args),
                       km.ln_mlp_residual_plain(*args), x)
    ms = cuda_ms(lambda: km.fused_ln_mlp_residual(*args))
    plain_ms = cuda_ms(lambda: km.ln_mlp_residual_plain(*args), iters=5)
    M = Bh * 257
    bnd = bound(4.0 * M * Cw * hid, 2 * M * Cw * 2 + 2 * Cw * hid * 2, peaks)
    record(results, "fused_ln_mlp_residual", PATH_H, f"B={Bh} N=257 C={Cw}", ms, plain_ms,
           bnd, err, rel)

    for n in (257, 180):  # K2: B6's body at 257, the short-row kernel at 180
        x = x_of(n)
        args = (x, blk["norm1"], blk["attn"], None, Hh, scale, 1e-6)
        got = kb.fused_attn_block(*args)
        err, rel = compare(f"K2 N={n} C={Cw}", got, kb.attn_block_plain(*args), x)
        reject_planted(f"K2 N={n} C={Cw}", got, lambda: kb.attn_block_plain(*args), x)
        ms = cuda_ms(lambda: kb.fused_attn_block(*args))
        plain_ms = cuda_ms(lambda: kb.attn_block_plain(*args), iters=5)
        M = Bh * n
        bnd = bound(2.0 * M * Cw * 4 * Cw + 4.0 * Bh * n * n * Cw,
                    2 * M * Cw * 2 + 4 * Cw * Cw * 2, peaks)
        record(results, "fused_attn_block", PATH_H, f"B={Bh} N={n} C={Cw}", ms, plain_ms, bnd,
               err, rel)

    x = x_of(257)  # B4, at the first pruned block
    for with_scores in (False, True):
        args = (x, blk["norm1"], blk["attn"]["qkv"], Hh, 1e-6, with_scores)
        gq, gs = kb.fused_ln_qkv(*args)
        wq, ws = kb.ln_qkv_plain(*args)
        err, rel = compare(f"B4 N=257 C={Cw} with_scores={with_scores}", gq, wq,
                           torch.zeros_like(wq))
        if with_scores:
            srel = ((gs - ws).abs() / ws.abs()).max().item()
            print(f"B4 N=257 C={Cw}: scores rel err max {srel:.3e} (against the plain "
                  "version's own qkv)")
            check(srel <= SCORE_RTOL, f"B4 N=257 C={Cw}: scores rel err {srel} > {SCORE_RTOL}")
    ms = cuda_ms(lambda: kb.fused_ln_qkv(*args))
    plain_ms = cuda_ms(lambda: kb.ln_qkv_plain(*args), iters=5)
    M = Bh * 257
    bnd = bound(2.0 * M * Cw * 3 * Cw, M * Cw * 2 + 3 * Cw * Cw * 2 + M * 3 * Cw * 2 + M * 4,
                peaks)
    record(results, "fused_ln_qkv", PATH_H, f"B={Bh} N=257 C={Cw}", ms, plain_ms, bnd, err, rel)

    for n in (257, 180, 126, 88):  # the score kernel (head_dim 80: two lanes a head)
        x = x_of(n)
        qkv, got = kb.fused_ln_qkv(x, blk["norm1"], blk["attn"]["qkv"], Hh, 1e-6, True)
        check(bool(torch.isfinite(got).all()) and bool((got > 0).all()),
              f"scores N={n} C={Cw}: not finite and positive")
        want = kb._importance_f32(qkv.float(), Hh)
        rel = ((got - want).abs() / want.abs()).max().item()
        bad = ((got - importance_biased_std(qkv.float(), Hh)).abs() / want.abs()).max().item()
        times = launch_ms(lambda: kb.fused_ln_qkv(x, blk["norm1"], blk["attn"]["qkv"], Hh, 1e-6,
                                                  True))
        ms = sum(v for k, v in times.items() if "score_kernel" in k)
        bnd = bound(0.0, (Bh * n * 2 * Cw + Bh * Cw) * 2 + Bh * n * 4, peaks)
        print(f"scores B={Bh} N={n} C={Cw}: rel err max {rel:.3e} against _importance_f32 of "
              f"the same qkv; planted fault 'biased std' {bad:.3e} | score kernel {ms:.4f} ms "
              f"of device time | bound {bnd[0]:.4f} ms ({bnd[1]}) | {ms / bnd[0]:.2f}x")
        check(rel <= SCORE_SUM_RTOL, f"scores N={n} C={Cw}: rel err {rel} > {SCORE_SUM_RTOL}")
        check(bad > SCORE_SUM_RTOL, f"scores N={n} C={Cw}: the gate missed 'biased std'")

    qkv = qkv_of(x_of(257))  # B6's body at 257: T = 5, one pass (T0 = 3)
    got = ka.fused_sdpa(qkv, Hh, scale)
    want = ka.fused_sdpa_plain(qkv, Hh, scale)
    zero = torch.zeros_like(got)
    err, rel = compare(f"B6 N=257 C={Cw}", got, want, zero)
    reject_planted(f"B6 N=257 C={Cw}", got, lambda: ka.fused_sdpa_plain(qkv, Hh, scale), zero)
    rounding_point(f"B6 N=257 C={Cw}", {"out": got}, {"out": want},
                   {"out": b6_unnormalized(qkv, Hh, scale)}, {"out": B6_REL_L2})
    ms = cuda_ms(lambda: ka.fused_sdpa(qkv, Hh, scale))
    dev = device_ms(lambda: ka.fused_sdpa(qkv, Hh, scale))
    plain_ms = cuda_ms(lambda: ka.fused_sdpa_plain(qkv, Hh, scale), iters=5)
    q, k, v = qkv.view(Bh, 257, 3, Hh, Cw // Hh).permute(2, 0, 3, 1, 4).contiguous()
    lib = device_ms(lambda: Fnn.scaled_dot_product_attention(q, k, v, scale=scale))
    bnd = bound(4.0 * Bh * 257 * 257 * Cw, Bh * 257 * 3 * Cw * 2 + Bh * 257 * Cw * 2, peaks)
    record(results, "fused_sdpa", PATH_H, f"B={Bh} N=257 C={Cw}", ms, plain_ms, bnd, err, rel,
           lib, dev)
    phased_body_phases(device, gen)

    x = x_of(257)  # the selection and B5 at 257→180: one qkv and one selection for both
    qkv = qkv_of(x)
    s = kb._importance_f32(qkv.float(), Hh)
    got, want = kb.select_kept(s, 179), kb.select_kept_plain(s, 179)
    exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ms, plain_ms = cuda_ms(lambda: kb.select_kept(s, 179)), cuda_ms(
        lambda: kb.select_kept_plain(s, 179))
    print(f"select_kept B={Bh} N=257 K=180: {'exact' if exact else 'DIFFER'} | kernel "
          f"{ms:.4f} ms | plain (torch) {plain_ms:.4f} ms")
    check(exact, "select_kept N=257: differs from select_tokens_dense")
    t_bytes = (Bh * 257 * 4 + Bh * 180 * (8 + 4)) / (peaks[1] * 1e12) * 1e3
    record(results, "select_kept", PATH_H, f"B={Bh} N=257 K=180", ms, plain_ms,
           (t_bytes, "bytes"), 0.0, 0.0)
    keep_idx = want[0]
    args = (qkv, keep_idx, x, blk["attn"]["proj"], None, Hh, scale)
    got = kb.fused_gather_sdpa_proj_residual(*args)
    x_kept = torch.take_along_dim(x, keep_idx[..., None], dim=1)
    err, rel = compare(f"B5 N=257 K=180 C={Cw}", got, kb.gather_sdpa_proj_residual_plain(*args),
                       x_kept)
    reject_planted(f"B5 N=257 K=180 C={Cw}", got,
                   lambda: kb.gather_sdpa_proj_residual_plain(*args), x_kept)
    ms = cuda_ms(lambda: kb.fused_gather_sdpa_proj_residual(*args))
    plain_ms = cuda_ms(lambda: kb.gather_sdpa_proj_residual_plain(*args), iters=5)
    K = 180
    flops = 4.0 * Bh * K * K * Cw + 2.0 * Bh * K * Cw * Cw
    nbytes = Bh * K * 3 * Cw * 2 + Bh * K * Cw * 2 + Bh * K * 8 + Cw * Cw * 2 + Bh * K * Cw * 2
    record(results, "fused_gather_sdpa_proj_residual", PATH_H, f"B={Bh} N=257 K=180 C={Cw}",
           ms, plain_ms, bound(flops, nbytes, peaks), err, rel)

    n, keep = 180, 125  # K1 at 180→126
    K = keep + 1
    x = x_of(n)
    tag = f"K1 N={n} C={Cw}"
    common = (x, blk["norm1"], blk["attn"], None)
    threaded = (*common, torch.rand(Bh, n, generator=gen).to(device), Hh, keep, scale, 1e-6,
                False)
    got = kb.fused_pruned_attn_block(*threaded)
    want = kb.pruned_attn_block_plain(*threaded)
    check(torch.equal(got[2], want[2]), f"{tag} with_scores=False: kept sets differ")
    check(torch.equal(got[1], want[1]), f"{tag} with_scores=False: next_scores differ")
    x_kept = torch.take_along_dim(x, want[2][..., None], dim=1)
    err, rel = compare(f"{tag} with_scores=False", got[0], want[0], x_kept)
    reject_planted(tag, got[0], lambda: kb.pruned_attn_block_plain(*threaded)[0], x_kept)
    rescored = (*common, None, Hh, keep, scale, 1e-6, True)
    got = kb.fused_pruned_attn_block(*rescored)
    want = kb.pruned_attn_block_plain(*rescored)
    e2, r2 = check_rescored(tag, got, want, bf16_scores(x, blk, Hh), keep, x)
    ms = cuda_ms(lambda: kb.fused_pruned_attn_block(*rescored))
    plain_ms = cuda_ms(lambda: kb.pruned_attn_block_plain(*rescored), iters=5)
    parts = launch_ms(lambda: kb.fused_pruned_attn_block(*rescored))
    print(f"{tag} K={K}: its launches, device ms a call (sum {sum(parts.values()):.3f}): "
          + "; ".join(f"{kernel_name(k)} {v:.3f}" for k, v in parts.items()))
    flops = 2.0 * Bh * n * Cw * 3 * Cw + 2.0 * Bh * K * Cw * Cw + 4.0 * Bh * K * K * Cw
    nbytes = Bh * n * Cw * 2 + 4 * Cw * Cw * 2 + Bh * K * Cw * 2 + Bh * K * 4
    record(results, "fused_pruned_attn_block", PATH_H, f"B={Bh} N={n} K={K} C={Cw}", ms,
           plain_ms, bound(flops, nbytes, peaks), max(err, e2), max(rel, r2))


# ViT-H/14 with int8 weights (scripts/bench_suite.py INT8_ROWS
# vit_h14_probe_int8 and vit_h14_probe_int8_static: batch 128, VIT_H_PROBE),
# dynamic (P14i) and calibrated static scales
P14I, P14S = f"{PATH_H} int8", f"{PATH_H} int8 static"
# the proj B10 and B11 take at C = 1280 (csrc/int8_block.cuh:TAIL_BAND_MAX_C,
# whose comment has the measurement): "band" or "gemm_s8q"
VIT_H_PROJ = "gemm_s8q"
# B10's attention rows at ViT-H's token counts: the band proj and gemm_s8q
# timed side by side at M = 128·n, N = K = 1280
VIT_H_PROJ_N = (257, 180, 126, 88, 61)


def vit_h_int8_phases(device, peaks, int8_peak, results):
    """The int8 kernels at ViT-H/14's shapes (B=128, C=1280, 16 heads of 80,
    hidden 5120, hc 1280), dynamic (P14i) and static: the int8 tails'
    attention with the row absmax at head_dim 80 (the short-row kernel at 61
    and 180 tokens, phased; B6's body at 257, per-head; bf16 and fp32 out,
    contiguous and gathered) against its plain version, its absmax equal to
    that of its own output; LN1 → int8 (ln_quant_kernel's 5 vectors a lane)
    with 0 int8 elements and 0 row scales apart from its plain version; B12
    at 257 and 180, B13 at 257→180, 88→61 and 257→257 (more than 256 kept:
    B6's body with an fp32 output), B10 at 257, 180 and 61 with its proj on
    VIT_H_PROJ, B9 at 257 and 61 rows an image, B11 at 30→21, each under the
    split-int8 gate with its planted faults rejected, timed beside its plain
    version and bound; and B10's proj on the band and on gemm_s8q, bit for
    bit, both timed, at VIT_H_PROJ_N."""
    import torch

    from rajni_tpu_torch.kernels import attention as ka
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import gemm as kg
    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.kernels.math import quantize_rows, quantize_static
    from rajni_tpu_torch.ops.pruning import select_tokens_dense

    Bh, Cw, Hh, hid = B_H, C_H, HEADS_H, HIDDEN_H
    gen = torch.Generator().manual_seed(24)
    blk = make_block(gen, device, Cw, hid)
    qblk = quantized_block(blk)
    scale = (Cw // Hh) ** -0.5
    hc = km._hidden_chunk(Cw, hid, 1)
    check(hc == Cw, f"ViT-H int8: hc {hc}, not {Cw}")
    a_bytes = 4 * Cw * Cw + 9 * Cw * 4  # int8 qkv + proj weights, fp32 vectors

    def x_of(n):
        return (X_STD * torch.randn(Bh, n, Cw, generator=gen)).to(device, torch.bfloat16)

    def gate(tag, got, plain, x, faults):
        err, rel = compare(tag, got, plain(), x, SPLIT_INT8_GATE)
        reject_planted(tag, got, plain, x, faults=faults, plant=planted_int8,
                       limit=SPLIT_INT8_GATE[2])
        return err, rel

    def timed(name, path, shape, kernel, plain, bnd, err, rel):
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        record(results, name, path, shape, ms, plain_ms, bnd, err, rel, device=device_ms(kernel))

    # the int8 tails' attention with the row absmax at head_dim 80
    qkv = torch.randn(Bh, 257, 3 * Cw, generator=gen).to(device, torch.bfloat16)
    perm = torch.stack([torch.cat([torch.zeros(1, dtype=torch.long),
                                   1 + torch.randperm(256, generator=gen)]) for _ in range(Bh)])
    perm = perm.to(device, torch.int32)
    for n, attend in ((61, ka.short_attention), (180, ka.short_attention),
                      (257, ka.body_attention)):
        form = "phased" if ka.mha_phased(Hh, n, scale) else "per-head"
        for idx in (None, perm if n == 257 else kept_indices(gen, Bh, 257, n, device)):
            src = qkv if idx is not None or n == 257 else qkv[:, :n].contiguous()
            for out_dtype in (torch.bfloat16, torch.float32):
                tag = (f"int8 tail attention B={Bh} C={Cw} N={n} {form} "
                       f"{'gathered' if idx is not None else 'contiguous'} {str(out_dtype)[6:]}")
                got, am = attend(src, idx, Hh, scale, out_dtype, True)
                want = ka.attention_route_plain(src, idx, Hh, scale, out_dtype)
                compare(tag, got, want, torch.zeros_like(got))
                rel = rel_l2(got, want)
                check(rel <= B6_REL_L2, f"{tag}: rel L2 {rel} > {B6_REL_L2}")
                rows = got.float().abs().reshape(Bh * n, Hh, Cw // Hh)
                diff = differ(am, rows.amax(dim=(1, 2)))
                short = differ(am, rows[..., :64].amax(dim=(1, 2)))
                print(f"{tag}: row absmax {diff} of {am.numel()} apart from its output's; planted "
                      f"fault 'the 16-column parts left out' {short} apart")
                check(diff == 0, f"{tag}: the row absmax differs from its output's ({diff})")
                check(short > 0, f"{tag}: the gate missed 'the 16-column parts left out'")
                if out_dtype == torch.float32:  # B13's static tail: fp32 out, no absmax
                    got = attend(src, idx, Hh, scale, out_dtype, False)[0]
                    check(torch.equal(got, attend(src, idx, Hh, scale, out_dtype, True)[0]),
                          f"{tag}: the output without the absmax differs from the one with it")

    for static in (False, True):
        path, mode = (P14S, "static") if static else (P14I, "dynamic")

        x = x_of(257)  # LN1 → int8 at C = 1280, B12's first launch
        sc = block_act_scales(blk, x, Hh)[:2] if static else None
        ab = attached(qblk, sc)
        _, _, qs, q8 = kb.launch_ln_qkv_int8(x, ab["norm1"], ab["attn"]["qkv"], Hh, 1e-6, False,
                                             sc, False)
        ops = kb.int8_attn_operands(qblk["norm1"], qblk["attn"], sc)

        def ln_int8(ln):
            y = ln(x.float(), ops["ln1s"], ops["ln1b"], 1e-6).reshape(-1, Cw)
            return (quantize_static(y), None) if static else quantize_rows(y)

        q, a = ln_int8(km._layer_norm_int8)
        dq, ds = differ(q8.view(-1, Cw), q), 0 if static else differ(qs, a.reshape(-1))
        # a reading: how many int8 steps PyTorch's summation order flips
        order = differ(q8.view(-1, Cw), ln_int8(km._layer_norm_f32)[0])
        fault = differ(q8.view(-1, Cw), ln_int8(
            lambda x32, s_, b_, eps: ln_faulty(x32, {"scale": s_, "bias": b_}, eps))[0])
        tag = f"LN1 → int8 B={Bh} N=257 C={Cw} {mode}"
        print(f"{tag}: {dq} int8 elements and {ds} row scales apart from the plain version; "
              f"{order} apart from the LN summed in PyTorch's order; planted fault 'statistics "
              f"of the first 1024 columns' {fault} apart")
        check(dq == 0 and ds == 0, f"{tag}: the kernel differs from its plain version")
        check(fault > 0, f"{tag}: the gate missed 'statistics of the first 1024 columns'")

        for n in (257, 180):  # B12, scoring as on the path
            x = x_of(n)
            sc = block_act_scales(blk, x, Hh)[:2] if static else None
            args = (x, qblk["norm1"], qblk["attn"]["qkv"], Hh, 1e-6, True, sc)
            ab = attached(qblk, sc)
            kargs = (x, ab["norm1"], ab["attn"]["qkv"], *args[3:])
            tag = f"B12 N={n} C={Cw} {mode}"
            gq, gs = kb.fused_ln_qkv_int8(*kargs)
            col = torch.ones(3 * Cw, device=device)  # V in its own units (static: 1/a_proj)
            if static:
                col[2 * Cw:] = sc[1]
            err, rel = gate(tag, gq.float() * col,
                            lambda: kb.ln_qkv_int8_plain(*args)[0].float() * col,
                            torch.zeros_like(gq), ("no V-fold" if static else "row scales shifted",))
            own = kb._importance_f32(gq.float(), Hh)
            srel = ((gs - own).abs() / own.abs()).max().item()
            print(f"{tag}: scores rel err max {srel:.3e} against its own qkv's")
            check(srel <= SCORE_RTOL, f"{tag}: scores rel err {srel} > {SCORE_RTOL}")
            M = Bh * n
            bnd = bound(0.0, M * Cw * 2 + 3 * Cw * Cw + 6 * Cw * 4 + M * 3 * Cw * 2 + M * 4, peaks,
                        6.0 * M * Cw * Cw, int8_peak)
            timed("fused_ln_qkv_int8", path, f"B={Bh} N={n} C={Cw} scores=True",
                  lambda: kb.fused_ln_qkv_int8(*kargs), lambda: kb.ln_qkv_int8_plain(*args), bnd,
                  err, rel)

        for n, K in ((257, 180), (88, 61), (257, 257)):  # B13 on B12's (folded) qkv
            x = x_of(n)
            sc = block_act_scales(blk, x, Hh)[:2] if static else None
            qkv = kb.ln_qkv_int8_plain(x, qblk["norm1"], qblk["attn"]["qkv"], Hh, 1e-6, False,
                                       sc)[0]
            keep_idx, _ = select_tokens_dense(torch.rand(Bh, n, generator=gen).to(device), K - 1,
                                              torch.bool)
            args = (qkv, keep_idx, x, qblk["attn"]["proj"], None, Hh, scale,
                    None if sc is None else sc[1])
            kargs = (*args[:3], attached(qblk, sc)["attn"]["proj"], *args[4:])
            tag = f"B13 N={n} K={K} C={Cw} {mode}"
            x_kept = torch.take_along_dim(x, keep_idx[..., None], dim=1)
            got = kb.fused_gather_sdpa_proj_residual_int8(*kargs)
            err, rel = gate(tag, got, lambda: kb.gather_sdpa_proj_residual_int8_plain(*args),
                            x_kept, ("sproj without a_proj" if static else "row scales shifted",))
            if K > ka.ATTN_MAX_N:  # a keep ratio near 1: held, not on the probe path
                continue
            bnd = bound(4.0 * Bh * K * K * Cw,
                        Bh * K * (3 * Cw * 2 + Cw * 2 + 8 + Cw * 2) + Cw * Cw + 2 * Cw * 4, peaks,
                        2.0 * Bh * K * Cw * Cw, int8_peak)
            timed("fused_gather_sdpa_proj_residual_int8", path, f"B={Bh} N={n} K={K} C={Cw}",
                  lambda: kb.fused_gather_sdpa_proj_residual_int8(*kargs),
                  lambda: kb.gather_sdpa_proj_residual_int8_plain(*args), bnd, err, rel)

        for n in (257, 180, 61):  # B10
            x = x_of(n)
            sc = block_act_scales(blk, x, Hh)[:2] if static else None
            args = (x, qblk["norm1"], qblk["attn"], None, Hh, scale, 1e-6, sc)
            ab = attached(qblk, sc)
            kargs = (x, ab["norm1"], ab["attn"], *args[3:])
            tag = f"B10 N={n} C={Cw} {mode}"
            got = kb.fused_attn_block_int8(*kargs)
            err, rel = gate(tag, got, lambda: kb.attn_block_int8_plain(*args), x,
                            ("bqkv without V-fold" if static else "row scales shifted",
                             "attention output fp32"))
            pt, took = proj_ms(lambda: kb.fused_attn_block_int8(*kargs))
            print(f"{tag}: proj on {took}, {pt:.4f} ms (device time)")
            check(took == VIT_H_PROJ, f"{tag}: the proj ran on {took!r}, not on {VIT_H_PROJ!r}")
            M = Bh * n
            bnd = bound(4.0 * Bh * n * n * Cw, 2 * M * Cw * 2 + a_bytes, peaks, 8.0 * M * Cw * Cw,
                        int8_peak)
            timed("fused_attn_block_int8", path, f"B={Bh} N={n} C={Cw}",
                  lambda: kb.fused_attn_block_int8(*kargs),
                  lambda: kb.attn_block_int8_plain(*args), bnd, err, rel)

        for n in (257, 61):  # B9
            x = x_of(n)
            mas = mlp_act_scales(blk, x) if static else None
            args = (x, qblk["norm2"], qblk["mlp"], None, 1e-6, True, mas)
            tag = f"B9 rows={Bh}x{n} hc={hc} C={Cw} {mode}"
            got = km.fused_ln_mlp_residual_int8(*args)
            faults = ("h without 1/a_fc2",) if static else ("row scales shifted",
                                                             "h over whole rows")
            err, rel = gate(tag, got, lambda: km.ln_mlp_residual_int8_plain(*args), x, faults)
            M = Bh * n
            bnd = bound(0.0, 2 * M * Cw * 2 + 2 * Cw * hid + (5 * Cw + 2 * hid) * 4, peaks,
                        4.0 * M * Cw * hid, int8_peak)
            timed("fused_ln_mlp_residual_int8", path, f"B={Bh} N={n} C={Cw} hc={hc}",
                  lambda: km.fused_ln_mlp_residual_int8(*args),
                  lambda: km.ln_mlp_residual_int8_plain(*args), bnd, err, rel)

        n, keep = 30, 20  # B11: JAX's one-kernel route, taken at ViT-H's width by n <= ~30
        K = keep + 1
        x = x_of(n)
        sc = block_act_scales(blk, x, Hh)[:2] if static else None
        tag = f"B11 N={n} K={K} C={Cw} {mode}"
        faults = ("attention output fp32",) + (("no V-fold",) if static else ())
        err, rel, kern, plain = check_b11(tag, x, qblk, Hh, keep, scale, sc, gen, faults)
        bnd = bound(4.0 * Bh * K * K * Cw,
                    Bh * n * Cw * 2 + a_bytes + Bh * K * (Cw * 2 + 8), peaks,
                    2.0 * Bh * (n * 3 * Cw * Cw + K * Cw * Cw), int8_peak)
        timed("fused_pruned_attn_block_int8", path, f"B={Bh} N={n} K={K} C={Cw}", kern, plain,
              bnd, err, rel)

    # B10's proj: the band's proj form and gemm_s8q, bit for bit, side by side
    proj = qblk["attn"]["proj"]
    w, ws, bias = proj["weight"]["int8"], proj["weight"]["scale"].float(), proj["bias"].float()
    for n in VIT_H_PROJ_N:
        x = x_of(n)
        o = kb._mha(kb.ln_qkv_plain(x, blk["norm1"], blk["attn"]["qkv"], Hh, 1e-6, False)[0],
                    Hh, scale, torch.bfloat16).reshape(-1, Cw).contiguous()
        res = x.reshape(-1, Cw)
        for amax in (kg.row_absmax_plain(o), None):
            band = kg.band_proj(o, amax, w, ws, bias, None, res)
            s8q = kg.gemm_s8q(o, amax, w, ws, bias, None, res)
            t_band = device_ms(lambda: kg.band_proj(o, amax, w, ws, bias, None, res))[0]
            t_s8q = device_ms(lambda: kg.gemm_s8q(o, amax, w, ws, bias, None, res))[0]
            tag = (f"B10 proj B={Bh} N={n} C={Cw} {'static' if amax is None else 'dynamic'}")
            print(f"{tag}: band {t_band:.4f} ms | gemm_s8q {t_s8q:.4f} ms (device time) | "
                  f"band/gemm_s8q {t_band / t_s8q:.3f} | {differ(band, s8q)} elements differ")
            check(torch.equal(band, s8q), f"{tag}: the band proj differs from gemm_s8q")


# ptxas's report of the head_dim-80 instantiations (csrc/short_attn.cu,
# csrc/sdpa.cu, csrc/sdpa_bwd.cu, common.cuh:score_kernel<80, ...>), of the C = 1280
# LayerNorm (common.cuh:layer_norm_kernel<5>) and of the head_dim-64 score kernel at
# C = 1280 (score_kernel<64, 5, ...>), by mangled name
HEAD_DIM80_KERNELS = {"short-row attention": "short_attn_kernelILi80E",
                      "B6's body": "sdpa_wgmma_kernelILi80E",
                      "B18 one launch": "sdpa_bwd_fused_kernelILi80E",
                      "B18 query launch": "sdpa_bwd_query_kernelILi80E",
                      "B18 key launch": "sdpa_bwd_key_kernelILi80E",
                      "score kernel": "score_kernelILi80E",
                      # C5: head_dim 64 at C = 1280, five 16-byte pieces a lane
                      "score kernel head_dim 64 C=1280": "score_kernelILi64ELi5E",
                      "LayerNorm C=1280": "layer_norm_kernelILi5E",
                      "LayerNorm → int8 C=1280": "ln_quant_kernelILi5E"}


def head_dim80_spills(reports: dict) -> None:
    """Every head_dim-80 instantiation (and the C=1280 LayerNorm) was
    compiled, with 0 bytes of spill stores and loads and no serialized
    wgmma; prints each one's registers and spills."""
    found = {k: 0 for k in HEAD_DIM80_KERNELS}
    for src, rep in reports.items():
        fn = None
        for line in rep.splitlines():
            if ("C7520" in line or "C7515" in line) and any(t in line for t in
                                                            HEAD_DIM80_KERNELS.values()):
                raise SmokeFailure(f"{src}: ptxas serialized wgmma: {line.strip()}")
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
                continue
            kind = next((k for k, tag in HEAD_DIM80_KERNELS.items() if fn and tag in fn), None)
            if kind is None:
                continue
            spill = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            if spill:
                found[kind] += 1
                print(f"  {src}: {kind} {fn}: {line.strip()}")
                check(all(int(b) == 0 for b in spill), f"{src}: {fn} spills ({line.strip()})")
    print("head_dim-80 instantiations compiled with 0 spill bytes: "
          + ", ".join(f"{k} {v}" for k, v in found.items()))
    check(all(found.values()), f"head_dim-80 instantiations missing from ptxas's report: {found}")


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
        parts = launch_ms(lambda: wb.fused_pruned_block_full(*rescored))
        dev = sum(parts.values())
        print(f"B7 N={n} K={K}: its launches, device ms a call (sum {dev:.3f}): "
              + "; ".join(f"{kernel_name(k)} {v:.3f}" for k, v in parts.items()))
        flops = (2.0 * B * n * C_S * 3 * C_S + 2.0 * B * K * C_S * C_S + 4.0 * B * K * K * C_S
                 + 4.0 * B * K * C_S * HIDDEN_S)
        nbytes = B * n * C_S * 2 + wbytes + B * K * C_S * 2 + B * K * 8
        record(results, "fused_pruned_block_full", P3A, f"B={B} N={n} K={K} C={C_S}", ms,
               plain_ms, bound(flops, nbytes, peaks), max(err, e2), max(rel, r2),
               device=(dev, "its launches summed"))


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
def ln_float32():
    """The int8 plain versions with their LayerNorm statistics summed in
    PyTorch's order instead of the kernel's: a last-bit change of the LN
    output, to read how far the quantizers carry such a change."""
    from rajni_tpu_torch.kernels import mlp as km

    with swapped("_layer_norm_int8", km._layer_norm_f32):
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
                    with ln_float32():
                        alt = wb.block_full_int8_plain(*args)
                    print(f"{tag}: plain vs plain with PyTorch's LayerNorm sum order: "
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
                dev = None
                if keep is not None:  # B14: its events read the host; its launches by device time
                    parts = launch_ms(timed[0])
                    dev = (sum(parts.values()), "its launches summed")
                    print(f"{tag} K={K}: its launches, device ms a call (sum {dev[0]:.3f}): "
                          + "; ".join(f"{kernel_name(k)} {v:.3f}" for k, v in parts.items()))
                int8_ops = 2.0 * batch * (n * width * 3 * width + K * width * width
                                      + 2 * K * width * hidden)
                nbytes = (batch * n * width * 2 + wbytes + batch * K * width * 2
                          + (batch * K * 8 if keep else 0))
                record(results, kname, path, f"B={batch} N={n} K={K} C={width} hc={hc}", ms,
                       plain_ms,
                       bound(4.0 * batch * K * K * width, nbytes, peaks, int8_ops, int8_peak),
                       err, rel, device=dev)


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
            ab = attached(qblk, sc)
            kargs = (x, ab["norm1"], ab["attn"], *args[3:])
            tag = f"B10 N={n} {mode}"
            got = kb.fused_attn_block_int8(*kargs)
            err, rel = gate(tag, got, lambda: kb.attn_block_int8_plain(*args), x,
                            ("bqkv without V-fold" if static else "row scales shifted",
                             "attention output fp32"))
            M = Bl * n
            bnd = bound(4.0 * Bl * n * n * C, 2 * M * C * 2 + a_bytes, peaks, 8.0 * M * C * C,
                        int8_peak)
            timed("fused_attn_block_int8", path, f"B={Bl} N={n} C={C}",
                  lambda: kb.fused_attn_block_int8(*kargs),
                  lambda: kb.attn_block_int8_plain(*args), bnd, err, rel)

        for n in (577, 442):  # B12
            x = x_of(n)
            sc = block_act_scales(blk, x, HEADS)[:2] if static else None
            for with_scores in (True, False):
                args = (x, qblk["norm1"], qblk["attn"]["qkv"], HEADS, 1e-6, with_scores, sc)
                ab = attached(qblk, sc)
                kargs = (x, ab["norm1"], ab["attn"]["qkv"], *args[3:])
                tag = f"B12 N={n} {mode} with_scores={with_scores}"
                gq, gs = kb.fused_ln_qkv_int8(*kargs)
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
                      lambda: kb.fused_ln_qkv_int8(*kargs), lambda: kb.ln_qkv_int8_plain(*args),
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
            kargs = (*args[:3], attached(qblk, sc)["attn"]["proj"], *args[4:])
            tag = f"B13 N={n} K={K} {mode}"
            x_kept = torch.take_along_dim(x, keep_idx[..., None], dim=1)
            got = kb.fused_gather_sdpa_proj_residual_int8(*kargs)
            err, rel = gate(tag, got, lambda: kb.gather_sdpa_proj_residual_int8_plain(*args),
                            x_kept, ("sproj without a_proj" if static else "row scales shifted",))
            bnd = bound(4.0 * Bl * K * K * C,
                        Bl * K * (3 * C * 2 + C * 2 + 8 + C * 2) + C * C + 2 * C * 4, peaks,
                        2.0 * Bl * K * C * C, int8_peak)
            timed("fused_gather_sdpa_proj_residual_int8", path, f"B={Bl} N={n} K={K} C={C}",
                  lambda: kb.fused_gather_sdpa_proj_residual_int8(*kargs),
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
    y = kb._layer_norm_int8(x.float(), ops["ln1s"], ops["ln1b"], eps)
    qkv32 = km._int8_matmul(y, attn["qkv"]["weight"]["int8"], ops["sqkv"], act is not None)
    s = kb._importance_f32(qkv32 + ops["bqkv"], heads)
    return kb.pruned_attn_block_int8_plain(x, ln, attn, ls, s, heads, keep, scale, eps, False, act)


def attached(qblk, sc):
    """qblk with the scales ``sc`` (static ``(a_qkv, a_proj, ...)``, or None:
    dynamic) attached as ``RAJNIViT`` attaches them
    (``quant.attach_act_scales``): the int8 attention wrappers (B10-B13)
    then read their operands made once and fold or convert nothing on the
    call, as on the main path. The plain versions take qblk and fold on the
    call, so a fold fault planted there is held against the attached
    operands."""
    from rajni_tpu_torch.kernels.block import attach_attn_operands

    return {**qblk, "attn": attach_attn_operands(qblk["norm1"], qblk["attn"],
                                                 None if sc is None else sc[:2])}


def check_b11(tag, x, qblk, heads, keep, scale, act, gen, faults):
    """B11 against its plain version, threaded (kept sets and next_scores
    exact, the output under the split-int8 gate, ``faults`` planted in the
    plain version rejected) and rescored (``check_rescored`` with the median
    score gate; scores from the unrounded qkv rejected). Returns ``(max abs
    err, branch rel L2, timed kernel, timed plain)``."""
    import torch

    from rajni_tpu_torch.kernels import block as kb

    B_, n, _ = x.shape
    ab = attached(qblk, act)  # the kernel's block: the scales attached
    common = (x, qblk["norm1"], qblk["attn"], None)
    threaded = (*common, torch.rand(B_, n, generator=gen).to(x.device), heads, keep, scale, 1e-6,
                False, act)
    got = kb.fused_pruned_attn_block_int8(x, ab["norm1"], ab["attn"], *threaded[3:])
    want = kb.pruned_attn_block_int8_plain(*threaded)
    check(torch.equal(got[2], want[2]), f"{tag} with_scores=False: kept sets differ")
    check(torch.equal(got[1], want[1]), f"{tag} with_scores=False: next_scores differ")
    x_kept = torch.take_along_dim(x, want[2][..., None], dim=1)
    err, rel = compare(f"{tag} with_scores=False", got[0], want[0], x_kept, SPLIT_INT8_GATE)
    reject_planted(tag, got[0], lambda: kb.pruned_attn_block_int8_plain(*threaded)[0], x_kept,
                   faults=faults, plant=planted_int8, limit=SPLIT_INT8_GATE[2])

    rescored = (*common, None, heads, keep, scale, 1e-6, True, act)
    krescored = (x, ab["norm1"], ab["attn"], *rescored[3:])
    got = kb.fused_pruned_attn_block_int8(*krescored)
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
    return (max(err, e2), max(rel, r2), lambda: kb.fused_pruned_attn_block_int8(*krescored),
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
            ab = attached(qblk, sc)
            kargs = (x, ab["norm1"], ab["attn"], *args[3:])
            tag = f"B10 N={n} C={width} {mode}"
            got = kb.fused_attn_block_int8(*kargs)
            err, rel = compare(tag, got, kb.attn_block_int8_plain(*args), x, SPLIT_INT8_GATE)
            reject_planted(tag, got, lambda: kb.attn_block_int8_plain(*args), x,
                           faults=("bqkv without V-fold" if static else "row scales shifted",
                                   "attention output fp32"),
                           plant=planted_int8, limit=SPLIT_INT8_GATE[2])
            M = B * n
            timed("fused_attn_block_int8", path, f"B={B} N={n} C={width}",
                  lambda: kb.fused_attn_block_int8(*kargs),
                  lambda: kb.attn_block_int8_plain(*args),
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
    B5; and B20 beside that route, timed, at the path's four later pruned
    blocks (548→520, 520→442, 442→375, 375→356), where it must give the same
    kept tokens and bits."""
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

    def two_kernel(x=x, keep=keep):
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
    def route(x=x, keep=keep):
        qkv, _, idx, ns = two_kernel(x, keep)
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

    for n, keep in ((548, 519), (520, 441), (442, 374), (375, 355)):  # not routed: timed only
        x = (X_STD * torch.randn(Bl, n, C, generator=gen)).to(device, torch.bfloat16)
        rescored = (x, ln, attn, None, None, HEADS, keep, scale, 1e-6, True)
        got, two = kl.fused_pruned_attn_block_long(*rescored), route(x, keep)
        tag = f"B20 N={n} K={keep + 1}"
        check(all(torch.equal(g, t) for g, t in zip(got, (two[0], two[1], two[2]))),
              f"{tag}: differs from the two-kernel route")
        ms = cuda_ms(lambda: kl.fused_pruned_attn_block_long(*rescored))
        two_ms = cuda_ms(lambda: route(x, keep))
        print(f"{tag}: {ms:.3f} ms against B4 + torch selection + B5 {two_ms:.3f} ms")


# The score kernel (csrc/common.cuh:score_kernel, inside K1, B4, B19, B20,
# B11, B12 and B14) against _importance_f32 of the same bf16 qkv: both take
# the same fp32 operations in another order of summation, so the scores
# differ by a few ulp, amplified where the z-score's difference vn - mu
# cancels. SCORE_SUM_RTOL bounds the largest relative error over the
# scores: on an H100 SXM it read 3.084e-6 at most (197 and 577 tokens); the
# limit is 2.5x that. It must reject a planted fault of the reference, the
# value norms' variance taken over N instead of N - 1 (the z-score moves by
# 0.09% at 577 tokens; it read 3.3e-3 and 9.2e-3).
SCORE_SUM_RTOL = 7.7e-6


def importance_biased_std(qkv32, num_heads: int, eps: float = 1e-6):
    """``_importance_f32`` with the biased variance of the value norms: a
    planted fault."""
    import torch

    from rajni_tpu_torch.kernels import block as kb

    B_, n = qkv32.shape[:2]
    s = kb._importance_f32(qkv32, num_heads, eps)
    q5 = qkv32.reshape(B_, n, 3, num_heads, -1)
    V = (q5[:, :, 2] * (1.0 / num_heads)).sum(dim=2)
    V = V - V.mean(dim=1, keepdim=True)
    vn = torch.sqrt((V * V).sum(dim=2))
    mu = vn.mean(dim=1, keepdim=True)
    var = (vn - mu).square().sum(dim=1, keepdim=True)
    std_u, std_b = torch.sqrt(var / (n - 1)) + eps, torch.sqrt(var / n) + eps
    return s / torch.sigmoid((vn - mu) / std_u) * torch.sigmoid((vn - mu) / std_b)


def score_phases(device, peaks):
    """B4's scores at 197 tokens (B=256) and 577 (B=128) against
    ``_importance_f32`` of B4's own qkv on the card; then the score kernel's
    device time at the five pruned blocks of ViT-B/16 224 (197, 187, 177,
    150 and 127 tokens, B=256) and at 577 (B=128), against its byte bound
    (the CLS q, every k and v row and the scores, once)."""
    import torch

    from rajni_tpu_torch.kernels import block as kb

    gen = torch.Generator().manual_seed(15)
    blk = make_block(gen, device)
    ln, wqkv = blk["norm1"], blk["attn"]["qkv"]
    for Bs, n in ((B, 197), (B384, 577)):
        x = (X_STD * torch.randn(Bs, n, C, generator=gen)).to(device, torch.bfloat16)
        qkv, got = kb.fused_ln_qkv(x, ln, wqkv, HEADS, 1e-6, True)
        check(bool(torch.isfinite(got).all()) and bool((got > 0).all()),
              f"scores B={Bs} N={n}: not finite and positive")
        want = kb._importance_f32(qkv.float(), HEADS)
        rel = ((got - want).abs() / want.abs()).max().item()
        bad = ((got - importance_biased_std(qkv.float(), HEADS)).abs() / want.abs()).max().item()
        print(f"scores B={Bs} N={n}: rel err max {rel:.3e} against _importance_f32 of the same "
              f"qkv; planted fault 'biased std' {bad:.3e}")
        check(rel <= SCORE_SUM_RTOL, f"scores N={n}: rel err {rel} > {SCORE_SUM_RTOL}")
        check(bad > SCORE_SUM_RTOL, f"scores N={n}: the gate missed the planted fault 'biased std'")

    total = total_bound = 0.0
    for Bs, n, path224 in ((B, 197, True), (B, 187, True), (B, 177, True), (B, 150, True),
                           (B, 127, True), (B384, 577, False)):
        x = (X_STD * torch.randn(Bs, n, C, generator=gen)).to(device, torch.bfloat16)
        times = launch_ms(lambda: kb.fused_ln_qkv(x, ln, wqkv, HEADS, 1e-6, True))
        ms = sum(v for k, v in times.items() if "score_kernel" in k)
        bnd = bound(0.0, (Bs * n * 2 * C + Bs * C) * 2 + Bs * n * 4, peaks)
        print(f"score kernel B={Bs} N={n}: {ms:.4f} ms of device time | bound {bnd[0]:.4f} ms "
              f"({bnd[1]}) | {ms / bnd[0]:.2f}x")
        if path224:
            total, total_bound = total + ms, total_bound + bnd[0]
    print(f"score kernel at ViT-B/16 224's five pruned blocks (B={B}): {total:.4f} ms against a "
          f"byte bound of {total_bound:.4f} ms ({total / total_bound:.2f}x)")


# C3: rajni_tpu_torch/quant.py:quantize_weight on the card against the CPU
# at ViT-B's and ViT-L's qkv, proj, fc1 and fc2 weights ([out, in], N(0,
# 0.02) in fp32); the old expression, absmax / 127.0 (on CUDA a multiply by
# fl(1/127), two roundings), is the planted fault the count must see.
C3_SHAPES = tuple((f"{model} {layer}", out, inp)
                  for model, c in (("ViT-B", C), ("ViT-L", C_L))
                  for layer, out, inp in (("qkv", 3 * c, c), ("proj", c, c), ("fc1", 4 * c, c),
                                          ("fc2", c, 4 * c)))


def quantize_weight_two_roundings(w):
    """``quant.quantize_weight`` as it was before C3's repair: the absmax
    divided by the Python float 127.0."""
    import torch

    w32 = w.float()
    scale = torch.clamp_min(w32.abs().amax(dim=1, keepdim=True), 1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"int8": q, "scale": scale[:, 0]}


def c3_phase(device):
    """C3: the weight quantizer on the card gives the CPU's (true division)
    scales and int8 values, 0 of each differing, at every C3_SHAPES weight;
    the old expression must differ in more than 0 scales over them."""
    import torch

    from rajni_tpu_torch.quant import quantize_weight

    gen = torch.Generator().manual_seed(21)
    old_scales = 0
    for tag, out, inp in C3_SHAPES:
        w = 0.02 * torch.randn(out, inp, generator=gen)
        cpu = quantize_weight(w)
        card = quantize_weight(w.to(device))
        old = quantize_weight_two_roundings(w.to(device))
        ds = int((card["scale"].cpu() != cpu["scale"]).sum())
        dq = int((card["int8"].cpu() != cpu["int8"]).sum())
        os_ = int((old["scale"].cpu() != cpu["scale"]).sum())
        oq = int((old["int8"].cpu() != cpu["int8"]).sum())
        old_scales += os_
        print(f"C3 {tag} [{out}, {inp}]: {ds} of {out} scales and {dq} int8 values differ "
              f"from the CPU's | planted fault (absmax / 127.0): {os_} scales, {oq} int8 values")
        check(ds == 0 and dq == 0, f"C3 {tag}: {ds} scales and {dq} int8 values differ")
    check(old_scales > 0, "C3: the count missed the old expression (absmax / 127.0)")


# Every attention at or below 256 tokens that the 14 paths run: (label,
# width, heads, batch, n_src, n, gathered). Gathered: K1 / B14 (ViT-B/224),
# B7 / B14 (DeiT-S), K1 / B11 (ViT-L), B14 (DeiT-S/384 275→247), B5 (T6,
# batch 128); contiguous: K2, B8, B10, B15, B16.
SHORT_SHAPES = (
    *((f"{PATH224} K1/B14", C, HEADS, B, ns, n, True)
      for ns, n in ((197, 187), (187, 177), (177, 150), (150, 127), (127, 120))),
    *((f"{PATH224} K2/B15", C, HEADS, B, n, n, False) for n in (197, 120)),
    *((f"{DEIT_S} B7/B14", C_S, HEADS_S, B, ns, n, True)
      for ns, n in ((197, 177), (177, 159), (159, 143), (143, 128), (128, 115), (115, 103),
                    (103, 92), (92, 82))),
    (f"{DEIT_S} B8/B15", C_S, HEADS_S, B, 197, 197, False),
    (f"{DEIT_S} B15", C_S, HEADS_S, B, 82, 82, False),
    *((f"{PATH_L} K1/B11", C_L, HEADS_L, B, ns, n, True)
      for ns, n in ((197, 138), (138, 96), (96, 67), (67, 47))),
    *((f"{PATH_L} K2/B10/B15", C_L, HEADS_L, B, n, n, False) for n in (197, 138, 96, 67, 47)),
    (f"{DEIT_S384} B14", C_S, HEADS_S, B_S384, 275, 247, True),
    (f"{DEIT_S384} B15", C_S, HEADS_S, B_S384, 247, 247, False),
    (f"{TRAIN} B5", C, HEADS, B_TRAIN, 197, 187, True),
    # ViT-H/14 (head_dim 80): K1 (180→126, 126→88, 88→61) and B5 (257→180)
    # gathered, K2 contiguous
    *((f"{PATH_H} K1/B5", C_H, HEADS_H, B_H, ns, n, True)
      for ns, n in ((257, 180), (180, 126), (126, 88), (88, 61))),
    *((f"{PATH_H} K2", C_H, HEADS_H, B_H, n, n, False) for n in (180, 126, 88, 61)),
)
SHORT_FAULTS = ("gather ignored", "keys past n unmasked")


def short_faulty(fault, qkv, idx, heads, scale, out_dtype):
    """The short-row attention's plain version with one planted fault: the
    rows 0..n-1 read instead of rows idx (gather ignored), or the kept rows
    padded with zero rows to whole 64-token tiles and every key of them
    softmaxed (keys past n unmasked)."""
    import torch

    from rajni_tpu_torch.kernels import attention as ka

    kept = kept_rows(qkv, idx)
    n = kept.shape[1]
    if fault == "gather ignored":
        return ka.attention_route_plain(qkv[:, :n].contiguous(), None, heads, scale, out_dtype)
    padded = torch.nn.functional.pad(kept, (0, 0, 0, -n % 64))
    form = ka._sdpa_phased if ka.mha_phased(heads, n, scale) else ka._sdpa_perhead
    return form(padded, heads, scale, out_dtype)[:, :n]


def check_phased_form(tag, got, qkv, idx, heads, scale, rel):
    """Where ``_mha`` takes its phased form (q·scale rounded first), a kernel
    held to it at ``rel`` must be nearer it than the per-head form (the
    planted fault 'per-head form'): else the Q tile was not rescaled."""
    from rajni_tpu_torch.kernels import attention as ka

    far = rel_l2(got, ka._sdpa_perhead(kept_rows(qkv, idx), heads, scale, got.dtype))
    print(f"{tag}: planted fault 'per-head form': rel L2 {far:.3e} (phased form {rel:.3e})")
    check(rel < far, f"{tag}: nearer the per-head form than the phased one")


def phased_body_phases(device, gen):
    """B6's body in ``_mha``'s phased form (``attention_route(..., "body")``
    where ``mha_phased``), contiguous and gathered: the blocks send it there past
    256 tokens only at 8 heads of 80 (C = 640, n <= 295 below 4 MiB); held at
    ViT-H's 16 heads too. Gated as the short-row kernel is (BF16_GATE and
    B6_REL_L2), and nearer the phased form than the per-head one."""
    import torch

    from rajni_tpu_torch.kernels import attention as ka

    for width, heads, batch, n_src, n in ((C_H, HEADS_H, B_H, 257, 180),
                                          (C_H, HEADS_H, B_H, 180, 180),
                                          (640, 8, 64, 320, 288), (640, 8, 64, 288, 288)):
        scale = (width // heads) ** -0.5
        check(ka.mha_phased(heads, n, scale), f"phased body: {heads}x{n} is not phased")
        qkv = torch.randn(batch, n_src, 3 * width, generator=gen).to(device, torch.bfloat16)
        idx = kept_indices(gen, batch, n_src, n, device)
        tag = f"B6 body phased B={batch} C={width} heads={heads} N={n} of {n_src}"
        got = ka.attention_route(qkv, idx, heads, scale, "body")
        want = ka.attention_route_plain(qkv, idx, heads, scale)
        compare(tag, got, want, torch.zeros_like(got))
        rel = rel_l2(got, want)
        check(rel <= B6_REL_L2, f"{tag}: rel L2 {rel} > {B6_REL_L2}")
        check_phased_form(tag, got, qkv, idx, heads, scale, rel)


def kept_indices(gen, batch, n_src, n, device):
    """int32 [batch, n]: CLS and n - 1 other tokens of n_src, ascending."""
    import torch

    from rajni_tpu_torch.ops.pruning import select_tokens_dense

    if n == n_src:
        return None
    return select_tokens_dense(torch.rand(batch, n_src, generator=gen).to(device), n - 1,
                               torch.bool)[0].to(torch.int32).contiguous()


def kept_rows(qkv, idx):
    """The rows idx [B, n] of qkv [B, n_src, 3C] (all of them when None)."""
    import torch

    return qkv if idx is None else torch.take_along_dim(qkv, idx.long()[..., None], dim=1)


def attention_bytes(batch, n, width, out_bytes, gathered):
    """Bytes the attention must move: the kept q, k and v rows read once (and
    their indices), the output written once."""
    return batch * n * (3 * width * 2 + width * out_bytes + (4 if gathered else 0))


def library_sdpa_ms(qkv, idx, heads):
    """Device time of torch.nn.functional.scaled_dot_product_attention (the
    library yardstick; the port never calls it) on the same heads already
    laid out [B, H, n, 64]."""
    import torch

    kept = kept_rows(qkv, idx)
    Bq, n, three_c = kept.shape
    q, k, v = (t.contiguous() for t in
               kept.reshape(Bq, n, 3, heads, three_c // (3 * heads)).permute(2, 0, 3, 1, 4))
    return device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))


def short_attn_phases(device, peaks, results):
    """The short-row attention (csrc/short_attn.cu) at every SHORT_SHAPES
    shape, bf16 and fp32 out, with and without the row absmax: held to its
    plain version (attention_route_plain) under BF16_GATE and by relative L2
    at B6_REL_L2; its absmax (head_dim 64: the int8 tails') equal to that of
    its own stored output, element for element; the planted faults
    SHORT_FAULTS rejected (the gather where tokens are gathered, keys past n
    where n is not a multiple of 64), and "P rounded before normalization"
    where it separates (at one shape at least). Timed at ViT-B/224's
    197→187, DeiT-S's 197→177 and ViT-H's 180→126 (head_dim 80), beside its
    byte bound and the library's device time."""
    import torch

    from rajni_tpu_torch.kernels import attention as ka

    gen = torch.Generator().manual_seed(22)
    separated = 0
    for label, width, heads, batch, n_src, n, gathered in SHORT_SHAPES:
        scale = (width // heads) ** -0.5
        qkv = torch.randn(batch, n_src, 3 * width, generator=gen).to(device, torch.bfloat16)
        idx = kept_indices(gen, batch, n_src, n, device)
        kind = f"{n} of {n_src}" if gathered else f"{n} contiguous"
        phased = ka.mha_phased(heads, n, scale)  # the form the blocks launch it in
        tag = f"short attention {label} B={batch} C={width} N={kind}" + (
            " phased" if phased else "")
        outs = {}
        for out_dtype in (torch.bfloat16, torch.float32):
            want = ka.attention_route_plain(qkv, idx, heads, scale, out_dtype)
            for amax in (False, True) if width == heads * 64 else (False,):
                got, am = ka.short_attention(qkv, idx, heads, scale, out_dtype, amax)
                name = f"{tag} {str(out_dtype)[6:]}" + (" amax" if amax else "")
                err, _ = compare(name, got, want, torch.zeros_like(got))
                rel = rel_l2(got, want)
                check(rel <= B6_REL_L2, f"{name}: rel L2 {rel} > {B6_REL_L2}")
                if amax:
                    diff = int((am != got.float().abs().amax(dim=-1).reshape(-1)).sum())
                    check(diff == 0, f"{name}: {diff} row absmax values differ from the "
                                     "absmax of its stored output")
                outs[out_dtype, amax] = (got, want, err, rel)
        got, want, err, rel = outs[torch.bfloat16, False]
        if phased:
            check_phased_form(tag, got, qkv, idx, heads, scale, rel)
        for fault in SHORT_FAULTS:
            if (fault == "keys past n unmasked" and n % 64 == 0) or (
                    fault == "gather ignored" and not gathered):
                continue
            bad = short_faulty(fault, qkv, idx, heads, scale, torch.bfloat16)
            missed = (torch.allclose(got.float(), bad.float(), atol=ATOL, rtol=RTOL)
                      and rel_l2(got, bad) <= B6_REL_L2)
            print(f"{tag}: planted fault '{fault}': rel L2 {rel_l2(got, bad):.3e}")
            check(not missed, f"{tag}: the gate missed '{fault}'")
        unnorm = b6_unnormalized(kept_rows(qkv, idx), heads, scale)
        separated += rel_or_zero(unnorm, want) >= B6_REL_L2
        rounding_point(tag, {"out": got}, {"out": want}, {"out": unnorm}, {"out": B6_REL_L2})
        if (width, n_src, n, batch) in ((C, 197, 187, B), (C_S, 197, 177, B),
                                        (C_H, 180, 126, B_H)):
            ms = cuda_ms(lambda: ka.short_attention(qkv, idx, heads, scale))
            dev = device_ms(lambda: ka.short_attention(qkv, idx, heads, scale))
            plain_ms = cuda_ms(lambda: ka.attention_route_plain(qkv, idx, heads, scale), iters=5)
            bnd = bound(4.0 * batch * n * n * width,
                        attention_bytes(batch, n, width, 2, gathered), peaks)
            record(results, "short_attention", {C: PATH224, C_S: P3A, C_H: PATH_H}[width],
                   f"B={batch} N={n_src} K={n} C={width}", ms, plain_ms, bnd, max(
                       e for _, _, e, _ in outs.values()), max(r for _, _, _, r in outs.values()),
                   library=library_sdpa_ms(qkv, idx, heads), device=dev)
    check(separated > 0, "short attention: 'P rounded before normalization' separated nowhere")


# token counts of the attention on the paths, where the crossover between
# the attention kernels is read (csrc/common.cuh: SHORT_ATTN_MAX_N)
CROSSOVER_N = (47, 67, 96, 120, 138, 197)


# the attention kernels up to 256 tokens, as kernels/attention.py:
# attention_route names them
ATTENTION_ROUTES = ("short", "body")


def attention_phases(device, peaks):
    """The attention at and below 256 tokens, measured for its routing: B6's
    wgmma body (``fused_sdpa``) against the attention inside K2 at 197, 187
    and 120 tokens, B=256, by device time, B6's output held to its plain
    version there; and the crossover at CROSSOVER_N, C = 768 and 1024,
    tokens contiguous (K2, B10, B15) and gathered (K1, B5, B11, B13, B14):
    each of ATTENTION_ROUTES through ``kernels/attention.py:attention_route``,
    held to its plain version, beside the byte bound and the library's
    ``scaled_dot_product_attention`` on the heads laid out ``[B, H, n, 64]``."""
    import torch

    from rajni_tpu_torch.kernels import attention as ka
    from rajni_tpu_torch.kernels import block as kb

    gen = torch.Generator().manual_seed(16)
    blk = make_block(gen, device)
    scale = (C // HEADS) ** -0.5
    for n in (197, 187, 120):
        x = (X_STD * torch.randn(B, n, C, generator=gen)).to(device, torch.bfloat16)
        args = (x, blk["norm1"], blk["attn"], None, HEADS, scale, 1e-6)
        qkv = kb.ln_qkv_plain(x, blk["norm1"], blk["attn"]["qkv"], HEADS, 1e-6, False)[0]
        got = ka.fused_sdpa(qkv, HEADS, scale)
        compare(f"B6 N={n} B={B}", got, ka.fused_sdpa_plain(qkv, HEADS, scale),
                torch.zeros_like(got))
        att = {kernel_name(k): v for k, v in launch_ms(lambda: kb.fused_attn_block(*args)).items()
               if "short_attn" in k}
        body = sum(launch_ms(lambda: ka.fused_sdpa(qkv, HEADS, scale)).values())
        print(f"attention N={n} B={B}: B6's wgmma body {body:.4f} ms | K2's attention "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in att.items()) + " (device time)")
    for width, heads in ((C, HEADS), (C_L, HEADS_L)):
        blk = make_block(gen, device, width, 4 * width)
        for n in CROSSOVER_N:
            for gathered in (False, True):
                # gathered: n kept of 8n/7 tokens, the kept sets of B11, B13, B14
                n_src = n + n // 7 if gathered else n
                x = (X_STD * torch.randn(B, n_src, width, generator=gen)).to(device, torch.bfloat16)
                qkv = kb.ln_qkv_plain(x, blk["norm1"], blk["attn"]["qkv"], heads, 1e-6, False)[0]
                idx = kept_indices(gen, B, n_src, n, device) if gathered else None
                want = ka.attention_route_plain(qkv, idx, heads, scale)
                ms = {}
                for route in ATTENTION_ROUTES:
                    got = ka.attention_route(qkv, idx, heads, scale, route)
                    rel = rel_l2(got, want)
                    check(rel <= BF16_GATE[2], f"crossover N={n}: route {route} rel L2 {rel}")
                    ms[route] = sum(launch_ms(
                        lambda: ka.attention_route(qkv, idx, heads, scale, route)).values())
                lib = library_sdpa_ms(qkv, idx, heads)[0]
                bnd = bound(4.0 * B * n * n * width, attention_bytes(B, n, width, 2, gathered),
                            peaks)[0]
                kind = f"gathered from {n_src}" if gathered else "contiguous"
                took = TAIL_ROUTES.get((gathered, n))
                print(f"crossover C={width} N={n} ({kind}) B={B}: "
                      + " | ".join(f"{r} {v:.4f} ms" for r, v in ms.items())
                      + f" | library {lib:.4f} ms | byte bound {bnd:.4f} ms (device time)"
                      + ("" if took is None else f" | the int8 tails took the {took} kernel"))


def rel_l2(got, want) -> float:
    """Relative L2 distance of two tensors, in fp32."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def b18_faulty(fault: str):
    """B18's plain version with one planted fault: the row term taken from
    the rounded pb instead of p32, dV from p32 instead of pb, P rounded
    before normalization (attn_out and dV from bf16(e), scaled by 1/Σe
    after the product); at head_dim 80 the phased form (the logits from
    q·scale rounded to bf16, the forward kernels' ``_mha``) and dQ, dK and
    dV without each head's 16 columns past 64."""
    import torch

    from rajni_tpu_torch.kernels import train as kt

    def fn(qkv, dout, num_heads, scale):
        C = qkv.shape[-1] // 3
        q, k, v = (kt._heads(qkv[..., i * C:(i + 1) * C], num_heads).float() for i in range(3))
        do = kt._heads(dout, num_heads).float()
        if fault == PHASED:
            logits = (q * scale).to(qkv.dtype).float() @ k.transpose(-1, -2)
        else:
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
        grads = [dsb @ k, dsb.transpose(-1, -2) @ q, dv]
        if fault == PARTS_LEFT_OUT:
            for g in grads:
                g[..., 64:] = 0.0
        d_qkv = torch.cat([kt._merge(g) for g in grads], dim=-1)
        out = (e.to(qkv.dtype).float() @ v) * inv if fault == ROUNDED_FIRST else pb @ v
        return kt._merge(out).to(qkv.dtype), d_qkv.to(qkv.dtype)

    return fn


B18_FAULTS = ("row term from pb", "dV from p32")
ROUNDED_FIRST = "P rounded before normalization"
# head_dim 80: B18 takes the per-head form (the TPU backward's), not the
# forward kernels' phased one, which reads ~3.4e-3 from it at 80^-0.5; and
# every output column of a head comes from the 64-column products plus the
# 16-column parts
PHASED, PARTS_LEFT_OUT = "phased form", "16-column parts left out of dQ, dK and dV"
B18_FAULTS_D80 = B18_FAULTS + (PHASED, PARTS_LEFT_OUT)
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


def train_kernel_phases(device, peaks, results, path=TRAIN, C=C, HEADS=HEADS, HIDDEN=HIDDEN,
                        batch=B_TRAIN, b16_n=(197,), b17_n=(197, 120),
                        b18_shapes=((B_TRAIN, 197), (B_TRAIN, 187), (B_TRAIN, 120), (32, 577)),
                        seed=11):
    """B16, B17 and B18 at a training path's shapes: T6's (ViT-B/16 224,
    B=128) by default, B16 at 197 tokens, B17 at 197 and 120, B18 at K =
    197, 187 and 120, and B18 at K=577 (B=32), past the JAX package's fit
    rule; T14's (ViT-H/14, C = 1280, head_dim 80, B=64) with its arguments.
    Each output is held to the plain version separately, and the planted
    faults must be rejected: B17's GELU on the unrounded h (K3's plain
    version, which computes exactly that), and B18's above (at head_dim 80
    also the phased form and the 16-column parts left out); B18's
    rounding-point fault is gated where it separates (``rounding_point``),
    and two calls of B18 on the same input must be bitwise equal."""
    import torch
    import torch.nn.functional as Fn

    from rajni_tpu_torch.kernels import mlp as km
    from rajni_tpu_torch.kernels import train as kt
    from rajni_tpu_torch.kernels.block import attn_block_qkv_plain

    gen = torch.Generator().manual_seed(seed)
    blk = make_block(gen, device, C, HIDDEN)
    D = C // HEADS
    scale = D ** -0.5

    def x_of(b, n):
        return (X_STD * torch.randn(b, n, C, generator=gen)).to(device, torch.bfloat16)

    for n in b16_n:  # B16
        x = x_of(batch, n)
        args = (x, blk["norm1"], blk["attn"], None, HEADS, scale, 1e-6)
        x1, qkv = kt.train_attn_block(*args)
        px1, pqkv = attn_block_qkv_plain(*args)
        err, rel = compare(f"B16 x1 N={n}", x1, px1, x)
        qrel = rel_l2(qkv, pqkv)
        print(f"B16 qkv N={n}: rel L2 {qrel:.3e}")
        check(qrel <= TRAIN_GATES["qkv"], f"B16 qkv rel L2 {qrel} > {TRAIN_GATES['qkv']}")
        reject_planted(f"B16 x1 N={n}", x1, lambda: attn_block_qkv_plain(*args)[0], x)
        M = batch * n
        bnd = bound(2.0 * M * C * 4 * C + 4.0 * batch * n * n * C,
                    M * C * 2 * 2 + M * 3 * C * 2 + 4 * C * C * 2, peaks)
        record(results, "train_attn_block", path, f"B={batch} N={n} C={C}",
               cuda_ms(lambda: kt.train_attn_block(*args)),
               cuda_ms(lambda: attn_block_qkv_plain(*args), iters=5), bnd, err, max(rel, qrel))

    w1, b1 = blk["mlp"]["fc1"]["weight"], blk["mlp"]["fc1"]["bias"]
    w2, b2 = blk["mlp"]["fc2"]["weight"], blk["mlp"]["fc2"]["bias"]
    for n in b17_n:  # B17
        x = x_of(batch, n)
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
        M = batch * n
        # fc1's epilogue on B17's own LN output, bit for bit
        yln = km._layer_norm_f32(x.float(), blk["norm2"]["scale"], blk["norm2"]["bias"],
                                 1e-6).to(x.dtype).reshape(M, C)
        hg = gelu_save_gate(f"B17 fc1 M={M}", yln, w1, b1)[0]
        bnd = bound(4.0 * M * C * HIDDEN, 2 * M * C * 2 + M * HIDDEN * 2 + 2 * C * HIDDEN * 2,
                    peaks)
        # B17's launches beside K3's at the same rows (fc1 with EPI_GELU, no
        # h) and cuBLAS's fc1 and fc2 (no GELU), by device time
        parts = {kernel_name(k): v for k, v in launch_ms(lambda: kt.train_ln_mlp(*args)).items()}
        k3 = {kernel_name(k): v
              for k, v in launch_ms(lambda: km.fused_ln_mlp_residual(*args)).items()}
        lib = (device_ms(lambda: Fn.linear(yln, w1, b1), iters=10)[0]
               + device_ms(lambda: Fn.linear(hg, w2, b2), iters=10)[0])
        print(f"B17 N={n} B={batch} C={C}: {sum(parts.values()):.3f} ms ("
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + f") | K3 {sum(k3.values()):.3f} ms ("
              + ", ".join(f"{k} {v:.3f}" for k, v in k3.items())
              + f") | cuBLAS fc1 + fc2 {lib:.3f} ms | bound {bnd[0]:.3f} ms ({bnd[1]}) "
              "(device time)")
        record(results, "train_ln_mlp", path, f"B={batch} N={n} C={C}",
               cuda_ms(lambda: kt.train_ln_mlp(*args)),
               cuda_ms(lambda: kt.train_ln_mlp_plain(*args), iters=5), bnd, err, max(rel, hrel))

    faults = B18_FAULTS_D80 if D == 80 else B18_FAULTS
    for b, n in b18_shapes:  # B18
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
        print(f"B18 head_dim {D} B={b} K={n}: max_abs_err {err:.3e}, rel L2 "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()))
        for k, v in rels.items():
            check(v <= TRAIN_GATES[k], f"B18 K={n} {k} rel L2 {v} > {TRAIN_GATES[k]}")
        for fault in faults:
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
        record(results, "train_sdpa_bwd", path, f"B={b} K={n} C={C}", ms, plain_ms, bnd, err,
               max(rels.values()), library=lib, device=dev)


# The GEMM of K1, K2, K3, B4 and B5 (csrc/gemm_sm90.cuh, through its own
# entry point kernels/gemm.py:gemm) against gemm_plain, by relative L2 of the
# output, or of the branch ``out - res`` where the epilogue adds a residual
# (the gathered rows of res where it reads them through res_idx). Both round
# once from fp32 sums taken in another order, so they differ by one-ulp flips
# where a sum lies within that order's error of a rounding edge. On an H100
# SXM the sound readings were at most GEMM_SOUND (fc2 at K=4096, the longest
# sums; 1.9e-5 to 1.5e-4 over the path and ragged shapes); the limit is 2.5x
# that. It must reject two planted faults of the plain version: the GELU of
# the bf16-rounded sum (B17's rounding point, not K3's; it read 3.0e-3 to
# 3.1e-3) at every fc1 shape, and the last K-tile skipped (0.2 and up) at
# every ragged one. With res_idx, at K1's and B5's proj shapes, it must also
# reject the residual added ungathered (row r of each image's rows instead of
# row res_idx[r]) and the index shifted by one row.
GEMM_SOUND = 1.533e-4
# the sources that build it (the int8 ones since the int8 products moved
# there, B17's since its fc1 and fc2 did)
GEMM_SOURCES = ("gemm.cu", "mlp.cu", "attn_block.cu", "pruned_attn_block.cu", "gather_attn.cu",
                "ln_qkv.cu", "ln_mlp_int8.cu", "block_full_int8.cu", "pruned_block_full_int8.cu",
                "attn_block_int8.cu", "ln_qkv_int8.cu", "gather_attn_int8.cu",
                "pruned_attn_block_int8.cu", "train_mlp.cu", "short_attn.cu")
# the sources that build the row-band GEMM (csrc/band_s8.cuh): its check
# entry point, B11's (head and proj), B12's (head) and B10's (proj)
BAND_SOURCES = ("gemm.cu", "ln_qkv_int8.cu", "pruned_attn_block_int8.cu", "attn_block_int8.cu")
GEMM_REL_L2 = 2.5 * GEMM_SOUND
# (label, width, hidden) of the bf16 paths whose products the GEMM runs:
# DeiT-S (P3a: B7's MLP half, B8), ViT-B (K2, K3, B16), ViT-L (P5c)
GEMM_WIDTHS = ((DEIT_S, C_S, HIDDEN_S), (PATH224, C, HIDDEN), (PATH_L, C_L, HIDDEN_L))


def gemm_faulty(fault: str):
    """gemm_plain with a planted fault."""
    import torch

    from rajni_tpu_torch.kernels import gemm as kg
    from rajni_tpu_torch.kernels.math import gelu_fast

    def fn(a, w, bias, epi, ls=None, res=None, res_idx=None, rows_out=1, rows_in=1):
        if fault == "K-tile skipped":  # the last 64 of K left out of the sum
            return kg.gemm_plain(a[..., :-kg.BLOCK_K], w[:, :-kg.BLOCK_K], bias, epi, ls, res,
                                 res_idx, rows_out, rows_in)
        if fault == "residual ungathered":  # each image's rows 0..rows_out-1, not res_idx's
            ungathered = torch.arange(rows_out, dtype=torch.int32, device=a.device)
            return kg.gemm_plain(a, w, bias, epi, ls, res,
                                 ungathered.repeat(res_idx.numel() // rows_out), rows_out,
                                 rows_in)
        if fault == "index shifted by one row":
            return kg.gemm_plain(a, w, bias, epi, ls, res, (res_idx + 1) % rows_in, rows_out,
                                 rows_in)
        # "GELU of the rounded sum"
        h = (a.float() @ w.float().t() + bias.float()).to(a.dtype)
        return gelu_fast(h.float()).to(a.dtype)
    return fn


def gelu_save_gate(tag, a, w, bias):
    """fc1's EPI_GELU_SAVE (B17) through the GEMM's entry point, which runs
    the instantiation B17 launches: the hidden must be PyTorch's gelu_fast
    of the kernel's own h, rounded, bit for bit (every GELU input is a bf16
    value), and h within GEMM_REL_L2 of gemm_plain's. The planted fault, the
    GELU of the unrounded sum (K3's rounding point, which B17's plain
    version computes under ``b17_unrounded_gelu``), must be rejected by the
    bitwise gate. Returns the kernel's (hidden, h)."""
    import torch

    from rajni_tpu_torch.kernels import gemm as kg
    from rajni_tpu_torch.kernels.math import gelu_fast

    hg, h = kg.gemm(a, w, bias, kg.EPI_GELU_SAVE)
    want = gelu_fast(h.float()).to(h.dtype)
    diff = int((hg.view(torch.int16) != want.view(torch.int16)).sum())
    hrel = rel_l2(h, kg.gemm_plain(a, w, bias, kg.EPI_BIAS))
    bad = kg.gemm_plain(a, w, bias, kg.EPI_GELU)  # the GELU of the unrounded fp32 sum
    missed = torch.equal(hg, bad)
    print(f"{tag} EPI_GELU_SAVE: {diff} of {hg.numel()} hidden elements differ from PyTorch's "
          f"gelu_fast of the kernel's h; h rel L2 {hrel:.3e}; planted fault 'GELU of the "
          f"unrounded sum': {'missed' if missed else 'rejected'}")
    check(bool(torch.isfinite(hg.float()).all()), f"{tag}: hidden not finite")
    check(diff == 0, f"{tag}: the hidden is not PyTorch's GELU of the kernel's h ({diff})")
    check(hrel <= GEMM_REL_L2, f"{tag}: h rel L2 {hrel} > {GEMM_REL_L2}")
    check(not missed, f"{tag}: the gate missed the GELU of the unrounded sum")
    return hg, h


def gemm_rel(got, want, args) -> float:
    """Relative L2 of the outputs, or of the branches when the residual of
    the gemm arguments ``args`` is added (its gathered rows with res_idx)."""
    from rajni_tpu_torch.kernels import gemm as kg

    res = args[5]
    if res is None:
        return rel_l2(got, want)
    if len(args) > 6 and args[6] is not None:
        res = res.reshape(-1, res.shape[-1])[kg.gathered_rows(*args[6:9])]
    return branch_rel(got.reshape(res.shape), want.reshape(res.shape), res)


def gemm_phases(device, peaks):
    """The GEMM on its own at each product of the bf16 paths (QKV, proj, fc1
    and fc2 at C = 384, 768 and 1024, M = 256·197 and 256·120), each timed
    beside ``F.linear`` (cuBLAS, which the port never calls) by device time;
    K1's and B5's proj with the residual gathered through the kept indices
    (M = 256·187 and 256·127 of 197 and 150 tokens, 128·548 of 577), timed
    beside the same product with a contiguous residual; and at ragged
    shapes, M in {1, 77, 128·394 + 1} and N not a multiple of the tile,
    which no path runs. Every epilogue, with and without the layer scale and
    the residual."""
    import torch
    import torch.nn.functional as Fnn

    from rajni_tpu_torch.kernels import gemm as kg
    from rajni_tpu_torch.kernels.math import gelu_fast
    from rajni_tpu_torch.ops.pruning import select_tokens_dense

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
        rel = gemm_rel(got, kg.gemm_plain(*args), args)
        print(f"GEMM {tag}: rel L2 {rel:.3e}")
        check(bool(torch.isfinite(got.float()).all()), f"GEMM {tag}: output not finite")
        check(rel <= GEMM_REL_L2, f"GEMM {tag}: rel L2 {rel} > {GEMM_REL_L2}")
        for fault in faults:
            bad = gemm_rel(got, gemm_faulty(fault)(*args), args)
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

    # K1's and B5's proj: the residual rows of x through the kept indices
    # (CLS and a random selection, ascending), as the entry points pass them
    for label, imgs, n, K in (("K1", B, 197, 187), ("K1", B, 150, 127), ("B5", B384, 577, 548)):
        M = imgs * K
        a, w, bias, epi, ls, _ = operands(M, C, C, kg.EPI_RESIDUAL, "proj", True, False)
        x = (X_STD * torch.randn(imgs, n, C, generator=gen)).to(device, torch.bfloat16)
        idx, _ = select_tokens_dense(torch.rand(imgs, n, generator=gen).to(device), K - 1,
                                     torch.bool)
        args = (a, w, bias, epi, ls, x, idx.to(torch.int32).reshape(M).contiguous(), K, n)
        tag = f"{label} proj gathered M={M} ({imgs}x{n}->{K}) N={C} K={C}"
        held(tag, args, ("residual ungathered", "index shifted by one row"))
        contiguous = (a, w, bias, epi, ls, torch.take_along_dim(x, idx[..., None], dim=1)
                      .reshape(M, C).contiguous())
        # the gather's own cost: the same contiguous rows through an index
        ident = (*contiguous, torch.arange(K, dtype=torch.int32, device=device).repeat(imgs),
                 K, K)
        ms, ms_c, ms_i = (device_ms(lambda: kg.gemm(*args), iters=10),
                          device_ms(lambda: kg.gemm(*contiguous), iters=10),
                          device_ms(lambda: kg.gemm(*ident), iters=10))
        ev, ev_c = stream_ms(lambda: kg.gemm(*args)), stream_ms(lambda: kg.gemm(*contiguous))
        lib = device_ms(lambda: Fnn.linear(a, w, bias), iters=10)
        bnd = bound(2.0 * M * C * C, (2 * M * C + C * C + M * C) * 2 + M * 4, peaks)
        print(f"GEMM {tag}: {ms[0]:.3f} ms ({ms[1]}; events {ev:.3f}) | contiguous residual "
              f"{ms_c[0]:.3f} ms (events {ev_c:.3f}), through an identity index "
              f"{ms_i[0]:.3f} ms | cuBLAS F.linear {lib[0]:.3f} ms | bound {bnd[0]:.3f} ms "
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
    # B17's EPI_GELU_SAVE past the tiles' edges
    for M, N, K in ((77, 776, 192), (128 * 394 + 1, 200, 64), (1, 8, 64)):
        a, w, bias = operands(M, N, K, kg.EPI_BIAS, "", False, False)[:3]
        gelu_save_gate(f"GEMM ragged M={M} N={N} K={K}", a, w, bias)


# The int8 GEMM of B9-B15 (csrc/gemm_sm90.cuh's kernel with csrc/int8.cuh's
# S8Epi, through its own entry point kernels/gemm.py:gemm_s8) against
# gemm_s8_plain. The product is exact in int32 and the epilogue is the same
# fp32 operations in the same order on both sides, so I8_BIAS and
# I8_RESIDUAL (grouped, ungrouped, gathered) must be the plain version's
# bits. I8_GELU takes the GELU by ex2 and a reciprocal where the plain
# version takes expf and a division: held within GEMM_REL_L2, with the bf16
# GEMM's fault "GELU of the rounded sum" (here the sum rounded to bf16). The
# gates must reject three planted faults of the plain version: the last
# 128-deep k-tile skipped (ragged shapes), each group's flush scaled by the
# neighbouring group's row scale (grouped fc2), the residual added ungathered
# (gathered proj).
# (label, width, hidden, M) of the int8 paths' products: DeiT-S (P3d),
# ViT-B at P3b's and P4a's rows, ViT-L (P5a); fc2 grouped at hc = hidden/2.
S8_WIDTHS = ((DEIT_S, C_S, HIDDEN_S, B * 197), (PATH224, C, HIDDEN, B * 197),
             (PATH384, C, HIDDEN, B384 * 577), (PATH_L, C_L, HIDDEN_L, B * 197))
# fc1 with its GELU quantized (kernels/gemm.py:gelu_quant) at the B9 and B15
# shapes (label, width, hidden, M, hc): the entry points' route (static: the
# GELU quantized in fc1's epilogue; dynamic: fp32 h with each row and
# group's absmax taken in fc1's epilogue, then one quantizing read) and the
# two-launch route (I8_GELU to fp32 h, then the row quantizer, which reads h
# twice) must give the same hq and hs, bit for bit. Planted faults of the
# two-launch route the gate must reject: hq scaled by its 256-column tile's
# absmax instead of its hc group's (dynamic), sinv of the neighbouring
# column (static).
GELU_Q_SHAPES = (("B9 P4a", C, HIDDEN, B384 * 577, HIDDEN), ("B9 P4a", C, HIDDEN, B384 * 577, 1536),
                 ("B9 P4a", C, HIDDEN, B384 * 356, HIDDEN),
                 ("B9 P5a", C_L, HIDDEN_L, B * 197, HIDDEN_L),
                 ("B15 P3b", C, HIDDEN, B * 197, 1536), ("B15 P5a", C_L, HIDDEN_L, B * 67, 2048),
                 ("B15 P5d", C_S, HIDDEN_S, B_S384 * 577, 768))


def s8_operands(gen, device, M, N, K, groups=1, static=False, with_ls=False, with_res=False):
    """int8 q [M, K] and w [N, K], row scales a [M, groups] (None if static),
    w_scale and bias [N] fp32 scaled so the dequantized sums are O(1), ls
    and res bf16."""
    import torch

    q = torch.randint(-127, 128, (M, K), generator=gen, device=device, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=gen, device=device, dtype=torch.int8)
    a = None if static else 0.004 + 0.008 * torch.rand(M, groups, generator=gen, device=device)
    ws = (0.5 + torch.rand(N, generator=gen, device=device)) / (64.0 * math.sqrt(K))
    if static:
        ws = ws / 127.0
    bias = 0.1 * torch.randn(N, generator=gen, device=device)
    ls = (1 + 0.1 * torch.randn(N, generator=gen, device=device)).to(torch.bfloat16) \
        if with_ls else None
    res = (X_STD * torch.randn(M, N, generator=gen, device=device)).to(torch.bfloat16) \
        if with_res else None
    return q, w, ws, bias, a, ls, res


def s8_phases(device, peaks, int8_peak):
    """The int8 GEMM on its own at each int8 path's products (qkv, proj with
    the residual, fc1, fc2 ungrouped and grouped over hc = hidden/2; C = 384,
    768, 1024; M = 256·197 and 128·577), each timed beside
    ``torch._int_mm`` by device time; proj with the residual gathered
    through the kept indices (B14 at P3b's 197→187, B13 at P4a's 442→375);
    ragged M (1, 77, 128·394 + 1), N (400) and K (128, 384), dynamic and
    static."""
    import torch

    from rajni_tpu_torch.kernels import gemm as kg
    from rajni_tpu_torch.ops.pruning import select_tokens_dense

    gen = torch.Generator(device=device).manual_seed(17)

    def held(tag, args, kw, faults=()):
        got = kg.gemm_s8(*args, **kw)
        want = kg.gemm_s8_plain(*args, **kw)
        check(bool(torch.isfinite(got.float()).all()), f"s8 GEMM {tag}: output not finite")
        if args[4] == kg.I8_GELU:
            rel = rel_l2(got, want)
            print(f"s8 GEMM {tag}: rel L2 {rel:.3e} (GELU: ex2 and a reciprocal)")
            check(rel <= GEMM_REL_L2, f"s8 GEMM {tag}: rel L2 {rel} > {GEMM_REL_L2}")
        else:
            diff = int((got != want).sum())
            print(f"s8 GEMM {tag}: {diff} elements differ from gemm_s8_plain")
            check(diff == 0, f"s8 GEMM {tag}: not bitwise equal to gemm_s8_plain ({diff})")
        for fault in faults:
            bad = s8_faulty(fault, args, kw)
            if args[4] == kg.I8_GELU:
                missed = rel_l2(got, bad) <= GEMM_REL_L2
            else:
                missed = torch.equal(got, bad)
            print(f"s8 GEMM {tag}: planted fault '{fault}': "
                  f"{'missed' if missed else 'rejected'}")
            check(not missed, f"s8 GEMM {tag}: the gate missed the planted fault '{fault}'")
        return got

    def timed(tag, args, kw, nbytes):
        q, w = args[0], args[1]
        M, K, N = q.shape[0], q.shape[1], w.shape[0]
        ms = device_ms(lambda: kg.gemm_s8(*args, **kw), iters=10)
        # cuBLASLt's int8 product with no epilogue, int32 out
        lib = device_ms(lambda: torch._int_mm(q, w.t()), iters=10)
        bnd = bound(0.0, nbytes, peaks, 2.0 * M * N * K, int8_peak)
        print(f"s8 GEMM {tag}: {ms[0]:.3f} ms ({ms[1]}) | torch._int_mm {lib[0]:.3f} ms "
              f"({lib[1]}) | bound {bnd[0]:.3f} ms ({bnd[1]})")

    for label, width, hidden, M in S8_WIDTHS:
        products = (("qkv", 3 * width, width, kg.I8_BIAS, None, False, False),
                    ("proj", width, width, kg.I8_RESIDUAL, None, True, True),
                    ("fc1", hidden, width, kg.I8_GELU, None, False, False),
                    ("fc2", width, hidden, kg.I8_RESIDUAL, None, True, True),
                    ("fc2 grouped", width, hidden, kg.I8_RESIDUAL, hidden // 2, True, True))
        for name, N, K, epi, gk, with_ls, with_res in products:
            groups = K // (gk or K)
            q, w, ws, bias, a, ls, res = s8_operands(gen, device, M, N, K, groups,
                                                     with_ls=with_ls, with_res=with_res)
            args, kw = (q, w, ws, bias, epi), dict(a=a, group_k=gk, ls=ls, res=res)
            tag = f"{label} {name} M={M} N={N} K={K}"
            faults = ("flush scaled by the neighbouring group's row scale",) if gk else ()
            if epi == kg.I8_GELU:
                faults = ("GELU of the rounded sum",)
            held(tag, args, kw, faults)
            out_bytes = 4 if epi == kg.I8_GELU else 2
            timed(tag, args, kw, M * K + N * K + M * N * out_bytes + (M * N * 2 if with_res else 0)
                  + M * groups * 4 + N * 8)
        if label == PATH224:  # static scales: the same products without row scales
            for name, N, K, epi, gk in (("qkv", 3 * width, width, kg.I8_BIAS, None),
                                        ("fc2 grouped", width, hidden, kg.I8_RESIDUAL,
                                         hidden // 2)):
                q, w, ws, bias, a, ls, res = s8_operands(gen, device, M, N, K, static=True,
                                                         with_ls=True, with_res=True)
                if epi == kg.I8_BIAS:
                    ls = res = None
                held(f"{label} {name} static M={M} N={N} K={K}", (q, w, ws, bias, epi),
                     dict(group_k=gk, ls=ls, res=res))

    # proj with the residual rows of x through the kept indices: B14 at P3b's
    # first pruned block, B13 at P4a's 442→375
    for label, imgs, n, Kk in (("B14", B, 197, 187), ("B13", B384, 442, 375)):
        M = imgs * Kk
        q, w, ws, bias, a, ls, _ = s8_operands(gen, device, M, C, C, with_ls=True)
        x = (X_STD * torch.randn(imgs, n, C, generator=gen, device=device)).to(torch.bfloat16)
        idx, _ = select_tokens_dense(torch.rand(imgs, n, generator=gen, device=device), Kk - 1,
                                     torch.bool)
        res_idx = idx.to(torch.int32).reshape(M).contiguous()
        args = (q, w, ws, bias, kg.I8_RESIDUAL)
        kw = dict(a=a, ls=ls, res=x, res_idx=res_idx, rows_out=Kk, rows_in=n)
        tag = f"{label} proj gathered M={M} ({imgs}x{n}->{Kk}) N={C} K={C}"
        held(tag, args, kw, ("residual ungathered",))
        timed(tag, args, kw, 2 * M * C + C * C + 2 * M * C * 2 + M * 8 + C * 10)

    # ragged: M past the 128-row tile, N past the 128-column tile, K of one
    # and three 128-deep steps, dynamic and static
    for M in (1, 77, 128 * 394 + 1):
        for N, K, epi, gk, static in ((3 * C_S, C_S, kg.I8_BIAS, None, False),
                                      (400, 384, kg.I8_RESIDUAL, None, True),
                                      (C_S, HIDDEN_S, kg.I8_RESIDUAL, 768, False),
                                      (C_S, HIDDEN_S, kg.I8_RESIDUAL, 768, True),
                                      (400, 128, kg.I8_GELU, None, False)):
            q, w, ws, bias, a, ls, res = s8_operands(gen, device, M, N, K, K // (gk or K), static,
                                                     epi == kg.I8_RESIDUAL,
                                                     epi == kg.I8_RESIDUAL)
            faults = ("k-tile skipped",) if K > 128 else ()
            if gk and not static:
                faults += ("flush scaled by the neighbouring group's row scale",)
            held(f"ragged M={M} N={N} K={K} epi={epi} group_k={gk} "
                 f"{'static' if static else 'dynamic'}", (q, w, ws, bias, epi),
                 dict(a=a, group_k=gk, ls=ls, res=res), faults)


def s8_faulty(fault: str, args, kw):
    """gemm_s8_plain with a planted fault."""
    import torch

    from rajni_tpu_torch.kernels import gemm as kg
    from rajni_tpu_torch.kernels.math import gelu_fast

    q, w, ws, bias, epi = args
    kw = dict(kw)
    if fault == "k-tile skipped":  # the last 128 of K left out of the sum
        return kg.gemm_s8_plain(q[..., :-kg.S8_BLOCK_K], w[:, :-kg.S8_BLOCK_K], ws, bias, epi,
                                **kw)
    if fault == "flush scaled by the neighbouring group's row scale":
        kw["a"] = torch.roll(kw["a"], 1, dims=-1)
        return kg.gemm_s8_plain(q, w, ws, bias, epi, **kw)
    if fault == "residual ungathered":  # each image's rows 0..rows_out-1, not res_idx's
        ungathered = torch.arange(kw["rows_out"], dtype=torch.int32, device=q.device)
        kw["res_idx"] = ungathered.repeat(kw["res_idx"].numel() // kw["rows_out"])
        return kg.gemm_s8_plain(q, w, ws, bias, epi, **kw)
    # "GELU of the rounded sum": the dequantized sum rounded to bf16 first
    h = kg.gemm_s8_plain(q, w, ws, bias, kg.I8_BIAS, kw.get("a"))
    return gelu_fast(h.float())


def gelu_quant_phases(device, peaks, int8_peak):
    """fc1 with its GELU quantized at every B9 and B15 shape (GELU_Q_SHAPES),
    dynamic and static: the entry points' route against the two-launch
    route, bit for bit, with the planted faults; both routes timed (CUDA
    events)."""
    import torch

    from rajni_tpu_torch.kernels import gemm as kg

    gen = torch.Generator(device=device).manual_seed(18)
    for label, width, hidden, M, hc in GELU_Q_SHAPES:
        for static in (False, True):
            q, w, ws, bias, a, _, _ = s8_operands(gen, device, M, hidden, width, static=static)
            # static: GELU outputs of O(1) times a per-column fold, most of
            # them inside the int8 range
            sinv = (20.0 + 20.0 * torch.rand(hidden, generator=gen, device=device)) \
                if static else None
            tag = f"{label} GELU-quantize M={M} hidden={hidden} C={width} hc={hc} " \
                  f"{'static' if static else 'dynamic'}"
            fused = kg.gelu_quant(q, w, ws, bias, hc, a, sinv)
            two = kg.gelu_quant(q, w, ws, bias, hc, a, sinv, two_launch=True)
            same = torch.equal(fused[0], two[0]) and (static or torch.equal(fused[1], two[1]))
            # beside the plain quantizer of the kernel's own fp32 h, which
            # divides 127 / absmax once, as the kernels do (C2): bit for bit
            plain = kg.quant_groups_plain(kg.gemm_s8(q, w, ws, bias, kg.I8_GELU, a), hc, sinv)
            steps = int((fused[0] != plain[0]).sum())
            scales = 0 if static else int((fused[1] != plain[1]).sum())
            print(f"{tag}: hq{'' if static else ' and hs'} bitwise equal to the two-launch "
                  f"route {same}; against the plain quantizer of the kernel's h, {steps} of "
                  f"{fused[0].numel()} hq and {scales} hs elements differ")
            check(same, f"{tag}: the entry points' route differs from the two-launch route")
            check(steps == 0 and scales == 0,
                  f"{tag}: {steps} hq and {scales} hs elements differ from the plain quantizer")
            # the faults, planted in the two-launch route the gate holds to
            if static:
                fault = "sinv of the neighbouring column"
                bad = kg.gelu_quant(q, w, ws, bias, hc, a, torch.roll(sinv, 1), two_launch=True)
            else:
                fault = "hq scaled by its tile's absmax"
                bad = kg.gelu_quant(q, w, ws, bias, 256, a, sinv, two_launch=True)
            missed = torch.equal(fused[0], bad[0])
            print(f"{tag}: planted fault '{fault}': {'missed' if missed else 'rejected'}")
            check(not missed, f"{tag}: the gate missed the planted fault '{fault}'")
            ms_f = cuda_ms(lambda: kg.gelu_quant(q, w, ws, bias, hc, a, sinv))
            ms_t = cuda_ms(lambda: kg.gelu_quant(q, w, ws, bias, hc, a, sinv, two_launch=True))
            bnd = bound(0.0, M * width + hidden * width + M * hidden + hidden * 12, peaks,
                        2.0 * M * hidden * width, int8_peak)
            print(f"{tag}: entry points' route {ms_f:.3f} ms | two-launch {ms_t:.3f} ms | "
                  f"bound {bnd[0]:.3f} ms ({bnd[1]})")


# The int8 attention tail (csrc/int8.cuh:int8_attn_tail) of B10, B11, B13,
# B14 and B15: the attention's epilogue takes each row's absmax, and proj
# quantizes the attention output as it loads it. Held bit for bit to the
# two-launch route (the same attention, the row quantizer, the int8 proj)
# at every path shape, dynamic and static: (kernel, width, heads, hidden,
# batch, paths, (n, K) with K None for the stock blocks).
TAIL_SHAPES = (
    ("B10", C, HEADS, HIDDEN, B384, "P4a/P4b", ((577, None),)),
    ("B10", C_L, HEADS_L, HIDDEN_L, B, "P5a/P5b", ((197, None), (138, None), (96, None))),
    ("B11", C_L, HEADS_L, HIDDEN_L, B, "P5a/P5b", ((197, 138), (138, 96), (96, 67), (67, 47))),
    ("B11", C_S, HEADS_S, HIDDEN_S, B_S384, "P5d", ((577, 519),)),
    ("B13", C, HEADS, HIDDEN, B384, "P4a/P4b", ((442, 375), (375, 356))),
    ("B14", C, HEADS, HIDDEN, B, "P3b/P3c",
     ((197, 187), (187, 177), (177, 150), (150, 127), (127, 120))),
    ("B14", C_S, HEADS_S, HIDDEN_S, B, "P3d",
     ((197, 177), (177, 159), (159, 143), (143, 128), (128, 115), (115, 103), (103, 92),
      (92, 82))),
    ("B14", C_S, HEADS_S, HIDDEN_S, B_S384, "P5d",
     ((519, 467), (467, 420), (420, 378), (378, 340), (340, 306), (306, 275), (275, 247))),
    ("B15", C, HEADS, HIDDEN, B, "P3b/P3c", ((197, None), (120, None))),
    ("B15", C, HEADS, HIDDEN, B384, "P4a/P4b", ((356, None),)),
    ("B15", C_L, HEADS_L, HIDDEN_L, B, "P5a/P5b", ((67, None), (47, None))),
    ("B15", C_S, HEADS_S, HIDDEN_S, B, "P3d", ((197, None), (82, None))),
    ("B15", C_S, HEADS_S, HIDDEN_S, B_S384, "P5d", ((577, None), (247, None))),
)
# the planted faults of the quantize-on-load proj (kernels/gemm.py:gemm_s8q),
# each in the two-step reference that the gate holds it to
TAIL_FAULTS = ("absmax of the first head's columns only", "scale of the neighbouring row")
# the shapes whose launches are read by device time on both routes, beside
# the first of each TAIL_SHAPES entry: (kernel, n, K)
TAIL_BREAKDOWN = {("B11", 67, 47)}
# the attention each tail took, by (gathered, attention tokens): "register",
# "short-row" or "wgmma body", as the launch counts of B6's body and the
# short-row kernel (counted in csrc/sdpa.cu and csrc/short_attn.cu) read it
TAIL_ROUTES: dict = {}


def tail_call(name, x, qblk, heads, K, scale, sc, qkv=None, keep_idx=None):
    """One call of the int8 tail's entry point ``name`` (B10, B11, B13, B14,
    B15) on x, as a function of ``two_launch``; its output tensor."""
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import wholeblock as wb

    def call(two_launch):
        kw = dict(two_launch=two_launch)
        if name == "B10":
            return kb.fused_attn_block_int8(x, qblk["norm1"], qblk["attn"], None, heads, scale,
                                            1e-6, None if sc is None else sc[:2], **kw)
        if name == "B11":
            return kb.fused_pruned_attn_block_int8(x, qblk["norm1"], qblk["attn"], None, None,
                                                   heads, K - 1, scale, 1e-6, True,
                                                   None if sc is None else sc[:2], **kw)[0]
        if name == "B13":
            return kb.fused_gather_sdpa_proj_residual_int8(
                qkv, keep_idx, x, qblk["attn"]["proj"], None, heads, scale,
                None if sc is None else sc[1], **kw)
        if name == "B14":
            return wb.fused_pruned_block_full_int8(x, qblk, None, heads, K - 1, scale, 1e-6, True,
                                                   sc, **kw)[0]
        return wb.fused_block_full_int8(x, qblk, heads, scale, 1e-6, sc, **kw)
    return call


def proj_ms(fn) -> tuple[float, str]:
    """Device time per call of the int8 tail's proj among fn's launches, and
    which proj that was: the row-band GEMM's proj form ("band") or gemm_s8q
    (the S8Epi I8_RESIDUAL instantiation whose A is bf16 or fp32, not fc2's
    int8 one)."""
    parts = launch_ms(fn)
    band = sum(v for k, v in parts.items() if "band_s8_kernel<1>" in k)
    s8q = sum(v for k, v in parts.items() if "S8Epi<2" in k and "signed char" not in k)
    return band + s8q, "+".join(n for n, v in (("band", band), ("gemm_s8q", s8q)) if v)


def tail_faults(tag, o, qblk, x, res_idx, n, K):
    """The quantize-on-load proj (``gemm_s8q``) on an attention output o
    [M, C] against the two-step route on the card (``quantize_rows``, which
    divides as the kernels do, then ``gemm_s8``), bit for bit, dynamic and
    static, with the residual x gathered through res_idx where given; the
    planted faults TAIL_FAULTS must be rejected."""
    import torch

    from rajni_tpu_torch.kernels import gemm as kg
    from rajni_tpu_torch.kernels.math import quantize_rows, quantize_static

    proj = qblk["attn"]["proj"]
    w, ws, bias = proj["weight"]["int8"], proj["weight"]["scale"].float(), proj["bias"].float()
    gather = {} if res_idx is None else dict(res_idx=res_idx, rows_out=K, rows_in=n)
    res = x if res_idx is not None else x.reshape(o.shape)
    amax = kg.row_absmax_plain(o)
    got = kg.gemm_s8q(o, amax, w, ws, bias, None, res, **gather)
    q, a = quantize_rows(o.float())
    want = kg.gemm_s8(q, w, ws, bias, kg.I8_RESIDUAL, a, res=res, **gather)
    got_s = kg.gemm_s8q(o, None, w, ws, bias, None, res, **gather)
    want_s = kg.gemm_s8(quantize_static(o.float()), w, ws, bias, kg.I8_RESIDUAL, res=res,
                        **gather)
    diff, diff_s = int((got != want).sum()), int((got_s != want_s).sum())
    head = o.float()[:, :64].abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    bad = {TAIL_FAULTS[0]: kg.gemm_s8(torch.clamp(torch.round(o.float() * (
               torch.full_like(head, 127.0) / head)), -127, 127).to(torch.int8), w, ws, bias,
               kg.I8_RESIDUAL, head * (1.0 / 127.0), res=res, **gather),
           TAIL_FAULTS[1]: kg.gemm_s8(q, w, ws, bias, kg.I8_RESIDUAL, torch.roll(a, 1, dims=0),
                                      res=res, **gather)}
    missed = [f for f, b in bad.items() if torch.equal(got, b)]
    print(f"{tag} proj quantized on load ({o.dtype}): {diff} (dynamic) and {diff_s} (static) "
          f"elements differ from quantize_rows + gemm_s8; planted faults "
          + ", ".join(f"'{f}' {'missed' if f in missed else 'rejected'}" for f in bad))
    check(diff == 0 and diff_s == 0, f"{tag}: gemm_s8q differs from the two-step route")
    check(not missed, f"{tag}: the gate missed {missed}")


def tail_phases(device):
    """The int8 tail at every path shape of TAIL_SHAPES, dynamic and static:
    the entry point's route bitwise equal to its two-launch route, both
    timed (CUDA events); the attention each took, from the launch counts of
    B6's body and the short-row kernel, each kernel taking one range of n
    for contiguous and one for gathered tokens, and agreeing with the
    kernels the profiler saw; the launches by device time on each route at the first
    shape of each entry and at TAIL_BREAKDOWN (no row quantizer on B10's,
    B11's and B13's new route); and at one shape of each attention output
    type and residual (B10 bf16, B11 bf16 gathered, B13 fp32 gathered) the
    quantize-on-load proj alone against the two-step route, with the planted
    faults."""
    import torch

    from rajni_tpu_torch.kernels import attention as ka
    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.ops.pruning import select_tokens_dense

    gen = torch.Generator().manual_seed(19)
    blocks = {}
    faulted = set()
    for name, width, heads, hidden, Bt, paths, shapes in TAIL_SHAPES:
        if (width, hidden) not in blocks:
            blk = make_block(gen, device, width, hidden)
            blocks[width, hidden] = (blk, quantized_block(blk))
        blk, qblk = blocks[width, hidden]
        scale = (width // heads) ** -0.5
        for n, K in shapes:
            x = (X_STD * torch.randn(Bt, n, width, generator=gen)).to(device, torch.bfloat16)
            qkv = keep_idx = None
            if name == "B13":
                qkv = kb.ln_qkv_int8_plain(x, qblk["norm1"], qblk["attn"]["qkv"], heads, 1e-6,
                                           False)[0]
                keep_idx, _ = select_tokens_dense(torch.rand(Bt, n, generator=gen).to(device),
                                                  K - 1, torch.bool)
            for static in (False, True):
                sc = block_act_scales(blk, x, heads) if static else None
                if name == "B13" and static:  # B12's qkv with the V-fold, as B13 reads it
                    qkv = kb.ln_qkv_int8_plain(x, qblk["norm1"], qblk["attn"]["qkv"], heads,
                                               1e-6, False, sc[:2])[0]
                call = tail_call(name, x, attached(qblk, sc), heads, K or n, scale, sc, qkv,
                                 keep_idx)
                tag = (f"int8 tail {name} ({paths}) B={Bt} N={n}" + (f" K={K}" if K else "")
                       + f" C={width} {'static' if static else 'dynamic'}")
                new, two = call(False), call(True)
                diff = int((new != two).sum())
                check(bool(torch.isfinite(new.float()).all()), f"{tag}: output not finite")
                ms_new, ms_two = cuda_ms(lambda: call(False)), cuda_ms(lambda: call(True))
                print(f"{tag}: {diff} of {new.numel()} elements differ from the two-launch route "
                      f"| {ms_new:.3f} ms | two-launch {ms_two:.3f} ms")
                check(diff == 0, f"{tag}: the tail differs from its two-launch route ({diff})")
                # the proj the route took: the band for B10's and B11's bf16
                # output, gemm_s8q for B13-B15's fp32 one; dynamic, by device time
                if not static:
                    pt, took_proj = proj_ms(lambda: call(False))
                    want_proj = "band" if name in ("B10", "B11") else "gemm_s8q"
                    print(f"{tag}: proj on {took_proj}, {pt:.4f} ms (device time)")
                    check(took_proj == want_proj,
                          f"{tag}: the proj ran on {took_proj!r}, not on {want_proj!r}")
                gathered = name in ("B11", "B13", "B14")
                ka.SDPA_KERNEL.launches = ka.SHORT_KERNEL.launches = 0
                call(False)
                torch.cuda.synchronize()
                body, short = ka.SDPA_KERNEL.launches, ka.SHORT_KERNEL.launches
                check(body in (0, 1) and short in (0, 1) and body + short <= 1,
                      f"{tag}: B6's body launched {body} times, the short-row kernel {short}")
                took = "wgmma body" if body else "short-row" if short else "register"
                check(TAIL_ROUTES.setdefault((gathered, K or n), took) == took,
                      f"{tag}: the attention took another kernel than at the same n before")
                if (n, K) == shapes[0] or (name, n, K) in TAIL_BREAKDOWN:
                    for route, fn in (("new", lambda: call(False)),
                                      ("two-launch", lambda: call(True))):
                        parts = {kernel_name(k): v for k, v in launch_ms(fn).items()}
                        if (any("sdpa_wgmma" in k for k in parts) != bool(body)
                                or any("short_attn" in k for k in parts) != bool(short)):
                            # a trace can drop a kernel's records (one kept only
                            # ln_quant_kernel's of B11's seven kernels at 67→47):
                            # trace again; a disagreement that repeats fails below
                            print(f"{tag} {route}: the trace disagrees with the counts "
                                  f"({sorted(parts)}); traced again")
                            parts = {kernel_name(k): v for k, v in launch_ms(fn).items()}
                        print(f"{tag} {route} route: {sum(parts.values()):.3f} ms ("
                              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                              + ") (device time)")
                        check(any("sdpa_wgmma" in k for k in parts) == bool(body),
                              f"{tag} {route}: B6's count {body} disagrees with the kernels run")
                        check(any("short_attn" in k for k in parts) == bool(short),
                              f"{tag} {route}: the short-row count {short} disagrees with the "
                              "kernels run")
                        if route == "new" and name in ("B10", "B11", "B13"):
                            check(not any("quant_rows" in k for k in parts),
                                  f"{tag}: the new route launched the row quantizer")
            if name in ("B10", "B11", "B13") and name not in faulted:
                faulted.add(name)
                o32 = kb._mha(qkv if name == "B13" else kb.ln_qkv_plain(
                    x, blk["norm1"], blk["attn"]["qkv"], heads, 1e-6, False)[0], heads, scale,
                    torch.float32)
                res_idx = None
                if name != "B10":
                    idx, _ = select_tokens_dense(torch.rand(Bt, n, generator=gen).to(device),
                                                 K - 1, torch.bool)
                    o32 = torch.take_along_dim(o32, idx[..., None], dim=1)
                    res_idx = idx.to(torch.int32).reshape(-1).contiguous()
                o = o32 if name == "B13" else o32.to(torch.bfloat16)
                tail_faults(f"int8 tail {name} B={Bt} N={n} C={width}",
                            o.reshape(-1, width).contiguous(), qblk, x, res_idx, n, K or n)
    for gathered in (False, True):
        seq = [r for (g, n), r in sorted(TAIL_ROUTES.items()) if g == gathered]
        kind = "gathered" if gathered else "contiguous"
        print(f"int8 tails, {kind} tokens: " + "; ".join(
            f"the {r} kernel at n = "
            + str(sorted(n for (g, n), t in TAIL_ROUTES.items() if g == gathered and t == r))
            for r in dict.fromkeys(seq)) + " (the kernels' launch counts)")
        runs = [r for i, r in enumerate(seq) if i == 0 or seq[i - 1] != r]
        check(len(runs) == len(set(runs)),
              f"int8 tails ({kind}): an attention kernel takes more than one range of n")


# The row-band GEMM (csrc/band_s8.cuh) beside the route each path takes: B12's
# head at P4a/P4b's five shapes (B=128, C=768) and B11's head and proj at
# P5a/P5b's four (B=256, C=1024) and P5d's (B=128, C=384), dynamic and static
BAND_B12 = (577, 548, 520, 442, 375)
BAND_B11 = ((C_L, HEADS_L, HIDDEN_L, B, "P5a/P5b", ((197, 138), (138, 96), (96, 67), (67, 47))),
            (C_S, HEADS_S, HIDDEN_S, B_S384, "P5d", ((577, 519),)))
# the faults each band gate must reject, planted in the reference it is held to
BAND_FAULTS = ("LN summed in another order", "proj's A quantized with the neighbouring row's absmax")
# the two-kernel route's selection (csrc/select.cu) at P4a/P4b's pruned blocks
SELECT_SHAPES = ((577, 548), (548, 520), (520, 442), (442, 375), (375, 356))


def parts_ms(fn) -> tuple[float, str]:
    """Device time per call of fn's launches (:func:`launch_ms`), summed,
    and the launches one by one."""
    parts = {kernel_name(k): v for k, v in launch_ms(fn).items()}
    return sum(parts.values()), ", ".join(f"{k[:48]} {v:.4f}" for k, v in parts.items())


def differ(a, b) -> int:
    return int((a != b).sum())


def band_phases(device, peaks, int8_peak, results):
    """The row-band GEMM against the routes the paths take, bit for bit,
    with both routes' launches by device time: B12's band head (qkv, scores
    and the LN rows' scales) against its route at BAND_B12, B11's band head
    against its route (proj on the band in both) and its two-launch route
    at BAND_B11, and the band proj alone against gemm_s8q (gathered). Each
    gate rejects its BAND_FAULTS entry. Then the two-kernel route's
    selection against select_tokens_dense, exactly, with planted ties, timed
    (SELECT_SHAPES); and the static operands folded once when the scales are
    attached (quant.attach_act_scales) against the per-call fold, bit for
    bit, with no fold on the wrappers' calls."""
    import torch

    from rajni_tpu_torch.kernels import block as kb
    from rajni_tpu_torch.kernels import gemm as kg
    from rajni_tpu_torch.ops.pruning import select_tokens_dense
    from rajni_tpu_torch.quant import ActScales, attach_act_scales

    gen = torch.Generator().manual_seed(21)
    blk = make_block(gen, device)
    qblk = quantized_block(blk)
    for static in (False, True):
        mode = "static" if static else "dynamic"
        for n in BAND_B12:
            x = (X_STD * torch.randn(B384, n, C, generator=gen)).to(device, torch.bfloat16)
            sc = block_act_scales(blk, x, HEADS)[:2] if static else None
            for ws in (True, False):
                ab = attached(qblk, sc)
                args = (x, ab["norm1"], ab["attn"]["qkv"], HEADS, 1e-6, ws, sc)
                band, route = kb.launch_ln_qkv_int8(*args, True), kb.launch_ln_qkv_int8(*args, False)
                torch.cuda.synchronize()
                d = [differ(band[0], route[0]), differ(band[1], route[1]),
                     0 if static else differ(band[2], route[2])]
                tag = f"band B12 (P4a/P4b) B={B384} N={n} C={C} {mode} with_scores={ws}"
                times = ""
                if ws or n == BAND_B12[0]:  # without scores: the memset for the score kernel
                    t_band, p_band = parts_ms(lambda: kb.launch_ln_qkv_int8(*args, True))
                    t_route, p_route = parts_ms(lambda: kb.launch_ln_qkv_int8(*args, False))
                    times = (f" | band {t_band:.4f} ms ({p_band}) | route {t_route:.4f} ms "
                             f"({p_route}) (device time) | events band "
                             f"{cuda_ms(lambda: kb.launch_ln_qkv_int8(*args, True)):.4f}, route "
                             f"{cuda_ms(lambda: kb.launch_ln_qkv_int8(*args, False)):.4f} ms")
                print(f"{tag}: qkv {d[0]}, scores {d[1]}, row scales {d[2]} differ from the "
                      f"route's{times}")
                check(d == [0, 0, 0], f"{tag}: the band head differs from the route's")
            if n == BAND_B12[0]:
                with ln_float32():
                    bad = kb.ln_qkv_int8_plain(x, qblk["norm1"], qblk["attn"]["qkv"], HEADS,
                                               1e-6, False, sc)[0]
                missed = torch.equal(band[0], bad)
                print(f"band B12 N={n} {mode}: planted fault '{BAND_FAULTS[0]}' "
                      f"{'missed' if missed else 'rejected'} ({differ(band[0], bad)} differ)")
                check(not missed, f"band B12: the gate missed '{BAND_FAULTS[0]}'")

    for width, heads, hidden, Bt, paths, shapes in BAND_B11:
        blk = make_block(gen, device, width, hidden)
        qblk = quantized_block(blk)
        scale = (width // heads) ** -0.5
        for n, K in shapes:
            x = (X_STD * torch.randn(Bt, n, width, generator=gen)).to(device, torch.bfloat16)
            for static in (False, True):
                sc = block_act_scales(blk, x, heads)[:2] if static else None
                ab = attached(qblk, sc)

                def call(band, two_launch=False):
                    return kb.fused_pruned_attn_block_int8(
                        x, ab["norm1"], ab["attn"], None, None, heads, K - 1, scale, 1e-6,
                        True, sc, two_launch=two_launch, band=band)
                got, route, two = call(True), call(False), call(False, True)
                torch.cuda.synchronize()
                d = [differ(got[0], route[0]), differ(got[0], two[0]), differ(got[2], route[2]),
                     differ(got[1], route[1])]
                tag = (f"band B11 ({paths}) B={Bt} N={n} K={K} C={width} "
                       f"{'static' if static else 'dynamic'}")
                t_band, p_band = parts_ms(lambda: call(True))
                t_route, p_route = parts_ms(lambda: call(False))
                print(f"{tag}: out {d[0]} (vs two-launch {d[1]}), kept {d[2]}, next_scores {d[3]} "
                      f"differ | band {t_band:.4f} ms ({p_band}) | route {t_route:.4f} ms "
                      f"({p_route}) (device time) | events band {cuda_ms(lambda: call(True)):.4f}"
                      f", route {cuda_ms(lambda: call(False)):.4f} ms")
                check(d == [0, 0, 0, 0], f"{tag}: the band route differs from the route's")
            # the band proj alone against gemm_s8q, gathered; the planted fault
            # at each width's first shape
            proj = qblk["attn"]["proj"]
            w, wsc, bias = (proj["weight"]["int8"], proj["weight"]["scale"].float(),
                            proj["bias"].float())
            o = kb._mha(kb.ln_qkv_plain(x, blk["norm1"], blk["attn"]["qkv"], heads, 1e-6,
                                        False)[0], heads, scale, torch.bfloat16)
            idx, _ = select_tokens_dense(torch.rand(Bt, n, generator=gen).to(device), K - 1,
                                         torch.bool)
            o = torch.take_along_dim(o, idx[..., None], dim=1).reshape(-1, width).contiguous()
            res_idx = idx.to(torch.int32).reshape(-1).contiguous()
            amax = kg.row_absmax_plain(o)
            for a in (amax, None):
                pa = (o, a, w, wsc, bias, None, x, res_idx, K, n)
                band, ref = kg.band_proj(*pa), kg.gemm_s8q(*pa)
                t_band, t_ref = parts_ms(lambda: kg.band_proj(*pa))[0], parts_ms(
                    lambda: kg.gemm_s8q(*pa))[0]
                tag = f"band proj B={Bt} K={K} C={width} {'dynamic' if a is not None else 'static'}"
                print(f"{tag}: {differ(band, ref)} differ from gemm_s8q | band {t_band:.4f} ms | "
                      f"gemm_s8q {t_ref:.4f} ms (device time)")
                check(differ(band, ref) == 0, f"{tag}: differs from gemm_s8q")
                if a is not None and (n, K) == shapes[0]:
                    bad = kg.gemm_s8q_plain(o, torch.roll(a, 1, dims=0), w, wsc, bias, None, x,
                                            res_idx, K, n)
                    missed = torch.equal(band, bad)
                    print(f"{tag}: planted fault '{BAND_FAULTS[1]}' "
                          f"{'missed' if missed else 'rejected'} ({differ(band, bad)} differ)")
                    check(not missed, f"band proj: the gate missed '{BAND_FAULTS[1]}'")

    # the two-kernel route's selection, exact, with planted ties
    for n, K in SELECT_SHAPES:
        s = torch.rand(B384, n, generator=gen)
        order = torch.argsort(s[:, 1:], dim=1, descending=True) + 1
        edge = order[:, K - 3:K + 1]  # a tie across the keep boundary
        s.scatter_(1, edge, s.gather(1, order[:, K - 2:K - 1]).expand_as(edge))
        s[:, 0] = s.min()  # CLS kept by the forcing alone
        s = s.to(device)
        got, want = kb.select_kept(s, K - 1), kb.select_kept_plain(s, K - 1)
        torch.cuda.synchronize()
        exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ms, plain_ms = cuda_ms(lambda: kb.select_kept(s, K - 1)), cuda_ms(
            lambda: kb.select_kept_plain(s, K - 1))
        print(f"select_kept B={B384} N={n} K={K}: kept indices and next_scores "
              f"{'exact' if exact else 'DIFFER'} | kernel {ms:.4f} ms | plain (torch) "
              f"{plain_ms:.4f} ms")
        check(exact, f"select_kept N={n}: differs from select_tokens_dense")
        # the bound: the function's bytes (scores in; indices and scores out).
        # A top-K with ties to the lower index needs O(N log N) work an image,
        # far under the bytes' time, so the kernel's N² comparisons (its
        # algorithm, not the function) do not enter it
        t_bytes = (B384 * n * 4 + B384 * K * (8 + 4)) / (peaks[1] * 1e12) * 1e3
        record(results, "select_kept", P4A, f"B={B384} N={n} K={K}", ms, plain_ms,
               (t_bytes, "bytes"), 0.0, 0.0)

    # the static operands, folded once when the scales are attached
    calls = []
    sound = {name: getattr(kb, name) for name in ("fold_static_attn", "_int8_proj_operands")}

    def spy(name):
        def fn(*a):
            if a[-1] is not None:  # _int8_proj_operands folds only a static a_proj
                calls.append(name)
            return sound[name](*a)
        return fn

    for width, hidden, heads, n in ((C, HIDDEN, HEADS, 577), (C_L, HIDDEN_L, HEADS_L, 67)):
        blk = make_block(gen, device, width, hidden)
        qblk = quantized_block(blk)
        x = (X_STD * torch.randn(8, n, width, generator=gen)).to(device, torch.bfloat16)
        sc = block_act_scales(blk, x, heads)
        ablk = attach_act_scales({"blocks": [qblk]}, ActScales((tuple(sc),), 1.0))["blocks"][0]
        once = kb.attn_operands(ablk["norm1"], ablk["attn"], sc[:2])
        each = kb.int8_attn_operands(qblk["norm1"], qblk["attn"], sc[:2])
        pronce = kb.proj_operands(ablk["attn"]["proj"], sc[1])
        preach = kb._int8_proj_operands(qblk["attn"]["proj"], sc[1])
        d = sum(differ(once[k], each[k]) for k in each) + sum(
            differ(pronce[k], preach[k]) for k in preach)
        scale = (width // heads) ** -0.5
        idx = torch.arange(n - 10, device=device).expand(8, -1).contiguous()
        qkv = kb.ln_qkv_int8_plain(x, qblk["norm1"], qblk["attn"]["qkv"], heads, 1e-6, False,
                                   sc[:2])[0]
        runs = {"B10": lambda p: kb.fused_attn_block_int8(x, p["norm1"], p["attn"], None, heads,
                                                          scale, 1e-6, sc[:2]),
                "B11": lambda p: kb.fused_pruned_attn_block_int8(
                    x, p["norm1"], p["attn"], None, None, heads, n - 11, scale, 1e-6, True,
                    sc[:2])[0],
                "B12": lambda p: kb.fused_ln_qkv_int8(x, p["norm1"], p["attn"]["qkv"], heads,
                                                      1e-6, True, sc[:2])[0],
                "B13": lambda p: kb.fused_gather_sdpa_proj_residual_int8(
                    qkv, idx, x, p["attn"]["proj"], None, heads, scale, sc[1])}
        per_call = {name: run(qblk) for name, run in runs.items()}  # folds on each call
        for name in sound:
            setattr(kb, name, spy(name))
        try:
            got = {name: run(ablk) for name, run in runs.items()}
        finally:
            for name, fn in sound.items():
                setattr(kb, name, fn)
        torch.cuda.synchronize()
        d_out = {name: differ(got[name], per_call[name]) for name in runs}
        print(f"static operands C={width}: attached once, {d} values differ from the per-call "
              f"fold; folds in the calls of B10, B11, B12, B13 on the attached params: "
              f"{len(calls)}; outputs differing from the calls that fold: {d_out}")
        check(d == 0, f"C={width}: the operands attached once differ from the per-call fold")
        check(not calls, f"C={width}: the static wrappers folded on the call: {calls}")
        check(not any(d_out.values()), f"C={width}: attached operands change an output: {d_out}")


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


def first_step(device, path=TRAIN) -> dict:
    """A training path's first step (``TRAIN_PATHS[path]``: T6, ViT-B/16 224
    at batch 128 through ``REFERENCE_SCHEDULE``; T14, ViT-H/14 at batch 64
    through VIT_H_PROBE), bf16 params: loss and gradients through the kernels
    against (1) the same path with the kernels' plain versions on the card,
    (2) the torch-autograd route (``vit_forward(..., "torch")``, its own
    rounding points), and (3) at T6, the plain route with each planted fault
    of ``TRAIN_FAULTS``, which is printed only: over twelve bf16 blocks the
    sound reading is as large as a fault's (:func:`train_block_ops` holds
    them). (1)-(3) take the kernel route's kept sets; each reports how its own
    selection departs from them. Returns the readings; prints them."""
    import torch

    from rajni_tpu_torch import train as tt
    from rajni_tpu_torch.models import train_path as tp
    from rajni_tpu_torch.models import vit as tvit
    from rajni_tpu_torch.ops import attention as oa

    spec = TRAIN_PATHS[path]
    config, schedule, batch = path_config(spec["model"]), train_schedule(path), spec["batch"]
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(batch, config.img_size, config.img_size, 3, generator=gen).to(device)
    labels = torch.randint(0, config.num_classes, (batch,), generator=gen).to(device)
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
        return tp.vit_forward_train(params, images, config, schedule,
                                    _sel_tap=lambda i, k: blocks.setdefault(i))

    loss_k, grads_k = run(train_forward, sel.record())

    def versus(tag, forward, subs, report):
        loss, grads = run(forward, subs)
        rels = [rel_l2(a, b) for a, b in zip(grads_k, grads)]
        worst = max(range(len(rels)), key=rels.__getitem__)
        print(f"{path}: first step, kernels against {tag}: loss {loss_k:.6f} vs {loss:.6f}; "
              f"gradient rel L2 median {statistics.median(rels):.3e}, worst {rels[worst]:.3e} "
              f"(leaf {worst} of {len(rels)})")
        print(f"{path}: {tag}, {GAP_HEAD}, by block: {gap_line(report, list(blocks))}")
        return {"loss": abs(loss - loss_k), "worst": rels[worst], "sel": report}

    def torch_forward():
        sound = oa.select_tokens
        oa.select_tokens = sel.forced(torch_report)
        try:
            return tvit.vit_forward(params, images, config, schedule, "torch")
        finally:
            oa.select_tokens = sound

    readings = {"calls": len(sel.kept)}
    report: dict = {}
    readings["plain"] = versus("their plain versions", train_forward,
                               {**plain_train_kernels(), **sel.forced_dense(report)}, report)
    torch_report: dict = {}
    readings["torch"] = versus("the torch-autograd route", torch_forward, {}, torch_report)
    for fault, subs in (TRAIN_FAULTS.items() if spec["faults"] else ()):
        report = {}
        versus(f"the plain versions with '{fault}' (printed only)", train_forward,
               {**plain_train_kernels(), **subs(), **sel.forced_dense(report)}, report)
    for p in leaves:
        p.requires_grad_(False)
    return readings


def train_schedule(path):
    """The pruned schedule of ``TRAIN_PATHS[path]``."""
    from rajni_tpu_torch import REFERENCE_SCHEDULE

    schedules = {"reference": REFERENCE_SCHEDULE, "vit_h": VIT_H_SCHEDULE, "c5": C5_SCHEDULE}
    return schedules[TRAIN_PATHS[path]["schedule"]]


def path_config(model):
    """A path's config: a model name, or the fields of a ``ViTConfig``."""
    from rajni_tpu_torch.models import vit as tvit

    return tvit.get_config(model) if isinstance(model, str) else tvit.ViTConfig(**model)


@contextlib.contextmanager
def selection_calls(counter: dict):
    """Count the training path's selections (``select_tokens_dense``, torch's:
    no kernel of its own, as JAX selects outside Pallas) in ``counter["n"]``."""
    from rajni_tpu_torch.models import train_path as tp

    dense = tp.select_tokens_dense

    def select(*args, **kw):
        counter["n"] += 1
        return dense(*args, **kw)

    with train_path_swapped({"select_tokens_dense": select}):
        yield


def checked_first_step(device, path) -> None:
    """:func:`first_step` of ``path``, held to its gates: each selection
    either route would make otherwise within its score discrepancy, the
    selections' score discrepancy, the share of images the torch route would
    select otherwise, and the loss and worst gradient against the plain
    versions and the torch-autograd route."""
    spec = TRAIN_PATHS[path]
    r = first_step(device, path)
    for tag in ("plain", "torch"):
        check_gaps(f"{path} first step, {tag}", r[tag]["sel"], r["calls"])
    for i, g in r["plain"]["sel"].items():
        check(g["delta_rel"] <= spec["score_rel"],
              f"{path} selection {i}: scores vs their plain versions' {g['delta_rel']} > "
              f"{spec['score_rel']}")
    worst_sel = max(g["images"] for g in r["torch"]["sel"].values()) / spec["batch"]
    check(worst_sel <= TRAIN_SEL_DIFF,
          f"{path}: {worst_sel:.3f} of the images select otherwise than the torch route (> "
          f"{TRAIN_SEL_DIFF})")
    for tag, (loss_atol, grad_gate) in (("plain", (spec["plain_loss"], TRAIN_PLAIN_GRAD_REL_L2)),
                                        ("torch", (TRAIN_LOSS_ATOL, TRAIN_GRAD_REL_L2))):
        check(r[tag]["loss"] <= loss_atol, f"{path} first-step loss vs {tag}: "
              f"{r[tag]['loss']} > {loss_atol}")
        check(r[tag]["worst"] <= grad_gate, f"{path} gradient rel L2 vs {tag}: "
              f"{r[tag]['worst']} > {grad_gate}")


def step_launches(device, results, counters, path, fresh_params, images, labels) -> dict:
    """Each schedule of ``path`` (``TRAIN_PATHS[path]["launches"]``): the
    launches and selections of one train step on fresh params (every count
    set to 0 first), held to the expected ones, then ``steps - 1`` more
    steps; returns each schedule's losses."""
    import torch

    from rajni_tpu_torch import train as tt

    spec = TRAIN_PATHS[path]
    config, steps = path_config(spec["model"]), spec["steps"]
    scheds = {"pruned": train_schedule(path), "identity": None}
    losses = {}
    for sched, expected in spec["launches"].items():
        tx = tt.build_optimizer(1e-4, steps, 0.05)
        state = tt.create_train_state(fresh_params(), tx)
        step = tt.make_train_step(config, scheds[sched], tx, impl="cuda")
        for k in counters.values():
            k.launches = 0
        selections = {"n": 0}
        with selection_calls(selections):
            run = [step(state, images, labels)["loss"]]
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in counters.items()}
        print(f"{path}: launches per {sched} train step: { {n: v for n, v in got.items() if v} }; "
              f"selections {selections['n']}")
        check(got == expected, f"{path} {sched} launches {got} != {expected}")
        want_sel = sum(1 for s in (scheds[sched] or {}).values() if s)
        check(selections["n"] == want_sel,
              f"{path} {sched}: {selections['n']} selections, not {want_sel}")
        if sched == "pruned":
            for n, v in got.items():
                if (n, path) in results:
                    results[(n, path)]["launches"] = v
        run += [step(state, images, labels)["loss"] for _ in range(steps - 1)]
        losses[sched] = [float(l) for l in run]
        del state, step
    return losses


def train_end_to_end(device, device_name, results, counters, path=TRAIN):
    """A training path (``TRAIN_PATHS[path]``), bf16 params, pruned and
    identity: the first step's loss and gradients through the kernels
    against their plain versions and against the torch-autograd route on the
    card (:func:`first_step`), the launches of one step and its selections
    (every count set to 0 first), the loss over a few steps on one fixed
    batch, and train img/s with ``train_mfu`` for both routes."""
    import torch

    from rajni_tpu_torch import train as tt
    from rajni_tpu_torch.models import vit as tvit
    from rajni_tpu_torch.utils.flops import train_mfu
    from rajni_tpu_torch.utils.timing import measure_throughput

    spec = TRAIN_PATHS[path]
    config, batch = path_config(spec["model"]), spec["batch"]
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(batch, config.img_size, config.img_size, 3, generator=gen).to(device)
    labels = torch.randint(0, config.num_classes, (batch,), generator=gen).to(device)
    scheds = {"pruned": train_schedule(path), "identity": None}

    def fresh_params():
        return tvit.init_params(torch.Generator().manual_seed(0), config, torch.bfloat16, device)

    checked_first_step(device, path)
    losses = step_launches(device, results, counters, path, fresh_params, images, labels)
    for sched in scheds:  # the loss over a few steps on one batch
        print(f"{path} {sched}: loss over {len(losses[sched])} steps on one batch "
              f"{losses[sched][0]:.4f} -> {losses[sched][-1]:.4f}")
        check(all(math.isfinite(l) for l in losses[sched]) and losses[sched][-1] < losses[sched][0],
              f"{path} {sched}: the loss did not fall: {losses[sched]}")

    iters, repeats = spec["timing"]
    for sched, schedule in scheds.items():  # scripts/bench_train.py's protocol
        trace = tvit.model_stats(config, schedule)["token_counts"]
        for impl in ("cuda", "torch"):
            tx = tt.build_optimizer(1e-4, 100, 0.05)
            state = tt.create_train_state(fresh_params(), tx)
            step = tt.make_train_step(config, schedule, tx, impl=impl)
            ips = measure_throughput(step, state, images, labels, batch=batch, device=device,
                                     iters=iters, warmup=2, repeats=repeats)
            print(f"{path} train img/s {sched} kernels={impl}: {ips:.1f} | "
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
           "train_ln_mlp", "train_sdpa_bwd", "short_attention", "select_kept")
# the training path: B16 in every stock block, B4 + B5 in every pruned
# block, B17 and B18 in every block; no inference kernel. The attention of
# B16 and B5 (at most 197 tokens) is the short-row kernel
TRAIN_LAUNCHES = {
    "pruned": launches(train_attn_block=7, fused_ln_qkv=5, fused_gather_sdpa_proj_residual=5,
                       train_ln_mlp=12, train_sdpa_bwd=12, short_attention=12),
    "identity": launches(train_attn_block=12, train_ln_mlp=12, train_sdpa_bwd=12,
                         short_attention=12)}
# T14: B16 in the 28 stock blocks (B6's body inside it at 257 tokens, blocks
# 0-4; the short-row kernel at 180 to 61), B4 + selection + B5 in blocks 5,
# 10, 15 and 20 (the short-row kernel, 180 to 61 kept), B17 and B18 in all 32
# (B18 two launches a call at 257 tokens: five calls pruned, 32 identity)
TRAIN_H_LAUNCHES = {
    "pruned": launches(train_attn_block=28, fused_ln_qkv=4, fused_gather_sdpa_proj_residual=4,
                       train_ln_mlp=32, train_sdpa_bwd=32, fused_sdpa=5, short_attention=27),
    "identity": launches(train_attn_block=32, train_ln_mlp=32, train_sdpa_bwd=32, fused_sdpa=32)}
# The training paths: model, batch, schedule, launches per step, steps of the
# falling-loss check, (iters, repeats) of the img/s timing, whether the first
# step also runs the printed-only planted faults, and its limits on the loss
# against the plain versions and on the selections' score discrepancy
TRAIN_PATHS = {
    TRAIN: dict(model=PATH224, batch=B_TRAIN, schedule="reference", launches=TRAIN_LAUNCHES,
                steps=20, timing=(10, 3), faults=True, plain_loss=TRAIN_PLAIN_LOSS_ATOL,
                score_rel=TRAIN_SCORE_REL),
    TRAIN_H: dict(model=PATH_H, batch=B_TRAIN_H, schedule="vit_h", launches=TRAIN_H_LAUNCHES,
                  steps=8, timing=(5, 2), faults=False, plain_loss=TRAIN_H_PLAIN_LOSS_ATOL,
                  score_rel=TRAIN_H_SCORE_REL),
    # one pruned step: B16 in the five stock blocks, B4 + selection + B5 in
    # blocks 3-5, B17 and B18 in all 8, the short-row kernel in B16 and B5
    TRAIN_C5: dict(model=C5_MODEL, batch=B_C5, schedule="c5",
                   launches={"pruned": launches(train_attn_block=5, fused_ln_qkv=3,
                                                fused_gather_sdpa_proj_residual=3,
                                                train_ln_mlp=8, train_sdpa_bwd=8,
                                                short_attention=8)},
                   steps=1, faults=False, plain_loss=TRAIN_PLAIN_LOSS_ATOL,
                   score_rel=TRAIN_SCORE_REL),
}
C5_COUNTS = [197] * 4 + [177, 159, 143, 143]
# K1 in the pruned blocks 3-5, K2 + K3 in the stock ones, the short-row
# kernel in every attention (at most 197 tokens)
C5_LAUNCHES = {"pruned": launches(fused_pruned_attn_block=3, fused_attn_block=5,
                                  fused_ln_mlp_residual=8, short_attention=8),
               "identity": launches(fused_attn_block=8, fused_ln_mlp_residual=8,
                                    short_attention=8)}
VIT_B384_COUNTS = [577, 577, 577, 577, 548, 520, 442, 375, 356, 356, 356, 356]
VIT_B_COUNTS = [197, 197, 197, 197, 187, 177, 150, 127, 120, 120, 120, 120]
DEIT_S_COUNTS = [197, 197, 197, 197, 177, 159, 143, 128, 115, 103, 92, 82]
VIT_L_COUNTS = [197] * 5 + [138] * 4 + [96] * 4 + [67] * 4 + [47] * 7
DEIT_S384_COUNTS = [577, 577, 577, 577, 519, 467, 420, 378, 340, 306, 275, 247]
VIT_H_COUNTS = [257] * 6 + [180] * 5 + [126] * 5 + [88] * 5 + [61] * 11
# ViT-L/16 int8: the pruned blocks 4, 8, 12, 16 take B11 + B9; the stock
# blocks at 197, 138 and 96 tokens B10 + B9 (no whole-block plan), at 67 and
# 47 tokens B15. Every attention up to 256 tokens (csrc/common.cuh:
# SHORT_ATTN_MAX_N), here all of them, takes the short-row kernel
VIT_L_INT8_LAUNCHES = {
    "pruned": launches(fused_pruned_attn_block_int8=4, fused_attn_block_int8=10,
                       fused_ln_mlp_residual_int8=14, fused_block_full_int8=10,
                       short_attention=24),
    "identity": launches(fused_attn_block_int8=24, fused_ln_mlp_residual_int8=24,
                         short_attention=24)}
# ViT-B/16 224 int8: B15's tail at 197 and 120 tokens and B14's kept tokens
# (187-120) on the short-row kernel
INT8_LAUNCHES = {"pruned": launches(fused_pruned_block_full_int8=5, fused_block_full_int8=7,
                                    short_attention=12),
                 "identity": launches(fused_block_full_int8=12, short_attention=12)}
INT8_384_LAUNCHES = {
    "pruned": launches(fused_attn_block_int8=3, fused_ln_mlp_residual_int8=8, fused_ln_qkv_int8=5,
                       fused_gather_sdpa_proj_residual=3, fused_gather_sdpa_proj_residual_int8=2,
                       fused_block_full_int8=4, fused_sdpa=12, select_kept=5),
    "identity": launches(fused_attn_block_int8=12, fused_ln_mlp_residual_int8=12, fused_sdpa=12)}
VIT_H_INT8_LAUNCHES = {
    "pruned": launches(fused_attn_block_int8=28, fused_ln_mlp_residual_int8=32,
                       fused_ln_qkv_int8=4, select_kept=4, fused_gather_sdpa_proj_residual_int8=4,
                       fused_sdpa=5, short_attention=27),
    "identity": launches(fused_attn_block_int8=32, fused_ln_mlp_residual_int8=32, fused_sdpa=32)}
PATHS = {
    PATH224: dict(
        model=PATH224, quant=None, batch=B, img=224, schedule="reference", counts=VIT_B_COUNTS,
        launches={
            "pruned": launches(fused_pruned_attn_block=5, fused_attn_block=7,
                               fused_ln_mlp_residual=12, short_attention=12),
            "identity": launches(fused_attn_block=12, fused_ln_mlp_residual=12,
                                 short_attention=12)}),
    # every block runs past ATTN_MAX_N tokens: B6's two-pass kernel is the
    # attention inside each K2 (7) and each B5 (5)
    PATH384: dict(
        model=PATH384, quant=None, batch=B384, img=384, schedule="reference",
        counts=VIT_B384_COUNTS,
        launches={
            "pruned": launches(fused_attn_block=7, fused_ln_mlp_residual=12, fused_ln_qkv=5,
                               fused_gather_sdpa_proj_residual=5, fused_sdpa=12, select_kept=5),
            "identity": launches(fused_attn_block=12, fused_ln_mlp_residual=12, fused_sdpa=12)}),
    # the whole-block paths: no K1, K2 or K3 launch
    P3A: dict(
        model=DEIT_S, quant=None, batch=B, img=224, schedule="deit", counts=DEIT_S_COUNTS,
        launches={"pruned": launches(fused_pruned_block_full=8, fused_attn_mlp_block=4,
                                     short_attention=12),
                  "identity": launches(fused_attn_mlp_block=12, short_attention=12)}),
    P3B: dict(model=PATH224, quant="dynamic", batch=B, img=224, schedule="reference",
              counts=VIT_B_COUNTS, launches=INT8_LAUNCHES),
    P3C: dict(model=PATH224, quant="static", batch=B, img=224, schedule="reference",
              counts=VIT_B_COUNTS, launches=INT8_LAUNCHES),
    # the short-row kernel in every int8 tail (B15 at 197 and 82 tokens, B14
    # at 177 down to 82 kept tokens)
    P3D: dict(
        model=DEIT_S, quant="dynamic", batch=B, img=224, schedule="deit", counts=DEIT_S_COUNTS,
        launches={"pruned": launches(fused_pruned_block_full_int8=8, fused_block_full_int8=4,
                                     short_attention=12),
                  "identity": launches(fused_block_full_int8=12, short_attention=12)}),
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
                                     fused_ln_mlp_residual_int8=12, short_attention=12),
                  "identity": launches(fused_attn_block=12, fused_ln_mlp_residual_int8=12,
                                       short_attention=12)}),
    P5A: dict(model=PATH_L, quant="dynamic", batch=B, img=224, schedule="vit_l",
              counts=VIT_L_COUNTS, launches=VIT_L_INT8_LAUNCHES),
    P5B: dict(model=PATH_L, quant="static", batch=B, img=224, schedule="vit_l",
              counts=VIT_L_COUNTS, launches=VIT_L_INT8_LAUNCHES),
    P5C: dict(
        model=PATH_L, quant=None, batch=B, img=224, schedule="vit_l", counts=VIT_L_COUNTS,
        launches={"pruned": launches(fused_pruned_attn_block=4, fused_attn_block=20,
                                     fused_ln_mlp_residual=24, short_attention=24),
                  "identity": launches(fused_attn_block=24, fused_ln_mlp_residual=24,
                                       short_attention=24)}),
    # DeiT-S/16 384 int8: blocks 0-2 B15 at 577 tokens, block 3 B11 + B9
    # (577→519), blocks 4-10 B14 (519→247), block 11 B15 at 247; B6's kernel
    # past 256 tokens in B15 (3), B11 (1) and B14 (6), the short-row kernel at
    # 247 in B14 (275→247) and B15
    P5D: dict(
        model=DEIT_S384, quant="dynamic", batch=B_S384, img=384, schedule="deit",
        counts=DEIT_S384_COUNTS,
        launches={"pruned": launches(fused_pruned_attn_block_int8=1,
                                     fused_ln_mlp_residual_int8=1,
                                     fused_pruned_block_full_int8=7, fused_block_full_int8=4,
                                     fused_sdpa=10, short_attention=2),
                  "identity": launches(fused_block_full_int8=12, fused_sdpa=12)}),
    # ViT-H/14 bf16 through kernels="auto" (head_dim 80): the stock blocks K2
    # + K3 (B6's body at 257 tokens, blocks 0-4; the short-row kernel at 180
    # to 61), block 5 (257→180) B4 + selection + B5, blocks 10, 15, 20 K1
    PATH_H: dict(
        model=PATH_H, quant=None, batch=B_H, img=224, schedule="vit_h", counts=VIT_H_COUNTS,
        kernels="auto",
        launches={"pruned": launches(fused_pruned_attn_block=3, fused_attn_block=28,
                                     fused_ln_mlp_residual=32, fused_ln_qkv=1,
                                     fused_gather_sdpa_proj_residual=1, select_kept=1,
                                     fused_sdpa=5, short_attention=27),
                  "identity": launches(fused_attn_block=32, fused_ln_mlp_residual=32,
                                       fused_sdpa=32)}),
    # ViT-H/14 int8 through kernels="auto": no whole-block plan fits at C =
    # 1280, nor B11's one-kernel route at these token counts, so the stock
    # blocks take B10 + B9 (B6's body inside B10 at 257 tokens, blocks 0-4;
    # the short-row kernel at 180 to 61) and the pruned blocks 5, 10, 15, 20
    # B12 + selection + B13 (the short-row kernel, 180 to 61 kept) + B9
    P14I: dict(model=PATH_H, quant="dynamic", batch=B_H, img=224, schedule="vit_h",
               counts=VIT_H_COUNTS, kernels="auto", launches=VIT_H_INT8_LAUNCHES),
    P14S: dict(model=PATH_H, quant="static", batch=B_H, img=224, schedule="vit_h",
               counts=VIT_H_COUNTS, kernels="auto", launches=VIT_H_INT8_LAUNCHES),
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
            "train_sdpa_bwd": kt.SDPA_BWD_KERNEL,
            "short_attention": ka.SHORT_KERNEL,
            "select_kept": kb.SELECT_KERNEL}


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
                "vit_l": VIT_L_SCHEDULE, "vit_h": VIT_H_SCHEDULE}[spec["schedule"]]
    scheds = {"pruned": schedule, "identity": None}
    kernels = spec.get("kernels", "cuda")
    raw = RAJNIViT(model_name, schedule, kernels=kernels, seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(batch, spec["img"], spec["img"], 3, generator=gen).to(device)
    params, scales = raw.params, {"pruned": None, "identity": None}
    if spec["quant"]:
        params = quantize_params(raw.params, attn=spec["quant"] != "mlp")
        if spec["quant"] == "static":  # calibrated on this batch, before quantization
            scales = {k: calibrate_act_scales(raw.params, images, raw.config, v)
                      for k, v in scheds.items()}
    models = {(k, impl): RAJNIViT(model_name, v, params=params,
                                  kernels=kernels if impl == "cuda" else impl, device=device,
                                  act_scales=scales[k])
              for k, v in scheds.items() for impl in ("cuda", "torch")}
    route = models[("pruned", "cuda")].route
    print(f"{path}: RAJNIViT(kernels={kernels!r}) {route}")
    check(route == "route: cuda", f"{path}: {route}, not the kernels")
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


def vit_h_train_cli(device):
    """ViT-H/14 training through the training CLI (bf16, ``--kernels cuda``,
    VIT_H_PROBE, 2 steps of batch 2) on the kernels: ``route: cuda``."""
    with tempfile.TemporaryDirectory() as tmp:
        sched = Path(tmp) / "schedule.json"
        sched.write_text(json.dumps({str(k): v for k, v in VIT_H_SCHEDULE.items()}))
        argv = ["rajni_tpu_torch.train", "--synthetic", "--model", PATH_H, "--schedule",
                str(sched), "--steps", "2", "--batch_size", "2", "--dtype", "bfloat16",
                "--kernels", "cuda", "--log_every", "1", "--output", str(Path(tmp) / "h.msgpack")]
        p = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        tail = [l for l in p.stdout.splitlines() if l.startswith(("route:", "step"))]
        print(f"CLI rajni_tpu_torch.train {PATH_H}: " + " | ".join(tail))
        check(p.returncode == 0, f"train CLI {PATH_H} exited {p.returncode}:\n"
                                 f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        check("route: cuda" in p.stdout.splitlines(), f"train CLI {PATH_H}: no 'route: cuda' line")
        losses = [float(l.split()[3]) for l in p.stdout.splitlines() if l.startswith("step")]
        check(len(losses) == 2 and all(math.isfinite(l) for l in losses),
              f"train CLI {PATH_H}: losses {losses}")


def eval_cli():
    """The eval CLI at 224 and 384, each in bf16 and with ``--quantize
    --calibrate 1``, and on ViT-H/14 (VIT_H_PROBE) with ``--quantize`` and
    ``--quantize --calibrate 1``, each on the kernels (``route: cuda``)."""
    from rajni_tpu_torch import REFERENCE_SCHEDULE

    with tempfile.TemporaryDirectory() as tmp:
        files = {}
        for name, schedule in (("reference", REFERENCE_SCHEDULE), ("vit_h", VIT_H_SCHEDULE)):
            files[name] = Path(tmp) / f"{name}.json"
            files[name].write_text(json.dumps({str(k): v for k, v in schedule.items()}))
        quantize = ["--quantize", "--calibrate", "1"]
        for model, batch, extra, sched in ((PATH224, 64, [], "reference"),
                                           (PATH384, 32, [], "reference"),
                                           (PATH224, 64, quantize, "reference"),
                                           (PATH384, 32, quantize, "reference"),
                                           (PATH_H, 32, quantize[:1], "vit_h"),
                                           (PATH_H, 32, quantize, "vit_h")):
            cmd = [sys.executable, "-m", "rajni_tpu_torch.run", "--synthetic", "3",
                   "--batch_size", str(batch), "--model", model, "--schedule",
                   str(files[sched]), *extra]
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            tail = [l for l in p.stdout.splitlines()
                    if "RAJNI -" in l or "Token counts" in l or l.startswith("route:")]
            print(f"eval CLI {model} batch {batch} {' '.join(extra)}: " + " | ".join(tail))
            check(p.returncode == 0,
                  f"eval CLI exited {p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
            check("route: cuda" in p.stdout.splitlines(), f"eval CLI {model}: not on the kernels")
            want = f"Token counts per block: {PATHS[model]['counts']}"
            if "--calibrate" in extra:
                check("Calibrated static int8 activation scales" in p.stdout,
                      "eval CLI --calibrate: no calibration line")
            check(want in p.stdout, f"eval CLI {model}: no '{want}' line")


def c5_phases(device, peaks, results, counters):
    """C5: the score kernel at C = 1280 with 20 heads of 64 (B = 128, N =
    197 and 257) against ``_importance_f32`` of B4's own qkv at the score
    gate of the other widths, with the planted biased-std fault, and its
    device time against its byte bound; a pruned forward of ``C5_MODEL``
    (``kernels="auto"``: ``route: cuda``) through K1, K2 and K3, its launches
    and token counts, against its plain route's logits at the bf16 gate; one
    training step (``TRAIN_C5``) held as T6's first step is, and its
    launches."""
    import torch

    from rajni_tpu_torch import RAJNIViT
    from rajni_tpu_torch.kernels import block as kb

    C5_C, C5_H = C5_MODEL["embed_dim"], C5_MODEL["num_heads"]
    gen = torch.Generator().manual_seed(17)
    blk = make_block(gen, device, C5_C, 4 * C5_C)
    ln, wqkv = blk["norm1"], blk["attn"]["qkv"]
    check(kb._score_fits(197, C5_C, C5_H), "C5: _score_fits refuses C=1280, 20 heads")
    for n in (197, 257):
        x = (X_STD * torch.randn(B_C5, n, C5_C, generator=gen)).to(device, torch.bfloat16)
        qkv, got = kb.fused_ln_qkv(x, ln, wqkv, C5_H, 1e-6, True)
        want = kb._importance_f32(qkv.float(), C5_H)
        rel = ((got - want).abs() / want.abs()).max().item()
        bad = ((got - importance_biased_std(qkv.float(), C5_H)).abs() / want.abs()).max().item()
        times = launch_ms(lambda: kb.fused_ln_qkv(x, ln, wqkv, C5_H, 1e-6, True))
        ms = sum(v for k, v in times.items() if "score_kernel" in k)
        bnd = bound(0.0, (B_C5 * n * 2 * C5_C + B_C5 * C5_C) * 2 + B_C5 * n * 4, peaks)
        print(f"{C5} scores B={B_C5} N={n}: rel err max {rel:.3e} against _importance_f32 of the "
              f"same qkv; planted fault 'biased std' {bad:.3e}; score kernel {ms:.4f} ms of "
              f"device time | bound {bnd[0]:.4f} ms ({bnd[1]}) | {ms / bnd[0]:.2f}x")
        check(bool(torch.isfinite(got).all()) and bool((got > 0).all()),
              f"{C5} scores N={n}: not finite and positive")
        check(rel <= SCORE_SUM_RTOL, f"{C5} scores N={n}: rel err {rel} > {SCORE_SUM_RTOL}")
        check(bad > SCORE_SUM_RTOL, f"{C5} scores N={n}: the gate missed 'biased std'")

    config = path_config(C5_MODEL)
    models = {(k, impl): RAJNIViT(config, v, kernels=impl, seed=0, device=device)
              for k, v in (("pruned", C5_SCHEDULE), ("identity", None))
              for impl in ("auto", "torch")}
    route = models[("pruned", "auto")].route
    print(f"{C5}: RAJNIViT(kernels='auto') {route}")
    check(route == "route: cuda", f"{C5}: {route}, not the kernels")
    counts = models[("pruned", "auto")].get_last_stats()["token_counts"]
    check(counts == C5_COUNTS, f"{C5}: token counts {counts} != {C5_COUNTS}")
    images = torch.randn(B_C5, 224, 224, 3, generator=gen).to(device)
    for sched, expected in C5_LAUNCHES.items():
        for k in counters.values():
            k.launches = 0
        out = models[(sched, "auto")](images)
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in counters.items()}
        print(f"{C5}: launches per {sched} forward: { {n: v for n, v in got.items() if v} }")
        check(got == expected, f"{C5} {sched} launches {got} != {expected}")
        check(tuple(out.shape) == (B_C5, 1000) and bool(torch.isfinite(out).all()),
              f"{C5} {sched}: logits {tuple(out.shape)} not finite")
        rel = rel_l2(out, models[(sched, "torch")](images))
        print(f"{C5} {sched}: logits rel L2 (cuda vs torch on the card) {rel:.3e}")
        check(rel <= LOGITS_REL_L2, f"{C5} {sched} logits rel L2 {rel} > {LOGITS_REL_L2}")
    del models

    spec = TRAIN_PATHS[TRAIN_C5]
    checked_first_step(device, TRAIN_C5)
    from rajni_tpu_torch.models import vit as tvit

    gen = torch.Generator().manual_seed(1)
    images = torch.randn(spec["batch"], 224, 224, 3, generator=gen).to(device)
    labels = torch.randint(0, 1000, (spec["batch"],), generator=gen).to(device)
    loss = step_launches(device, results, counters, TRAIN_C5,
                         lambda: tvit.init_params(torch.Generator().manual_seed(0), config,
                                                  torch.bfloat16, device), images, labels)
    check(all(math.isfinite(l) for l in loss["pruned"]), f"{TRAIN_C5}: loss {loss}")
    print(f"{TRAIN_C5}: one pruned step on the kernels, loss {loss['pruned'][0]:.4f}")


# The evaluation from images: IMAGE_COUNT procedural images in IMAGE_CLASSES
# classes, sized as ImageNet-val's commonly are (w, h): landscape, portrait,
# 3:2, 4:3 past the 512 canvas, small (upscaled), 4:3 larger still
IMAGE_COUNT, IMAGE_CLASSES, IMAGE_WARMUP = 1000, 10, 2
IMAGE_SIZES = ((500, 375), (375, 500), (500, 333), (640, 480), (200, 150), (800, 600))
CANVAS = 512
# the host tiers of the eval CLI: its --preprocess, RAJNI_NATIVE, the
# preprocess: line it must print
IMAGE_TIERS = {"host (native)": ("host", "1"), "host (PIL)": ("host", "0"),
               "device": ("device", "1"), "device-full": ("device-full", "1")}
# tests/test_native.py's tolerance: ±1.5/255 before the normalize
NATIVE_TOL_LEVELS = 1.5
# device-full against host PIL on images that fit the canvas: one uint8 level
# a resample pass (two passes), and at most this share of pixels apart
FULL_MAX_LEVELS, FULL_SHARE = 2.0, 1e-2
# preprocess_on_device on the card against its own run on the CPU: the
# products' summation orders differ (cuBLAS and the CPU's), which moves a
# value across a rounding edge between the passes by one level at most, at
# few pixels; elsewhere fp32 rounding of the normalize
CARD_CPU_MAX_LEVELS, CARD_CPU_SHARE = 1.0, 1e-3


def procedural_image(index: int):
    """Image ``index`` as uint8 HWC: a class-coloured gradient with stripes
    and noise (JPEG-friendly, not constant), and its class."""
    import numpy as np

    label = index % IMAGE_CLASSES
    w, h = IMAGE_SIZES[index % len(IMAGE_SIZES)]
    rng = np.random.default_rng(index)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    hue = np.array([(label * 37) % 256, (label * 91) % 256, (label * 53) % 256], np.float32)
    stripes = 40.0 * np.sin((x * (3 + label) + y * (2 + index % 5)) * np.pi * 2)
    arr = hue * (0.5 + 0.5 * y) + 60.0 * x + stripes
    arr = arr + rng.normal(0.0, 12.0, (h, w, 3)).astype(np.float32)
    return np.clip(arr, 0, 255).astype(np.uint8), label


def write_images(root: Path, jpeg: bool) -> None:
    """The image folder: ``root/class_XX/img_XXXX.(jpg|png)``."""
    import concurrent.futures

    from PIL import Image

    def one(i):
        arr, label = procedural_image(i)
        d = root / f"class_{label:02d}"
        Image.fromarray(arr, "RGB").save(d / f"img_{i:04d}.{'jpg' if jpeg else 'png'}",
                                         **({"quality": 90} if jpeg else {}))

    for c in range(IMAGE_CLASSES):
        (root / f"class_{c:02d}").mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(IMAGE_COUNT)))


@contextlib.contextmanager
def recorded_logits(run_module, store: list):
    """Record every forward's logits (a device copy) of ``run_module``'s
    evaluations, a list an evaluation, into ``store``."""
    real = run_module.evaluate_model

    def evaluate(model, *args, **kw):
        outs = []
        store.append(outs)

        def recorded(x):
            out = model(x)
            outs.append(out.detach().clone())
            return out

        return real(recorded, *args, **kw)

    run_module.evaluate_model = evaluate
    try:
        yield
    finally:
        run_module.evaluate_model = real


@contextlib.contextmanager
def native_env(value: str):
    import os

    old = os.environ.get("RAJNI_NATIVE")
    os.environ["RAJNI_NATIVE"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["RAJNI_NATIVE"]
        else:
            os.environ["RAJNI_NATIVE"] = old


def cli_lines(out: str, keep=("route:", "preprocess:", "Token counts", "Base  -", "RAJNI -",
                              "Speedup", "Loaded", "NOTE")) -> list[str]:
    return [l for l in out.splitlines() if l.startswith(keep)]


def image_eval_phases(device, counters, tmp: Path) -> dict:
    """The eval CLI (``rajni_tpu_torch.run.main``) on an image folder at
    ViT-B/16 224 bf16, ``REFERENCE_SCHEDULE``, batch 256 (four batches, the
    last 232), ``--compare_base``, once a host tier: ``route: cuda``, the
    tier's ``preprocess:`` line, the token counts, every launch of the two
    evaluations (two warmup and four timed batches each) through K1, K2 and K3, the
    host (PIL) and device tiers' logits equal; then the tiers' batches on
    their own: the device tier's normalized batch bitwise the host PIL
    tier's, device-full against host PIL (images that fit the canvas gated,
    the larger ones reported), ``preprocess_on_device`` on the card against
    its run on the CPU, and the C++ tier against PIL. Returns the image
    folder and the schedule file for the ``.pth`` phase."""
    import io

    import numpy as np
    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE, run
    from rajni_tpu_torch.data import native
    from rajni_tpu_torch.data import pipeline as dp
    from rajni_tpu_torch.data.device import normalize_images, preprocess_on_device

    t0 = time.perf_counter()
    try:
        import PIL

        jpeg = True
        print(f"Pillow {PIL.__version__}: JPEG image files")
    except ImportError:
        raise SmokeFailure("Pillow is missing: the image phases need it to decode")
    root = tmp / "images"
    write_images(root, jpeg)
    sched = tmp / "reference.json"
    sched.write_text(json.dumps({str(k): v for k, v in REFERENCE_SCHEDULE.items()}))
    print(f"wrote {IMAGE_COUNT} images in {IMAGE_CLASSES} classes ({time.perf_counter() - t0:.1f} s)")
    check(native.available(), f"the C++ preprocessing did not build on this machine: {native.error()}")
    print(f"C++ preprocessing library: {native.library_path()}")

    per_forward = PATHS[PATH224]["launches"]
    batches = -(-IMAGE_COUNT // B)  # the last one partial
    # the warmup and the timed batches, base (identity) and RAJNI (pruned)
    want = {n: (batches + IMAGE_WARMUP) * (per_forward["pruned"][n] + per_forward["identity"][n])
            for n in per_forward["pruned"]}
    logits = {}
    for line, (tier, env) in IMAGE_TIERS.items():
        argv = ["--data_path", str(root), "--model", PATH224, "--schedule", str(sched),
                "--batch_size", str(B), "--compare_base", "--warmup", str(IMAGE_WARMUP),
                "--num_workers", "8",
                "--no-progress",
                "--preprocess", tier, "--canvas", str(CANVAS)]
        store: list = []
        for k in counters.values():
            k.launches = 0
        buf = io.StringIO()
        t1 = time.perf_counter()
        with native_env(env), recorded_logits(run, store), contextlib.redirect_stdout(buf):
            result = run.main(argv)
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in counters.items()}
        out = buf.getvalue()
        lines = cli_lines(out)
        print(f"eval CLI from images, --preprocess {tier} (RAJNI_NATIVE={env}): "
              f"{time.perf_counter() - t1:.1f} s | " + " | ".join(lines))
        check("route: cuda" in out.splitlines(), f"images {line}: not on the kernels")
        check(f"preprocess: {line}" in out.splitlines(), f"images {line}: no 'preprocess: {line}'")
        check(f"Token counts per block: {VIT_B_COUNTS}" in out, f"images {line}: token counts")
        check(got == want, f"images {line}: launches {got} != {want}")
        rajni = store[-1][-batches:]
        check([t.shape[0] for t in rajni] == [B] * (batches - 1) + [IMAGE_COUNT - B * (batches - 1)],
              f"images {line}: batches {[t.shape for t in rajni]}")
        logits[line] = torch.cat(rajni).float()
        check(bool(torch.isfinite(logits[line]).all()), f"images {line}: logits not finite")
        print(f"images {line}: img/s base {result['base'][1]:.1f}, RAJNI {result['rajni'][1]:.1f} "
              f"(speedup {result['rajni'][1] / result['base'][1]:.2f}x; eval-protocol readings, "
              "not a benchmark)")
    same = torch.equal(logits["host (PIL)"], logits["device"])
    rel = rel_l2(logits["device"], logits["host (PIL)"])
    print(f"images: RAJNI logits of the host (PIL) and device tiers (identical inputs) "
          f"{'equal' if same else 'differ'}, rel L2 {rel:.3e}")
    if not same:
        forward_determinism(device)
        check(rel <= 1e-2, f"images: host (PIL) and device logits rel L2 {rel}")

    # the tiers' batches on their own: the first batch of the folder
    def first(**kw):
        return next(iter(dp.DataLoader(dp.ImageFolder(str(root), **kw), batch_size=B,
                                       num_workers=8)))[0]

    pil = first(use_native=False)
    u8 = first(output="uint8")
    canvas, sizes = first(output="canvas", canvas=CANVAS)
    nat = first()
    dev = normalize_images(torch.from_numpy(u8).to(device), torch.float32)
    check(torch.equal(dev.cpu(), torch.from_numpy(pil)),
          "device tier: the normalized batch made on the card differs from the host PIL tier's")
    print(f"device tier: the normalized batch made on the card ({B} images) is bitwise the host "
          "PIL tier's")
    std = torch.from_numpy(dp.IMAGENET_STD)
    full = preprocess_on_device(torch.from_numpy(canvas).to(device), torch.from_numpy(sizes).to(device),
                                dtype=torch.float32).cpu()
    # the first batch's images, in the folder's order (by class, then name)
    index = [int(Path(f).stem.split("_")[1]) for f, _ in dp.ImageFolder(str(root)).samples[:B]]
    fits = np.array([max(IMAGE_SIZES[i % len(IMAGE_SIZES)]) <= CANVAS for i in index])
    lev = (full - torch.from_numpy(pil)).abs() * std * 255
    for tag, sel in (("fit the canvas", fits), ("are larger than the canvas", ~fits)):
        d = lev[torch.from_numpy(sel)]
        print(f"device-full vs host PIL, {int(sel.sum())} images that {tag}: largest difference "
              f"{d.max().item():.4f} uint8 levels, {(d > 1e-3).float().mean().item():.3e} of the "
              f"values differ, {(d > 1 + 1e-3).float().mean().item():.3e} by more than one level")
    d = lev[torch.from_numpy(fits)]
    check(d.max().item() <= FULL_MAX_LEVELS + 1e-3,
          f"device-full vs host PIL: {d.max().item()} levels > {FULL_MAX_LEVELS}")
    check((d > 1e-3).float().mean().item() <= FULL_SHARE,
          f"device-full vs host PIL: {(d > 1e-3).float().mean().item()} of the values differ")
    n = 64
    cpu = preprocess_on_device(torch.from_numpy(canvas[:n]), torch.from_numpy(sizes[:n]),
                               dtype=torch.float32)
    d = (full[:n] - cpu).abs() * std * 255
    print(f"preprocess_on_device on the card vs the CPU ({n} images): largest difference "
          f"{d.max().item():.3e} uint8 levels, {(d > 1e-3).float().mean().item():.3e} of the "
          f"values past 1e-3 of a level")
    check(d.max().item() <= CARD_CPU_MAX_LEVELS + 1e-3,
          f"preprocess_on_device card vs CPU: {d.max().item()} levels > {CARD_CPU_MAX_LEVELS}")
    check((d > 1e-3).float().mean().item() <= CARD_CPU_SHARE,
          f"preprocess_on_device card vs CPU: {(d > 1e-3).float().mean().item()} of the values")
    d = (torch.from_numpy(nat) - torch.from_numpy(pil)).abs() * std * 255
    print(f"host C++ tier vs PIL ({B} images): largest difference {d.max().item():.4f} uint8 "
          f"levels (tolerance {NATIVE_TOL_LEVELS}), {(d < 1e-3).float().mean().item():.3f} of the "
          "values equal")
    check(d.max().item() <= NATIVE_TOL_LEVELS, f"C++ tier vs PIL: {d.max().item()} levels")
    return {"root": root, "schedule": sched}


def forward_determinism(device) -> None:
    """Whether two runs of the ViT-B/16 224 pruned forward on one batch give
    the same bits; printed."""
    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT

    model = RAJNIViT(PATH224, REFERENCE_SCHEDULE, kernels="cuda", seed=0, device=device)
    x = torch.randn(B, 224, 224, 3, generator=torch.Generator().manual_seed(5)).to(device)
    same = torch.equal(model(x), model(x))
    print(f"the pruned forward on one batch twice: {'bitwise equal' if same else 'not deterministic'}")


def timm_state_dict(seed: int = 0) -> dict:
    """A timm-layout ViT-B/16 224 state_dict from a seeded generator: timm's
    names and shapes, weights ~ N(0, 1/fan_in), norms near 1, small biases."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    c, P, hidden = C, 16, HIDDEN

    def w(*shape, fan_in):
        return torch.randn(*shape, generator=gen) / math.sqrt(fan_in)

    def b(n, scale=0.1):
        return scale * torch.randn(n, generator=gen)

    sd = {"cls_token": 0.1 * torch.randn(1, 1, c, generator=gen),
          "pos_embed": 0.1 * torch.randn(1, 197, c, generator=gen),
          "patch_embed.proj.weight": w(c, 3, P, P, fan_in=3 * P * P),
          "patch_embed.proj.bias": b(c),
          "norm.weight": 1 + b(c), "norm.bias": b(c),
          "head.weight": w(1000, c, fan_in=c), "head.bias": b(1000)}
    for i in range(12):
        p = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = 1 + b(c), b(c)
        for n, (o, k) in (("attn.qkv", (3 * c, c)), ("attn.proj", (c, c)),
                          ("mlp.fc1", (hidden, c)), ("mlp.fc2", (c, hidden))):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = w(o, k, fan_in=k), b(o)
    return sd


def timm_pth_phases(device, counters, images: dict, tmp: Path) -> None:
    """A timm ViT-B/16 224 ``.pth`` (``{"model": ...}`` with ``module.``
    keys): the eval CLI on it (``--checkpoint``, the image folder, two
    batches of 256) through the kernels; the converted patch embedding
    against ``F.conv2d`` with the timm weight on the card (the layout checked
    apart from the converter); the kernels' logits against the plain route's
    at 224; and the same checkpoint in ``vit_base_patch16_384``, its pos-embed
    resampled from 197 to 577 tokens (against ``F.interpolate``, timm's
    resampler), through B4, B5, B6, K2 and K3 against the plain route."""
    import io

    import torch
    import torch.nn.functional as F

    from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT, run
    from rajni_tpu_torch.models.vit import get_config, patch_embed
    from rajni_tpu_torch.params.io import load_checkpoint_auto

    sd = timm_state_dict()
    path = tmp / "vit_base_patch16_224.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}, "epoch": 300}, path)
    argv = ["--checkpoint", str(path), "--data_path", str(images["root"]), "--model", PATH224,
            "--schedule", str(images["schedule"]), "--batch_size", str(B), "--max_batches", "2",
            "--warmup", "1", "--preprocess", "device", "--no-progress"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run.main(argv)
    out = buf.getvalue()
    print("eval CLI --checkpoint .pth: " + " | ".join(cli_lines(out)))
    check(f"Loaded params from {path}" in out, "eval CLI: the .pth was not loaded")
    check("route: cuda" in out.splitlines(), "eval CLI --checkpoint .pth: not on the kernels")
    check(f"Token counts per block: {VIT_B_COUNTS}" in out, "eval CLI .pth: token counts")

    gen = torch.Generator().manual_seed(9)
    p224 = load_checkpoint_auto(str(path), PATH224, device=device)
    x = torch.randn(8, 224, 224, 3, generator=gen).to(device)
    got = patch_embed(x, p224["patch_embed"], get_config(PATH224))
    want = F.conv2d(x.permute(0, 3, 1, 2), sd["patch_embed.proj.weight"].to(device),
                    sd["patch_embed.proj.bias"].to(device), stride=16).flatten(2).transpose(1, 2)
    rel = rel_l2(got, want)
    print(f".pth patch embedding against F.conv2d with the timm weight (fp32): rel L2 {rel:.3e}")
    check(rel <= 1e-6, f".pth patch embedding vs F.conv2d: rel L2 {rel}")

    for model, batch in ((PATH224, 64), (PATH384, 32)):
        params = load_checkpoint_auto(str(path), model, torch.bfloat16, device)
        if model == PATH384:
            grid = sd["pos_embed"][:, 1:].reshape(1, 14, 14, C).permute(0, 3, 1, 2)
            ref = F.interpolate(grid, size=(24, 24), mode="bicubic", align_corners=False,
                                antialias=True).permute(0, 2, 3, 1).reshape(1, 576, C)
            pe = load_checkpoint_auto(str(path), model)["pos_embed"]
            err = (pe[:, 1:] - ref).abs().max().item()
            print(f".pth in {model}: pos-embed 197 -> {pe.shape[1]} tokens, max abs diff "
                  f"{err:.3e} from F.interpolate(bicubic, antialias)")
            check(pe.shape[1] == 577 and err <= 1e-5, f".pth 384 pos-embed: {err}")
        kernels = RAJNIViT(model, REFERENCE_SCHEDULE, params=params, kernels="cuda", device=device)
        plain = RAJNIViT(model, REFERENCE_SCHEDULE, params=params, kernels="torch", device=device)
        check(kernels.route == "route: cuda", f".pth {model}: {kernels.route}")
        img = PATHS[model]["img"]
        x = torch.randn(batch, img, img, 3, generator=gen).to(device)
        for k in counters.values():
            k.launches = 0
        out = kernels(x)
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in counters.items()}
        check(got == PATHS[model]["launches"]["pruned"], f".pth {model}: launches {got}")
        rel = rel_l2(out, plain(x))
        print(f".pth in {model} (batch {batch}): launches { {n: v for n, v in got.items() if v} }; "
              f"logits rel L2 kernels vs plain route {rel:.3e}")
        check(bool(torch.isfinite(out).all()) and rel <= LOGITS_REL_L2,
              f".pth {model}: logits rel L2 {rel} > {LOGITS_REL_L2}")


def data_phases(device, counters) -> None:
    """The evaluation from images and the timm ``.pth``, in one temporary
    directory."""
    with tempfile.TemporaryDirectory() as tmp:
        images = image_eval_phases(device, counters, Path(tmp))
        timm_pth_phases(device, counters, images, Path(tmp))


# ---------------------------------------------------------------------------
# Export, serving and attestation (rajni_tpu_torch/export.py, serving.py,
# attest.py, run.py --artifact), and the extended timm variants
# ---------------------------------------------------------------------------

# The bucket artifact of ViT-B/16 224 (REFERENCE_SCHEDULE) and its requests:
# padded (3 → 8, 40 → 256), exact (8, 256) and chunked (300 = 256 + 44 → 256)
SERVE_BUCKETS = [8, 32, 256]
SERVE_REQUESTS = (3, 8, 40, 256, 300)
# the int8 static artifact: B14/B15 through buckets 8, 32, 64 (calibrated on 64 images)
INT8_BUCKETS = [8, 32, 64]
INT8_REQUESTS = (20, 64)
# the HTTP phase: 64 client threads at once over a three-model registry
SERVE_CLIENTS, SERVE_DELAY_MS = 64, 20.0
# the attestation CLI's --min_agreement above any agreement: it must exit non-zero
UNREACHABLE_AGREEMENT = "1.01"


def bucket_batches(x, buckets):
    """The padded batches a bucket artifact runs for ``x``
    (``export.load_exported``): chunks of the largest bucket, each padded
    with zero images to the smallest sufficient bucket; ``(batch, rows)``."""
    import torch

    out = []
    for i in range(0, x.shape[0], buckets[-1]):
        chunk = x[i:i + buckets[-1]]
        cap = next(c for c in buckets if chunk.shape[0] <= c)
        pad = chunk.new_zeros((cap - chunk.shape[0],) + tuple(chunk.shape[1:]))
        out.append((torch.cat([chunk, pad]), chunk.shape[0]))
    return out


def counted(counters, fn, *args):
    """``fn(*args)`` with every launch count set to 0 first; ``(result,
    {kernel: launches})`` read after a synchronize."""
    import torch

    for k in counters.values():
        k.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {n: k.launches for n, k in counters.items()}


def export_phases(device, counters, tmp: Path) -> dict:
    """``export.export_model``/``load_exported`` on the card. The bucket
    artifact (ViT-B/16 224 bf16, ``REFERENCE_SCHEDULE``, buckets
    ``SERVE_BUCKETS``, platform cuda): its route, its launches a bucket call
    (K1 ×5, K2 ×7, K3 ×12), each request's logits bitwise the eager forward
    (``RAJNIViT`` on the same params) on the same padded batches, and
    against the same images at their own batch (bitwise or not, printed;
    gated at ``LOGITS_REL_L2``). A dynamic artifact at 5 and 17 images,
    bitwise the eager forward. The int8 static artifact (``quantize_params``
    and ``calibrate_act_scales`` baked): B14 ×5, B15 ×7 a call, bitwise
    ``RAJNIViT`` with the same scales on the same padded batch. A cpu
    artifact refused on the card. Returns the artifacts and the params."""
    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT
    from rajni_tpu_torch.export import export_model, load_exported
    from rajni_tpu_torch.quant import calibrate_act_scales, quantize_params

    eager = RAJNIViT(PATH224, REFERENCE_SCHEDULE, kernels="cuda", seed=0, device=device)
    params, cfg = eager.params, eager.config
    gen = torch.Generator().manual_seed(21)
    images = torch.randn(max(SERVE_REQUESTS), 224, 224, 3, generator=gen).to(device,
                                                                              torch.bfloat16)
    arts, loaded = {"params": params}, {}  # the files (returned), the loaded callables
    for name, schedule, batch in (("pruned", REFERENCE_SCHEDULE, SERVE_BUCKETS),
                                  ("stock", None, SERVE_BUCKETS),
                                  ("dynamic", REFERENCE_SCHEDULE, "dynamic")):
        arts[name] = tmp / f"{name}.rajni"
        t0 = time.perf_counter()
        export_model(str(arts[name]), params, cfg, schedule, batch, platform="cuda")
        t1 = time.perf_counter()
        serve = load_exported(str(arts[name]), device)
        print(f"export {name} (batch {batch}): {arts[name].stat().st_size / 1e6:.1f} MB, written "
              f"in {t1 - t0:.1f} s, loaded in {time.perf_counter() - t1:.1f} s; {serve.route}")
        check(serve.route == "route: cuda", f"artifact {name}: {serve.route}")
        loaded[name] = serve
    serve = loaded["pruned"]
    per_call = PATHS[PATH224]["launches"]["pruned"]
    for n in SERVE_REQUESTS:
        x = images[:n]
        out, got = counted(counters, serve, x)
        batches = bucket_batches(x, SERVE_BUCKETS)
        want = {k: v * len(batches) for k, v in per_call.items()}
        check(got == want, f"bucket artifact, {n} images: launches {got} != {want}")
        check(tuple(out.shape) == (n, 1000) and bool(torch.isfinite(out).all()),
              f"bucket artifact, {n} images: logits {tuple(out.shape)}")
        ref = torch.cat([eager(b)[:rows] for b, rows in batches])
        check(torch.equal(out, ref), f"bucket artifact, {n} images: the real rows differ from "
                                     "the eager forward on the same padded batches")
        own = eager(x)
        rel = rel_l2(out, own)
        print(f"bucket artifact, {n} images through buckets {[b.shape[0] for b, _ in batches]}: "
              f"{len(batches)} call(s), each K1 ×5, K2 ×7, K3 ×12; real rows bitwise the eager "
              f"forward on the padded batches; against the images at their own batch "
              f"{'bitwise equal' if torch.equal(out, own) else f'rel L2 {rel:.3e}'}")
        check(rel <= LOGITS_REL_L2, f"bucket artifact, {n} images vs own batch: rel L2 {rel}")
    for n in (5, 17):
        out, got = counted(counters, loaded["dynamic"], images[:n])
        check(got == per_call, f"dynamic artifact, {n} images: launches {got}")
        check(torch.equal(out, eager(images[:n])), f"dynamic artifact, {n} images: not bitwise "
                                                   "the eager forward")
    print("dynamic artifact at 5 and 17 images: bitwise the eager forward, K1 ×5, K2 ×7, K3 ×12")

    q = quantize_params(params)
    scales = calibrate_act_scales(params, images[:INT8_BUCKETS[-1]], cfg, REFERENCE_SCHEDULE)
    arts["int8"] = tmp / "int8.rajni"
    export_model(str(arts["int8"]), q, cfg, REFERENCE_SCHEDULE, INT8_BUCKETS, platform="cuda",
                 act_scales=scales)
    int8 = load_exported(str(arts["int8"]), device)
    check(int8.route == "route: cuda", f"int8 static artifact: {int8.route}")
    ref_model = RAJNIViT(PATH224, REFERENCE_SCHEDULE, params=q, kernels="cuda", device=device,
                         act_scales=scales)
    for n in INT8_REQUESTS:
        out, got = counted(counters, int8, images[:n])
        want = PATHS[P3C]["launches"]["pruned"]
        check(got == want, f"int8 static artifact, {n} images: launches {got} != {want}")
        ref = torch.cat([ref_model(b)[:rows] for b, rows in bucket_batches(images[:n],
                                                                           INT8_BUCKETS)])
        check(torch.equal(out, ref), f"int8 static artifact, {n} images: not bitwise RAJNIViT "
                                     "with the same scales on the same batch")
    print(f"int8 static artifact ({arts['int8'].stat().st_size / 1e6:.1f} MB, buckets "
          f"{INT8_BUCKETS}) at {INT8_REQUESTS} images: B14 ×5, B15 ×7 a call, bitwise RAJNIViT "
          f"with the same scales; {int8.route}")

    tiny = RAJNIViT("vit_tiny_patch16_224", device=device)
    cpu_art = tmp / "cpu.rajni"
    export_model(str(cpu_art), tiny.params, tiny.config, batch=2, platform="cpu")
    try:
        load_exported(str(cpu_art), device)
        refused = False
    except ValueError as e:
        refused = "platform 'cpu'" in str(e)
        print(f"a cpu artifact on the card: refused ({e})")
    check(refused, "a cpu artifact loaded on the card")
    return arts


def artifact_cli_phase(arts: dict) -> None:
    """``run.main(["--artifact", ...])`` on the bucket artifact, two
    synthetic batches of 64: ``route: cuda`` and ViT-B/16 224's token counts."""
    import io

    from rajni_tpu_torch import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run.main(["--artifact", str(arts["pruned"]), "--synthetic", "2", "--batch_size", "64",
                  "--warmup", "1", "--no-progress"])
    out = buf.getvalue()
    # a route and token-count check: two batches time nothing worth keeping
    lines = [l for l in out.splitlines() if l.startswith(("Artifact", "route:", "Token counts"))
             and not l.startswith("Artifact model")]
    print("eval CLI --artifact: " + " | ".join(lines))
    check("route: cuda" in out.splitlines(), "eval CLI --artifact: not on the kernels")
    check(f"Token counts per block: {VIT_B_COUNTS}" in out, "eval CLI --artifact: token counts")


def serving_phases(device, arts: dict) -> None:
    """``serving.make_server`` on 127.0.0.1, port 0, over a registry of three
    engines from artifacts (stock, pruned bf16, int8 static), each warmed up
    (timed). ``SERVE_CLIENTS`` client threads POST one request each at once,
    to the three models in turn: raw uint8 crops, and JPEG bodies that the
    server decodes with PIL. Each response is held bitwise to that image's
    eager forward through the same engine's model, run on all of the
    model's requests at once: its top classes are the eager row's (the
    server's ``argsort`` on the same float32 row) and its top logits the
    eager row's values there. Rows do not depend on the batch they share
    (the export phase gates that bitwise), so a request answered with
    another's row fails. ``/v1/stats``: coalesced batches
    (mean batch > 1), p50 and p99. ``/healthz``, ``/v1/models``, a 404, a 400
    on a wrong byte count. The peak allocated memory of the registry."""
    import concurrent.futures
    import gc
    import http.client
    import io
    import threading

    import numpy as np
    import torch
    from PIL import Image

    from rajni_tpu_torch.data.device import normalize_images
    from rajni_tpu_torch.data.pipeline import preprocess_u8
    from rajni_tpu_torch.export import load_exported
    from rajni_tpu_torch.serving import BatchingEngine, make_server

    gc.collect()  # what the earlier phases left unreferenced is freed first
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engines = {}
    for name in ("stock", "pruned", "int8"):
        serve = load_exported(str(arts[name]), device)
        engines[name] = eng = BatchingEngine(serve, max_delay_ms=SERVE_DELAY_MS)
        t0 = time.perf_counter()
        eng.warmup()
        print(f"serving {name}: {serve.route}, buckets {serve.buckets}, warmup "
              f"{time.perf_counter() - t0:.3f} s (kernels built earlier in this run)")
    names = list(engines)
    requests = []
    for i in range(SERVE_CLIENTS):
        arr, _ = procedural_image(i)
        if i % 2:
            buf = io.BytesIO()
            Image.fromarray(arr, "RGB").save(buf, format="JPEG", quality=90)
            body, ctype = buf.getvalue(), "image/jpeg"
            with Image.open(io.BytesIO(body)) as im:
                crop = preprocess_u8(im.convert("RGB"), 224)
        else:
            crop = preprocess_u8(Image.fromarray(arr, "RGB"), 224)
            body, ctype = crop.tobytes(), "application/octet-stream"
        requests.append((names[i % len(names)], body, ctype, crop))

    httpd = make_server(engines, "127.0.0.1", 0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    start = threading.Barrier(SERVE_CLIENTS)

    def call(method, path, body=None, ctype=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request(method, path, body=body,
                         headers={"Content-Type": ctype} if ctype else {})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def client(req):
        name, body, ctype, _ = req
        start.wait(timeout=120)
        return call("POST", f"/v1/models/{name}/classify", body, ctype)

    try:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            answers = list(pool.map(client, requests))
        wall = time.perf_counter() - t0
        check(all(code == 200 for code, _ in answers),
              f"serving: statuses {[code for code, _ in answers]}")
        for name in names:
            idx = [i for i, r in enumerate(requests) if r[0] == name]
            crops = torch.from_numpy(np.stack([requests[i][3] for i in idx])).to(device)
            model = engines[name]._serve.model
            with torch.no_grad():
                ref = model(normalize_images(crops, torch.bfloat16)).float().cpu().numpy()
            for row, i in zip(ref, idx):
                out = answers[i][1]
                want = np.argsort(row)[::-1][:5]
                check(out["top_classes"] == want.tolist(), f"serving {name} request {i}: top "
                      f"classes {out['top_classes']} != eager {want.tolist()}")
                check(out["top_logits"] == row[want].tolist(), f"serving {name} request {i}: "
                      f"top logits {out['top_logits']} != eager {row[want].tolist()}")
        status, stats = call("GET", "/v1/stats")
        check(status == 200 and sorted(stats) == sorted(names), f"/v1/stats: {status} {stats}")
        for name in names:
            st = stats[name]
            print(f"serving {name}: {st['requests']} requests in {st['batches']} batches, mean "
                  f"batch {st['mean_batch']:.2f}, p50 {st['p50_ms']:.1f} ms, p99 "
                  f"{st['p99_ms']:.1f} ms")
        check(sum(stats[n]["requests"] for n in names) == SERVE_CLIENTS,
              f"serving: {stats} does not count {SERVE_CLIENTS} requests")
        check(max(stats[n]["mean_batch"] for n in names) > 1.0,
              "serving: no batch coalesced more than one request")
        print(f"serving: {SERVE_CLIENTS} concurrent requests (raw and JPEG) in {wall:.2f} s wall; "
              f"top-5 classes and logits bitwise the eager forward's")
        check(call("GET", "/healthz") == (200, {"ok": True}), "/healthz")
        check(call("GET", "/v1/models") == (200, {"models": names}), "/v1/models")
        check(call("GET", "/v1/models/nope/stats")[0] == 404, "an unknown model: not 404")
        code, err = call("POST", "/v1/classify", b"abc", "application/octet-stream")
        check(code == 400 and "150528 bytes" in err.get("error", ""), f"a 3-byte body: {code}")
        print("serving: /healthz, /v1/models, 404 on an unknown model, 400 on a wrong byte count")
    finally:
        httpd.shutdown()
        httpd.server_close()
        for eng in engines.values():
            eng.stop()
        server.join(timeout=60)
    check(not server.is_alive(), "serving: the server thread did not stop")
    peak = torch.cuda.max_memory_allocated()
    print(f"serving: peak allocated memory {peak / 2**30:.3f} GiB ({(peak - before) / 2**30:.3f} "
          f"GiB over the {before / 2**30:.3f} GiB allocated before the registry loaded), "
          f"{torch.cuda.get_device_name(0)}")


def attest_phases(device, arts: dict, tmp: Path) -> None:
    """The committed reference fixture (vit_tiny, C = 192: the torch route)
    replayed with its msgpack on the card (top-1 agreement 1.0); a bf16
    self-fixture of ViT-B/16 224 captured and checked through the kernels
    (agreement 1.0); the attestation CLI at an unreachable
    ``--min_agreement`` exits non-zero."""
    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE
    from rajni_tpu_torch.attest import capture_self_fixture, check_fixture, load_fixture
    from rajni_tpu_torch.models.vit import get_config, resolve_route, route_line
    from rajni_tpu_torch.params.io import load_params

    base = ROOT / "tests" / "fixtures" / "reference_vit_tiny_schedulejson"
    fix = load_fixture(f"{base}.npz")
    cfg = get_config(fix["model"])
    impl, why = resolve_route("auto", cfg, torch.float32, device)
    report = check_fixture(fix, load_params(f"{base}.msgpack"), impl="auto", device=device)
    print(f"attest reference fixture ({fix['model']}, {report['n']} images, fp32, "
          f"{route_line(impl, why)}; in bf16 "
          f"{route_line(*resolve_route('auto', cfg, torch.bfloat16, device))}): top-1 agreement "
          f"{report['top1_agreement']}, largest difference {report['max_abs_diff']:.3e}")
    check(impl == "torch" and resolve_route("auto", cfg, torch.bfloat16, device) == (
        "torch", "C=192 is not a multiple of 128"), f"attest: {route_line(impl, why)}")
    check(report["top1_agreement"] == 1.0, f"attest reference fixture: {report}")

    path = tmp / "self_vit_b.npz"
    params = arts["params"]
    capture_self_fixture(str(path), params, PATH224, REFERENCE_SCHEDULE, n=32, impl="cuda",
                         device=device)
    report = check_fixture(str(path), params, impl="cuda", device=device)
    print(f"attest bf16 self-fixture of {PATH224} through the kernels (32 images): top-1 "
          f"agreement {report['top1_agreement']}, largest difference {report['max_abs_diff']:.3e}")
    check(report["top1_agreement"] == 1.0, f"attest self-fixture: {report}")

    p = subprocess.run([sys.executable, "-m", "rajni_tpu_torch.attest", f"{base}.npz",
                        "--checkpoint", f"{base}.msgpack", "--kernels", "auto",
                        "--min_agreement", UNREACHABLE_AGREEMENT], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    print(f"attest CLI at --min_agreement {UNREACHABLE_AGREEMENT}: exit {p.returncode}; "
          f"{p.stdout.strip().splitlines()[-1] if p.stdout.strip() else p.stderr[-300:]}")
    check(p.returncode != 0 and '"top1_agreement": 1.0' in p.stdout,
          f"attest CLI: exit {p.returncode}\n{p.stdout[-2000:]}\n{p.stderr[-2000:]}")


def variant_state_dict(layout: str) -> dict:
    """``timm_state_dict``'s ViT-B/16 224 in a variant's layout: DeiT-3's
    (a 196-row patch-only pos-embed, LayerScale gammas) or MAE's (``fc_norm``
    in place of ``norm``: the ``avg`` head)."""
    import torch

    sd = timm_state_dict(seed=3)
    gen = torch.Generator().manual_seed(4)
    if layout == "deit3":
        sd["pos_embed"] = sd["pos_embed"][:, 1:].clone()
        for i in range(12):
            for n in ("ls1", "ls2"):
                sd[f"blocks.{i}.{n}.gamma"] = 0.2 + 0.8 * torch.rand(C, generator=gen)
    else:
        sd["fc_norm.weight"], sd["fc_norm.bias"] = sd.pop("norm.weight"), sd.pop("norm.bias")
    return sd


def variant_phases(device, counters, tmp: Path) -> None:
    """The extended timm variants on the card. A DeiT-3-layout and an
    MAE-layout ViT-B/16 224 ``.pth`` (``variant_state_dict``): the eval CLI
    on each (``--checkpoint``, adapted from the keys, ``route: cuda``), and
    each through ``RAJNIViT(kernels="cuda")``: K1 ×5, K2 ×7, K3 ×12, logits
    against the plain route at ``LOGITS_REL_L2``. Registers (``_reg4``),
    the distillation token and qk-norm: ``route: torch (an extended timm
    variant)``, no launch, finite logits, and the kept sets' sizes equal to
    ``model_stats``' token counts."""
    import dataclasses
    import io

    import torch

    from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT, run
    from rajni_tpu_torch.models.vit import (
        adapt_config_to_params,
        get_config,
        model_stats,
        vit_forward,
    )
    from rajni_tpu_torch.params.io import load_checkpoint_auto

    sched = tmp / "reference.json"
    sched.write_text(json.dumps({str(k): v for k, v in REFERENCE_SCHEDULE.items()}))
    gen = torch.Generator().manual_seed(23)
    x = torch.randn(64, 224, 224, 3, generator=gen).to(device)
    for layout in ("deit3", "mae"):
        path = tmp / f"{layout}.pth"
        torch.save({"model": variant_state_dict(layout)}, path)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run.main(["--checkpoint", str(path), "--synthetic", "1", "--batch_size", "64",
                      "--schedule", str(sched), "--warmup", "1", "--no-progress"])
        out = buf.getvalue()
        print(f"eval CLI on the {layout} .pth: " + " | ".join(
            l for l in out.splitlines() if l.startswith(("Adapted", "route:", "Token counts"))))
        check("route: cuda" in out.splitlines() and "Adapted config" in out,
              f"eval CLI {layout}: not adapted or not on the kernels")
        check(f"Token counts per block: {VIT_B_COUNTS}" in out, f"eval CLI {layout}: token counts")
        params = load_checkpoint_auto(str(path), PATH224, torch.bfloat16, device)
        cfg = adapt_config_to_params(get_config(PATH224), params)
        check(cfg.no_embed_class if layout == "deit3" else cfg.global_pool == "avg",
              f"{layout}: adapted to {cfg}")
        kernels = RAJNIViT(cfg, REFERENCE_SCHEDULE, params=params, kernels="cuda", device=device)
        plain = RAJNIViT(cfg, REFERENCE_SCHEDULE, params=params, kernels="torch", device=device)
        check(kernels.route == "route: cuda", f"{layout}: {kernels.route}")
        out, got = counted(counters, kernels, x)
        check(got == PATHS[PATH224]["launches"]["pruned"], f"{layout}: launches {got}")
        rel = rel_l2(out, plain(x))
        print(f"{layout} layout through RAJNIViT (batch 64): {kernels.route}, K1 ×5, K2 ×7, "
              f"K3 ×12; logits rel L2 kernels vs plain route {rel:.3e}")
        check(bool(torch.isfinite(out).all()) and rel <= LOGITS_REL_L2,
              f"{layout}: logits rel L2 {rel} > {LOGITS_REL_L2}")

    extended = {"_reg4": get_config("vit_base_patch16_reg4_224"),
                "distilled": get_config("deit_base_distilled_patch16_224"),
                "qk-norm": dataclasses.replace(get_config(PATH224), qk_norm=True)}
    for name, cfg in extended.items():
        model = RAJNIViT(cfg, REFERENCE_SCHEDULE, kernels="auto", device=device)
        check(model.route == "route: torch (an extended timm variant)", f"{name}: {model.route}")
        kept = {}
        with torch.no_grad():
            out, got = counted(counters, vit_forward, model.params, x[:8], cfg, model.schedule,
                               "auto", None, lambda i, k: kept.__setitem__(i, k.shape[1]))
        n, trace = cfg.num_tokens, []
        for i in range(cfg.depth):
            trace.append(n)
            n = kept.get(i, n)
        want = model_stats(cfg, REFERENCE_SCHEDULE)["token_counts"]
        print(f"{name} ({cfg.num_prefix_tokens} prefix tokens): {model.route}, token counts "
              f"{trace}, logits {tuple(out.shape)}")
        check(not any(got.values()), f"{name}: kernel launches {got}")
        check(trace == want, f"{name}: token counts {trace} != {want}")
        check(tuple(out.shape) == (8, 1000) and bool(torch.isfinite(out).all()),
              f"{name}: logits")


def serving_slice_phases(device, counters) -> None:
    """Export, ``--artifact``, serving, attestation and the extended
    variants, in one temporary directory; each part's time printed."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        arts = export_phases(device, counters, tmp)
        parts = [("export", t0)]
        for label, fn in (("--artifact", lambda: artifact_cli_phase(arts)),
                          ("serving", lambda: serving_phases(device, arts)),
                          ("attestation", lambda: attest_phases(device, arts, tmp)),
                          ("extended variants", lambda: variant_phases(device, counters, tmp))):
            parts.append((label, time.perf_counter()))
            fn()
        parts.append(("end", time.perf_counter()))
        print("serving slice parts: " + ", ".join(
            f"{a[0]} {b[1] - a[1]:.1f} s" for a, b in zip(parts, parts[1:])))


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
    # the row-band GEMM (csrc/band_s8.cuh) is compiled where its forms are used
    band = [src for src, rep in reports.items() if "band_s8_kernel" in rep]
    if reports:
        head_dim80_spills(reports)
        print(f"  csrc/band_s8.cuh's band_s8_kernel compiled in {band}, each held above to no "
              "spill and no serialized wgmma")
        check(set(BAND_SOURCES) <= set(band) and set(band) <= set(GEMM_SOURCES),
              f"band_s8_kernel compiled in {band}, not in {BAND_SOURCES} within the checked sources")

    peaks, int8_peak = device_peaks(device_name), device_int8_peak(device_name)
    results: dict = {}
    phases = [("C3: the weight quantizer on the card", lambda: c3_phase(device)),
              ("the short-row attention (csrc/short_attn.cu)",
               lambda: short_attn_phases(device, peaks, results)),
              ("kernel phases 224", lambda: kernel_phases(device, peaks, results)),
              ("kernel phases 384", lambda: long_phases(device, peaks, results)),
              ("kernel phases ViT-H/14 (C=1280, head_dim 80)",
               lambda: vit_h_phases(device, peaks, results)),
              ("int8 kernels at ViT-H/14 (C=1280, head_dim 80)",
               lambda: vit_h_int8_phases(device, peaks, int8_peak, results)),
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
              ("kernel phases B16/B17/B18 at T14 (ViT-H/14 training, C=1280, head_dim 80)",
               lambda: train_kernel_phases(device, peaks, results, TRAIN_H, C_H, HEADS_H,
                                           HIDDEN_H, B_TRAIN_H, (257, 180), (257, 61),
                                           tuple((B_TRAIN_H, n) for n in VIT_H_TRAIN_K),
                                           seed=16)),
              ("kernel phases B6/B18 at ragged lengths", lambda: ragged_phases(device)),
              ("GEMM (csrc/gemm_sm90.cuh) beside cuBLAS", lambda: gemm_phases(device, peaks)),
              ("int8 GEMM (csrc/gemm_sm90.cuh, S8Epi) beside torch._int_mm",
               lambda: s8_phases(device, peaks, int8_peak)),
              ("fc1's GELU quantized: the entry points' and the two-launch route",
               lambda: gelu_quant_phases(device, peaks, int8_peak)),
              ("the int8 attention tail: the new route and the two-launch route",
               lambda: tail_phases(device)),
              ("the row-band GEMM, the two-kernel route's selection, the folded static scales",
               lambda: band_phases(device, peaks, int8_peak, results)),
              ("score kernel", lambda: score_phases(device, peaks)),
              ("C5: head_dim 64 at C=1280 (score kernel, pruned forward, training step)",
               lambda: c5_phases(device, peaks, results, kernel_counters())),
              ("attention at and below 256 tokens", lambda: attention_phases(device, peaks)),
              ("training block ops", lambda: train_block_ops(device))]
    phases += [(f"end to end {path}", lambda path=path: end_to_end(device, device_name, results, path))
               for path in PATHS]
    phases += [("training end to end",
                lambda: train_end_to_end(device, device_name, results, kernel_counters())),
               ("T14 training end to end (ViT-H/14)",
                lambda: train_end_to_end(device, device_name, results, kernel_counters(),
                                         TRAIN_H)),
               ("eval CLI", eval_cli),
               ("the evaluation from images and a timm .pth",
                lambda: data_phases(device, kernel_counters())),
               ("export, serving, attestation, --artifact and the extended timm variants",
                lambda: serving_slice_phases(device, kernel_counters())),
               ("training and eval CLIs", lambda: train_cli(device)),
               (f"{PATH_H} training through the training CLI", lambda: vit_h_train_cli(device))]
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
