"""B20 ``fused_pruned_attn_block_long``: the pruned attention half of a
block at any sequence length, LN1 → QKV → RAJNI scores (or the threaded
ones) → selection → attention on the kept tokens → proj → compacted
residual.

Port of ``rajni_tpu/kernels/longseq.py``. On a CUDA tensor the wrapper
launches K1's hand-written entry point (``csrc/pruned_attn_block.cu``),
which takes B6's attention past ``ATTN_MAX_N`` kept tokens, at N up
to ``SDPA_MAX_N``; this wrapper admits those lengths and counts its own
launches. On a CPU tensor it runs :func:`pruned_attn_block_long_plain`.

Numeric contract: the JAX package's test defines the kernel as equal to the
two-kernel composition B4 → selection → B5 (``tests/test_kernels.py:336``),
which is K1's function, so the plain version is K1's
(:func:`.block.pruned_attn_block_plain`). The TPU kernel takes the
attention in the per-head form at every length (``longseq.py:229-243``);
the plain ``_mha`` does so past ``H·N²·6 > 4 MiB``, and at head_dim 64,
where the scale is 1/8, the two forms give the same bits. The TPU kernel's
128-row token chunking is a VMEM device and is not carried over. No route
of either package takes this kernel (``rajni_tpu/models/vit.py:852-862``:
measured slower there than the two-kernel route).
"""

from __future__ import annotations

import torch

from .attention import SDPA_MAX_N
from .block import (
    _check_attn_shapes,
    _check_prev_scores,
    PRUNED_KERNEL,
    _score_fits,
    pruned_attn_block_plain as pruned_attn_block_long_plain,
)
from .build import CudaKernel, check_cuda, ptr, stream
from .wholeblock import _VMEM_BUDGET

LONG_KERNEL = CudaKernel("rajni_pruned_attn_block", PRUNED_KERNEL.argtypes)

# The JAX package's VMEM fit rule for its chunked kernel (longseq.py:45,
# 253-267), copied: a TPU fact that chooses no Hopper tile and routes
# nothing here, kept so the two packages answer alike.
_RC = 128


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def longseq_block_fits(N: int, K: int, C: int, itemsize: int) -> bool:
    """Whether the TPU kernel's chunked footprint fits its VMEM budget."""
    n8 = _round_up(N, 8)
    k_pad = _round_up(K, _RC)
    scratch = (n8 * 3 * C + k_pad * 3 * C + k_pad * C) * itemsize
    weights = 4 * C * C * itemsize
    io = 2 * (N * C + _RC * C + 2 * N) * itemsize
    transient = _RC * 3 * C * 4 + 2 * _RC * N * 4 + _RC * K * 4
    return scratch + weights + io + transient <= _VMEM_BUDGET


def fused_pruned_attn_block_long(x, ln_params, attn_params, ls, prev_scores, num_heads: int,
                                 keep: int, scale: float, eps: float = 1e-6,
                                 with_scores: bool = True):
    """Pruned attention half for long sequences: ``(x [B, K, C], next_scores
    [B, K] fp32, keep_idx [B, K])`` with ``K = keep + 1``, N up to
    ``SDPA_MAX_N``. ``with_scores=False`` selects from ``prev_scores [B,
    N]``."""
    if not with_scores and prev_scores is None:
        raise ValueError("with_scores=False needs prev_scores")
    if x.device.type == "cpu":
        return pruned_attn_block_long_plain(x, ln_params, attn_params, ls, prev_scores,
                                            num_heads, keep, scale, eps, with_scores)
    B, N, C = x.shape
    K = keep + 1
    qkv_p, proj_p = attn_params["qkv"], attn_params["proj"]
    check_cuda(
        torch.bfloat16, x=x, ln_scale=ln_params["scale"], ln_bias=ln_params["bias"],
        wqkv=qkv_p["weight"], bqkv=qkv_p["bias"], wproj=proj_p["weight"],
        bproj=proj_p["bias"], ls=ls,
    )
    prev = _check_prev_scores(prev_scores, with_scores, B, N)
    _check_attn_shapes("fused_pruned_attn_block_long", N, C, num_heads, SDPA_MAX_N)
    if not 1 <= keep < N:
        raise ValueError(f"keep must be in [1, {N - 1}], got {keep}")
    if with_scores and not _score_fits(N, C, num_heads):
        raise ValueError(f"fused_pruned_attn_block_long cannot score N={N}, C={C}, "
                         f"heads={num_heads}")
    dev = x.device
    y = torch.empty(B * N, C, dtype=x.dtype, device=dev)
    qkv = torch.empty(B * N, 3 * C, dtype=x.dtype, device=dev)
    scores = torch.empty(B, N, dtype=torch.float32, device=dev) if with_scores else None
    attn = torch.empty(B * K, C, dtype=x.dtype, device=dev)
    idx = torch.empty(B, K, dtype=torch.int32, device=dev)
    next_scores = torch.empty(B, K, dtype=torch.float32, device=dev)
    out = torch.empty(B, K, C, dtype=x.dtype, device=dev)
    LONG_KERNEL(
        ptr(x), ptr(ln_params["scale"]), ptr(ln_params["bias"]), ptr(qkv_p["weight"]),
        ptr(qkv_p["bias"]), ptr(proj_p["weight"]), ptr(proj_p["bias"]), ptr(ls),
        ptr(prev), int(with_scores), ptr(y), ptr(qkv), ptr(scores), ptr(attn), ptr(idx),
        ptr(next_scores), ptr(out), B, N, K, C, num_heads, float(scale), float(eps),
        stream(),
    )
    return out, next_scores, idx.long()
