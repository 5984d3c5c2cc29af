"""B6 ``fused_sdpa``: multi-head self-attention on packed QKV.

Port of ``rajni_tpu/kernels/attention.py:fused_sdpa``. On a CUDA tensor the
wrapper launches the hand-written Hopper kernel (``csrc/sdpa.cu``: wgmma,
TMA or cp.async tiles on mbarriers, one pass with the softmax row in
registers up to 640 tokens, two passes past that); on a CPU tensor it runs
:func:`fused_sdpa_plain`, the same function in plain PyTorch.

Numeric contract (the "per-head" form of the TPU kernel, ``attention.py:
53-67``): ``logits = (q·kᵀ) * scale`` in fp32 from the unscaled operands,
softmax in fp32 as ``exp(l - max) * (1 / sum)``, P rounded to the activation
dtype before P·V, P·V accumulated in fp32, output rounded.

The same kernel body (``rajni_sdpa_body``) is the attention inside K2
``fused_attn_block``, B5 ``fused_gather_sdpa_proj_residual``, K1/B20 and the
int8 tails past ``ATTN_MAX_N`` tokens, where the register-resident kernel of
K1/K2 cannot hold a softmax row.
"""

from __future__ import annotations

import torch

from .build import F, I, P, CudaKernel, check_cuda, ptr, stream

HEAD_DIM = 64  # csrc/common.cuh: ATTN_D
# csrc/common.cuh: SDPA_MAX_N, the longest sequence a path sends to the
# kernels (the config demotes past it, models/vit.py:cuda_kernels_take).
SDPA_MAX_N = 848

SDPA_KERNEL = CudaKernel("rajni_sdpa", [P, P, I, I, I, I, F, P])


def _packed(qkv: torch.Tensor) -> torch.Tensor:
    """``[B, N, 3, C]`` (the head-aligned tensor-parallel layout) has the
    same element order as ``[B, N, 3C]``; flatten it."""
    if qkv.ndim == 4:
        return qkv.reshape(qkv.shape[0], qkv.shape[1], -1)
    return qkv


def _sdpa_perhead(qkv: torch.Tensor, num_heads: int, scale: float, out_dtype) -> torch.Tensor:
    """Per-head SDPA on packed ``[B, N, 3C]`` (lanes ``(qkv, head, dim)``),
    the scale applied to the fp32 logits."""
    B, N, three_c = qkv.shape
    C = three_c // 3
    D = C // num_heads
    q5 = qkv.reshape(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)  # [3,B,H,N,D]
    q, k, v = q5[0], q5[1], q5[2]
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = (p * (1.0 / p.sum(dim=-1, keepdim=True))).to(qkv.dtype)
    out = p.float() @ v.float()  # [B, H, N, D]
    return out.permute(0, 2, 1, 3).reshape(B, N, C).to(out_dtype)


def fused_sdpa_plain(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of B6: ``[B, N, 3C]`` or ``[B, N, 3, C]`` →
    ``[B, N, C]``."""
    qkv = _packed(qkv)
    if qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(f"C={qkv.shape[-1] // 3} not divisible by num_heads={num_heads}")
    return _sdpa_perhead(qkv, num_heads, scale, qkv.dtype)


def fused_sdpa(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Fused SDPA on packed QKV: ``[B, N, 3C]`` (or ``[B, N, 3, C]``) →
    ``[B, N, C]``."""
    if qkv.device.type == "cpu":
        return fused_sdpa_plain(qkv, num_heads, scale)
    qkv = _packed(qkv)
    check_cuda(torch.bfloat16, qkv=qkv)
    B, N, three_c = qkv.shape
    C = three_c // 3
    if three_c % 3 or C != num_heads * HEAD_DIM:
        raise ValueError(
            f"fused_sdpa needs head_dim {HEAD_DIM}; got C={C}, heads={num_heads}"
        )
    if not 1 <= N <= SDPA_MAX_N:
        raise ValueError(f"fused_sdpa supports 1 <= N <= {SDPA_MAX_N}, got N={N}")
    out = torch.empty(B, N, C, dtype=qkv.dtype, device=qkv.device)
    SDPA_KERNEL(ptr(qkv), ptr(out), B, N, C, num_heads, float(scale), stream())
    return out
