"""RAJNI token-importance scoring (PyTorch counterpart of
``rajni_tpu/ops/importance.py``).

Per token: the head-averaged CLS attention row, times the sigmoid of a
z-score of the centred head-mean value norm. Numerics:
  * fp32 throughout; CLS logits scaled by ``1/sqrt(D)``;
  * values head-averaged first, centred over tokens, L2 norm per token;
  * z-score with the UNBIASED std (``correction=1``), ``eps`` added after
    the square root.
"""

from __future__ import annotations

import math

import torch


def compute_importance(
    qkv: torch.Tensor,
    num_heads: int,
    eps: float = 1e-6,
    *,
    qk_norm=None,
) -> torch.Tensor:
    """``qkv [B, N, 3C]`` (lanes in ``(qkv, head, dim)`` order, token 0 =
    CLS) → scores ``[B, N]`` fp32."""
    if qk_norm is not None:
        raise NotImplementedError(
            "qk-normed variants are not ported yet (extended timm variants)"
        )
    B, N = qkv.shape[:2]
    C = qkv.shape[-1] // 3
    D = C // num_heads
    with torch.no_grad():
        q5 = qkv.reshape(B, N, 3, num_heads, D)
        q_cls = q5[:, 0, 0].float()  # [B, H, D]
        k = q5[:, :, 1].float()  # [B, N, H, D]
        logits = torch.einsum("bhd,bnhd->bhn", q_cls, k)
        # a true division on CUDA too (a Python divisor is a reciprocal multiply)
        logits = logits / torch.full_like(logits[..., :1], math.sqrt(D))
        a_cls = torch.softmax(logits, dim=-1).mean(dim=1)  # [B, N]

        V = q5[:, :, 2].float().mean(dim=2)  # [B, N, D]
        V = V - V.mean(dim=1, keepdim=True)
        v_norm = torch.linalg.vector_norm(V, dim=-1)  # [B, N]
        mu = v_norm.mean(dim=1, keepdim=True)
        std = torch.std(v_norm, dim=1, keepdim=True, correction=1) + eps
        z = torch.sigmoid((v_norm - mu) / std)
        return a_cls * z
