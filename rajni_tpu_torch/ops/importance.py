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
    CLS) → scores ``[B, N]`` fp32. ``qk_norm`` is ``(attn params, eps)`` of
    a qk-normed block: the CLS row then comes from the per-head normed q
    and k, as in JAX (q in fp32, k normed in the activation dtype); the
    value signal takes the raw v."""
    B, N = qkv.shape[:2]
    C = qkv.shape[-1] // 3
    D = C // num_heads
    with torch.no_grad():
        q5 = qkv.reshape(B, N, 3, num_heads, D)
        q_cls = q5[:, 0, 0].float()  # [B, H, D]
        k = q5[:, :, 1]  # [B, N, H, D]
        if qk_norm is not None:
            from .attention import apply_qk_norm

            q_cls, k = apply_qk_norm(q_cls, k, *qk_norm)
        k = k.float()
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


# ---------------------------------------------------------------------------
# Tensor-parallel decomposition (``rajni_tpu/ops/importance.py:128-190``):
# each head shard computes the partial sums of the scorer's two cross-head
# means; one all-reduce over the ``model`` group completes them, and the rest
# (centring, norm, z-score, sigmoid) is the same replicated math on every
# shard.
# ---------------------------------------------------------------------------


def importance_partials(
    qkv_local: torch.Tensor,
    num_heads_local: int,
    *,
    qk_norm=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``qkv_local [B, N, 3C_l]`` (this shard's whole heads) → ``(a_cls_sum
    [B, N], v_sum [B, N, D])`` fp32: the sums over the local heads of the
    CLS softmax rows and of the value vectors, before the head means.
    ``qk_norm`` (``(attn params, eps)``) normalizes the CLS q and the keys
    per head as :func:`compute_importance` does; the norms are per head
    dim, so each shard applies them to its own heads."""
    B, N = qkv_local.shape[:2]
    C = qkv_local.shape[-1] // 3
    D = C // num_heads_local
    with torch.no_grad():
        q5 = qkv_local.reshape(B, N, 3, num_heads_local, D)
        q_cls = q5[:, 0, 0].float()
        k = q5[:, :, 1]
        if qk_norm is not None:
            from .attention import apply_qk_norm

            q_cls, k = apply_qk_norm(q_cls, k, *qk_norm)
        logits = torch.einsum("bhd,bnhd->bhn", q_cls, k.float())
        logits = logits / torch.full_like(logits[..., :1], math.sqrt(D))
        a_sum = torch.softmax(logits, dim=-1).sum(dim=1)  # [B, N]
        v_sum = q5[:, :, 2].float().sum(dim=2)  # [B, N, D]
        return a_sum, v_sum


def importance_from_partials(
    a_cls_sum: torch.Tensor,
    v_sum: torch.Tensor,
    num_heads_total: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The scores ``[B, N]`` fp32 from the all-reduced partial sums: the
    head means as ``sum · (1/H)``, then :func:`compute_importance`'s value
    statistics (an associativity-level difference from its fused means)."""
    with torch.no_grad():
        inv = 1.0 / num_heads_total
        a_cls = a_cls_sum * inv
        V = v_sum * inv
        V = V - V.mean(dim=1, keepdim=True)
        v_norm = torch.linalg.vector_norm(V, dim=-1)
        mu = v_norm.mean(dim=1, keepdim=True)
        std = torch.std(v_norm, dim=1, keepdim=True, correction=1) + eps
        z = torch.sigmoid((v_norm - mu) / std)
        return a_cls * z
