"""Multi-head self-attention ops, stock and token-pruning (PyTorch
counterpart of ``rajni_tpu/ops/attention.py``).

Weights are stored as ``nn.Linear`` does, ``weight [out, in]``; the packed
QKV output keeps the ``(qkv, head, dim)`` lane order. ``impl="torch"`` runs
the SDPA as plain ops (JAX's ``"xla"``); ``impl="cuda"`` runs it through B6
:func:`..kernels.attention.fused_sdpa` and selects with
:func:`.pruning.select_tokens_dense` (JAX's ``"pallas"``).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..kernels.attention import fused_sdpa
from .importance import compute_importance
from .pruning import gather_tokens, select_tokens, select_tokens_dense

AttnParams = Mapping[str, Any]


def _linear(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return x @ p["weight"].t() + p["bias"]


def _qkv_projection(x: torch.Tensor, params: AttnParams) -> torch.Tensor:
    """Packed QKV linear: ``[B, N, C] -> [B, N, 3C]``."""
    return _linear(x, params["qkv"])


def _sdpa(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Softmax SDPA on packed QKV ``[B, N, 3C] -> [B, N, C]``; logits in the
    activation dtype, softmax in fp32, probabilities cast back."""
    B, N = qkv.shape[:2]
    C = qkv.shape[-1] // 3
    D = C // num_heads
    q5 = qkv.reshape(B, N, 3, num_heads, D)
    q, k, v = q5[:, :, 0], q5[:, :, 1], q5[:, :, 2]
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return out.reshape(B, N, C)


def _dispatch_sdpa(qkv: torch.Tensor, num_heads: int, scale: float, impl: str) -> torch.Tensor:
    """``"torch"`` (:func:`_sdpa`) or ``"cuda"`` (B6 ``fused_sdpa``)."""
    if impl == "torch":
        return _sdpa(qkv, num_heads, scale)
    if impl == "cuda":
        return fused_sdpa(qkv, num_heads, scale)
    raise ValueError(f"unknown attention impl {impl!r}; use 'torch' or 'cuda'")


def attention(
    x: torch.Tensor, params: AttnParams, num_heads: int, scale: float,
    impl: str = "torch",
) -> torch.Tensor:
    """Stock multi-head self-attention on ``[B, N, C]``."""
    out = _dispatch_sdpa(_qkv_projection(x, params), num_heads, scale, impl)
    return _linear(out, params["proj"])


def pruned_attention(
    x: torch.Tensor,
    params: AttnParams,
    num_heads: int,
    scale: float,
    keep: int,
    update: bool,
    prev_scores: torch.Tensor | None,
    impl: str = "torch",
    num_prefix: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score → select → prune → attend.

    ``x`` is the post-norm1 ``[B, N, C]``. QKV is projected on all N
    tokens; scores are recomputed iff ``update or prev_scores is None``.
    Returns ``(out [B, K, C], keep_idx [B, K], next_scores [B, K])`` with
    ``K = keep + num_prefix``; ``next_scores`` is gathered from the
    original scores.
    """
    qkv = _qkv_projection(x, params)
    if update or prev_scores is None:
        scores = compute_importance(qkv, num_heads)
    else:
        scores = prev_scores
    if impl == "cuda":
        keep_idx, _ = select_tokens_dense(scores, keep, torch.bool, num_prefix)
    else:
        keep_idx = select_tokens(scores, keep, num_prefix)
    out = _dispatch_sdpa(gather_tokens(qkv, keep_idx), num_heads, scale, impl)
    out = _linear(out, params["proj"])
    next_scores = torch.take_along_dim(scores, keep_idx, dim=1)
    return out, keep_idx, next_scores
