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
from ..kernels.mlp import _layer_norm_f32
from .importance import compute_importance
from .pruning import gather_tokens, select_tokens, select_tokens_dense

AttnParams = Mapping[str, Any]


def _linear(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return x @ p["weight"].t() + p["bias"]


def _qkv_projection(x: torch.Tensor, params: AttnParams) -> torch.Tensor:
    """Packed QKV linear: ``[B, N, C] -> [B, N, 3C]``."""
    return _linear(x, params["qkv"])


def _head_layer_norm(x: torch.Tensor, params: Mapping[str, torch.Tensor],
                     eps: float) -> torch.Tensor:
    """Per-head LayerNorm over the head dim (timm ``qk_norm``): fp32
    statistics, output in ``x``'s dtype."""
    return _layer_norm_f32(x.float(), params["scale"], params["bias"], eps).to(x.dtype)


def apply_qk_norm(q: torch.Tensor, k: torch.Tensor, params: AttnParams,
                  eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's per-head q/k LayerNorms where ``params`` carries them
    (``rajni_tpu/ops/attention.py:apply_qk_norm``); ``q``/``k`` are ``[...,
    D]``. A no-op for classic blocks."""
    if "q_norm" not in params:
        return q, k
    return (_head_layer_norm(q, params["q_norm"], eps),
            _head_layer_norm(k, params["k_norm"], eps))


def _sdpa(qkv: torch.Tensor, num_heads: int, scale: float,
          qk_norm: tuple[AttnParams, float] | None = None) -> torch.Tensor:
    """Softmax SDPA on packed QKV ``[B, N, 3C] -> [B, N, C]``; logits in the
    activation dtype, softmax in fp32, probabilities cast back. ``qk_norm``
    is ``(attn params, eps)`` for qk-normed blocks."""
    B, N = qkv.shape[:2]
    C = qkv.shape[-1] // 3
    D = C // num_heads
    q5 = qkv.reshape(B, N, 3, num_heads, D)
    q, k, v = q5[:, :, 0], q5[:, :, 1], q5[:, :, 2]
    if qk_norm is not None:
        q, k = apply_qk_norm(q, k, *qk_norm)
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return out.reshape(B, N, C)


def _check_impl(impl: str, qk_norm: tuple[AttnParams, float] | None) -> None:
    """Refuse an unknown ``impl``, and ``"cuda"`` on a qk-normed block: B6
    and the dense selection take no per-head norms, so such a block is an
    extended timm variant that only ``"torch"`` runs (``resolve_route``
    demotes it there)."""
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown attention impl {impl!r}; use 'torch' or 'cuda'")
    if impl == "cuda" and qk_norm is not None:
        raise ValueError("impl='cuda' does not take a qk-normed block (an extended timm "
                         "variant: B6 has no per-head q/k norms); use impl='torch'")


def _dispatch_sdpa(qkv: torch.Tensor, num_heads: int, scale: float, impl: str,
                   qk_norm: tuple[AttnParams, float] | None = None) -> torch.Tensor:
    """``"torch"`` (:func:`_sdpa`) or ``"cuda"`` (B6 ``fused_sdpa``); see
    :func:`_check_impl` for what ``"cuda"`` refuses."""
    _check_impl(impl, qk_norm)
    if impl == "torch":
        return _sdpa(qkv, num_heads, scale, qk_norm)
    return fused_sdpa(qkv, num_heads, scale)


def attention(
    x: torch.Tensor, params: AttnParams, num_heads: int, scale: float,
    impl: str = "torch", norm_eps: float = 1e-6,
) -> torch.Tensor:
    """Stock multi-head self-attention on ``[B, N, C]``, with the per-head
    q/k LayerNorms where ``params`` carries them (``norm_eps`` their eps)."""
    qk = (params, norm_eps) if "q_norm" in params else None
    out = _dispatch_sdpa(_qkv_projection(x, params), num_heads, scale, impl, qk)
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
    norm_eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score → select → prune → attend.

    ``x`` is the post-norm1 ``[B, N, C]``. QKV is projected on all N
    tokens; scores are recomputed iff ``update or prev_scores is None``.
    The ``num_prefix`` leading tokens (CLS, the distillation token, the
    registers) are always kept and never ranked. Where ``params`` carries
    ``q_norm``/``k_norm`` (eps ``norm_eps``), both the attention and the
    scores' CLS row take the normed q and k. Returns ``(out [B, K, C],
    keep_idx [B, K], next_scores [B, K])`` with ``K = keep + num_prefix``;
    ``next_scores`` is gathered from the original scores.
    """
    qk = (params, norm_eps) if "q_norm" in params else None
    _check_impl(impl, qk)
    qkv = _qkv_projection(x, params)
    if update or prev_scores is None:
        scores = compute_importance(qkv, num_heads, qk_norm=qk)
    else:
        scores = prev_scores
    if impl == "cuda":
        keep_idx, _ = select_tokens_dense(scores, keep, torch.bool, num_prefix)
    else:
        keep_idx = select_tokens(scores, keep, num_prefix)
    out = _dispatch_sdpa(gather_tokens(qkv, keep_idx), num_heads, scale, impl, qk)
    out = _linear(out, params["proj"])
    next_scores = torch.take_along_dim(scores, keep_idx, dim=1)
    return out, keep_idx, next_scores
