"""Static-shape token selection and residual-stream compaction (PyTorch).

Counterpart of ``rajni_tpu/ops/pruning.py``. The number of kept tokens
depends only on ``keep_ratio`` and the incoming token count; only the
gather indices depend on the data.

Selection contract:
  * ``keep = max(1, int(keep_ratio * (N - num_prefix)))`` patch tokens;
  * the top ``keep`` patch scores, ties broken to the LOWER index (as
    ``jax.lax.top_k`` does), returned in ascending index order after the
    always-kept prefix.

``torch.topk`` promises no tie order, so :func:`select_tokens` uses a
stable descending sort and :func:`select_tokens_dense` the rank-matrix
form; both give ``lax.top_k``'s set and order.
"""

from __future__ import annotations

import torch


def keep_count(keep_ratio: float, num_tokens: int, num_prefix: int = 1) -> int:
    """Number of patch tokens kept by a pruned block (prefix excluded)."""
    num_patches = num_tokens - num_prefix
    return max(1, int(keep_ratio * num_patches))


def select_tokens(
    scores: torch.Tensor, keep: int, num_prefix: int = 1
) -> torch.Tensor:
    """``[B, N]`` scores → ``keep_idx [B, keep + num_prefix]`` int64,
    prefix first, patches ascending."""
    B = scores.shape[0]
    patch = scores[:, num_prefix:]
    order = torch.sort(patch, dim=1, descending=True, stable=True).indices
    idx = torch.sort(order[:, :keep], dim=1).values
    prefix = torch.arange(num_prefix, device=scores.device).expand(B, -1)
    return torch.cat([prefix, idx + num_prefix], dim=1)


def gather_tokens(x: torch.Tensor, keep_idx: torch.Tensor) -> torch.Tensor:
    """Compact the token axis of ``[B, N, ...]`` to ``[B, K, ...]``."""
    idx = keep_idx.long().reshape(keep_idx.shape + (1,) * (x.ndim - 2))
    return torch.take_along_dim(x, idx, dim=1)


def select_tokens_dense(
    scores: torch.Tensor, keep: int, dtype=None, num_prefix: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-free selection: rank matrix + cumsum compaction.

    ``rank[b, n] = #{m : s_m > s_n or (s_m == s_n and m < n)}`` over patch
    tokens; ``keep_mask = rank < keep``; ``pos = cumsum(keep_mask) - 1``
    gives each kept token its output slot.

    Returns ``(keep_idx [B, K] int64, sel [B, K, N] dtype)`` with
    ``K = keep + num_prefix``.
    """
    B, N = scores.shape
    if dtype is None:
        dtype = scores.dtype
    p = scores[:, num_prefix:].float()
    n = N - num_prefix
    ahead = p[:, None, :] > p[:, :, None]  # [B, self, other]
    ar = torch.arange(n, device=scores.device)
    ties = (p[:, None, :] == p[:, :, None]) & (ar[None, :] < ar[:, None])
    rank = (ahead | ties).sum(dim=2)
    keep_mask = torch.cat(
        [torch.ones(B, num_prefix, dtype=torch.bool, device=scores.device),
         rank < keep],
        dim=1,
    )
    pos = torch.cumsum(keep_mask.long(), dim=1) - 1
    iota_k = torch.arange(keep + num_prefix, device=scores.device)
    sel_b = (pos[:, None, :] == iota_k[None, :, None]) & keep_mask[:, None, :]
    keep_idx = sel_b.long().argmax(dim=2)
    return keep_idx, sel_b.to(dtype)


def onehot_matrix(keep_idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """Selection matrix ``[B, K, N]`` with ``S[b, k, keep_idx[b, k]] = 1``."""
    iota = torch.arange(n, device=keep_idx.device)
    return (keep_idx[:, :, None] == iota).to(dtype)


def gather_tokens_matmul(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Token gather as a one-hot product ``[B, K, N] @ [B, N, C]``.

    0/1 entries make the fp32 product exact, so the result equals a
    gather bit for bit.
    """
    return torch.bmm(sel.float(), x.float()).to(x.dtype)
