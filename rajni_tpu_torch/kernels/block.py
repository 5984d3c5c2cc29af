"""K1 ``fused_pruned_attn_block`` and K2 ``fused_attn_block``: the attention
halves of a pruned and of a stock block.

Ports of ``rajni_tpu/kernels/block.py:fused_pruned_attn_block`` and
``fused_attn_block``. On a CUDA tensor each wrapper launches its
hand-written kernel (``csrc/pruned_attn_block.cu``, ``csrc/attn_block.cu``);
on a CPU tensor it runs the plain PyTorch version beside it.

Numeric contract (shared with the TPU kernels, ``block.py:30-31``):
  * LayerNorm statistics fp32, normed rows rounded to the activation dtype;
  * ``qkv = y @ Wqkv + b`` accumulated in fp32, rounded;
  * scores in fp32 from that rounded qkv (:func:`_importance_f32`);
  * SDPA in the "phased" form: ``q * scale`` in fp32 then rounded, logits
    fp32, softmax fp32 as ``exp(l - max) * (1 / sum)``, P rounded before
    P·V, per-head outputs rounded before proj;
  * residual ``x32 + (acc + b) * ls`` in fp32, stored in the activation
    dtype; in K1 the gathered pre-norm x stays fp32 until that add;
  * selection (``_select_from_scores`` on the TPU): CLS ranked +inf, the top
    ``K = keep + 1`` kept in ascending index order, ties to the lower
    index, ``next_scores`` the real scores of the kept tokens.

The TPU kernels switch to a per-head loop with the scale on the logits when
``H·N²·6`` exceeds 4 MiB (N > ~240 at H=12); the CUDA attention kernel
keeps the phased form up to its own limit of ``ATTN_MAX_N`` tokens, and the
plain versions follow the kernel.
"""

from __future__ import annotations

import math

import torch

from ..ops.pruning import select_tokens_dense
from .build import F, I, P, CudaKernel, check_cuda, ptr, stream
from .mlp import _layer_norm_f32, _mm

ATTN_MAX_N = 256  # csrc/common.cuh: whole softmax rows in registers
HEAD_DIM = 64  # csrc/common.cuh: ATTN_D

PRUNED_KERNEL = CudaKernel(
    "rajni_pruned_attn_block",
    [P, P, P, P, P, P, P, P, P, I, P, P, P, P, P, P, I, I, I, I, I, F, F, P],
)
ATTN_KERNEL = CudaKernel(
    "rajni_attn_block",
    [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, F, P],
)


def _mha(qkv: torch.Tensor, num_heads: int, scale: float, out_dtype) -> torch.Tensor:
    """Phased SDPA on packed ``[B, N, 3C]`` (lanes ``(qkv, head, dim)``)."""
    B, N, three_c = qkv.shape
    C = three_c // 3
    D = C // num_heads
    q5 = qkv.reshape(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)  # [3,B,H,N,D]
    q, k, v = q5[0], q5[1], q5[2]
    qs = (q.float() * scale).to(qkv.dtype)
    logits = qs.float() @ k.float().transpose(-1, -2)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = (p * (1.0 / p.sum(dim=-1, keepdim=True))).to(qkv.dtype)
    out = p.float() @ v.float()  # [B, H, N, D]
    return out.permute(0, 2, 1, 3).reshape(B, N, C).to(out_dtype)


def _importance_f32(qkv32: torch.Tensor, num_heads: int, eps: float = 1e-6):
    """RAJNI scores ``[B, N]`` from an fp32 ``[B, N, 3C]`` qkv, following
    ``rajni_tpu/kernels/block.py:_importance_f32``."""
    B, N, three_c = qkv32.shape
    C = three_c // 3
    H = num_heads
    D = C // H
    q5 = qkv32.reshape(B, N, 3, H, D)
    logits = torch.einsum("bhd,bnhd->bhn", q5[:, 0, 0], q5[:, :, 1]) * (
        1.0 / math.sqrt(D)
    )
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = p * (1.0 / p.sum(dim=-1, keepdim=True))
    a_cls = p.mean(dim=1)  # [B, N]
    V = (q5[:, :, 2] * (1.0 / H)).sum(dim=2)  # [B, N, D] head mean
    V = V - V.mean(dim=1, keepdim=True)
    vn = torch.sqrt((V * V).sum(dim=2))
    mu = vn.mean(dim=1, keepdim=True)
    var = (vn - mu).square().sum(dim=1, keepdim=True) / (N - 1)
    std = torch.sqrt(var) + eps
    return a_cls * torch.sigmoid((vn - mu) / std)


def attn_block_plain(
    x: torch.Tensor, ln_params, attn_params, ls, num_heads: int, scale: float,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    x32 = x.float()
    y = _layer_norm_f32(x32, ln_params["scale"], ln_params["bias"], eps).to(x.dtype)
    qkv = (_mm(y, attn_params["qkv"]["weight"]) + attn_params["qkv"]["bias"].float()).to(x.dtype)
    a = _mha(qkv, num_heads, scale, x.dtype)
    out = _mm(a, attn_params["proj"]["weight"]) + attn_params["proj"]["bias"].float()
    if ls is not None:
        out = out * ls.float()
    return (x32 + out).to(x.dtype)


def pruned_attn_block_plain(
    x: torch.Tensor, ln_params, attn_params, ls, prev_scores, num_heads: int,
    keep: int, scale: float, eps: float = 1e-6, with_scores: bool = True,
):
    """Plain PyTorch version of K1: ``(x [B, K, C], next_scores [B, K],
    keep_idx [B, K])`` with ``K = keep + 1``."""
    x32 = x.float()
    y = _layer_norm_f32(x32, ln_params["scale"], ln_params["bias"], eps).to(x.dtype)
    qkv = (_mm(y, attn_params["qkv"]["weight"]) + attn_params["qkv"]["bias"].float()).to(x.dtype)
    s = _importance_f32(qkv.float(), num_heads) if with_scores else prev_scores.float()
    # the kernel ranks CLS as +inf among all N; ranking the patches alone
    # and prepending CLS keeps the same set in the same order
    keep_idx, _ = select_tokens_dense(s, keep)
    next_scores = torch.take_along_dim(s, keep_idx, dim=1)
    qkv_g = torch.take_along_dim(qkv, keep_idx[..., None], dim=1)
    x_g32 = torch.take_along_dim(x32, keep_idx[..., None], dim=1)
    a = _mha(qkv_g, num_heads, scale, x.dtype)
    out = _mm(a, attn_params["proj"]["weight"]) + attn_params["proj"]["bias"].float()
    if ls is not None:
        out = out * ls.float()
    return (x_g32 + out).to(x.dtype), next_scores, keep_idx


def _check_attn_shapes(name: str, N: int, C: int, num_heads: int) -> None:
    if C % 128 or C > 1024 or C // num_heads != HEAD_DIM or C % num_heads:
        raise ValueError(
            f"{name} needs C % 128 == 0, C <= 1024 and head_dim {HEAD_DIM}; "
            f"got C={C}, heads={num_heads}"
        )
    if not 2 <= N <= ATTN_MAX_N:
        raise ValueError(f"{name} supports 2 <= N <= {ATTN_MAX_N}, got N={N}")


def fused_attn_block(
    x: torch.Tensor, ln_params, attn_params, ls, num_heads: int, scale: float,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``x + ls1 * proj(mhsa(qkv(norm1(x))))`` on ``[B, N, C]``."""
    if x.device.type == "cpu":
        return attn_block_plain(x, ln_params, attn_params, ls, num_heads, scale, eps)
    B, N, C = x.shape
    qkv_p, proj_p = attn_params["qkv"], attn_params["proj"]
    check_cuda(
        torch.bfloat16, x=x, ln_scale=ln_params["scale"], ln_bias=ln_params["bias"],
        wqkv=qkv_p["weight"], bqkv=qkv_p["bias"], wproj=proj_p["weight"],
        bproj=proj_p["bias"], ls=ls,
    )
    _check_attn_shapes("fused_attn_block", N, C, num_heads)
    rows = B * N
    y = torch.empty(rows, C, dtype=x.dtype, device=x.device)
    qkv = torch.empty(rows, 3 * C, dtype=x.dtype, device=x.device)
    attn = torch.empty(rows, C, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    ATTN_KERNEL(
        ptr(x), ptr(ln_params["scale"]), ptr(ln_params["bias"]), ptr(qkv_p["weight"]),
        ptr(qkv_p["bias"]), ptr(proj_p["weight"]), ptr(proj_p["bias"]), ptr(ls),
        ptr(y), ptr(qkv), ptr(attn), ptr(out), B, N, C, num_heads, float(scale),
        float(eps), stream(),
    )
    return out


def fused_pruned_attn_block(
    x: torch.Tensor, ln_params, attn_params, ls, prev_scores, num_heads: int,
    keep: int, scale: float, eps: float = 1e-6, with_scores: bool = True,
):
    """Pruned attention half: ``(x [B, K, C], next_scores [B, K] fp32,
    keep_idx [B, K])`` with ``K = keep + 1``. ``with_scores=False`` selects
    from ``prev_scores [B, N]`` instead of rescoring."""
    if not with_scores and prev_scores is None:
        raise ValueError("with_scores=False needs prev_scores")
    if x.device.type == "cpu":
        return pruned_attn_block_plain(
            x, ln_params, attn_params, ls, prev_scores, num_heads, keep, scale,
            eps, with_scores,
        )
    B, N, C = x.shape
    K = keep + 1
    qkv_p, proj_p = attn_params["qkv"], attn_params["proj"]
    check_cuda(
        torch.bfloat16, x=x, ln_scale=ln_params["scale"], ln_bias=ln_params["bias"],
        wqkv=qkv_p["weight"], bqkv=qkv_p["bias"], wproj=proj_p["weight"],
        bproj=proj_p["bias"], ls=ls,
    )
    prev = None
    if not with_scores:
        prev = prev_scores
        check_cuda(torch.float32, prev_scores=prev)
        if prev.shape != (B, N):
            raise ValueError(f"prev_scores must be [{B}, {N}], got {tuple(prev.shape)}")
    _check_attn_shapes("fused_pruned_attn_block", N, C, num_heads)
    if not 1 <= keep < N:
        raise ValueError(f"keep must be in [1, {N - 1}], got {keep}")
    dev = x.device
    y = torch.empty(B * N, C, dtype=x.dtype, device=dev)
    qkv = torch.empty(B * N, 3 * C, dtype=x.dtype, device=dev)
    attn = torch.empty(B * K, C, dtype=x.dtype, device=dev)
    idx = torch.empty(B, K, dtype=torch.int32, device=dev)
    next_scores = torch.empty(B, K, dtype=torch.float32, device=dev)
    out = torch.empty(B, K, C, dtype=x.dtype, device=dev)
    PRUNED_KERNEL(
        ptr(x), ptr(ln_params["scale"]), ptr(ln_params["bias"]), ptr(qkv_p["weight"]),
        ptr(qkv_p["bias"]), ptr(proj_p["weight"]), ptr(proj_p["bias"]), ptr(ls),
        ptr(prev), int(with_scores), ptr(y), ptr(qkv), ptr(attn), ptr(idx),
        ptr(next_scores), ptr(out), B, N, K, C, num_heads, float(scale), float(eps),
        stream(),
    )
    return out, next_scores, idx.long()
