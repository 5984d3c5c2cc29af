"""The attention halves of a block: K1 ``fused_pruned_attn_block``, K2
``fused_attn_block``, the two kernels of the long-sequence pruned route, B4
``fused_ln_qkv`` and B5 ``fused_gather_sdpa_proj_residual``, their int8
counterparts B11 ``fused_pruned_attn_block_int8``, B10
``fused_attn_block_int8``, B12 ``fused_ln_qkv_int8`` and B13
``fused_gather_sdpa_proj_residual_int8``, and B19 ``fused_ln_qkv_select``
(B4 with the selection in the same call, which no route takes).

Ports of the functions of the same names in ``rajni_tpu/kernels/block.py``.
On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/pruned_attn_block.cu``, ``csrc/attn_block.cu``, ``csrc/ln_qkv.cu``,
``csrc/gather_attn.cu``, ``csrc/pruned_attn_block_int8.cu``,
``csrc/attn_block_int8.cu``, ``csrc/ln_qkv_int8.cu``,
``csrc/gather_attn_int8.cu``, ``csrc/ln_qkv_select.cu``); on a CPU tensor
it runs the plain PyTorch version beside it.

Numeric contract (shared with the TPU kernels, ``block.py:30-31``):
  * LayerNorm statistics fp32, normed rows rounded to the activation dtype;
  * ``qkv = y @ Wqkv + b`` accumulated in fp32, rounded;
  * scores in fp32 from that rounded qkv (:func:`_importance_f32`);
  * SDPA (:func:`_mha`) with logits and softmax in fp32 as
    ``exp(l - max) * (1 / sum)``, P rounded before P·V, per-head outputs
    rounded before proj;
  * residual ``x32 + (acc + b) * ls`` in fp32, stored in the activation
    dtype; the gathered pre-norm x stays fp32 until that add;
  * selection (``_select_from_scores`` on the TPU): CLS ranked +inf, the top
    ``K = keep + 1`` kept in ascending index order, ties to the lower
    index, ``next_scores`` the real scores of the kept tokens.

The SDPA has two forms, switched as the TPU kernels switch them
(``block.py:136``): the "phased" form (``q * scale`` in fp32, rounded, then
the logits, :func:`..attention._sdpa_phased`) while ``H·N²·6 <= 4 MiB``, else
the per-head form (scale on the fp32 logits,
:func:`..attention.fused_sdpa_plain`). On the card the short-row kernel
(``N <= ATTN_MAX_N``, ``csrc/short_attn.cu``) and B6's body (``N >
ATTN_MAX_N``) take the same switch (``csrc/common.cuh:mha_phased``): in the
phased form they round ``q * scale`` in the Q tile. At head_dim 64 the scale
is 1/8, a power of two, so both forms give the same bits and the kernels
keep the per-head one there; at head_dim 80 (ViT-H/14) they do not.

The int8 kernels (``block.py:1098-1440``) quantize the LN output straight
from fp32 (its statistics summed in the kernel's order,
:func:`..mlp._layer_norm_int8`, so that kernel and plain version agree bit
for bit) and the attention output before proj, per row or with calibrated
static scales folded into the operands (:func:`..math.fold_static_attn`);
qkv is rounded to the activation dtype (B11 and B12 score it, B12 stores it,
B10's attention casts it). B10 and B11 round their attention output to the
activation dtype before quantizing it (``_mha_mixed(..., x_ref.dtype,
...)``, ``block.py:1255``, and ``_mha_mixed(..., dtype, dtype, ...)``,
``block.py:2566``); B13, like B14 and B15, keeps it fp32 (``block.py:1122``).
Under static scales B12 folds ``1/a_proj`` into the V columns, which only
B13 undoes: a caller that sends B12's qkv to B5 passes no scales to B12.
B11 always folds (``block.py:2611-2614``), since its own proj undoes it; its
scores then come from the pre-scaled V.

On the card the int8 tails (B10, B11, B13, and B14 and B15 in
``wholeblock.py``) run ``csrc/int8_block.cuh:int8_attn_tail``: the
attention (the short-row kernel up to 256 tokens, B6's kernel past them),
which in dynamic mode also takes each output row's absmax, and proj, which
quantizes the attention output itself, with no quantizer launch between
them: B10's and B11's bf16 output on the row-band GEMM's proj form up to C =
1024 (``csrc/band_s8.cuh``: each 128-row band's int8 A made once in shared
memory; :func:`..gemm.band_proj`), B13-B15's fp32 one, and B10's and B11's
at ViT-H/14's C = 1280 (``int8_block.cuh:TAIL_BAND_MAX_C`` has the
measurement), as it loads it (:func:`..gemm.gemm_s8q`). ``two_launch=True``
runs the old tail instead (attention, row quantizer, int8 proj), the new
one's bitwise reference.

B11 and B12 take ``band=True``: LN1 → int8 and the qkv product as one
launch of the row-band GEMM's head form, the same bits. It read slower at
every path shape on the H100 (PERF.md §6), so no path takes it; it stays as
the bitwise-checked alternative.

The int8 attention kernels' fp32 operands are made once, static scales
folded in, when the scales are attached (:func:`..quant.attach_act_scales`,
which ``RAJNIViT`` runs, dynamic scales too): the int8 attention wrappers
(B10-B13) read the :class:`AttachedOperands` attached for their scales
(:func:`attn_operands`, :func:`proj_operands`) and make them on the call
only where none are (a direct call on params without them); the plain
versions fold on each call. :func:`select_kept` is the
two-kernel route's selection (``csrc/select.cu`` on the card).

B4, B5, B12 and B13 take a tensor-parallel head shard on the card as their
TPU kernels do (``rajni_tpu/parallel/mesh.py:tp_pallas_forward``): B4 and
B12 a head-aligned ``[3C_l, C]`` qkv weight without scores, B5 and B13 qkv
``[B, N, 3C_l]`` with ``C_l / head_dim`` heads and a row-parallel proj
weight ``[C, C_l]``, the attention over ``C_l`` columns and the proj
contracting over them into the ``C`` residual columns; given a zero residual
and bias, they return the shard's partial sum (:mod:`..parallel.mesh`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.pruning import select_tokens_dense
from .attention import (
    _PHASED_MAX_BYTES, ATTN_MAX_N, HEAD_DIMS, SDPA_MAX_N, _sdpa_perhead, _sdpa_phased, sdpa_max_n,
)
from .build import F, I, P, CudaKernel, check_cuda, ptr, stream
from .math import fold_static_attn
from .mlp import _int8_matmul, _layer_norm_f32, _layer_norm_int8, _mm

HEAD_DIM = 64  # csrc/common.cuh: ATTN_D
# the widest C of the head_dim-64 int8, whole-block and training kernels, and
# of the bf16 ones (ViT-H/14's, which the int8 kernels take at head_dim 80)
C_MAX, C_MAX_BF16 = 1024, 1280

PRUNED_KERNEL = CudaKernel(
    "rajni_pruned_attn_block",
    [P, P, P, P, P, P, P, P, P, I, P, P, P, P, P, P, P, I, I, I, I, I, F, F, P],
)
ATTN_KERNEL = CudaKernel(
    "rajni_attn_block",
    [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, F, P],
)
LN_QKV_KERNEL = CudaKernel(
    "rajni_ln_qkv",
    [P, P, P, P, P, I, P, P, P, I, I, I, I, I, F, P],
)
GATHER_KERNEL = CudaKernel(
    "rajni_gather_sdpa_proj_residual",
    [P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P],
)
ATTN_INT8_KERNEL = CudaKernel(
    "rajni_attn_block_int8", [P] * 10 + [I, I] + [P] * 6 + [I] * 4 + [F, F, P],
)
LN_QKV_INT8_KERNEL = CudaKernel(
    "rajni_ln_qkv_int8", [P] * 6 + [I, I, I] + [P] * 4 + [I] * 5 + [F, P],
)
GATHER_INT8_KERNEL = CudaKernel(
    "rajni_gather_sdpa_proj_residual_int8", [P] * 7 + [I, I] + [P] * 5 + [I] * 6 + [F, P],
)
PRUNED_INT8_KERNEL = CudaKernel(
    "rajni_pruned_attn_block_int8", [P] * 11 + [I, I, I, I] + [P] * 9 + [I] * 5 + [F, F, P],
)
LN_QKV_SELECT_KERNEL = CudaKernel("rajni_ln_qkv_select", [P] * 11 + [I] * 5 + [F, P])
SELECT_KERNEL = CudaKernel("rajni_select", [P, P, P, I, I, I, P])


def _mha(qkv: torch.Tensor, num_heads: int, scale: float, out_dtype) -> torch.Tensor:
    """SDPA on packed ``[B, N, 3C]`` (lanes ``(qkv, head, dim)``): phased
    while ``H·N²·6 <= 4 MiB``, per-head above, as the TPU kernels' ``_mha``."""
    B, N, three_c = qkv.shape
    if num_heads * N * N * 6 > _PHASED_MAX_BYTES:
        return _sdpa_perhead(qkv, num_heads, scale, out_dtype)
    return _sdpa_phased(qkv, num_heads, scale, out_dtype)


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
    ss = (vn - mu).square().sum(dim=1, keepdim=True)
    var = ss / torch.full_like(ss, float(N - 1))  # a true division on CUDA too
    std = torch.sqrt(var) + eps
    return a_cls * torch.sigmoid((vn - mu) / std)


def ln_qkv_plain(
    x: torch.Tensor, ln_params, qkv_params, num_heads: int, eps: float = 1e-6,
    with_scores: bool = True,
):
    """Plain PyTorch version of B4: ``(qkv [B, N, out_w], scores [B, N]
    fp32)``, ``scores`` zeros when ``with_scores=False``."""
    _check_ln_qkv(x, qkv_params, with_scores)
    y = _layer_norm_f32(x.float(), ln_params["scale"], ln_params["bias"], eps).to(x.dtype)
    qkv = (_mm(y, qkv_params["weight"]) + qkv_params["bias"].float()).to(x.dtype)
    if with_scores:
        scores = _importance_f32(qkv.float(), num_heads)
    else:
        scores = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
    return qkv, scores


def attn_block_qkv_plain(
    x: torch.Tensor, ln_params, attn_params, ls, num_heads: int, scale: float,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 that also returns the post-bias, rounded
    packed qkv ``[B, N, 3C]`` (B16 ``train_attn_block``'s function)."""
    qkv, _ = ln_qkv_plain(x, ln_params, attn_params["qkv"], num_heads, eps, False)
    a = _mha(qkv, num_heads, scale, x.dtype)
    out = _mm(a, attn_params["proj"]["weight"]) + attn_params["proj"]["bias"].float()
    if ls is not None:
        out = out * ls.float()
    return (x.float() + out).to(x.dtype), qkv


def attn_block_plain(
    x: torch.Tensor, ln_params, attn_params, ls, num_heads: int, scale: float,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    return attn_block_qkv_plain(x, ln_params, attn_params, ls, num_heads, scale, eps)[0]


def gather_sdpa_proj_residual_plain(
    qkv: torch.Tensor, keep_idx: torch.Tensor, x: torch.Tensor, proj_params, ls,
    num_heads: int, scale: float,
) -> torch.Tensor:
    """Plain PyTorch version of B5: ``gather(x) + ls1 *
    proj(mhsa(gather(qkv)))`` → ``[B, K, C]``."""
    idx = keep_idx.long()[..., None]
    qkv_g = torch.take_along_dim(qkv, idx, dim=1)
    x_g32 = torch.take_along_dim(x, idx, dim=1).float()
    a = _mha(qkv_g, num_heads, scale, x.dtype)
    out = _mm(a, proj_params["weight"]) + proj_params["bias"].float()
    if ls is not None:
        out = out * ls.float()
    return (x_g32 + out).to(x.dtype)


def pruned_attn_block_plain(
    x: torch.Tensor, ln_params, attn_params, ls, prev_scores, num_heads: int,
    keep: int, scale: float, eps: float = 1e-6, with_scores: bool = True,
):
    """Plain PyTorch version of K1: ``(x [B, K, C], next_scores [B, K],
    keep_idx [B, K])`` with ``K = keep + 1``."""
    qkv, s = ln_qkv_plain(x, ln_params, attn_params["qkv"], num_heads, eps, with_scores)
    if not with_scores:
        s = prev_scores.float()
    # the kernel ranks CLS as +inf among all N; ranking the patches alone
    # and prepending CLS keeps the same set in the same order
    keep_idx, _ = select_tokens_dense(s, keep, torch.bool)
    next_scores = torch.take_along_dim(s, keep_idx, dim=1)
    out = gather_sdpa_proj_residual_plain(
        qkv, keep_idx, x, attn_params["proj"], ls, num_heads, scale
    )
    return out, next_scores, keep_idx


def int8_width_ok(C: int, head_dim: int) -> bool:
    """Whether the int8 attention kernels (B10-B13) take this width:
    head_dim 64 with C <= 1024, or head_dim 80 at ViT-H/14's C = 1280 (the
    int8 LayerNorm's 5 vectors a lane, the tails' row absmax at head_dim 80,
    the band proj's 2 W stages)."""
    return (head_dim == HEAD_DIM and C <= C_MAX) or (head_dim == 80 and C == C_MAX_BF16)


# The widths each family of attention kernels takes, C % 128 == 0 given:
# (rule on (C, head_dim), what it says)
ATTN_WIDTHS = {
    # K1, K2, B5: the bf16 kernels, ViT-H/14 included
    "bf16": (lambda C, D: D in HEAD_DIMS and C <= C_MAX_BF16,
             f"head_dim 64 or 80 with C <= {C_MAX_BF16}"),
    # B10, B11, B13
    "int8": (int8_width_ok, f"head_dim 64 with C <= {C_MAX} or head_dim 80 with C = {C_MAX_BF16}"),
    # the whole blocks B7, B8, B14, B15, and B20
    "head_dim64": (lambda C, D: D == HEAD_DIM and C <= C_MAX, f"head_dim 64 with C <= {C_MAX}"),
}


def _check_attn_shapes(name: str, N: int, C: int, num_heads: int, max_n: int,
                       widths: str = "head_dim64") -> None:
    """Raise unless the kernel takes these shapes: C % 128 == 0 and the
    head_dim and C that ``ATTN_WIDTHS[widths]`` allows, at most
    ``SDPA_MAX_N_D80`` tokens at head_dim 80; and 2 <= N <= max_n."""
    fits, what = ATTN_WIDTHS[widths]
    D = C // num_heads
    if C % 128 or C % num_heads or not fits(C, D):
        raise ValueError(f"{name} needs C % 128 == 0 and {what}; got C={C}, heads={num_heads}")
    max_n = min(max_n, sdpa_max_n(D))
    if not 2 <= N <= max_n:
        raise ValueError(f"{name} supports 2 <= N <= {max_n}, got N={N}")


def _check_ln_qkv(x: torch.Tensor, qkv_params, with_scores: bool) -> None:
    C = x.shape[-1]
    out_w = qkv_params["weight"].shape[0]
    if with_scores and out_w != 3 * C:
        raise ValueError(
            "with_scores=True needs the full [3C, C] projection; a head-sharded "
            f"[{out_w}, {C}] shard cannot score locally"
        )


def _check_prev_scores(prev_scores, with_scores: bool, B: int, N: int):
    """The threaded scores for the card (None when rescoring)."""
    if with_scores:
        return None
    check_cuda(torch.float32, prev_scores=prev_scores)
    if prev_scores.shape != (B, N):
        raise ValueError(f"prev_scores must be [{B}, {N}], got {tuple(prev_scores.shape)}")
    return prev_scores


def _score_fits(N: int, C: int, H: int) -> bool:
    """Whether ``csrc/common.cuh:score_kernel`` takes these shapes: head_dim
    64 with ``C % 64 == 0`` and ``C <= 1280`` (up to 5 pieces of 16 bytes a
    lane), or head_dim 80 with at most 16 heads (``C <= 1280``, two lanes a
    head), and ``2 <= N <= 1024`` (a cluster of 2 blocks an image up to 512
    tokens, else 4, a block's share of the tokens at most its 256 threads;
    its shared memory, 99 KB at most, always fits)."""
    fits = (C % 64 == 0 and C <= 1280 and C == HEAD_DIM * H) or (C == 80 * H and H <= 16)
    return fits and 2 <= N <= 1024


def select_kept_plain(scores: torch.Tensor, keep: int):
    """Plain PyTorch version of :func:`select_kept`: ``select_tokens_dense``'s
    kept indices and the real scores of the kept tokens."""
    keep_idx, _ = select_tokens_dense(scores, keep, torch.bool)
    return keep_idx, torch.take_along_dim(scores, keep_idx, dim=1)


def select_kept(scores: torch.Tensor, keep: int):
    """The two-kernel route's selection: ``(keep_idx [B, K] int64,
    next_scores [B, K] fp32)`` with ``K = keep + 1`` from fp32 ``scores [B,
    N]``: CLS forced, the top ``keep`` patches (ties to the lower index) in
    ascending order, ``next_scores`` the kept tokens' own scores. On a CUDA
    tensor it launches ``csrc/select.cu`` (``common.cuh:select_kernel``, the
    selection K1, B11 and B14 run in their calls), exact; on a CPU tensor its
    plain version. Raises before it dispatches, on any device, unless
    ``scores`` is fp32 ``[B, N]`` with ``N >= 2`` and ``1 <= keep < N``."""
    if scores.dtype != torch.float32 or scores.dim() != 2 or scores.shape[1] < 2:
        raise ValueError(f"select_kept takes fp32 scores [B, N >= 2], got {scores.dtype} "
                         f"{tuple(scores.shape)}")
    B, N = scores.shape
    if not 1 <= keep < N:
        raise ValueError(f"keep must be in [1, {N - 1}], got {keep}")
    if scores.device.type == "cpu":
        return select_kept_plain(scores, keep)
    check_cuda(torch.float32, scores=scores)
    K = keep + 1
    idx = torch.empty(B, K, dtype=torch.int32, device=scores.device)
    next_scores = torch.empty(B, K, dtype=torch.float32, device=scores.device)
    SELECT_KERNEL(ptr(scores), ptr(idx), ptr(next_scores), B, N, K, stream())
    return idx.long(), next_scores


def fused_attn_block(
    x: torch.Tensor, ln_params, attn_params, ls, num_heads: int, scale: float,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``x + ls1 * proj(mhsa(qkv(norm1(x))))`` on ``[B, N, C]``."""
    if x.device.type == "cpu":
        return attn_block_plain(x, ln_params, attn_params, ls, num_heads, scale, eps)
    return launch_attn_block(ATTN_KERNEL, "fused_attn_block", x, ln_params, attn_params, ls,
                             num_heads, scale, eps)[0]


def launch_attn_block(kernel: CudaKernel, name: str, x: torch.Tensor, ln_params, attn_params,
                      ls, num_heads: int, scale: float, eps: float):
    """K2's entry point (``csrc/attn_block.cu``) through ``kernel``'s
    counter: ``(out [B, N, C], qkv [B, N, 3C])``, the qkv being the
    post-bias, rounded buffer the launches leave in device memory. K2 and B16
    take the bf16 kernels' widths (:func:`_check_attn_shapes`), ViT-H/14's
    included: B16's backward, B18, takes head_dim 64 and 80."""
    B, N, C = x.shape
    qkv_p, proj_p = attn_params["qkv"], attn_params["proj"]
    check_cuda(
        torch.bfloat16, x=x, ln_scale=ln_params["scale"], ln_bias=ln_params["bias"],
        wqkv=qkv_p["weight"], bqkv=qkv_p["bias"], wproj=proj_p["weight"],
        bproj=proj_p["bias"], ls=ls,
    )
    _check_attn_shapes(name, N, C, num_heads, SDPA_MAX_N, "bf16")
    rows = B * N
    y = torch.empty(rows, C, dtype=x.dtype, device=x.device)
    qkv = torch.empty(B, N, 3 * C, dtype=x.dtype, device=x.device)
    attn = torch.empty(rows, C, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    kernel(
        ptr(x), ptr(ln_params["scale"]), ptr(ln_params["bias"]), ptr(qkv_p["weight"]),
        ptr(qkv_p["bias"]), ptr(proj_p["weight"]), ptr(proj_p["bias"]), ptr(ls),
        ptr(y), ptr(qkv), ptr(attn), ptr(out), B, N, C, num_heads, float(scale),
        float(eps), stream(),
    )
    return out, qkv


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
    prev = _check_prev_scores(prev_scores, with_scores, B, N)
    _check_attn_shapes("fused_pruned_attn_block", N, C, num_heads, ATTN_MAX_N, "bf16")
    if not 1 <= keep < N:
        raise ValueError(f"keep must be in [1, {N - 1}], got {keep}")
    dev = x.device
    y = torch.empty(B * N, C, dtype=x.dtype, device=dev)
    qkv = torch.empty(B * N, 3 * C, dtype=x.dtype, device=dev)
    scores = torch.empty(B, N, dtype=torch.float32, device=dev) if with_scores else None
    attn = torch.empty(B * K, C, dtype=x.dtype, device=dev)
    idx = torch.empty(B, K, dtype=torch.int32, device=dev)
    next_scores = torch.empty(B, K, dtype=torch.float32, device=dev)
    out = torch.empty(B, K, C, dtype=x.dtype, device=dev)
    PRUNED_KERNEL(
        ptr(x), ptr(ln_params["scale"]), ptr(ln_params["bias"]), ptr(qkv_p["weight"]),
        ptr(qkv_p["bias"]), ptr(proj_p["weight"]), ptr(proj_p["bias"]), ptr(ls),
        ptr(prev), int(with_scores), ptr(y), ptr(qkv), ptr(scores), ptr(attn), ptr(idx),
        ptr(next_scores), ptr(out), B, N, K, C, num_heads, float(scale), float(eps),
        stream(),
    )
    return out, next_scores, idx.long()


def fused_ln_qkv(
    x: torch.Tensor, ln_params, qkv_params, num_heads: int, eps: float = 1e-6,
    with_scores: bool = True,
):
    """LN1 + QKV projection with RAJNI scores in the same call: ``(qkv
    [B, N, out_w], scores [B, N] fp32)``; ``scores`` is zeros when
    ``with_scores=False``.

    ``out_w`` follows ``qkv_params["weight"] [out_w, C]``: a tensor-parallel
    shard may pass a head-aligned ``[3C_local, C]`` and gets ``[B, N,
    3C_local]``, but only with ``with_scores=False`` (scoring needs every
    head); ``with_scores=True`` on a shard raises ``ValueError``.
    """
    if x.device.type == "cpu":
        return ln_qkv_plain(x, ln_params, qkv_params, num_heads, eps, with_scores)
    B, N, C = x.shape
    w, b = qkv_params["weight"], qkv_params["bias"]
    out_w = w.shape[0]
    check_cuda(
        torch.bfloat16, x=x, ln_scale=ln_params["scale"], ln_bias=ln_params["bias"],
        wqkv=w, bqkv=b,
    )
    _check_ln_qkv(x, qkv_params, with_scores)
    if C % 64 or C > C_MAX_BF16 or out_w % 8 or w.shape[1] != C or N < 2:
        raise ValueError(
            f"fused_ln_qkv needs C % 64 == 0, C <= {C_MAX_BF16}, out_w % 8 == 0 and N >= 2; "
            f"got C={C}, wqkv {tuple(w.shape)}, N={N}"
        )
    if with_scores and not _score_fits(N, C, num_heads):
        raise ValueError(f"fused_ln_qkv cannot score N={N}, C={C}, heads={num_heads}")
    dev = x.device
    y = torch.empty(B * N, C, dtype=x.dtype, device=dev)
    qkv = torch.empty(B, N, out_w, dtype=x.dtype, device=dev)
    scores = torch.empty(B, N, dtype=torch.float32, device=dev)
    LN_QKV_KERNEL(
        ptr(x), ptr(ln_params["scale"]), ptr(ln_params["bias"]), ptr(w), ptr(b),
        int(with_scores), ptr(y), ptr(qkv), ptr(scores), B, N, C, out_w, num_heads,
        float(eps), stream(),
    )
    return qkv, scores


def fused_gather_sdpa_proj_residual(
    qkv: torch.Tensor, keep_idx: torch.Tensor, x: torch.Tensor, proj_params, ls,
    num_heads: int, scale: float,
) -> torch.Tensor:
    """Pruned attention tail: ``gather(x) + ls1 * proj(mhsa(gather(qkv)))``
    → ``[B, K, C]``.

    Args:
      qkv: ``[B, N, 3C]`` full-sequence packed QKV (from :func:`fused_ln_qkv`);
        a tensor-parallel shard passes ``[B, N, 3C_local]`` with its local
        ``num_heads`` and a ``proj`` weight ``[C, C_local]``, and gets this
        shard's partial proj sum plus the gathered residual, on the card too
        (``csrc/gather_attn.cu``'s attention width ``C_local``): the caller
        passes a zero residual and a zero bias to get the partial alone
        (:func:`..parallel.mesh.tp_forward`).
      keep_idx: ``[B, K]`` kept token indices, ascending after CLS
        (:func:`..ops.pruning.select_tokens_dense`). The TPU kernel takes the
        one-hot ``sel [B, K, N]`` built from the same selection; ``sel`` has
        exactly one 1 per row, so its product with a row block IS the gather
        by these indices, and both carry the same information.
      x: ``[B, N, C]`` pre-norm residual stream.
    """
    if x.device.type == "cpu":
        return gather_sdpa_proj_residual_plain(
            qkv, keep_idx, x, proj_params, ls, num_heads, scale
        )
    B, N, C = x.shape
    K = keep_idx.shape[1]
    w, b = proj_params["weight"], proj_params["bias"]
    check_cuda(torch.bfloat16, qkv=qkv, x=x, wproj=w, bproj=b, ls=ls)
    Ca = _shard_width("fused_gather_sdpa_proj_residual", qkv, w, B, N, C, num_heads)
    _check_attn_shapes("fused_gather_sdpa_proj_residual", K, Ca, num_heads, SDPA_MAX_N, "bf16")
    if keep_idx.shape != (B, K) or K > N:
        raise ValueError(f"keep_idx must be [{B}, K <= {N}], got {tuple(keep_idx.shape)}")
    idx = keep_idx.to(torch.int32).contiguous()
    check_cuda(torch.int32, keep_idx=idx)
    attn = torch.empty(B * K, C, dtype=x.dtype, device=x.device)
    out = torch.empty(B, K, C, dtype=x.dtype, device=x.device)
    GATHER_KERNEL(
        ptr(qkv), ptr(idx), ptr(x), ptr(w), ptr(b), ptr(ls), ptr(attn), ptr(out),
        B, N, K, C, Ca, num_heads, float(scale), stream(),
    )
    return out


def _shard_width(name: str, qkv: torch.Tensor, wproj: torch.Tensor, B: int, N: int, C: int,
                 num_heads: int) -> int:
    """The attention width ``C_l`` of a pruned tail's call: ``qkv [B, N,
    3C_l]`` and a proj weight ``[C, C_l]`` with ``C_l = C`` (the full width)
    or a tensor-parallel shard's whole heads (``C_l`` a multiple of 128 dividing
    C, ``num_heads`` its heads); raises otherwise."""
    Ca = qkv.shape[-1] // 3
    if (qkv.dim() != 3 or tuple(qkv.shape) != (B, N, 3 * Ca) or tuple(wproj.shape) != (C, Ca)
            or C % Ca or Ca % num_heads):
        raise ValueError(
            f"{name}: qkv must be [{B}, {N}, 3·C_l] and proj [{C}, C_l] with C_l dividing {C}; "
            f"got qkv {tuple(qkv.shape)}, proj {tuple(wproj.shape)}, heads {num_heads}")
    return Ca


# ---------------------------------------------------------------------------
# B10, B12, B13: int8 qkv and proj weights
# ---------------------------------------------------------------------------


def int8_attn_operands(ln_params, attn_params, act_scales=None) -> dict:
    """The fp32 vector operands of the int8 attention kernels (``ln1s, ln1b,
    sqkv, bqkv, sproj, bproj``), with :func:`..math.fold_static_attn`
    applied when ``act_scales = (a_qkv, a_proj)`` is given."""
    qkv, proj = attn_params["qkv"], attn_params.get("proj")
    ops = {"ln1s": ln_params["scale"].float(), "ln1b": ln_params["bias"].float(),
           "sqkv": qkv["weight"]["scale"].float(), "bqkv": qkv["bias"].float(),
           "sproj": None if proj is None else proj["weight"]["scale"].float(),
           "bproj": None if proj is None else proj["bias"].float()}
    if act_scales is not None:
        ops["ln1s"], ops["ln1b"], ops["sqkv"], ops["sproj"], ops["bqkv"] = fold_static_attn(
            ops["ln1s"], ops["ln1b"], ops["sqkv"], ops["sproj"], ops["bqkv"], *act_scales)
    return {k: (v if v is None else v.contiguous()) for k, v in ops.items()}


# The head's operands of the int8 attention kernels (B10-B12)
HEAD_OPS = ("ln1s", "ln1b", "sqkv", "bqkv")


@dataclasses.dataclass(frozen=True)
class AttachedOperands:
    """fp32 vector operands of an int8 attention layer's kernels, made once
    for the ``scales`` they carry (static, or None: dynamic, unfolded).
    :func:`attach_attn_operands` keeps them under ``"attached"`` in the
    layer's ``qkv`` record (:data:`HEAD_OPS` for ``(a_qkv, a_proj)``) and
    ``proj`` record (``sproj, bproj`` for ``(a_proj,)``)."""

    scales: tuple[float, ...] | None
    ops: dict


def attach_attn_operands(ln_params, attn_params, act_scales=None) -> dict:
    """``attn_params`` with its kernel operands for ``act_scales = (a_qkv,
    a_proj)`` (static: folded now, as :func:`int8_attn_operands` folds them
    on a call) or None (dynamic) made once and attached to its qkv and proj
    records, for the int8 attention wrappers (B10-B13) to read on every
    call. ``ln_params`` is the layer's LN1. A new dict sharing the tensors;
    attaching other scales makes them again, and so must a change of the
    weights in place."""
    scales = None if act_scales is None else (float(act_scales[0]), float(act_scales[1]))
    qkv, proj = attn_params["qkv"], attn_params.get("proj")
    head = int8_attn_operands(ln_params, {"qkv": qkv}, scales)
    out = {**attn_params,
           "qkv": {**qkv, "attached": AttachedOperands(scales, {k: head[k] for k in HEAD_OPS})}}
    if proj is not None:
        a_proj = None if scales is None else scales[1]
        out["proj"] = {**proj, "attached": AttachedOperands(
            None if scales is None else scales[1:], _int8_proj_operands(proj, a_proj))}
    return out


def _attached(record, scales) -> dict | None:
    """The operands attached to ``record`` for ``scales``, or None."""
    st = None if record is None else record.get("attached")
    return st.ops if st is not None and st.scales == scales else None


def attn_operands(ln_params, attn_params, act_scales=None) -> dict:
    """:func:`int8_attn_operands` as the int8 attention wrappers take them:
    those :func:`attach_attn_operands` attached for these scales, with no
    fold and no conversion on the call; where none are (a direct call on
    params without them), made now."""
    scales = None if act_scales is None else (float(act_scales[0]), float(act_scales[1]))
    head = _attached(attn_params["qkv"], scales)
    proj = attn_params.get("proj")
    tail = ({"sproj": None, "bproj": None} if proj is None
            else _attached(proj, None if scales is None else scales[1:]))
    if head is not None and tail is not None:
        return {**head, **tail}
    return int8_attn_operands(ln_params, attn_params, act_scales)


def _int8_qkv(x, wqkv_q, ops, static: bool, eps: float) -> torch.Tensor:
    """LN1 (fp32) quantized, the int8 qkv product dequantized, + bias,
    rounded to the activation dtype: ``[B, N, out_w]``."""
    y = _layer_norm_int8(x.float(), ops["ln1s"], ops["ln1b"], eps)
    return (_int8_matmul(y, wqkv_q, ops["sqkv"], static) + ops["bqkv"]).to(x.dtype)


def _int8_proj_residual(attn32, x_res32, wproj_q, ls, ops, static: bool, dtype):
    """``x + (proj(quant(attn)) + b) · ls1`` rounded to ``dtype``."""
    out = _int8_matmul(attn32, wproj_q, ops["sproj"], static) + ops["bproj"]
    if ls is not None:
        out = out * ls.float()
    return (x_res32 + out).to(dtype)


def attn_block_int8_plain(x, ln_params, attn_params, ls, num_heads: int, scale: float,
                          eps: float = 1e-6, act_scales=None):
    """Plain PyTorch version of B10 (``block.py:1240-1265``): the attention
    output rounded to the activation dtype before it is quantized."""
    static = act_scales is not None
    ops = int8_attn_operands(ln_params, attn_params, act_scales)
    qkv = _int8_qkv(x, attn_params["qkv"]["weight"]["int8"], ops, static, eps)
    attn = _mha(qkv, num_heads, scale, x.dtype).float()
    return _int8_proj_residual(attn, x.float(), attn_params["proj"]["weight"]["int8"], ls, ops,
                               static, x.dtype)


def ln_qkv_int8_plain(x, ln_params, qkv_params, num_heads: int, eps: float = 1e-6,
                      with_scores: bool = True, act_scales=None):
    """Plain PyTorch version of B12 (``block.py:1341-1366``): ``(qkv [B, N,
    out_w], scores [B, N] fp32)``, the scores from the rounded qkv, zeros
    when ``with_scores=False``. ``act_scales = (a_qkv, a_proj)`` folds
    ``1/a_proj`` into the V columns, for B13 only."""
    wq = qkv_params["weight"]["int8"]
    if with_scores and wq.shape[0] != 3 * x.shape[-1]:
        raise ValueError("with_scores=True needs the full [3C, C] projection; a head-sharded "
                         f"[{wq.shape[0]}, {x.shape[-1]}] shard cannot score locally")
    ops = int8_attn_operands(ln_params, {"qkv": qkv_params}, act_scales)
    qkv = _int8_qkv(x, wq, ops, act_scales is not None, eps)
    if with_scores:
        scores = _importance_f32(qkv.float(), num_heads)
    else:
        scores = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
    return qkv, scores


def _int8_proj_operands(proj_params, act_scale) -> dict:
    """``sproj`` (× ``a_proj`` under static scales) and ``bproj``."""
    sproj = proj_params["weight"]["scale"].float()
    if act_scale is not None:
        sproj = sproj * float(act_scale)
    return {"sproj": sproj.contiguous(), "bproj": proj_params["bias"].float().contiguous()}


def proj_operands(proj_params, act_scale) -> dict:
    """:func:`_int8_proj_operands` as B13 takes them: those attached for the
    static ``a_proj`` or dynamic (None) (:func:`attach_attn_operands`), or
    made now."""
    ops = _attached(proj_params, None if act_scale is None else (float(act_scale),))
    return ops if ops is not None else _int8_proj_operands(proj_params, act_scale)


def gather_sdpa_proj_residual_int8_plain(qkv, keep_idx, x, proj_params, ls, num_heads: int,
                                         scale: float, act_scale=None):
    """Plain PyTorch version of B13 (``block.py:1098-1126``): ``gather(x) +
    ls1 · proj(quant(mhsa(gather(qkv))))`` → ``[B, K, C]``, the attention
    output fp32 until quantized. ``act_scale`` is the static ``a_proj``;
    the qkv then comes from B12 with V pre-scaled by ``1/a_proj``."""
    idx = keep_idx.long()[..., None]
    attn = _mha(torch.take_along_dim(qkv, idx, dim=1), num_heads, scale, torch.float32)
    x_g32 = torch.take_along_dim(x, idx, dim=1).float()
    return _int8_proj_residual(attn, x_g32, proj_params["weight"]["int8"], ls,
                               _int8_proj_operands(proj_params, act_scale),
                               act_scale is not None, x.dtype)


def _check_int8(x, ls, ops, **weights) -> None:
    check_cuda(torch.bfloat16, x=x, ls=ls)
    check_cuda(torch.int8, **weights)
    check_cuda(torch.float32, **{k: v for k, v in ops.items() if v is not None})


def int8_tail_scratch(B: int, n_rows: int, n: int, C: int, dtype, dev, static: bool):
    """The int8 tail's attention output ``[B·n·C]`` of ``dtype`` and, in
    dynamic mode, its row absmax ``[n_rows]`` fp32 (None static), which
    LN1's launch zeroes over its ``n_rows >= B·n`` rows."""
    attn = torch.empty(B * n * C, dtype=dtype, device=dev)
    return attn, None if static else torch.empty(n_rows, dtype=torch.float32, device=dev)


def fused_attn_block_int8(x, ln_params, attn_params, ls, num_heads: int, scale: float,
                          eps: float = 1e-6, act_scales=None, two_launch: bool = False):
    """Stock attention half with int8 qkv and proj weights: ``x + ls1 ·
    proj(mhsa(qkv(norm1(x))))`` on ``[B, N, C]``. ``act_scales = (a_qkv,
    a_proj)`` selects calibrated static quantization; ``two_launch`` the
    old attention tail on the card (module docstring)."""
    if x.device.type == "cpu":
        return attn_block_int8_plain(x, ln_params, attn_params, ls, num_heads, scale, eps,
                                     act_scales)
    B, N, C = x.shape
    wqkv, wproj = attn_params["qkv"]["weight"]["int8"], attn_params["proj"]["weight"]["int8"]
    ops = attn_operands(ln_params, attn_params, act_scales)
    _check_int8(x, ls, ops, wqkv=wqkv, wproj=wproj)
    _check_attn_shapes("fused_attn_block_int8", N, C, num_heads, SDPA_MAX_N, "int8")
    if wqkv.shape != (3 * C, C) or wproj.shape != (C, C):
        raise ValueError(f"fused_attn_block_int8: bad int8 weight shapes {tuple(wqkv.shape)}, "
                         f"{tuple(wproj.shape)}")
    rows, dev, static = B * N, x.device, act_scales is not None
    q8 = torch.empty(rows * C, dtype=torch.int8, device=dev)
    qs = torch.empty(rows, dtype=torch.float32, device=dev)
    qkv = torch.empty(rows * 3 * C, dtype=x.dtype, device=dev)
    attn, amax = int8_tail_scratch(B, rows, N, C, x.dtype, dev, static)
    out = torch.empty_like(x)
    ATTN_INT8_KERNEL(
        ptr(x), ptr(ops["ln1s"]), ptr(ops["ln1b"]), ptr(wqkv), ptr(ops["sqkv"]),
        ptr(ops["bqkv"]), ptr(wproj), ptr(ops["sproj"]), ptr(ops["bproj"]), ptr(ls),
        int(static), int(two_launch), ptr(q8), ptr(qs), ptr(qkv), ptr(attn), ptr(amax), ptr(out),
        B, N, C, num_heads, float(scale), float(eps), stream(),
    )
    return out


def fused_ln_qkv_int8(x, ln_params, qkv_params, num_heads: int, eps: float = 1e-6,
                      with_scores: bool = True, act_scales=None, band: bool = False):
    """LN1 + int8 QKV projection with RAJNI scores in the same call: ``(qkv
    [B, N, 3C], scores [B, N] fp32)``, ``scores`` zeros when
    ``with_scores=False``. ``act_scales = (a_qkv, a_proj)``: static scales,
    V leaving pre-scaled by ``1/a_proj`` for
    :func:`fused_gather_sdpa_proj_residual_int8`. A tensor-parallel shard
    passes a head-aligned ``[3C_l, C]`` int8 record with its local
    ``num_heads`` and ``with_scores=False`` (scoring needs every head; True
    raises), as :func:`fused_ln_qkv` does, and gets ``[B, N, 3C_l]``.
    ``band`` runs LN1 and the qkv product as one launch of the row-band GEMM
    (module docstring: the same bits, no path takes it), at the full width
    only."""
    if x.device.type == "cpu":
        return ln_qkv_int8_plain(x, ln_params, qkv_params, num_heads, eps, with_scores,
                                 act_scales)
    return launch_ln_qkv_int8(x, ln_params, qkv_params, num_heads, eps, with_scores, act_scales,
                              band)[:2]


def launch_ln_qkv_int8(x, ln_params, qkv_params, num_heads: int, eps: float, with_scores: bool,
                       act_scales, band: bool):
    """B12's entry point (``csrc/ln_qkv_int8.cu``) on the card: ``(qkv,
    scores, qs, q8)``, ``qs [B·N]`` the LN rows' int8 scales either route
    writes in dynamic mode (its contents undefined under static scales) and
    ``q8 [B·N·C]`` the LN rows in int8 (LN1's launch, ``ln_quant_kernel``;
    empty on the band)."""
    B, N, C = x.shape
    wq = qkv_params["weight"]["int8"]
    ops = attn_operands(ln_params, {"qkv": qkv_params}, act_scales)
    _check_int8(x, None, ops, wqkv=wq)
    Ca = wq.shape[0] // 3
    # a tensor-parallel shard: whole heads of head_dim D, D as the full width's
    D = Ca // num_heads if Ca % num_heads == 0 else 0
    if (C % 128 or Ca % 128 or C % Ca or not int8_width_ok(C, D) or wq.shape != (3 * Ca, C)
            or N < 2):
        raise ValueError("fused_ln_qkv_int8 on the card needs C % 128 == 0, "
                         f"{ATTN_WIDTHS['int8'][1]}, a [3C, C] weight or a head-aligned "
                         "[3C_l, C] shard (C_l % 128 == 0 dividing C) and N >= 2; got "
                         f"C={C}, heads={num_heads}, wqkv {tuple(wq.shape)}, N={N}")
    _check_ln_qkv(x, {"weight": wq}, with_scores)
    if band and (C > C_MAX or Ca != C):
        raise ValueError(f"fused_ln_qkv_int8: the band head takes the full width, C <= {C_MAX}; "
                         f"got C={C}, wqkv {tuple(wq.shape)}")
    if with_scores and not _score_fits(N, C, num_heads):
        raise ValueError(f"fused_ln_qkv_int8 cannot score N={N}, C={C}, heads={num_heads}")
    dev = x.device
    # the LN rows' int8 copy: the route off the band only
    q8 = torch.empty(0 if band else B * N * C, dtype=torch.int8, device=dev)
    qs = torch.empty(B * N, dtype=torch.float32, device=dev)
    qkv = torch.empty(B, N, 3 * Ca, dtype=x.dtype, device=dev)
    scores = torch.empty(B, N, dtype=torch.float32, device=dev)
    LN_QKV_INT8_KERNEL(
        ptr(x), ptr(ops["ln1s"]), ptr(ops["ln1b"]), ptr(wq), ptr(ops["sqkv"]), ptr(ops["bqkv"]),
        int(with_scores), int(act_scales is not None), int(band), ptr(q8), ptr(qs), ptr(qkv),
        ptr(scores), B, N, C, Ca, num_heads, float(eps), stream(),
    )
    return qkv, scores, qs, q8


def fused_gather_sdpa_proj_residual_int8(qkv, keep_idx, x, proj_params, ls, num_heads: int,
                                         scale: float, act_scale=None, two_launch: bool = False):
    """Int8 pruned attention tail: ``gather(x) + ls1 ·
    proj(mhsa(gather(qkv)))`` → ``[B, K, C]`` with an int8 proj record;
    ``keep_idx [B, K]`` as in :func:`fused_gather_sdpa_proj_residual`.
    ``act_scale``: the static ``a_proj`` (the qkv from
    :func:`fused_ln_qkv_int8` with the same scales); ``two_launch`` the old
    attention tail on the card (module docstring). A tensor-parallel shard
    passes ``qkv [B, N, 3C_l]`` and a proj record ``[C, C_l]``, as to
    :func:`fused_gather_sdpa_proj_residual`; each attention row is then
    quantized over its ``C_l`` columns (JAX's grouped scale,
    ``rajni_tpu/parallel/mesh.py:428-435``)."""
    if x.device.type == "cpu":
        return gather_sdpa_proj_residual_int8_plain(qkv, keep_idx, x, proj_params, ls,
                                                    num_heads, scale, act_scale)
    B, N, C = x.shape
    K = keep_idx.shape[1]
    wq = proj_params["weight"]["int8"]
    ops = proj_operands(proj_params, act_scale)
    _check_int8(x, ls, ops, wproj=wq)
    check_cuda(torch.bfloat16, qkv=qkv)
    Ca = _shard_width("fused_gather_sdpa_proj_residual_int8", qkv, wq, B, N, C, num_heads)
    if Ca % 128:
        raise ValueError(f"fused_gather_sdpa_proj_residual_int8 needs C_l % 128 == 0, got {Ca}")
    # the int8 widths by the full C and the shard's head_dim
    _check_attn_shapes("fused_gather_sdpa_proj_residual_int8", K, C, C // (Ca // num_heads),
                       SDPA_MAX_N, "int8")
    if keep_idx.shape != (B, K) or K > N:
        raise ValueError(f"keep_idx must be [{B}, K <= {N}], got {tuple(keep_idx.shape)}")
    idx = keep_idx.to(torch.int32).contiguous()
    check_cuda(torch.int32, keep_idx=idx)
    dev, static = x.device, act_scale is not None
    attn, amax = int8_tail_scratch(B, B * K, K, Ca, torch.float32, dev, static)
    q8 = torch.empty(B * K * Ca, dtype=torch.int8, device=dev)  # the two-launch route's
    qs = torch.empty(B * K, dtype=torch.float32, device=dev)
    out = torch.empty(B, K, C, dtype=x.dtype, device=dev)
    GATHER_INT8_KERNEL(
        ptr(qkv), ptr(idx), ptr(x), ptr(wq), ptr(ops["sproj"]), ptr(ops["bproj"]), ptr(ls),
        int(static), int(two_launch), ptr(attn), ptr(amax), ptr(q8), ptr(qs), ptr(out), B, N, K,
        C, Ca, num_heads, float(scale), stream(),
    )
    return out


# ---------------------------------------------------------------------------
# B11: the pruned attention half with int8 qkv and proj weights
# ---------------------------------------------------------------------------


def pruned_attn_block_int8_plain(x, ln_params, attn_params, ls, prev_scores, num_heads: int,
                                 keep: int, scale: float, eps: float = 1e-6,
                                 with_scores: bool = True, act_scales=None):
    """Plain PyTorch version of B11 (``block.py:2527-2577``): ``(x [B, K,
    C], next_scores [B, K], keep_idx [B, K])``. qkv rounded to the
    activation dtype and scored; the attention output rounded to it before
    it is quantized (B10's rounding, not B13's)."""
    static = act_scales is not None
    ops = int8_attn_operands(ln_params, attn_params, act_scales)
    qkv = _int8_qkv(x, attn_params["qkv"]["weight"]["int8"], ops, static, eps)
    s = _importance_f32(qkv.float(), num_heads) if with_scores else prev_scores.float()
    keep_idx, _ = select_tokens_dense(s, keep, torch.bool)
    next_scores = torch.take_along_dim(s, keep_idx, dim=1)
    idx = keep_idx[..., None]
    attn = _mha(torch.take_along_dim(qkv, idx, dim=1), num_heads, scale, x.dtype).float()
    out = _int8_proj_residual(attn, torch.take_along_dim(x.float(), idx, dim=1),
                              attn_params["proj"]["weight"]["int8"], ls, ops, static, x.dtype)
    return out, next_scores, keep_idx


def fused_pruned_attn_block_int8(x, ln_params, attn_params, ls, prev_scores, num_heads: int,
                                 keep: int, scale: float, eps: float = 1e-6,
                                 with_scores: bool = True, act_scales=None,
                                 two_launch: bool = False, band: bool = False):
    """Pruned attention half with int8 qkv and proj weights: ``(x [B, K, C],
    next_scores [B, K] fp32, keep_idx [B, K])`` with ``K = keep + 1``.
    ``with_scores=False`` selects from ``prev_scores [B, N]``;
    ``act_scales = (a_qkv, a_proj)`` selects calibrated static quantization,
    with the V-column fold always applied; ``two_launch`` the old attention
    tail on the card; ``band`` LN1 and the qkv product as one launch of the
    row-band GEMM (module docstring)."""
    if not with_scores and prev_scores is None:
        raise ValueError("with_scores=False needs prev_scores")
    if x.device.type == "cpu":
        return pruned_attn_block_int8_plain(x, ln_params, attn_params, ls, prev_scores,
                                            num_heads, keep, scale, eps, with_scores, act_scales)
    B, N, C = x.shape
    K = keep + 1
    wqkv, wproj = attn_params["qkv"]["weight"]["int8"], attn_params["proj"]["weight"]["int8"]
    ops = attn_operands(ln_params, attn_params, act_scales)
    _check_int8(x, ls, ops, wqkv=wqkv, wproj=wproj)
    prev = _check_prev_scores(prev_scores, with_scores, B, N)
    _check_attn_shapes("fused_pruned_attn_block_int8", N, C, num_heads, SDPA_MAX_N, "int8")
    if wqkv.shape != (3 * C, C) or wproj.shape != (C, C):
        raise ValueError(f"fused_pruned_attn_block_int8: bad int8 weight shapes "
                         f"{tuple(wqkv.shape)}, {tuple(wproj.shape)}")
    if not 1 <= keep < N:
        raise ValueError(f"keep must be in [1, {N - 1}], got {keep}")
    if band and C > C_MAX:
        raise ValueError(f"fused_pruned_attn_block_int8: the band head takes C <= {C_MAX}, "
                         f"got C={C}")
    if with_scores and not _score_fits(N, C, num_heads):
        raise ValueError(f"fused_pruned_attn_block_int8 cannot score N={N}, C={C}, "
                         f"heads={num_heads}")
    dev, static = x.device, act_scales is not None
    # the LN rows' int8 copy (the head off the band; the two-launch tail's A)
    q8 = torch.empty(0 if band and not two_launch else B * N * C, dtype=torch.int8, device=dev)
    qs = torch.empty(B * N, dtype=torch.float32, device=dev)
    qkv = torch.empty(B * N * 3 * C, dtype=x.dtype, device=dev)
    scores = torch.empty(B, N, dtype=torch.float32, device=dev) if with_scores else None
    attn, amax = int8_tail_scratch(B, B * N, K, C, x.dtype, dev, static)
    idx = torch.empty(B, K, dtype=torch.int32, device=dev)
    next_scores = torch.empty(B, K, dtype=torch.float32, device=dev)
    out = torch.empty(B, K, C, dtype=x.dtype, device=dev)
    PRUNED_INT8_KERNEL(
        ptr(x), ptr(ops["ln1s"]), ptr(ops["ln1b"]), ptr(wqkv), ptr(ops["sqkv"]),
        ptr(ops["bqkv"]), ptr(wproj), ptr(ops["sproj"]), ptr(ops["bproj"]), ptr(ls), ptr(prev),
        int(with_scores), int(static), int(two_launch), int(band), ptr(q8), ptr(qs), ptr(qkv),
        ptr(scores), ptr(attn), ptr(amax), ptr(idx), ptr(next_scores), ptr(out), B, N, K, C,
        num_heads, float(scale), float(eps), stream(),
    )
    return out, next_scores, idx.long()


# ---------------------------------------------------------------------------
# B19: LN1 + QKV + scores + selection in one call (routed nowhere)
# ---------------------------------------------------------------------------


def ln_qkv_select_plain(x, ln_params, qkv_params, num_heads: int, keep: int, eps: float = 1e-6):
    """Plain PyTorch version of B19 (``block.py:784-802``): B4's plain
    version, then the selection. Returns ``(qkv [B, N, 3C], sel [B, K, N]
    x.dtype, keep_idx [B, K] int32, next_scores [B, K] fp32)``."""
    qkv, s = ln_qkv_plain(x, ln_params, qkv_params, num_heads, eps, True)
    keep_idx, sel = select_tokens_dense(s, keep, x.dtype)
    return qkv, sel, keep_idx.to(torch.int32), torch.take_along_dim(s, keep_idx, dim=1)


def fused_ln_qkv_select(x, ln_params, qkv_params, num_heads: int, keep: int, eps: float = 1e-6):
    """LN1 → QKV → RAJNI scores → top-K selection in one call: ``(qkv [B, N,
    3C], sel [B, K, N] one-hot in x.dtype, keep_idx [B, K] int32,
    next_scores [B, K] fp32)`` with ``K = keep + 1``. Always scores; the
    full ``[3C, C]`` projection only."""
    if x.device.type == "cpu":
        return ln_qkv_select_plain(x, ln_params, qkv_params, num_heads, keep, eps)
    B, N, C = x.shape
    K = keep + 1
    w, b = qkv_params["weight"], qkv_params["bias"]
    check_cuda(
        torch.bfloat16, x=x, ln_scale=ln_params["scale"], ln_bias=ln_params["bias"],
        wqkv=w, bqkv=b,
    )
    _check_ln_qkv(x, qkv_params, True)
    if not _score_fits(N, C, num_heads):
        raise ValueError(f"fused_ln_qkv_select cannot score N={N}, C={C}, heads={num_heads} "
                         "(it needs C % 64 == 0, C <= 1024 and head_dim 64)")
    if not 1 <= keep < N:
        raise ValueError(f"keep must be in [1, {N - 1}], got {keep}")
    dev = x.device
    y = torch.empty(B * N, C, dtype=x.dtype, device=dev)
    qkv = torch.empty(B, N, 3 * C, dtype=x.dtype, device=dev)
    scores = torch.empty(B, N, dtype=torch.float32, device=dev)
    sel = torch.empty(B, K, N, dtype=x.dtype, device=dev)
    idx = torch.empty(B, K, dtype=torch.int32, device=dev)
    next_scores = torch.empty(B, K, dtype=torch.float32, device=dev)
    LN_QKV_SELECT_KERNEL(
        ptr(x), ptr(ln_params["scale"]), ptr(ln_params["bias"]), ptr(w), ptr(b), ptr(y), ptr(qkv),
        ptr(scores), ptr(sel), ptr(idx), ptr(next_scores), B, N, K, C, num_heads, float(eps),
        stream(),
    )
    return qkv, sel, idx, next_scores
