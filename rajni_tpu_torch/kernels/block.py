"""The attention halves of a block: K1 ``fused_pruned_attn_block``, K2
``fused_attn_block``, the two kernels of the long-sequence pruned route, B4
``fused_ln_qkv`` and B5 ``fused_gather_sdpa_proj_residual``, and their int8
counterparts B10 ``fused_attn_block_int8``, B12 ``fused_ln_qkv_int8`` and
B13 ``fused_gather_sdpa_proj_residual_int8``.

Ports of the functions of the same names in ``rajni_tpu/kernels/block.py``.
On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/pruned_attn_block.cu``, ``csrc/attn_block.cu``, ``csrc/ln_qkv.cu``,
``csrc/gather_attn.cu``, ``csrc/attn_block_int8.cu``, ``csrc/ln_qkv_int8.cu``,
``csrc/gather_attn_int8.cu``); on a CPU tensor it runs the plain PyTorch
version beside it.

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
the logits) while ``H·N²·6 <= 4 MiB``, else the per-head form (scale on the
fp32 logits, :func:`..attention.fused_sdpa_plain`). On the card the
register-resident attention kernel (``N <= ATTN_MAX_N``) is phased and the
two-pass kernel (``N > ATTN_MAX_N``) per-head. At head_dim 64 the scale is
1/8, so both forms give the same bits and the switch points need not agree.

The int8 kernels (``block.py:1098-1440``) quantize the LN output straight
from fp32 and the attention output before proj, per row or with calibrated
static scales folded into the operands (:func:`..math.fold_static_attn`);
qkv is rounded to the activation dtype (B12 stores it, B10's attention casts
it). B10 rounds its attention output to the activation dtype before
quantizing it (``_mha_mixed(..., x_ref.dtype, ...)``, ``block.py:1255``);
B13, like B14 and B15, keeps it fp32 (``block.py:1122``). Under static
scales B12 folds ``1/a_proj`` into the V columns, which only B13 undoes:
a caller that sends B12's qkv to B5 passes no scales to B12.
"""

from __future__ import annotations

import math

import torch

from ..ops.pruning import select_tokens_dense
from .attention import SDPA_KERNEL, SDPA_MAX_N, _sdpa_perhead
from .build import F, I, P, CudaKernel, check_cuda, ptr, stream
from .math import fold_static_attn
from .mlp import _int8_matmul, _layer_norm_f32, _mm

ATTN_MAX_N = 256  # csrc/common.cuh: whole softmax rows in registers
HEAD_DIM = 64  # csrc/common.cuh: ATTN_D
_PHASED_MAX_BYTES = 4 * 1024 * 1024  # rajni_tpu/kernels/block.py:136
_SMEM_MAX = 232448  # bytes of shared memory a Hopper block may use

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
    [P, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
)
ATTN_INT8_KERNEL = CudaKernel(
    "rajni_attn_block_int8", [P] * 10 + [I] + [P] * 5 + [I] * 4 + [F, F, P],
)
LN_QKV_INT8_KERNEL = CudaKernel(
    "rajni_ln_qkv_int8", [P] * 6 + [I, I] + [P] * 4 + [I] * 4 + [F, P],
)
GATHER_INT8_KERNEL = CudaKernel(
    "rajni_gather_sdpa_proj_residual_int8", [P] * 7 + [I] + [P] * 4 + [I] * 5 + [F, P],
)


def _mha(qkv: torch.Tensor, num_heads: int, scale: float, out_dtype) -> torch.Tensor:
    """SDPA on packed ``[B, N, 3C]`` (lanes ``(qkv, head, dim)``): phased
    while ``H·N²·6 <= 4 MiB``, per-head above, as the TPU kernels' ``_mha``."""
    B, N, three_c = qkv.shape
    if num_heads * N * N * 6 > _PHASED_MAX_BYTES:
        return _sdpa_perhead(qkv, num_heads, scale, out_dtype)
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


def attn_block_plain(
    x: torch.Tensor, ln_params, attn_params, ls, num_heads: int, scale: float,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    qkv, _ = ln_qkv_plain(x, ln_params, attn_params["qkv"], num_heads, eps, False)
    a = _mha(qkv, num_heads, scale, x.dtype)
    out = _mm(a, attn_params["proj"]["weight"]) + attn_params["proj"]["bias"].float()
    if ls is not None:
        out = out * ls.float()
    return (x.float() + out).to(x.dtype)


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


def _check_attn_shapes(name: str, N: int, C: int, num_heads: int, max_n: int) -> None:
    if C % 128 or C > 1024 or C // num_heads != HEAD_DIM or C % num_heads:
        raise ValueError(
            f"{name} needs C % 128 == 0, C <= 1024 and head_dim {HEAD_DIM}; "
            f"got C={C}, heads={num_heads}"
        )
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


def _score_smem(N: int, C: int, H: int) -> int:
    """csrc/common.cuh:score_smem."""
    return (C + H * N + N * (C // H) + 2 * N + C // H + 2) * 4


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
    _check_attn_shapes("fused_attn_block", N, C, num_heads, SDPA_MAX_N)
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
    if N > ATTN_MAX_N:  # csrc/attn_block.cu launched the two-pass kernel
        SDPA_KERNEL.launches += 1
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
    _check_attn_shapes("fused_pruned_attn_block", N, C, num_heads, ATTN_MAX_N)
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
    if C % 64 or C > 1024 or out_w % 8 or w.shape[1] != C or N < 2:
        raise ValueError(
            f"fused_ln_qkv needs C % 64 == 0, C <= 1024, out_w % 8 == 0 and N >= 2; "
            f"got C={C}, wqkv {tuple(w.shape)}, N={N}"
        )
    if with_scores and (C % num_heads or _score_smem(N, C, num_heads) > _SMEM_MAX):
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
        shard's partial proj sum plus the gathered residual (the CUDA route
        takes the full width only and raises ``ValueError`` on a shard).
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
    if qkv.shape != (B, N, 3 * C) or w.shape != (C, C):
        raise ValueError(
            "fused_gather_sdpa_proj_residual on the card takes the full width "
            f"only: qkv {tuple(qkv.shape)}, proj {tuple(w.shape)}, x {tuple(x.shape)}"
        )
    _check_attn_shapes("fused_gather_sdpa_proj_residual", K, C, num_heads, SDPA_MAX_N)
    if keep_idx.shape != (B, K) or K > N:
        raise ValueError(f"keep_idx must be [{B}, K <= {N}], got {tuple(keep_idx.shape)}")
    idx = keep_idx.to(torch.int32).contiguous()
    check_cuda(torch.int32, keep_idx=idx)
    attn = torch.empty(B * K, C, dtype=x.dtype, device=x.device)
    out = torch.empty(B, K, C, dtype=x.dtype, device=x.device)
    GATHER_KERNEL(
        ptr(qkv), ptr(idx), ptr(x), ptr(w), ptr(b), ptr(ls), ptr(attn), ptr(out),
        B, N, K, C, num_heads, float(scale), stream(),
    )
    if K > ATTN_MAX_N:  # csrc/gather_attn.cu launched the two-pass kernel
        SDPA_KERNEL.launches += 1
    return out


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


def _int8_qkv(x, wqkv_q, ops, static: bool, eps: float) -> torch.Tensor:
    """LN1 (fp32) quantized, the int8 qkv product dequantized, + bias,
    rounded to the activation dtype: ``[B, N, out_w]``."""
    y = _layer_norm_f32(x.float(), ops["ln1s"], ops["ln1b"], eps)
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


def fused_attn_block_int8(x, ln_params, attn_params, ls, num_heads: int, scale: float,
                          eps: float = 1e-6, act_scales=None):
    """Stock attention half with int8 qkv and proj weights: ``x + ls1 ·
    proj(mhsa(qkv(norm1(x))))`` on ``[B, N, C]``. ``act_scales = (a_qkv,
    a_proj)`` selects calibrated static quantization."""
    if x.device.type == "cpu":
        return attn_block_int8_plain(x, ln_params, attn_params, ls, num_heads, scale, eps,
                                     act_scales)
    B, N, C = x.shape
    wqkv, wproj = attn_params["qkv"]["weight"]["int8"], attn_params["proj"]["weight"]["int8"]
    ops = int8_attn_operands(ln_params, attn_params, act_scales)
    _check_int8(x, ls, ops, wqkv=wqkv, wproj=wproj)
    _check_attn_shapes("fused_attn_block_int8", N, C, num_heads, SDPA_MAX_N)
    if wqkv.shape != (3 * C, C) or wproj.shape != (C, C):
        raise ValueError(f"fused_attn_block_int8: bad int8 weight shapes {tuple(wqkv.shape)}, "
                         f"{tuple(wproj.shape)}")
    rows, dev = B * N, x.device
    q8 = torch.empty(rows * C, dtype=torch.int8, device=dev)
    qs = torch.empty(rows, dtype=torch.float32, device=dev)
    qkv = torch.empty(rows * 3 * C, dtype=x.dtype, device=dev)
    attn = torch.empty(rows * C, dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    ATTN_INT8_KERNEL(
        ptr(x), ptr(ops["ln1s"]), ptr(ops["ln1b"]), ptr(wqkv), ptr(ops["sqkv"]),
        ptr(ops["bqkv"]), ptr(wproj), ptr(ops["sproj"]), ptr(ops["bproj"]), ptr(ls),
        int(act_scales is not None), ptr(q8), ptr(qs), ptr(qkv), ptr(attn), ptr(out), B, N, C,
        num_heads, float(scale), float(eps), stream(),
    )
    if N > ATTN_MAX_N:  # int8.cuh's attention took the two-pass kernel
        SDPA_KERNEL.launches += 1
    return out


def fused_ln_qkv_int8(x, ln_params, qkv_params, num_heads: int, eps: float = 1e-6,
                      with_scores: bool = True, act_scales=None):
    """LN1 + int8 QKV projection with RAJNI scores in the same call: ``(qkv
    [B, N, 3C], scores [B, N] fp32)``, ``scores`` zeros when
    ``with_scores=False``. ``act_scales = (a_qkv, a_proj)``: static scales,
    V leaving pre-scaled by ``1/a_proj`` for
    :func:`fused_gather_sdpa_proj_residual_int8`. The CUDA route takes the
    full width only."""
    if x.device.type == "cpu":
        return ln_qkv_int8_plain(x, ln_params, qkv_params, num_heads, eps, with_scores,
                                 act_scales)
    B, N, C = x.shape
    wq = qkv_params["weight"]["int8"]
    ops = int8_attn_operands(ln_params, {"qkv": qkv_params}, act_scales)
    _check_int8(x, None, ops, wqkv=wq)
    if C % 128 or C > 1024 or wq.shape != (3 * C, C) or N < 2:
        raise ValueError("fused_ln_qkv_int8 on the card needs C % 128 == 0, C <= 1024, the "
                         f"full [3C, C] weight and N >= 2; got C={C}, wqkv {tuple(wq.shape)}, "
                         f"N={N}")
    if with_scores and (C % num_heads or _score_smem(N, C, num_heads) > _SMEM_MAX):
        raise ValueError(f"fused_ln_qkv_int8 cannot score N={N}, C={C}, heads={num_heads}")
    dev = x.device
    q8 = torch.empty(B * N * C, dtype=torch.int8, device=dev)
    qs = torch.empty(B * N, dtype=torch.float32, device=dev)
    qkv = torch.empty(B, N, 3 * C, dtype=x.dtype, device=dev)
    scores = torch.empty(B, N, dtype=torch.float32, device=dev)
    LN_QKV_INT8_KERNEL(
        ptr(x), ptr(ops["ln1s"]), ptr(ops["ln1b"]), ptr(wq), ptr(ops["sqkv"]), ptr(ops["bqkv"]),
        int(with_scores), int(act_scales is not None), ptr(q8), ptr(qs), ptr(qkv), ptr(scores),
        B, N, C, num_heads, float(eps), stream(),
    )
    return qkv, scores


def fused_gather_sdpa_proj_residual_int8(qkv, keep_idx, x, proj_params, ls, num_heads: int,
                                         scale: float, act_scale=None):
    """Int8 pruned attention tail: ``gather(x) + ls1 ·
    proj(mhsa(gather(qkv)))`` → ``[B, K, C]`` with an int8 proj record;
    ``keep_idx [B, K]`` as in :func:`fused_gather_sdpa_proj_residual`.
    ``act_scale``: the static ``a_proj`` (the qkv from
    :func:`fused_ln_qkv_int8` with the same scales)."""
    if x.device.type == "cpu":
        return gather_sdpa_proj_residual_int8_plain(qkv, keep_idx, x, proj_params, ls,
                                                    num_heads, scale, act_scale)
    B, N, C = x.shape
    K = keep_idx.shape[1]
    wq = proj_params["weight"]["int8"]
    ops = _int8_proj_operands(proj_params, act_scale)
    _check_int8(x, ls, ops, wproj=wq)
    check_cuda(torch.bfloat16, qkv=qkv)
    if qkv.shape != (B, N, 3 * C) or wq.shape != (C, C):
        raise ValueError(
            "fused_gather_sdpa_proj_residual_int8 on the card takes the full width only: "
            f"qkv {tuple(qkv.shape)}, proj {tuple(wq.shape)}, x {tuple(x.shape)}"
        )
    _check_attn_shapes("fused_gather_sdpa_proj_residual_int8", K, C, num_heads, SDPA_MAX_N)
    if keep_idx.shape != (B, K) or K > N:
        raise ValueError(f"keep_idx must be [{B}, K <= {N}], got {tuple(keep_idx.shape)}")
    idx = keep_idx.to(torch.int32).contiguous()
    check_cuda(torch.int32, keep_idx=idx)
    dev = x.device
    attn = torch.empty(B * K * C, dtype=torch.float32, device=dev)
    q8 = torch.empty(B * K * C, dtype=torch.int8, device=dev)
    qs = torch.empty(B * K, dtype=torch.float32, device=dev)
    out = torch.empty(B, K, C, dtype=x.dtype, device=dev)
    GATHER_INT8_KERNEL(
        ptr(qkv), ptr(idx), ptr(x), ptr(wq), ptr(ops["sproj"]), ptr(ops["bproj"]), ptr(ls),
        int(act_scale is not None), ptr(attn), ptr(q8), ptr(qs), ptr(out), B, N, K, C,
        num_heads, float(scale), stream(),
    )
    if K > ATTN_MAX_N:  # int8.cuh's attention took the two-pass kernel
        SDPA_KERNEL.launches += 1
    return out
