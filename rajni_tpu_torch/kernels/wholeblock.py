"""The whole-block kernels: a transformer block behind one entry point.

* B7 ``fused_pruned_block_full`` and B8 ``fused_attn_mlp_block``: a pruned
  and a stock block in bf16 (``csrc/pruned_block_full.cu``,
  ``csrc/attn_mlp_block.cu``);
* B14 ``fused_pruned_block_full_int8`` and B15 ``fused_block_full_int8``:
  the same with int8 weights and int8 activations, dynamic per-row or
  calibrated static scales (``csrc/pruned_block_full_int8.cu``,
  ``csrc/block_full_int8.cu``, built from ``csrc/int8.cuh``).

Ports of the functions of the same names in ``rajni_tpu/kernels/block.py``.
On a CUDA tensor each wrapper launches its hand-written kernel; on a CPU
tensor it runs the plain PyTorch version beside it.

Numerics. B7/B8 are those of K1/K2 + K3 (``block.py:2016-2017``,
``2207-2209``): LN, GELU and attention outputs rounded to the activation
dtype, and ``x_mid`` rounded at the half boundary. In B14/B15 the LN, GELU
and attention outputs stay fp32 until they are quantized; qkv and ``x_mid``
are rounded (``csrc/int8.cuh`` gives the lines). The int8 products are
exact: the plain versions take them in float64 (exact while ``|Σ| <
2^53``), then round to fp32 as the int32 accumulator's conversion does.

The fit rules below (``_VMEM_BUDGET`` and the ``_plan`` functions) are the
JAX package's TPU rules, copied. They choose no Hopper tile. They stay
because they fix the numerics, through ``hc`` (each hc-wide chunk of the
GELU output gets its own per-row scale), and because they fix which route
JAX takes, which the port's forward follows.
"""

from __future__ import annotations

import torch

from ..ops.pruning import select_tokens_dense
from .attention import SDPA_MAX_N
from .block import (
    ATTN_MAX_N,
    HEAD_DIM,
    _check_attn_shapes,
    _importance_f32,
    _int8_proj_residual,
    _int8_qkv,
    attn_block_plain,
    int8_attn_operands,
    pruned_attn_block_plain,
)
from .build import F, I, P, CudaKernel, check_cuda, ptr, stream
from .math import fold_static_attn, fold_static_mlp
from .mlp import _ln_mlp_int8, int8_mlp_operands, ln_mlp_residual_plain
from . import block as _block

PRUNED_FULL_KERNEL = CudaKernel(
    "rajni_pruned_block_full", [P] * 16 + [I] + [P] * 9 + [I] * 6 + [F, F, P],
)
ATTN_MLP_KERNEL = CudaKernel(
    "rajni_attn_mlp_block", [P] * 15 + [P] * 6 + [I] * 5 + [F, F, P],
)
PRUNED_FULL_INT8_KERNEL = CudaKernel(
    "rajni_pruned_block_full_int8", [P] * 21 + [I, I, I] + [P] * 12 + [I] * 7 + [F, F, P],
)
BLOCK_FULL_INT8_KERNEL = CudaKernel(
    "rajni_block_full_int8", [P] * 20 + [I, I] + [P] * 9 + [I] * 6 + [F, F, P],
)

# ---------------------------------------------------------------------------
# The JAX package's fit rules (rajni_tpu/kernels/block.py:87-102, 971-982,
# 1497-1510, 1728-1763, 2030-2053, 2193, 2374-2392), without its RAJNI_*_G
# knobs. _gather_fits_fast and _pruned_block_fits choose the split int8
# route as JAX's forward does (rajni_tpu/models/vit.py:810, 867-870).
# ---------------------------------------------------------------------------

_VMEM_BUDGET = 14 * 1024 * 1024


def _gather_fits_fast(N: int, K: int, C: int, itemsize: int) -> bool:
    """Whether the fast gather tail fits (the int8 tail B13 runs only then;
    otherwise the bf16 B5 on the dequantized proj weight)."""
    io = 2 * (N * 3 * C + K * N + N * C + K * C) * itemsize
    weights = C * C * itemsize
    live = K * 3 * C * itemsize + K * N * 4 + 2 * K * C * 4
    return io + weights + live <= _VMEM_BUDGET


def _pruned_block_fits(N: int, K: int, C: int, itemsize: int) -> bool:
    """Whether JAX's one-kernel pruned attention half (K1, or B11 with int8
    weights) fits."""
    io = 2 * (N * C + K * C + 2 * N) * itemsize
    weights = 4 * C * C * itemsize
    live = (N * 3 * C * itemsize + K * 3 * C * itemsize + 4 * N * N * 4 + K * N * 4
            + 2 * K * C * 4)
    return io + weights + live <= _VMEM_BUDGET


def _bf16_g_candidates(C: int, pruned: bool) -> tuple[int, ...]:
    return (4, 2, 1) if pruned and C <= 512 else (2, 1)


def _bf16_full_plan(N: int, K: int, C: int, hidden: int, itemsize: int) -> int | None:
    """Images per program of the bf16 whole-block kernels, or None when the
    block's bf16 weights do not all fit (the split kernels then run)."""
    weights = (4 * C * C + 2 * C * hidden) * itemsize

    def fits(g: int) -> bool:
        io = 2 * (g * N * C + g * K * C + 2 * g * N) * itemsize
        attn_live = (g * N * 3 * C * itemsize + 4 * N * N * 4 + K * 3 * C * itemsize
                     + 2 * g * K * C * 4)
        mlp_live = g * K * hidden * 4 + 3 * g * K * C * 4
        return io + weights + max(attn_live, mlp_live) <= _VMEM_BUDGET

    for g in _bf16_g_candidates(C, pruned=K < N):
        if fits(g):
            return g
    return None


def _attn_mlp_block_fits(N: int, C: int, hidden: int, itemsize: int) -> bool:
    return _bf16_full_plan(N, N, C, hidden, itemsize) is not None


def _pruned_full_int8_plan(N: int, K: int, C: int, hidden: int,
                           itemsize: int) -> tuple[int, int] | None:
    """``(G, hc)`` of the pruned whole-block int8 kernel, or None."""
    weights = 4 * C * C + 2 * C * hidden + (5 * C + hidden) * 4

    def fits(g: int, hc: int) -> bool:
        io = 2 * (g * N * C + g * K * C + 2 * g * N) * itemsize
        attn_live = g * N * 3 * C * 4 + 4 * N * N * 4 + K * 3 * C * 4 + 2 * g * K * C * 4
        mlp_live = g * K * hc * 4 + g * K * C * (4 + 4 + 1)
        return io + weights + max(attn_live, mlp_live) <= _VMEM_BUDGET

    candidates = [(2, hidden // 2), (1, hidden), (1, hidden // 2)]
    if K < N and C <= 512:
        candidates.insert(0, (4, hidden // 2))
    for g, hc in candidates:
        if hc >= 128 and fits(g, hc):
            return g, hc
    return None


def _block_full_int8_plan(N: int, C: int, hidden: int, itemsize: int) -> tuple[int, int] | None:
    """``(G, hc)`` of the stock whole-block int8 kernel, or None."""
    weights = 4 * C * C + 2 * C * hidden + (5 * C + hidden) * 4

    def fits(g: int, hc: int) -> bool:
        rows = g * N
        io = 2 * 2 * rows * C * itemsize
        attn_live = rows * 3 * C * 4 + rows * C * 4 + N * N * 4
        mlp_live = rows * hc * 4 + rows * C * (4 + 4 + 1)
        return io + weights + max(attn_live, mlp_live) <= _VMEM_BUDGET

    for g, hc in ((2, hidden // 2), (1, hidden), (1, hidden // 2)):
        if hc >= 128 and fits(g, hc):
            return g, hc
    return None


def hopper_block_shape_ok(N: int, C: int, num_heads: int, hidden: int,
                          pruned: bool) -> bool:
    """Whether the CUDA whole-block kernels take this shape: C % 128 == 0,
    C <= 1024, head_dim 64, hidden % 128 == 0, and for B7 N <= ATTN_MAX_N
    (its attention half is K1's)."""
    return (C % 128 == 0 and C <= 1024 and C == num_heads * HEAD_DIM and hidden % 128 == 0
            and 2 <= N <= (ATTN_MAX_N if pruned else SDPA_MAX_N))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def pruned_block_full_plain(x, block, prev_scores, num_heads: int, keep: int, scale: float,
                            eps: float = 1e-6, with_scores: bool = True):
    """Plain PyTorch version of B7: K1's plain version, then K3's on the
    kept tokens. Returns ``(x [B, K, C], next_scores [B, K], keep_idx)``."""
    x_mid, ns, idx = pruned_attn_block_plain(
        x, block["norm1"], block["attn"], block.get("ls1"), prev_scores, num_heads, keep,
        scale, eps, with_scores,
    )
    return ln_mlp_residual_plain(x_mid, block["norm2"], block["mlp"], block.get("ls2"), eps), ns, idx


def attn_mlp_block_plain(x, block, num_heads: int, scale: float, eps: float = 1e-6):
    """Plain PyTorch version of B8: K2's plain version, then K3's."""
    x_mid = attn_block_plain(x, block["norm1"], block["attn"], block.get("ls1"), num_heads,
                             scale, eps)
    return ln_mlp_residual_plain(x_mid, block["norm2"], block["mlp"], block.get("ls2"), eps)


def int8_operands(block, act_scales=None) -> dict:
    """The fp32 vector operands of B14/B15: LN affines, weight scales and
    biases, with the static folds (:func:`..math.fold_static_attn`,
    :func:`..math.fold_static_mlp`) applied when ``act_scales = (a_qkv,
    a_proj, a_fc1, a_fc2)`` is given. ``sinv`` is None in dynamic mode."""
    ops = {**int8_attn_operands(block["norm1"], block["attn"]),
           **int8_mlp_operands(block["norm2"], block["mlp"])}
    if act_scales is not None:
        aq, ap, a1, a2 = act_scales
        hidden = block["mlp"]["fc1"]["weight"]["int8"].shape[0]
        ops["ln1s"], ops["ln1b"], ops["sqkv"], ops["sproj"], ops["bqkv"] = fold_static_attn(
            ops["ln1s"], ops["ln1b"], ops["sqkv"], ops["sproj"], ops["bqkv"], aq, ap)
        ops["ln2s"], ops["ln2b"], ops["s1"], ops["s2"], ops["sinv"] = fold_static_mlp(
            ops["ln2s"], ops["ln2b"], ops["s1"], ops["s2"], hidden, a1, a2)
    return {k: (v if v is None else v.contiguous()) for k, v in ops.items()}


def _plan_hc(plan, name: str, shape: str) -> int:
    if plan is None:
        raise ValueError(f"{name} has no plan at {shape}: the JAX route there is the split "
                         "int8 kernels (B9-B13)")
    return plan[1]


def pruned_block_full_int8_plain(x, block, prev_scores, num_heads: int, keep: int,
                                 scale: float, eps: float = 1e-6, with_scores: bool = True,
                                 act_scales=None):
    """Plain PyTorch version of B14: ``(x [B, K, C], next_scores [B, K],
    keep_idx [B, K])`` (``block.py:1609-1710``)."""
    B, N, C = x.shape
    K = keep + 1
    hidden = block["mlp"]["fc1"]["weight"]["int8"].shape[0]
    hc = _plan_hc(_pruned_full_int8_plan(N, K, C, hidden, x.element_size()),
                  "fused_pruned_block_full_int8", f"N={N}, K={K}, C={C}, hidden={hidden}")
    static = act_scales is not None
    ops = int8_operands(block, act_scales)
    # rounded before scoring (block.py:1644)
    qkv = _int8_qkv(x, block["attn"]["qkv"]["weight"]["int8"], ops, static, eps)
    s = _importance_f32(qkv.float(), num_heads) if with_scores else prev_scores.float()
    keep_idx, _ = select_tokens_dense(s, keep, torch.bool)
    next_scores = torch.take_along_dim(s, keep_idx, dim=1)
    idx = keep_idx[..., None]
    attn = _block._mha(torch.take_along_dim(qkv, idx, dim=1), num_heads, scale, torch.float32)
    x_mid = _int8_proj_residual(attn, torch.take_along_dim(x.float(), idx, dim=1),
                                block["attn"]["proj"]["weight"]["int8"], block.get("ls1"), ops,
                                static, x.dtype)
    return (_ln_mlp_int8(x_mid, block["mlp"], ops, block.get("ls2"), hc, eps), next_scores,
            keep_idx)


def block_full_int8_plain(x, block, num_heads: int, scale: float, eps: float = 1e-6,
                          act_scales=None):
    """Plain PyTorch version of B15 (``block.py:2279-2371``)."""
    B, N, C = x.shape
    hidden = block["mlp"]["fc1"]["weight"]["int8"].shape[0]
    hc = _plan_hc(_block_full_int8_plan(N, C, hidden, x.element_size()),
                  "fused_block_full_int8", f"N={N}, C={C}, hidden={hidden}")
    static = act_scales is not None
    ops = int8_operands(block, act_scales)
    # not rounded here, but the attention casts it (block.py:284)
    qkv = _int8_qkv(x, block["attn"]["qkv"]["weight"]["int8"], ops, static, eps)
    attn = _block._mha(qkv, num_heads, scale, torch.float32)
    x_mid = _int8_proj_residual(attn, x.float(), block["attn"]["proj"]["weight"]["int8"],
                                block.get("ls1"), ops, static, x.dtype)
    return _ln_mlp_int8(x_mid, block["mlp"], ops, block.get("ls2"), hc, eps)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _bf16_block_tensors(x, block) -> list:
    """Check the bf16 block's tensors for the card; return them in the
    entry points' order (ln1, qkv, proj, ls1, ln2, fc1, fc2, ls2)."""
    a, m = block["attn"], block["mlp"]
    t = dict(
        ln1s=block["norm1"]["scale"], ln1b=block["norm1"]["bias"], wqkv=a["qkv"]["weight"],
        bqkv=a["qkv"]["bias"], wproj=a["proj"]["weight"], bproj=a["proj"]["bias"],
        ls1=block.get("ls1"), ln2s=block["norm2"]["scale"], ln2b=block["norm2"]["bias"],
        w1=m["fc1"]["weight"], b1=m["fc1"]["bias"], w2=m["fc2"]["weight"], b2=m["fc2"]["bias"],
        ls2=block.get("ls2"),
    )
    check_cuda(torch.bfloat16, x=x, **t)
    return [ptr(v) for v in t.values()]


def _check_shapes(name: str, x, num_heads: int, hidden: int, max_n: int) -> None:
    B, N, C = x.shape
    _check_attn_shapes(name, N, C, num_heads, max_n)
    if hidden % 128:
        raise ValueError(f"{name} needs hidden % 128 == 0, got {hidden}")


def fused_pruned_block_full(x, block, prev_scores, num_heads: int, keep: int, scale: float,
                            eps: float = 1e-6, with_scores: bool = True):
    """Whole pruned block, bf16: ``(x [B, K, C], next_scores [B, K] fp32,
    keep_idx [B, K])`` with ``K = keep + 1``. ``with_scores=False`` selects
    from ``prev_scores [B, N]``."""
    if not with_scores and prev_scores is None:
        raise ValueError("with_scores=False needs prev_scores")
    if x.device.type == "cpu":
        return pruned_block_full_plain(x, block, prev_scores, num_heads, keep, scale, eps,
                                       with_scores)
    B, N, C = x.shape
    K = keep + 1
    hidden = block["mlp"]["fc1"]["weight"].shape[0]
    ptrs = _bf16_block_tensors(x, block)
    prev = _block._check_prev_scores(prev_scores, with_scores, B, N)
    _check_shapes("fused_pruned_block_full", x, num_heads, hidden, ATTN_MAX_N)
    if not 1 <= keep < N:
        raise ValueError(f"keep must be in [1, {N - 1}], got {keep}")
    dev = x.device
    y = torch.empty(B * N, C, dtype=x.dtype, device=dev)
    qkv = torch.empty(B * N, 3 * C, dtype=x.dtype, device=dev)
    scores = torch.empty(B, N, dtype=torch.float32, device=dev) if with_scores else None
    attn = torch.empty(B * K, C, dtype=x.dtype, device=dev)
    idx = torch.empty(B, K, dtype=torch.int32, device=dev)
    next_scores = torch.empty(B, K, dtype=torch.float32, device=dev)
    mid = torch.empty(B * K, C, dtype=x.dtype, device=dev)
    h = torch.empty(B * K, hidden, dtype=x.dtype, device=dev)
    out = torch.empty(B, K, C, dtype=x.dtype, device=dev)
    PRUNED_FULL_KERNEL(
        ptr(x), *ptrs, ptr(prev), int(with_scores), ptr(y), ptr(qkv), ptr(scores), ptr(attn),
        ptr(idx), ptr(next_scores), ptr(mid), ptr(h), ptr(out), B, N, K, C, hidden, num_heads,
        float(scale), float(eps), stream(),
    )
    return out, next_scores, idx.long()


def fused_attn_mlp_block(x, block, num_heads: int, scale: float, eps: float = 1e-6):
    """Whole stock block, bf16: ``[B, N, C] -> [B, N, C]``."""
    if x.device.type == "cpu":
        return attn_mlp_block_plain(x, block, num_heads, scale, eps)
    B, N, C = x.shape
    hidden = block["mlp"]["fc1"]["weight"].shape[0]
    ptrs = _bf16_block_tensors(x, block)
    _check_shapes("fused_attn_mlp_block", x, num_heads, hidden, SDPA_MAX_N)
    dev, rows = x.device, B * N
    y = torch.empty(rows, C, dtype=x.dtype, device=dev)
    qkv = torch.empty(rows, 3 * C, dtype=x.dtype, device=dev)
    attn = torch.empty(rows, C, dtype=x.dtype, device=dev)
    mid = torch.empty(rows, C, dtype=x.dtype, device=dev)
    h = torch.empty(rows, hidden, dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    ATTN_MLP_KERNEL(
        ptr(x), *ptrs, ptr(y), ptr(qkv), ptr(attn), ptr(mid), ptr(h), ptr(out), B, N, C,
        hidden, num_heads, float(scale), float(eps), stream(),
    )
    return out


def _int8_launch_operands(x, block, ops, num_heads: int, hc: int, max_n: int, name: str):
    """Check the int8 block's tensors for the card; return the pointers of
    the entry points' first 20 arguments (x through sinv)."""
    a, m = block["attn"], block["mlp"]
    B, N, C = x.shape
    hidden = m["fc1"]["weight"]["int8"].shape[0]
    check_cuda(torch.bfloat16, x=x, ls1=block.get("ls1"), ls2=block.get("ls2"))
    w = dict(wqkv=a["qkv"]["weight"]["int8"], wproj=a["proj"]["weight"]["int8"],
             w1=m["fc1"]["weight"]["int8"], w2=m["fc2"]["weight"]["int8"])
    check_cuda(torch.int8, **w)
    check_cuda(torch.float32, **{k: v for k, v in ops.items() if v is not None})
    _check_shapes(name, x, num_heads, hidden, max_n)
    if hc % 128 or hidden % hc:
        raise ValueError(f"{name} needs hc % 128 == 0 dividing hidden, got hc={hc}")
    if (w["wqkv"].shape != (3 * C, C) or w["wproj"].shape != (C, C)
            or w["w1"].shape != (hidden, C) or w["w2"].shape != (C, hidden)):
        raise ValueError(f"{name}: bad int8 weight shapes")
    return [ptr(x), ptr(ops["ln1s"]), ptr(ops["ln1b"]), ptr(w["wqkv"]), ptr(ops["sqkv"]),
            ptr(ops["bqkv"]), ptr(w["wproj"]), ptr(ops["sproj"]), ptr(ops["bproj"]),
            ptr(block.get("ls1")), ptr(ops["ln2s"]), ptr(ops["ln2b"]), ptr(w["w1"]),
            ptr(ops["s1"]), ptr(ops["b1"]), ptr(w["w2"]), ptr(ops["s2"]), ptr(ops["b2"]),
            ptr(block.get("ls2")), ptr(ops["sinv"])]


def _int8_scratch(B: int, N: int, n: int, C: int, hidden: int, hc: int, dev,
                  static: bool) -> list:
    """q8, qs, qkv, attn, mid, h, hq, hs (csrc/int8.cuh:Int8Block; h, the
    fp32 GELU output and its absmax, in dynamic mode only, whose first B·N
    floats first hold the attention output's row absmax)."""
    f32, i8 = torch.float32, torch.int8
    return [torch.empty(B * N * C, dtype=i8, device=dev),
            torch.empty(B * N, dtype=f32, device=dev),
            torch.empty(B * N * 3 * C, dtype=torch.bfloat16, device=dev),
            torch.empty(B * n * C, dtype=f32, device=dev),
            torch.empty(B * n * C, dtype=torch.bfloat16, device=dev),
            None if static else torch.empty(B * n * (hidden + hidden // hc), dtype=f32,
                                            device=dev),
            torch.empty(B * n * hidden, dtype=i8, device=dev),
            torch.empty(B * n * (hidden // hc), dtype=f32, device=dev)]


def fused_pruned_block_full_int8(x, block, prev_scores, num_heads: int, keep: int,
                                 scale: float, eps: float = 1e-6, with_scores: bool = True,
                                 act_scales=None, two_launch: bool = False):
    """Whole pruned block with int8 weights: ``(x [B, K, C], next_scores
    [B, K] fp32, keep_idx [B, K])``. ``act_scales = (a_qkv, a_proj, a_fc1,
    a_fc2)`` selects static quantization; ``hc`` comes from
    :func:`_pruned_full_int8_plan` (a shape with no plan raises);
    ``two_launch`` the old attention tail on the card (``block.py``)."""
    if not with_scores and prev_scores is None:
        raise ValueError("with_scores=False needs prev_scores")
    if x.device.type == "cpu":
        return pruned_block_full_int8_plain(x, block, prev_scores, num_heads, keep, scale, eps,
                                            with_scores, act_scales)
    B, N, C = x.shape
    K = keep + 1
    hidden = block["mlp"]["fc1"]["weight"]["int8"].shape[0]
    hc = _plan_hc(_pruned_full_int8_plan(N, K, C, hidden, x.element_size()),
                  "fused_pruned_block_full_int8", f"N={N}, K={K}, C={C}, hidden={hidden}")
    ops = int8_operands(block, act_scales)
    # the attention on the kept tokens takes B6's kernel past ATTN_MAX_N
    # kept tokens (csrc/int8.cuh; DeiT-S/16 384 runs B14 from 519)
    args = _int8_launch_operands(x, block, ops, num_heads, hc, SDPA_MAX_N,
                                 "fused_pruned_block_full_int8")
    prev = _block._check_prev_scores(prev_scores, with_scores, B, N)
    if not 1 <= keep < N:
        raise ValueError(f"keep must be in [1, {N - 1}], got {keep}")
    if with_scores and not _block._score_fits(N, C, num_heads):
        raise ValueError(f"fused_pruned_block_full_int8 cannot score N={N}, C={C}, "
                         f"heads={num_heads}")
    dev = x.device
    q8, qs, qkv, attn, mid, h, hq, hs = _int8_scratch(B, N, K, C, hidden, hc, dev,
                                                      act_scales is not None)
    scores = torch.empty(B, N, dtype=torch.float32, device=dev) if with_scores else None
    idx = torch.empty(B, K, dtype=torch.int32, device=dev)
    next_scores = torch.empty(B, K, dtype=torch.float32, device=dev)
    out = torch.empty(B, K, C, dtype=x.dtype, device=dev)
    PRUNED_FULL_INT8_KERNEL(
        *args, ptr(prev), int(with_scores), int(act_scales is not None), int(two_launch),
        ptr(q8), ptr(qs),
        ptr(qkv), ptr(scores), ptr(attn), ptr(mid), ptr(h), ptr(hq), ptr(hs), ptr(idx),
        ptr(next_scores), ptr(out), B, N, K, C, hidden, hc, num_heads, float(scale),
        float(eps), stream(),
    )
    return out, next_scores, idx.long()


def fused_block_full_int8(x, block, num_heads: int, scale: float, eps: float = 1e-6,
                          act_scales=None, two_launch: bool = False):
    """Whole stock block with int8 weights: ``[B, N, C] -> [B, N, C]``;
    ``act_scales``, ``hc`` and ``two_launch`` as in
    :func:`fused_pruned_block_full_int8` (the plan is
    :func:`_block_full_int8_plan`)."""
    if x.device.type == "cpu":
        return block_full_int8_plain(x, block, num_heads, scale, eps, act_scales)
    B, N, C = x.shape
    hidden = block["mlp"]["fc1"]["weight"]["int8"].shape[0]
    hc = _plan_hc(_block_full_int8_plan(N, C, hidden, x.element_size()),
                  "fused_block_full_int8", f"N={N}, C={C}, hidden={hidden}")
    ops = int8_operands(block, act_scales)
    args = _int8_launch_operands(x, block, ops, num_heads, hc, SDPA_MAX_N,
                                 "fused_block_full_int8")
    q8, qs, qkv, attn, mid, h, hq, hs = _int8_scratch(B, N, N, C, hidden, hc, x.device,
                                                      act_scales is not None)
    out = torch.empty_like(x)
    BLOCK_FULL_INT8_KERNEL(
        *args, int(act_scales is not None), int(two_launch), ptr(q8), ptr(qs), ptr(qkv),
        ptr(attn), ptr(mid), ptr(h), ptr(hq), ptr(hs), ptr(out), B, N, C, hidden, hc, num_heads,
        float(scale), float(eps), stream(),
    )
    return out
