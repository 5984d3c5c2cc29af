"""The Hopper GEMM (``csrc/gemm_sm90.cuh``: persistent, warp-specialized,
TMA and wgmma) behind entry points of its own: bf16, the products of K1
``fused_pruned_attn_block``, K2 ``fused_attn_block``, K3
``fused_ln_mlp_residual``, B4 ``fused_ln_qkv``, B5
``fused_gather_sdpa_proj_residual`` and B17 ``train_ln_mlp``
(:func:`gemm`); and int8, the products of B9-B15 (:func:`gemm_s8`), fc1 with
its GELU quantized in the epilogue (:func:`gelu_quant`), and the int8 tails'
proj with its A operand quantized as it is loaded (:func:`gemm_s8q`).

The entry points launch the same kernel from their own sources, so these
wrappers exist to hold the GEMM to its plain versions and time it beside the
library's GEMM at each product's shapes; one path calls :func:`gemm_s8`
itself, the tensor-parallel stock blocks' int8 proj
(:func:`..parallel.mesh.tp_forward`, ``I8_PARTIAL``). On a
CUDA tensor each launches ``csrc/gemm.cu``; on a CPU tensor it runs its
plain version.

Numeric contract of :func:`gemm` (the epilogues of ``csrc/common.cuh``):
bf16 operands, the product accumulated in fp32, then in fp32 from that sum
``acc + b`` (``EPI_BIAS``), ``gelu_fast(acc + b)`` (``EPI_GELU``: of the fp32
sum, not of a rounded one) or ``res + (acc + b) · ls`` (``EPI_RESIDUAL``,
``ls`` and ``res`` optional), rounded once to the activation dtype; or
``EPI_GELU_SAVE`` (B17), two outputs, ``h = round(acc + b)`` and
``round(gelu_fast(h))``, the GELU of the rounded h (on the card computed as
PyTorch computes :func:`..math.gelu_fast`, so it is PyTorch's GELU of the
kernel's h bit for bit). With
``res_idx`` the residual is gathered, as K1's and B5's proj read the pre-norm
x of the kept tokens: output row ``r`` (of ``M``, flattened) adds row ``(r //
rows_out) * rows_in + res_idx[r]`` of ``res`` (flattened to ``[R, N]``), so
that ``rows_out`` output rows and ``rows_in`` residual rows make an image.

Numeric contract of :func:`gemm_s8` (``csrc/int8.cuh``): int8 operands, the
product exact in int32 (the plain version takes it in float64, exact while
``|Σ| < 2^53``, then rounds to fp32 as the int32 conversion does), then in
fp32, each operation rounded once in this order: ``· a[row]`` (dynamic; a
grouped product, ``group_k < K``, flushes each group's sum ``· a[row,
group]`` and adds the groups), ``· w_scale``, ``+ bias``, then
``I8_BIAS`` stores bf16, ``I8_PARTIAL`` stores fp32 (a row-parallel shard's
partial sum, all-reduced after), ``I8_GELU`` ``gelu_fast`` in fp32 (the kernel's GELU
differs from :func:`..math.gelu_fast` in its last bits: ex2 and a
reciprocal), ``I8_RESIDUAL`` ``· ls`` and ``res +``, bf16 (``res_idx`` as
above). So ``I8_BIAS``, ``I8_PARTIAL`` and ``I8_RESIDUAL`` are the plain
version's bits.
:func:`gelu_quant` quantizes ``I8_GELU``'s output per row and hc-wide column
group as the int8 kernels' h is: ``quantize_rows`` of each group (dynamic,
``(hq, hs)``) or ``quantize_static(h · sinv)`` (static, ``(hq, None)``). On
the card its hq and hs are those of ``I8_GELU`` followed by the kernels' row
quantizer, bit for bit, and those of :func:`quant_groups_plain` of the
kernel's h (``quantize_rows`` divides ``127 / absmax`` once, as the kernels
do).

:func:`gemm_s8q` is ``I8_RESIDUAL`` of :func:`gemm_s8` (ungrouped) on ``q,
a = quantize_rows(o)`` of the attention output ``o`` (bf16 or fp32), with
the quantizer's operations done as the GEMM loads ``o``: row ``r`` by ``127
/ max(amax[r], 1e-8)``, ``amax`` its absmax (:func:`row_absmax_plain`, which
the attention kernels take in their epilogue), dequantized by ``max(amax[r],
1e-8) · (1/127)``; or static (``amax`` None): ``quantize_static(o)``, no row
scale. Its plain version :func:`gemm_s8q_plain` is bitwise the two-step
route.

:func:`band_proj` is the proj form of the row-band GEMM
(``csrc/band_s8.cuh``, B10's and B11's proj): :func:`gemm_s8q`'s function on
a bf16 attention output, quantized once a 128-row band, its plain version
:func:`gemm_s8q_plain`.
"""

from __future__ import annotations

import torch

from .build import I, P, CudaKernel, check_cuda, ptr, stream
from .math import gelu_fast, quantize_rows, quantize_static
from .mlp import _int8_mm

# csrc/common.cuh: Epilogue
EPI_BIAS, EPI_GELU, EPI_RESIDUAL, EPI_GELU_SAVE = 0, 1, 2, 3
EPILOGUES = (EPI_BIAS, EPI_GELU, EPI_RESIDUAL, EPI_GELU_SAVE)
BLOCK_K = 64  # csrc/gemm_sm90.cuh: a stage is 128 bytes of k, 64 bf16
S8_BLOCK_K = 128  # ... and 128 int8
# csrc/int8.cuh: I8Epilogue
I8_BIAS, I8_GELU, I8_RESIDUAL, I8_PARTIAL = 0, 1, 2, 5
S8_EPILOGUES = (I8_BIAS, I8_GELU, I8_RESIDUAL, I8_PARTIAL)

KERNEL = CudaKernel("rajni_gemm_sm90", [P, P, P, I, I, I, I, P, P, P, P, I, I, P, P])
S8_KERNEL = CudaKernel("rajni_gemm_s8", [P, P, P, I, I, I, I] + [P] * 6 + [I, I, I, P])
GELU_QUANT_KERNEL = CudaKernel("rajni_gelu_quant_s8", [P] * 5 + [I] * 3 + [P] * 4 + [I, I, P])
S8Q_KERNEL = CudaKernel("rajni_gemm_s8q", [P, I, P, P, P, I, I, I] + [P] * 5 + [I, I, P])
BAND_PROJ_KERNEL = CudaKernel("rajni_band_proj", [P, P, P, P, I, I, I] + [P] * 5 + [I, I, P])


def gathered_rows(res_idx: torch.Tensor, rows_out: int, rows_in: int) -> torch.Tensor:
    """The residual row of each output row: ``(r // rows_out) * rows_in +
    res_idx[r]`` over the ``M`` flattened output rows (int64)."""
    r = torch.arange(res_idx.numel(), device=res_idx.device)
    return r // rows_out * rows_in + res_idx.reshape(-1).long()


def gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: int,
               ls: torch.Tensor | None = None, res: torch.Tensor | None = None,
               res_idx: torch.Tensor | None = None, rows_out: int = 1,
               rows_in: int = 1):
    """Plain PyTorch version of the GEMM: the same arithmetic, in the same
    order, as the plain versions of K1, K2, K3, B4, B5 and B17
    (``kernels/block.py``, ``kernels/mlp.py``, ``kernels/train.py``). Returns
    ``out``, or ``(out, h)`` for ``EPI_GELU_SAVE``."""
    out = a.float() @ w.float().t() + bias.float()
    if epilogue == EPI_GELU_SAVE:
        h = out.to(a.dtype)
        return gelu_fast(h.float()).to(a.dtype), h
    if epilogue == EPI_GELU:
        out = gelu_fast(out)
    elif epilogue == EPI_RESIDUAL:
        if ls is not None:
            out = out * ls.float()
        if res is not None:
            if res_idx is not None:
                rows = gathered_rows(res_idx, rows_out, rows_in)
                res = res.reshape(-1, res.shape[-1])[rows].reshape(out.shape)
            out = res.float() + out
    elif epilogue != EPI_BIAS:
        raise ValueError(f"gemm_plain: unknown epilogue {epilogue}")
    return out.to(a.dtype)


def _check(a, w, bias, epilogue, ls, res, res_idx, rows_out, rows_in) -> None:
    K = a.shape[-1]
    N = w.shape[0]
    if epilogue not in EPILOGUES:
        raise ValueError(f"gemm takes epilogues {EPILOGUES}, got {epilogue}")
    if w.ndim != 2 or w.shape[1] != K:
        raise ValueError(f"gemm: w must be [N, {K}], got {tuple(w.shape)}")
    if K % BLOCK_K or N % 8:
        raise ValueError(f"gemm needs K % {BLOCK_K} == 0 and N % 8 == 0; got K={K}, N={N}")
    if a.numel() == 0:
        raise ValueError("gemm needs at least one row")
    if tuple(bias.shape) != (N,) or (ls is not None and tuple(ls.shape) != (N,)):
        raise ValueError(f"gemm: bias and ls must be [{N}]")
    if epilogue != EPI_RESIDUAL and (ls is not None or res is not None):
        raise ValueError("gemm: ls and res belong to EPI_RESIDUAL")
    _check_residual("gemm", a, N, res, res_idx, rows_out, rows_in)


def _check_residual(name, a, N, res, res_idx, rows_out, rows_in) -> None:
    """The residual's shapes: ``[..., N]`` rows of ``a``, or gathered through
    ``res_idx`` (shapes only: a value check would sync the card)."""
    if res_idx is None:
        if res is not None and tuple(res.shape) != (*a.shape[:-1], N):
            raise ValueError(f"{name}: res must be {(*a.shape[:-1], N)}, got {tuple(res.shape)}")
        return
    M = a.numel() // a.shape[-1]
    if res is None:
        raise ValueError(f"{name}: res_idx needs res")
    if tuple(res_idx.shape) != tuple(a.shape[:-1]) or res_idx.dtype != torch.int32:
        raise ValueError(f"{name}: res_idx must be int32 {tuple(a.shape[:-1])}, got "
                         f"{res_idx.dtype} {tuple(res_idx.shape)}")
    if res_idx.device != a.device:
        raise ValueError(f"{name}: res_idx must be on {a.device}, got {res_idx.device}")
    if res.ndim < 1 or res.shape[-1] != N:
        raise ValueError(f"{name}: res must be [..., {N}], got {tuple(res.shape)}")
    R = res.numel() // N
    if (rows_out < 1 or rows_in < 1 or M % rows_out or R % rows_in
            or M // rows_out != R // rows_in):
        raise ValueError(f"{name}: rows_out={rows_out} and rows_in={rows_in} must divide the "
                         f"{M} output and {R} residual rows into the same number of images")


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: int,
         ls: torch.Tensor | None = None, res: torch.Tensor | None = None,
         res_idx: torch.Tensor | None = None, rows_out: int = 1,
         rows_in: int = 1):
    """``[..., K] @ [N, K]ᵀ -> [..., N]`` with the epilogue ``epilogue``
    (with ``res_idx``, the gathered residual of the module docstring;
    ``EPI_GELU_SAVE`` returns ``(out, h)``). Raises on shapes the kernel
    does not take (``K % 64``, ``N % 8``, an epilogue code not in
    ``EPILOGUES``, a ``res_idx`` that is not int32 ``a.shape[:-1]`` on
    ``a``'s device, ``rows_out``/``rows_in`` that do not split the output
    and residual rows into the same images) before it dispatches, on any
    device. Each ``res_idx[r]`` must lie in ``[0, rows_in)``; that is not
    checked (it would sync the card)."""
    _check(a, w, bias, epilogue, ls, res, res_idx, rows_out, rows_in)
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, epilogue, ls, res, res_idx, rows_out, rows_in)
    check_cuda(torch.bfloat16, a=a, w=w, bias=bias, ls=ls, res=res)
    check_cuda(torch.int32, res_idx=res_idx)
    K, N = a.shape[-1], w.shape[0]
    M = a.numel() // K
    out = torch.empty(*a.shape[:-1], N, dtype=a.dtype, device=a.device)
    h = torch.empty_like(out) if epilogue == EPI_GELU_SAVE else None
    KERNEL(ptr(a), ptr(w), ptr(out), M, N, K, epilogue, ptr(bias), ptr(ls), ptr(res),
           ptr(res_idx), rows_out, rows_in, ptr(h), stream())
    return out if h is None else (out, h)


# ---------------------------------------------------------------------------
# int8: the products of B9-B15
# ---------------------------------------------------------------------------


def gemm_s8_plain(q: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
                  epilogue: int, a: torch.Tensor | None = None, group_k: int | None = None,
                  ls: torch.Tensor | None = None, res: torch.Tensor | None = None,
                  res_idx: torch.Tensor | None = None, rows_out: int = 1,
                  rows_in: int = 1, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the int8 GEMM: ``q [..., K]`` and ``w [N, K]``
    int8, ``a [..., K // group_k]`` fp32 row scales (or None: static),
    ``w_scale`` and ``bias [N]`` fp32, ``ls [N]`` and ``res`` bf16; the
    module docstring's operations in the kernel's order. Returns
    ``out_dtype`` (``I8_BIAS``, ``I8_RESIDUAL``: the kernel stores bf16) or
    fp32 (``I8_GELU``, ``I8_PARTIAL``)."""
    K = q.shape[-1]
    gk = group_k or K
    acc = None
    for g, j in enumerate(range(0, K, gk)):
        part = _int8_mm(q[..., j:j + gk], w[:, j:j + gk])
        if a is not None:
            part = part * a[..., g:g + 1]
        acc = part if acc is None else acc + part
    out = acc * w_scale + bias
    if epilogue == I8_GELU:
        return gelu_fast(out)
    if epilogue == I8_PARTIAL:
        return out
    if epilogue == I8_RESIDUAL:
        if ls is not None:
            out = out * ls.float()
        if res is not None:
            if res_idx is not None:
                rows = gathered_rows(res_idx, rows_out, rows_in)
                res = res.reshape(-1, res.shape[-1])[rows].reshape(out.shape)
            out = res.float() + out
    elif epilogue != I8_BIAS:
        raise ValueError(f"gemm_s8_plain: unknown epilogue {epilogue}")
    return out.to(out_dtype)


def quant_groups_plain(h: torch.Tensor, hc: int, sinv: torch.Tensor | None = None):
    """``h [..., N]`` fp32 quantized per row and hc-wide column group, as the
    int8 kernels' GELU output is (``kernels/mlp.py:_ln_mlp_int8``): ``(hq
    int8 [..., N], hs fp32 [..., N // hc])``, or ``(hq, None)`` with the
    static fold ``sinv [N]``."""
    qs, ss = [], []
    for j in range(0, h.shape[-1], hc):
        if sinv is not None:
            qs.append(quantize_static(h[..., j:j + hc] * sinv[j:j + hc]))
        else:
            q, s = quantize_rows(h[..., j:j + hc])
            qs.append(q)
            ss.append(s)
    return torch.cat(qs, dim=-1), (None if sinv is not None else torch.cat(ss, dim=-1))


def gelu_quant_plain(q, w, w_scale, bias, hc: int, a=None, sinv=None):
    """Plain PyTorch version of fc1 with its GELU quantized: ``I8_GELU`` of
    :func:`gemm_s8_plain`, then :func:`quant_groups_plain`."""
    return quant_groups_plain(gemm_s8_plain(q, w, w_scale, bias, I8_GELU, a), hc, sinv)


def _check_s8(q, w, w_scale, bias, epilogue, a, group_k, ls, res, res_idx, rows_out,
              rows_in) -> int:
    """Shape checks of :func:`gemm_s8` (and :func:`gelu_quant`); returns
    group_k."""
    K, N = q.shape[-1], w.shape[0]
    gk = group_k or K
    if epilogue not in S8_EPILOGUES:
        raise ValueError(f"gemm_s8 takes epilogues {S8_EPILOGUES}, got {epilogue}")
    if w.ndim != 2 or w.shape[1] != K:
        raise ValueError(f"gemm_s8: w must be [N, {K}], got {tuple(w.shape)}")
    if K % S8_BLOCK_K or N % 16 or gk % S8_BLOCK_K or K % gk:
        raise ValueError(f"gemm_s8 needs K % {S8_BLOCK_K} == 0, N % 16 == 0 and group_k % "
                         f"{S8_BLOCK_K} == 0 dividing K; got K={K}, N={N}, group_k={gk}")
    if q.numel() == 0:
        raise ValueError("gemm_s8 needs at least one row")
    if any(t is not None and tuple(t.shape) != (N,) for t in (w_scale, bias, ls)):
        raise ValueError(f"gemm_s8: w_scale, bias and ls must be [{N}]")
    if a is not None and tuple(a.shape) != (*q.shape[:-1], K // gk):
        raise ValueError(f"gemm_s8: a must be {(*q.shape[:-1], K // gk)}, got {tuple(a.shape)}")
    if gk != K and epilogue != I8_RESIDUAL:
        raise ValueError("gemm_s8: only I8_RESIDUAL (fc2) is grouped")
    if epilogue != I8_RESIDUAL and (ls is not None or res is not None):
        raise ValueError("gemm_s8: ls and res belong to I8_RESIDUAL")
    _check_residual("gemm_s8", q, N, res, res_idx, rows_out, rows_in)
    return gk


def gemm_s8(q: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
            epilogue: int, a: torch.Tensor | None = None, group_k: int | None = None,
            ls: torch.Tensor | None = None, res: torch.Tensor | None = None,
            res_idx: torch.Tensor | None = None, rows_out: int = 1,
            rows_in: int = 1) -> torch.Tensor:
    """The int8 GEMM (:func:`gemm_s8_plain`'s arguments). Raises on shapes the
    kernel does not take (``K % 128``, ``N % 16``, ``group_k``, a grouped
    epilogue other than ``I8_RESIDUAL``, and :func:`gemm`'s ``res_idx``
    refusals) before it dispatches, on any device."""
    gk = _check_s8(q, w, w_scale, bias, epilogue, a, group_k, ls, res, res_idx, rows_out,
                   rows_in)
    if q.device.type == "cpu":
        return gemm_s8_plain(q, w, w_scale, bias, epilogue, a, group_k, ls, res, res_idx,
                             rows_out, rows_in)
    check_cuda(torch.int8, q=q, w=w)
    check_cuda(torch.float32, a=a, w_scale=w_scale, bias=bias)
    check_cuda(torch.bfloat16, ls=ls, res=res)
    check_cuda(torch.int32, res_idx=res_idx)
    K, N = q.shape[-1], w.shape[0]
    M = q.numel() // K
    out = torch.empty(*q.shape[:-1], N, device=q.device,
                      dtype=torch.float32 if epilogue in (I8_GELU, I8_PARTIAL) else torch.bfloat16)
    S8_KERNEL(ptr(q), ptr(w), ptr(out), M, N, K, epilogue, ptr(a), ptr(w_scale), ptr(bias),
              ptr(ls), ptr(res), ptr(res_idx), rows_out, rows_in, gk, stream())
    return out


def gelu_quant(q, w, w_scale, bias, hc: int, a=None, sinv=None, two_launch: bool = False):
    """fc1 with its GELU quantized per row and hc group: ``(hq, hs)``
    (dynamic) or ``(hq, None)`` (static, ``sinv [N]`` given), as
    :func:`gelu_quant_plain`. On the card: the route of B9, B14 and B15
    (static: the GELU quantized in fc1's epilogue; dynamic: fp32 h with each
    row and group's absmax taken in fc1's epilogue, then a quantizer that
    reads h once), or with ``two_launch`` ``I8_GELU`` to fp32 h and the row
    quantizer, which reads h twice. Raises before it dispatches where ``hc %
    128`` or ``N % hc``, or as :func:`gemm_s8` does."""
    _check_s8(q, w, w_scale, bias, I8_GELU, a, None, None, None, None, 1, 1)
    N = w.shape[0]
    if hc < S8_BLOCK_K or hc % S8_BLOCK_K or N % hc:
        raise ValueError(f"gelu_quant needs hc % {S8_BLOCK_K} == 0 dividing N={N}, got {hc}")
    if sinv is not None and a is not None:
        raise ValueError("gelu_quant: static (sinv) takes no row scales a")
    if q.device.type == "cpu":
        return gelu_quant_plain(q, w, w_scale, bias, hc, a, sinv)
    check_cuda(torch.int8, q=q, w=w)
    check_cuda(torch.float32, a=a, w_scale=w_scale, bias=bias, sinv=sinv)
    K = q.shape[-1]
    M = q.numel() // K
    dev = q.device
    hq = torch.empty(*q.shape[:-1], N, dtype=torch.int8, device=dev)
    hs = None if sinv is not None else torch.empty(*q.shape[:-1], N // hc,
                                                   dtype=torch.float32, device=dev)
    scratch = torch.empty(M * (N + N // hc), dtype=torch.float32, device=dev)  # h, its absmax
    GELU_QUANT_KERNEL(ptr(q), ptr(w), ptr(hq), ptr(hs), ptr(scratch), M, N, K, ptr(a),
                      ptr(w_scale), ptr(bias), ptr(sinv), hc, int(two_launch), stream())
    return hq, hs


# ---------------------------------------------------------------------------
# The int8 tails' proj: the attention output quantized as it is loaded
# ---------------------------------------------------------------------------


def row_absmax_plain(o: torch.Tensor) -> torch.Tensor:
    """Each row's absmax of the attention output ``o [..., C]`` as stored
    (bf16 or fp32), fp32 ``[...]``: what the attention kernels' epilogue
    takes (the maximum over the heads of each head's maximum, which is the
    row's)."""
    return o.float().abs().amax(dim=-1)


def gemm_s8q_plain(o: torch.Tensor, amax: torch.Tensor | None, w: torch.Tensor,
                   w_scale: torch.Tensor, bias: torch.Tensor, ls: torch.Tensor | None = None,
                   res: torch.Tensor | None = None, res_idx: torch.Tensor | None = None,
                   rows_out: int = 1, rows_in: int = 1,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemm_s8q`: ``o [..., K]`` (bf16 or
    fp32) quantized per row by its absmax ``amax [...]`` (None: static) with
    the operations of :func:`..math.quantize_rows`, then ``I8_RESIDUAL`` of
    :func:`gemm_s8_plain` (stored in ``out_dtype``; the kernel stores
    bf16)."""
    o32 = o.float()
    if amax is None:
        q, a = quantize_static(o32), None
    else:
        m = torch.clamp_min(amax.float(), 1e-8)[..., None]
        mul = torch.full_like(m, 127.0) / m
        q = torch.clamp(torch.round(o32 * mul), -127, 127).to(torch.int8)
        a = m * (1.0 / 127.0)
    return gemm_s8_plain(q, w, w_scale, bias, I8_RESIDUAL, a, None, ls, res, res_idx, rows_out,
                         rows_in, out_dtype)


def gemm_s8q(o: torch.Tensor, amax: torch.Tensor | None, w: torch.Tensor,
             w_scale: torch.Tensor, bias: torch.Tensor, ls: torch.Tensor | None = None,
             res: torch.Tensor | None = None, res_idx: torch.Tensor | None = None,
             rows_out: int = 1, rows_in: int = 1) -> torch.Tensor:
    """The int8 tails' proj (``csrc/int8.cuh:launch_gemm_s8q``), arguments
    as :func:`gemm_s8q_plain`. Raises before it dispatches, on any device,
    where ``o`` is neither bf16 nor fp32, ``amax`` is not fp32 ``o.shape[:-1]``
    on ``o``'s device, or as :func:`gemm_s8` does (``K % 128``, ``N % 16``,
    the residual's shapes)."""
    if o.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gemm_s8q takes a bf16 or fp32 A, got {o.dtype}")
    if amax is not None and (tuple(amax.shape) != tuple(o.shape[:-1])
                             or amax.dtype != torch.float32 or amax.device != o.device):
        raise ValueError(f"gemm_s8q: amax must be fp32 {tuple(o.shape[:-1])} on {o.device}, "
                         f"got {amax.dtype} {tuple(amax.shape)} on {amax.device}")
    _check_s8(o, w, w_scale, bias, I8_RESIDUAL, None, None, ls, res, res_idx, rows_out, rows_in)
    if o.device.type == "cpu":
        return gemm_s8q_plain(o, amax, w, w_scale, bias, ls, res, res_idx, rows_out, rows_in)
    check_cuda(o.dtype, o=o)
    check_cuda(torch.int8, w=w)
    check_cuda(torch.float32, amax=amax, w_scale=w_scale, bias=bias)
    check_cuda(torch.bfloat16, ls=ls, res=res)
    check_cuda(torch.int32, res_idx=res_idx)
    K, N = o.shape[-1], w.shape[0]
    M = o.numel() // K
    out = torch.empty(*o.shape[:-1], N, dtype=torch.bfloat16, device=o.device)
    S8Q_KERNEL(ptr(o), int(o.dtype == torch.float32), ptr(amax), ptr(w), ptr(out), M, N, K,
               ptr(w_scale), ptr(bias), ptr(ls), ptr(res), ptr(res_idx), rows_out, rows_in,
               stream())
    return out


# ---------------------------------------------------------------------------
# The row-band GEMM's proj (csrc/band_s8.cuh): B10's and B11's proj
# ---------------------------------------------------------------------------

BAND_PROJ_MAX_C = 1280  # csrc/band_s8.cuh: the widest band of the proj form (2 W stages)


def band_proj(o: torch.Tensor, amax: torch.Tensor | None, w: torch.Tensor,
              w_scale: torch.Tensor, bias: torch.Tensor, ls: torch.Tensor | None = None,
              res: torch.Tensor | None = None, res_idx: torch.Tensor | None = None,
              rows_out: int = 1, rows_in: int = 1) -> torch.Tensor:
    """The band GEMM's proj form: :func:`gemm_s8q`'s function (its plain
    version :func:`gemm_s8q_plain`) on a bf16 attention output ``o``,
    quantized once a 128-row band in shared memory. Raises before it
    dispatches, on any device, without the residual, on another dtype of
    ``o``, where ``C % 128``, ``C > BAND_PROJ_MAX_C`` or ``N % 128``, and as
    :func:`gemm_s8q` does."""
    C, N = o.shape[-1], w.shape[0]
    if res is None or C % 128 or C > BAND_PROJ_MAX_C or N % 128:
        raise ValueError(f"band_proj needs the residual, C % 128 == 0, C <= {BAND_PROJ_MAX_C} "
                         f"and N % 128 == 0; got res {'given' if res is not None else 'None'}, o "
                         f"{tuple(o.shape)}, w {tuple(w.shape)}")
    if o.dtype != torch.bfloat16:
        raise ValueError(f"band_proj takes a bf16 A, got {o.dtype}")
    if amax is not None and (tuple(amax.shape) != tuple(o.shape[:-1])
                             or amax.dtype != torch.float32 or amax.device != o.device):
        raise ValueError(f"band_proj: amax must be fp32 {tuple(o.shape[:-1])} on {o.device}, "
                         f"got {amax.dtype} {tuple(amax.shape)} on {amax.device}")
    _check_s8(o, w, w_scale, bias, I8_RESIDUAL, None, None, ls, res, res_idx, rows_out, rows_in)
    if o.device.type == "cpu":
        return gemm_s8q_plain(o, amax, w, w_scale, bias, ls, res, res_idx, rows_out, rows_in)
    check_cuda(torch.bfloat16, o=o)
    check_cuda(torch.int8, w=w)
    check_cuda(torch.float32, amax=amax, w_scale=w_scale, bias=bias)
    check_cuda(torch.bfloat16, ls=ls, res=res)
    check_cuda(torch.int32, res_idx=res_idx)
    M = o.numel() // C
    out = torch.empty(*o.shape[:-1], N, dtype=torch.bfloat16, device=o.device)
    BAND_PROJ_KERNEL(ptr(o), ptr(amax), ptr(w), ptr(out), M, N, C, ptr(w_scale), ptr(bias),
                     ptr(ls), ptr(res), ptr(res_idx), rows_out, rows_in, stream())
    return out
