"""The Hopper GEMM of K1 ``fused_pruned_attn_block``, K2
``fused_attn_block``, K3 ``fused_ln_mlp_residual``, B4 ``fused_ln_qkv`` and
B5 ``fused_gather_sdpa_proj_residual`` behind an entry point of its own:
``out[..., N] = epilogue(a[..., K] @ w[N, K]ᵀ)``.

No path calls :func:`gemm`: those entry points launch the same kernel
(``csrc/gemm_sm90.cuh``: persistent, warp-specialized, TMA and wgmma) from
their own sources. This wrapper exists so that the GEMM can be held to
:func:`gemm_plain` and timed beside the library's GEMM at each product's
shapes. On a CUDA tensor it launches ``csrc/gemm.cu``; on a CPU tensor it
runs :func:`gemm_plain`.

Numeric contract (the epilogues of ``csrc/common.cuh``): bf16 operands, the
product accumulated in fp32, then in fp32 from that sum ``acc + b``
(``EPI_BIAS``), ``gelu_fast(acc + b)`` (``EPI_GELU``: of the fp32 sum, not
of a rounded one) or ``res + (acc + b) · ls`` (``EPI_RESIDUAL``, ``ls`` and
``res`` optional), rounded once to the activation dtype. With ``res_idx``
the residual is gathered, as K1's and B5's proj read the pre-norm x of the
kept tokens: output row ``r`` (of ``M``, flattened) adds row ``(r //
rows_out) * rows_in + res_idx[r]`` of ``res`` (flattened to ``[R, N]``), so
that ``rows_out`` output rows and ``rows_in`` residual rows make an image.
"""

from __future__ import annotations

import torch

from .build import I, P, CudaKernel, check_cuda, ptr, stream
from .math import gelu_fast

# csrc/common.cuh: Epilogue
EPI_BIAS, EPI_GELU, EPI_RESIDUAL, EPI_GELU_SAVE = 0, 1, 2, 3
EPILOGUES = (EPI_BIAS, EPI_GELU, EPI_RESIDUAL)  # what csrc/gemm_sm90.cuh computes
BLOCK_K = 64  # csrc/gemm_sm90.cuh: G9_BK, the k depth of a stage

KERNEL = CudaKernel("rajni_gemm_sm90", [P, P, P, I, I, I, I, P, P, P, P, I, I, P])


def gathered_rows(res_idx: torch.Tensor, rows_out: int, rows_in: int) -> torch.Tensor:
    """The residual row of each output row: ``(r // rows_out) * rows_in +
    res_idx[r]`` over the ``M`` flattened output rows (int64)."""
    r = torch.arange(res_idx.numel(), device=res_idx.device)
    return r // rows_out * rows_in + res_idx.reshape(-1).long()


def gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: int,
               ls: torch.Tensor | None = None, res: torch.Tensor | None = None,
               res_idx: torch.Tensor | None = None, rows_out: int = 1,
               rows_in: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the GEMM: the same arithmetic, in the same
    order, as the plain versions of K1, K2, K3, B4 and B5
    (``kernels/block.py``, ``kernels/mlp.py``)."""
    out = a.float() @ w.float().t() + bias.float()
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
    if res_idx is None:
        if res is not None and tuple(res.shape) != (*a.shape[:-1], N):
            raise ValueError(f"gemm: res must be {(*a.shape[:-1], N)}, got {tuple(res.shape)}")
        return
    # the gathered residual: shapes only (a value check would sync the card)
    M = a.numel() // K
    if res is None:
        raise ValueError("gemm: res_idx needs res")
    if tuple(res_idx.shape) != tuple(a.shape[:-1]) or res_idx.dtype != torch.int32:
        raise ValueError(f"gemm: res_idx must be int32 {tuple(a.shape[:-1])}, got "
                         f"{res_idx.dtype} {tuple(res_idx.shape)}")
    if res_idx.device != a.device:
        raise ValueError(f"gemm: res_idx must be on {a.device}, got {res_idx.device}")
    if res.ndim < 1 or res.shape[-1] != N:
        raise ValueError(f"gemm: res must be [..., {N}], got {tuple(res.shape)}")
    R = res.numel() // N
    if (rows_out < 1 or rows_in < 1 or M % rows_out or R % rows_in
            or M // rows_out != R // rows_in):
        raise ValueError(f"gemm: rows_out={rows_out} and rows_in={rows_in} must divide the "
                         f"{M} output and {R} residual rows into the same number of images")


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: int,
         ls: torch.Tensor | None = None, res: torch.Tensor | None = None,
         res_idx: torch.Tensor | None = None, rows_out: int = 1,
         rows_in: int = 1) -> torch.Tensor:
    """``[..., K] @ [N, K]ᵀ -> [..., N]`` with the epilogue ``epilogue``
    (with ``res_idx``, the gathered residual of the module docstring).
    Raises on shapes the kernel does not take (``K % 64``, ``N % 8``,
    ``EPI_GELU_SAVE``, a ``res_idx`` that is not int32 ``a.shape[:-1]`` on
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
    KERNEL(ptr(a), ptr(w), ptr(out), M, N, K, epilogue, ptr(bias), ptr(ls), ptr(res),
           ptr(res_idx), rows_out, rows_in, stream())
    return out
