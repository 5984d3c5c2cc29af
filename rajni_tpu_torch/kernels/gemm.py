"""The Hopper GEMM of K2 ``fused_attn_block`` and K3
``fused_ln_mlp_residual`` behind an entry point of its own:
``out[..., N] = epilogue(a[..., K] @ w[N, K]ᵀ)``.

No path calls :func:`gemm`: K2 and K3 launch the same kernel
(``csrc/gemm_sm90.cuh``: persistent, warp-specialized, TMA and wgmma) from
their own entry points. This wrapper exists so that the GEMM can be held to
:func:`gemm_plain` and timed beside the library's GEMM at each product's
shapes. On a CUDA tensor it launches ``csrc/gemm.cu``; on a CPU tensor it
runs :func:`gemm_plain`.

Numeric contract (the epilogues of ``csrc/common.cuh``): bf16 operands, the
product accumulated in fp32, then in fp32 from that sum ``acc + b``
(``EPI_BIAS``), ``gelu_fast(acc + b)`` (``EPI_GELU``: of the fp32 sum, not
of a rounded one) or ``res + (acc + b) · ls`` (``EPI_RESIDUAL``, ``ls`` and
``res`` optional), rounded once to the activation dtype.
"""

from __future__ import annotations

import torch

from .build import I, P, CudaKernel, check_cuda, ptr, stream
from .math import gelu_fast

# csrc/common.cuh: Epilogue
EPI_BIAS, EPI_GELU, EPI_RESIDUAL, EPI_GELU_SAVE = 0, 1, 2, 3
EPILOGUES = (EPI_BIAS, EPI_GELU, EPI_RESIDUAL)  # what csrc/gemm_sm90.cuh computes
BLOCK_K = 64  # csrc/gemm_sm90.cuh: G9_BK, the k depth of a stage

KERNEL = CudaKernel("rajni_gemm_sm90", [P, P, P, I, I, I, I, P, P, P, P])


def gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: int,
               ls: torch.Tensor | None = None, res: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the GEMM: the same arithmetic, in the same
    order, as the plain versions of K2 and K3 (``kernels/block.py``,
    ``kernels/mlp.py``)."""
    out = a.float() @ w.float().t() + bias.float()
    if epilogue == EPI_GELU:
        out = gelu_fast(out)
    elif epilogue == EPI_RESIDUAL:
        if ls is not None:
            out = out * ls.float()
        if res is not None:
            out = res.float() + out
    elif epilogue != EPI_BIAS:
        raise ValueError(f"gemm_plain: unknown epilogue {epilogue}")
    return out.to(a.dtype)


def _check(a, w, bias, epilogue, ls, res) -> None:
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
    if res is not None and tuple(res.shape) != (*a.shape[:-1], N):
        raise ValueError(f"gemm: res must be {(*a.shape[:-1], N)}, got {tuple(res.shape)}")
    if epilogue != EPI_RESIDUAL and (ls is not None or res is not None):
        raise ValueError("gemm: ls and res belong to EPI_RESIDUAL")


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: int,
         ls: torch.Tensor | None = None, res: torch.Tensor | None = None) -> torch.Tensor:
    """``[..., K] @ [N, K]ᵀ -> [..., N]`` with the epilogue ``epilogue``.
    Raises on shapes the kernel does not take (``K % 64``, ``N % 8``,
    ``EPI_GELU_SAVE``) before it dispatches, on any device."""
    _check(a, w, bias, epilogue, ls, res)
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, epilogue, ls, res)
    check_cuda(torch.bfloat16, a=a, w=w, bias=bias, ls=ls, res=res)
    K, N = a.shape[-1], w.shape[0]
    M = a.numel() // K
    out = torch.empty(*a.shape[:-1], N, dtype=a.dtype, device=a.device)
    KERNEL(ptr(a), ptr(w), ptr(out), M, N, K, epilogue, ptr(bias), ptr(ls), ptr(res), stream())
    return out
