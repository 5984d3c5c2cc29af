"""K3 ``fused_ln_mlp_residual``: ``x + ls * fc2(gelu_fast(fc1(LN(x))))``.

Port of ``rajni_tpu/kernels/mlp.py:fused_ln_mlp_residual``. On a CUDA tensor
it launches the hand-written kernel in ``csrc/mlp.cu``; on a CPU tensor it
runs :func:`ln_mlp_residual_plain`, the same function in plain PyTorch.

Numeric contract (shared with the TPU kernel): LayerNorm statistics in fp32
(biased variance), the normed rows rounded to the activation dtype; fc1 in
fp32 from the rounded operands, ``gelu_fast(fc1 + b1)`` in fp32 then rounded;
fc2 in fp32, ``(acc + b2) * ls`` then ``x32 +`` that, stored in the
activation dtype. ``add_residual=False`` returns the branch alone.
"""

from __future__ import annotations

import torch

from .build import F, I, P, CudaKernel, check_cuda, ptr, stream
from .math import gelu_fast

KERNEL = CudaKernel(
    "rajni_ln_mlp_residual",
    [P, P, P, P, P, P, P, P, I, P, P, P, I, I, I, F, P],
)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` in fp32 from the (rounded) operands."""
    return a.float() @ w.float().t()


def _layer_norm_f32(x32, scale, bias, eps: float) -> torch.Tensor:
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y * scale.float() + bias.float()


def ln_mlp_residual_plain(
    x: torch.Tensor, ln_params, mlp_params, ls=None, eps: float = 1e-6,
    add_residual: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of K3 (same rounding points as the kernel)."""
    x32 = x.float()
    y = _layer_norm_f32(x32, ln_params["scale"], ln_params["bias"], eps)
    h = _mm(y.to(x.dtype), mlp_params["fc1"]["weight"])
    h = gelu_fast(h + mlp_params["fc1"]["bias"].float()).to(x.dtype)
    out = _mm(h, mlp_params["fc2"]["weight"]) + mlp_params["fc2"]["bias"].float()
    if ls is not None:
        out = out * ls.float()
    if add_residual:
        out = x32 + out
    return out.to(x.dtype)


def fused_ln_mlp_residual(
    x: torch.Tensor, ln_params, mlp_params, ls=None, eps: float = 1e-6,
    add_residual: bool = True,
) -> torch.Tensor:
    """``[B, N, C] -> [B, N, C]``; weights ``fc1 [4C, C]``, ``fc2 [C, 4C]``."""
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x, ln_params, mlp_params, ls, eps, add_residual)
    B, N, C = x.shape
    w1, b1 = mlp_params["fc1"]["weight"], mlp_params["fc1"]["bias"]
    w2, b2 = mlp_params["fc2"]["weight"], mlp_params["fc2"]["bias"]
    hidden = w1.shape[0]
    check_cuda(
        torch.bfloat16, x=x, ln_scale=ln_params["scale"], ln_bias=ln_params["bias"],
        w1=w1, b1=b1, w2=w2, b2=b2, ls=ls,
    )
    if C % 128 or hidden % 128 or C > 1024:
        raise ValueError(
            f"fused_ln_mlp_residual needs C and hidden multiples of 128 and "
            f"C <= 1024, got C={C}, hidden={hidden}"
        )
    if w1.shape != (hidden, C) or w2.shape != (C, hidden):
        raise ValueError(f"bad MLP weight shapes {w1.shape}, {w2.shape}")
    rows = B * N
    y = torch.empty(rows, C, dtype=x.dtype, device=x.device)
    h = torch.empty(rows, hidden, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    KERNEL(
        ptr(x), ptr(ln_params["scale"]), ptr(ln_params["bias"]), ptr(w1), ptr(b1),
        ptr(w2), ptr(b2), ptr(ls), int(add_residual), ptr(y), ptr(h), ptr(out),
        rows, C, hidden, float(eps), stream(),
    )
    return out
