"""The MLP half of a block: K3 ``fused_ln_mlp_residual``, ``x + ls *
fc2(gelu_fast(fc1(LN(x))))``, and B9 ``fused_ln_mlp_residual_int8``, the same
with int8 weights and int8 activations.

Ports of the functions of the same names in ``rajni_tpu/kernels/mlp.py``. On
a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/mlp.cu``, ``csrc/ln_mlp_int8.cu``); on a CPU tensor it runs the plain
PyTorch version beside it.

Numeric contract of K3 (shared with the TPU kernel): LayerNorm statistics in
fp32 (biased variance), the normed rows rounded to the activation dtype; fc1
in fp32 from the rounded operands, ``gelu_fast(fc1 + b1)`` in fp32 then
rounded; fc2 in fp32, ``(acc + b2) * ls`` then ``x32 +`` that, stored in the
activation dtype. ``add_residual=False`` returns the branch alone.

B9 (``mlp.py:225-327``): the LN output and the GELU output stay fp32 until
they are quantized, per row (dynamic) or with the calibrated static scales
folded into the operands (:func:`..math.fold_static_mlp`). Where the weights
stream in hidden chunks of ``hc`` (:func:`_hidden_chunk`), dynamic mode
quantizes each chunk of h with its own row scale, so hc is numerics. The
int8 products are exact: the plain version takes them in float64.
"""

from __future__ import annotations

import torch

from .build import F, I, P, CudaKernel, check_cuda, ptr, stream
from .math import fold_static_mlp, gelu_fast, quantize_rows, quantize_static

KERNEL = CudaKernel(
    "rajni_ln_mlp_residual",
    [P, P, P, P, P, P, P, P, I, P, P, P, I, I, I, F, P],
)
INT8_KERNEL = CudaKernel(
    "rajni_ln_mlp_residual_int8", [P] * 11 + [I, I] + [P] * 6 + [I] * 4 + [F, P],
)

# The JAX package's resident-weight budget and hidden-chunk rule
# (rajni_tpu/kernels/mlp.py:50-65), copied: a TPU fact that chooses no Hopper
# tile, kept because hc is the numerics of B9's dynamic mode and the port
# must chunk where JAX chunks.
_WEIGHT_BUDGET = 10 * 1024 * 1024


def _hidden_chunk(C: int, hidden: int, itemsize: int) -> int:
    """Largest hidden chunk whose streamed weight blocks fit the budget."""
    if 2 * C * hidden * itemsize <= _WEIGHT_BUDGET:
        return hidden
    hc = hidden
    while hc > 128 and 4 * C * hc * itemsize > _WEIGHT_BUDGET:
        hc //= 2
    while hidden % hc:
        hc //= 2
    return max(hc, 128)


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


# ---------------------------------------------------------------------------
# B9: int8 weights and activations
# ---------------------------------------------------------------------------


def _int8_mm(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``q @ wq.T`` of int8 operands, exact (float64), then rounded to fp32
    as the int32 accumulator's conversion rounds."""
    return (q.double() @ wq.double().t()).float()


def _int8_matmul(y32, wq, ws, static: bool):
    """``f32 [.., C] @ int8 weight -> f32``: quantize the rows (dynamic) or
    only round them (static: ``y32`` arrives pre-scaled), then ``acc · a ·
    w_scale`` (``block.py:_int8_matmul``)."""
    if static:
        return _int8_mm(quantize_static(y32), wq) * ws
    q, a = quantize_rows(y32)
    return _int8_mm(q, wq) * a * ws


def int8_mlp_operands(ln_params, mlp_params, act_scales=None) -> dict:
    """The fp32 vector operands of B9 (``ln2s, ln2b, s1, b1, s2, b2, sinv``),
    with :func:`..math.fold_static_mlp` applied when ``act_scales = (a_fc1,
    a_fc2)`` is given; ``sinv`` is None in dynamic mode."""
    fc1, fc2 = mlp_params["fc1"], mlp_params["fc2"]
    ops = {"ln2s": ln_params["scale"].float(), "ln2b": ln_params["bias"].float(),
           "s1": fc1["weight"]["scale"].float(), "b1": fc1["bias"].float(),
           "s2": fc2["weight"]["scale"].float(), "b2": fc2["bias"].float(), "sinv": None}
    if act_scales is not None:
        ops["ln2s"], ops["ln2b"], ops["s1"], ops["s2"], ops["sinv"] = fold_static_mlp(
            ops["ln2s"], ops["ln2b"], ops["s1"], ops["s2"], fc1["weight"]["int8"].shape[0],
            *act_scales)
    return {k: (v if v is None else v.contiguous()) for k, v in ops.items()}


def _ln_mlp_int8(x, mlp_params, ops, ls, hc: int, eps: float, add_residual: bool = True):
    """The int8 MLP on rows ``x`` with its vector operands ``ops``: LN2
    quantized (fp32 LN, never rounded), fc1 with GELU in fp32, each hc chunk
    of h quantized with its own row scale (static: ``· sinv``, rounded), fc2
    partial sums dequantized per chunk and added in fp32, then ``x + (acc ·
    s2 + b2) · ls`` (``mlp.py:225-327``; B14/B15 run it on ``x_mid``,
    ``block.py:1677-1710``)."""
    static = ops["sinv"] is not None
    w1q, w2q = mlp_params["fc1"]["weight"]["int8"], mlp_params["fc2"]["weight"]["int8"]
    x32 = x.float()
    y2 = _layer_norm_f32(x32, ops["ln2s"], ops["ln2b"], eps)
    if static:
        y2q, a1 = quantize_static(y2), None
    else:
        y2q, a1 = quantize_rows(y2)
    acc = None
    for j in range(0, w1q.shape[0], hc):
        h = _int8_mm(y2q, w1q[j:j + hc])
        if not static:
            h = h * a1
        h = gelu_fast(h * ops["s1"][j:j + hc] + ops["b1"][j:j + hc])
        if static:
            hq, a2 = quantize_static(h * ops["sinv"][j:j + hc]), None
        else:
            hq, a2 = quantize_rows(h)
        part = _int8_mm(hq, w2q[:, j:j + hc])
        if not static:
            part = part * a2
        acc = part if acc is None else acc + part
    out = acc * ops["s2"] + ops["b2"]
    if ls is not None:
        out = out * ls.float()
    if add_residual:
        out = x32 + out
    return out.to(x.dtype)


def ln_mlp_residual_int8_plain(x, ln_params, mlp_params, ls=None, eps: float = 1e-6,
                               add_residual: bool = True, act_scales=None):
    """Plain PyTorch version of B9; ``hc`` from :func:`_hidden_chunk`."""
    w1q = mlp_params["fc1"]["weight"]["int8"]
    hc = _hidden_chunk(x.shape[-1], w1q.shape[0], 1)
    ops = int8_mlp_operands(ln_params, mlp_params, act_scales)
    return _ln_mlp_int8(x, mlp_params, ops, ls, hc, eps, add_residual)


def fused_ln_mlp_residual_int8(x, ln_params, mlp_params, ls=None, eps: float = 1e-6,
                               add_residual: bool = True, act_scales=None):
    """``[B, N, C] -> [B, N, C]`` with int8 records ``fc1 {"int8": [hidden,
    C], "scale": [hidden]}``, ``fc2 {"int8": [C, hidden], ...}``.
    ``act_scales = (a_fc1, a_fc2)`` selects calibrated static quantization."""
    if x.device.type == "cpu":
        return ln_mlp_residual_int8_plain(x, ln_params, mlp_params, ls, eps, add_residual,
                                          act_scales)
    B, N, C = x.shape
    w1q, w2q = mlp_params["fc1"]["weight"]["int8"], mlp_params["fc2"]["weight"]["int8"]
    hidden = w1q.shape[0]
    hc = _hidden_chunk(C, hidden, 1)
    ops = int8_mlp_operands(ln_params, mlp_params, act_scales)
    check_cuda(torch.bfloat16, x=x, ls=ls)
    check_cuda(torch.int8, w1=w1q, w2=w2q)
    check_cuda(torch.float32, **{k: v for k, v in ops.items() if v is not None})
    if C % 128 or C > 1024 or hidden % 128 or hc % 128 or hidden % hc:
        raise ValueError(
            "fused_ln_mlp_residual_int8 needs C and hidden multiples of 128, C <= 1024 and "
            f"hc % 128 == 0 dividing hidden; got C={C}, hidden={hidden}, hc={hc}"
        )
    if w1q.shape != (hidden, C) or w2q.shape != (C, hidden):
        raise ValueError(f"bad int8 MLP weight shapes {tuple(w1q.shape)}, {tuple(w2q.shape)}")
    rows, dev = B * N, x.device
    q8 = torch.empty(rows * C, dtype=torch.int8, device=dev)
    qs = torch.empty(rows, dtype=torch.float32, device=dev)
    h = torch.empty(rows * hidden, dtype=torch.float32, device=dev)
    hq = torch.empty(rows * hidden, dtype=torch.int8, device=dev)
    hs = torch.empty(rows * (hidden // hc), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    INT8_KERNEL(
        ptr(x), ptr(ops["ln2s"]), ptr(ops["ln2b"]), ptr(w1q), ptr(ops["s1"]), ptr(ops["b1"]),
        ptr(w2q), ptr(ops["s2"]), ptr(ops["b2"]), ptr(ls), ptr(ops["sinv"]),
        int(act_scales is not None), int(add_residual), ptr(q8), ptr(qs), ptr(h), ptr(hq),
        ptr(hs), ptr(out), rows, C, hidden, hc, float(eps), stream(),
    )
    return out
