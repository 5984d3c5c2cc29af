"""The training kernels: B16 ``train_attn_block``, B17 ``train_ln_mlp`` and
B18 ``train_sdpa_bwd``.

Ports of the functions of the same names in ``rajni_tpu/kernels/train.py``.
The forward kernels run the inference kernels' math and also emit the
backward's residuals: B16 the post-bias packed ``qkv`` ``[B, N, 3C]``, B17
the pre-GELU hidden ``h`` ``[B, N, hidden]``, both in the activation dtype.
B18 recomputes the SDPA from the saved qkv and differentiates it. On a CUDA
tensor each wrapper launches its hand-written kernel: B16 K2's entry point
(``csrc/attn_block.cu``, which leaves the rounded qkv in device memory) under
a counter of its own, B17 ``csrc/train_mlp.cu``, B18 ``csrc/sdpa_bwd.cu``; on
a CPU tensor it runs the plain PyTorch version beside it.

Numeric contract (the TPU kernels'):
  * B16: K2's (:func:`.block.attn_block_plain`), qkv rounded before the SDPA
    and returned as the SDPA saw it;
  * B17: ``h = round(fc1(LN2 x) + b1)`` stored, then ``gelu_fast`` of that
    ROUNDED h (``train.py:189-191``; K3 takes the GELU of the fp32 sum), the
    GELU output rounded into fc2, ``y = x32 + (fc2 + b2)·ls2``;
  * B18, per head: ``s = (q·kᵀ)·scale`` in fp32, ``p32 = e·(1/Σe)``,
    ``pb = round(p32)``, ``attn_out = pb·v``, ``dv = pbᵀ·dO``, ``dp = dO·vᵀ``,
    ``ds = p32∘(dp − rowsum(dp∘p32))``, ``dsb = round(ds·scale)``, ``dq = dsb·k``,
    ``dk = dsbᵀ·q``, each product accumulated in fp32 and rounded once.

The JAX fit rules (``_train_attn_fits``, ``train_mlp_fits``,
``train_sdpa_bwd_fits``) are VMEM facts and have no counterpart: the Hopper
kernels stream their weights and tile their tokens. They take the bf16
inference kernels' widths, ViT-H/14's included: B16 K2's (head_dim 64 or 80,
C <= 1280), B17 C <= 1280, B18 head_dim 64 up to ``SDPA_MAX_N`` tokens and
80 up to ``SDPA_MAX_N_D80`` (the route gate's ``sdpa_max_n``).
"""

from __future__ import annotations

import torch

from .attention import HEAD_DIMS, sdpa_max_n
from .block import ATTN_KERNEL, C_MAX_BF16, attn_block_qkv_plain, launch_attn_block
from .build import F, I, P, CudaKernel, check_cuda, ptr, stream
from .math import gelu_fast
from .mlp import _layer_norm_f32, _mm

TRAIN_ATTN_KERNEL = CudaKernel("rajni_attn_block", ATTN_KERNEL.argtypes)
TRAIN_MLP_KERNEL = CudaKernel(
    "rajni_train_ln_mlp", [P, P, P, P, P, P, P, P, I, P, P, P, P, I, I, I, F, P],
)
SDPA_BWD_KERNEL = CudaKernel("rajni_train_sdpa_bwd", [P, P, P, P, P, I, I, I, I, F, P])


# ---------------------------------------------------------------------------
# B16: stock attention half returning qkv
# ---------------------------------------------------------------------------


def train_attn_block(x: torch.Tensor, ln_params, attn_params, ls, num_heads: int,
                     scale: float, eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x1, qkv)``: ``x1 = x + ls1·proj(mhsa(qkv(norm1(x))))`` on ``[B, N,
    C]`` and the packed post-bias qkv ``[B, N, 3C]`` the SDPA read."""
    if x.device.type == "cpu":
        return attn_block_qkv_plain(x, ln_params, attn_params, ls, num_heads, scale, eps)
    return launch_attn_block(TRAIN_ATTN_KERNEL, "train_attn_block", x, ln_params, attn_params,
                             ls, num_heads, scale, eps)


# ---------------------------------------------------------------------------
# B17: MLP half returning the pre-GELU hidden
# ---------------------------------------------------------------------------


def train_ln_mlp_plain(x: torch.Tensor, ln_params, mlp_params, ls=None, eps: float = 1e-6,
                       add_residual: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B17: ``(y, h)``."""
    x32 = x.float()
    y = _layer_norm_f32(x32, ln_params["scale"], ln_params["bias"], eps).to(x.dtype)
    h = (_mm(y, mlp_params["fc1"]["weight"]) + mlp_params["fc1"]["bias"].float()).to(x.dtype)
    hg = gelu_fast(h.float()).to(x.dtype)
    out = _mm(hg, mlp_params["fc2"]["weight"]) + mlp_params["fc2"]["bias"].float()
    if ls is not None:
        out = out * ls.float()
    if add_residual:
        out = x32 + out
    return out.to(x.dtype), h


def train_ln_mlp(x: torch.Tensor, ln_params, mlp_params, ls=None, eps: float = 1e-6,
                 add_residual: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, h)``: ``y = x + ls2·fc2(gelu_fast(h))`` (the branch alone with
    ``add_residual=False``) and the pre-GELU ``h [B, N, hidden]`` it was
    computed from; weights ``fc1 [hidden, C]``, ``fc2 [C, hidden]``."""
    if x.device.type == "cpu":
        return train_ln_mlp_plain(x, ln_params, mlp_params, ls, eps, add_residual)
    B, N, C = x.shape
    w1, b1 = mlp_params["fc1"]["weight"], mlp_params["fc1"]["bias"]
    w2, b2 = mlp_params["fc2"]["weight"], mlp_params["fc2"]["bias"]
    hidden = w1.shape[0]
    check_cuda(torch.bfloat16, x=x, ln_scale=ln_params["scale"], ln_bias=ln_params["bias"],
               w1=w1, b1=b1, w2=w2, b2=b2, ls=ls)
    if C % 128 or hidden % 128 or C > C_MAX_BF16:
        raise ValueError(f"train_ln_mlp needs C and hidden multiples of 128 and C <= "
                         f"{C_MAX_BF16}, got C={C}, hidden={hidden}")
    if w1.shape != (hidden, C) or w2.shape != (C, hidden):
        raise ValueError(f"bad MLP weight shapes {tuple(w1.shape)}, {tuple(w2.shape)}")
    rows, dev = B * N, x.device
    y = torch.empty(rows, C, dtype=x.dtype, device=dev)
    h = torch.empty(B, N, hidden, dtype=x.dtype, device=dev)
    hg = torch.empty(rows, hidden, dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    TRAIN_MLP_KERNEL(
        ptr(x), ptr(ln_params["scale"]), ptr(ln_params["bias"]), ptr(w1), ptr(b1), ptr(w2),
        ptr(b2), ptr(ls), int(add_residual), ptr(y), ptr(h), ptr(hg), ptr(out), rows, C, hidden,
        float(eps), stream(),
    )
    return out, h


# ---------------------------------------------------------------------------
# B18: SDPA forward recompute + backward
# ---------------------------------------------------------------------------


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[B, K, H·D] -> [B, H, K, D]``."""
    B, K, C = t.shape
    return t.reshape(B, K, num_heads, C // num_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """``[B, H, K, D] -> [B, K, H·D]``."""
    B, H, K, D = t.shape
    return t.transpose(1, 2).reshape(B, K, H * D)


def train_sdpa_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                         scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B18: ``(attn_out [B, K, C], d_qkv [B, K,
    3C])``, the per-head math of ``_sdpa_bwd_kernel`` (train.py:222-280)
    with the heads as a batch dimension."""
    C = qkv.shape[-1] // 3
    q, k, v = (_heads(qkv[..., i * C:(i + 1) * C], num_heads) for i in range(3))
    do = _heads(dout, num_heads)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p32 = e * (1.0 / e.sum(dim=-1, keepdim=True))
    pb = p32.to(qkv.dtype)
    out = pb.float() @ v.float()
    dv = pb.float().transpose(-1, -2) @ do.float()
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))
    dsb = (ds * scale).to(qkv.dtype).float()
    dq = dsb @ k.float()
    dk = dsb.transpose(-1, -2) @ q.float()
    d_qkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)
    return _merge(out).to(qkv.dtype), d_qkv.to(qkv.dtype)


def train_sdpa_bwd(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                   scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(qkv [B, K, 3C], d_out [B, K, C]) -> (attn_out [B, K, C], d_qkv [B,
    K, 3C])``: ``d_out`` is the cotangent at the SDPA output, ``attn_out``
    the recomputed forward output (the proj weight-gradient reads it). On the
    card: head_dim 64 with ``K <= SDPA_MAX_N``, or 80 with ``K <=
    SDPA_MAX_N_D80``, in the per-head form at both (the scale on the fp32
    logits; not the forward kernels' phased form)."""
    if qkv.device.type == "cpu":
        return train_sdpa_bwd_plain(qkv, dout, num_heads, scale)
    B, K, three_c = qkv.shape
    C = three_c // 3
    check_cuda(torch.bfloat16, qkv=qkv, dout=dout)
    if three_c % 3 or C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"train_sdpa_bwd needs head_dim 64 or 80; got C={C}, heads={num_heads}")
    if dout.shape != (B, K, C):
        raise ValueError(f"d_out must be [{B}, {K}, {C}], got {tuple(dout.shape)}")
    max_k = sdpa_max_n(C // num_heads)
    if not 1 <= K <= max_k:
        raise ValueError(f"train_sdpa_bwd supports 1 <= K <= {max_k} at head_dim "
                         f"{C // num_heads}, got K={K}")
    dev = qkv.device
    out = torch.empty(B, K, C, dtype=qkv.dtype, device=dev)
    d_qkv = torch.empty_like(qkv)
    stats = torch.empty(3, B, num_heads, K, dtype=torch.float32, device=dev)
    SDPA_BWD_KERNEL(ptr(qkv), ptr(dout), ptr(out), ptr(d_qkv), ptr(stats), B, K, C, num_heads,
                    float(scale), stream())
    return out, d_qkv
