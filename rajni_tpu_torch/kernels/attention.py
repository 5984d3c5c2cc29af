"""B6 ``fused_sdpa``: multi-head self-attention on packed QKV.

Port of ``rajni_tpu/kernels/attention.py:fused_sdpa``. On a CUDA tensor the
wrapper launches the hand-written Hopper kernel (``csrc/sdpa.cu``: wgmma,
TMA or cp.async tiles on mbarriers, one pass with the softmax row in
registers up to 640 tokens, two passes past that; at head_dim 80, ViT-H/14's,
one pass up to 384 tokens); on a CPU tensor it runs :func:`fused_sdpa_plain`,
the same function in plain PyTorch.

Numeric contract (the "per-head" form of the TPU kernel, ``attention.py:
53-67``): ``logits = (q·kᵀ) * scale`` in fp32 from the unscaled operands,
softmax in fp32 as ``exp(l - max) * (1 / sum)``, P rounded to the activation
dtype before P·V, P·V accumulated in fp32, output rounded.

The same kernel body (``rajni_sdpa_body``) is the attention inside K2
``fused_attn_block``, B5 ``fused_gather_sdpa_proj_residual``, K1/B20 and the
int8 tails past 256 tokens (``csrc/common.cuh``, ``csrc/int8.cuh``); up to 256
tokens they run the short-row kernel (``csrc/short_attn.cu``,
:func:`short_attention`). The library counts each kernel's launches where
they happen, whichever entry point makes them, and ``SDPA_KERNEL.launches``
and ``SHORT_KERNEL.launches`` read those counts.
"""

from __future__ import annotations

import math

import torch

from .build import F, I, P, CudaKernel, check_cuda, ptr, stream

HEAD_DIM = 64  # csrc/common.cuh: ATTN_D, the training and whole-block kernels' head_dim
# csrc/common.cuh: ATTN_D and ATTN_D80, the head_dims the bf16 attention
# kernels (the short-row kernel and B6's body) take
HEAD_DIMS = (64, 80)
# csrc/common.cuh: SDPA_MAX_N, the longest sequence a path sends to the
# kernels (the config demotes past it, models/vit.py:cuda_kernels_take);
# SDPA_MAX_N_D80 at head_dim 80, where B6's body runs one pass only
SDPA_MAX_N = 848
SDPA_MAX_N_D80 = 384


def sdpa_max_n(head_dim: int) -> int:
    """The longest sequence B6's body takes at ``head_dim`` (0: none)."""
    return {64: SDPA_MAX_N, 80: SDPA_MAX_N_D80}.get(head_dim, 0)

# its launches are the body's, counted in csrc/sdpa.cu wherever an entry
# point launches it (K2, B5, K1/B20 and the int8 tails run it inside theirs)
SDPA_KERNEL = CudaKernel("rajni_sdpa", [P, P, P, P, I, I, I, I, I, I, F, I, P],
                         counter="rajni_sdpa_launches")
ATTN_MAX_N = 256  # csrc/common.cuh: the short-row kernel's longest row (4 key tiles)


def _packed(qkv: torch.Tensor) -> torch.Tensor:
    """``[B, N, 3, C]`` (the head-aligned tensor-parallel layout) has the
    same element order as ``[B, N, 3C]``; flatten it."""
    if qkv.ndim == 4:
        return qkv.reshape(qkv.shape[0], qkv.shape[1], -1)
    return qkv


def _sdpa_perhead(qkv: torch.Tensor, num_heads: int, scale: float, out_dtype) -> torch.Tensor:
    """Per-head SDPA on packed ``[B, N, 3C]`` (lanes ``(qkv, head, dim)``),
    the scale applied to the fp32 logits."""
    B, N, three_c = qkv.shape
    C = three_c // 3
    D = C // num_heads
    q5 = qkv.reshape(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)  # [3,B,H,N,D]
    q, k, v = q5[0], q5[1], q5[2]
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = (p * (1.0 / p.sum(dim=-1, keepdim=True))).to(qkv.dtype)
    out = p.float() @ v.float()  # [B, H, N, D]
    return out.permute(0, 2, 1, 3).reshape(B, N, C).to(out_dtype)


_PHASED_MAX_BYTES = 4 * 1024 * 1024  # rajni_tpu/kernels/block.py:136


def mha_phased(num_heads: int, n: int, scale: float) -> bool:
    """Whether the kernels take the TPU kernels' phased form on ``n`` tokens
    (``csrc/common.cuh:mha_phased``): ``H·n²·6 <= 4 MiB``, as JAX's ``_mha``,
    and a scale that is not a power of two (at a power of two both forms
    give the same bits, so the kernels keep the per-head one)."""
    return num_heads * n * n * 6 <= _PHASED_MAX_BYTES and math.frexp(scale)[0] != 0.5


def _sdpa_phased(qkv: torch.Tensor, num_heads: int, scale: float, out_dtype) -> torch.Tensor:
    """The phased form of the TPU kernels' ``_mha`` on packed ``[B, N, 3C]``:
    ``q * scale`` in fp32 rounded to ``qkv``'s dtype, then unscaled fp32
    logits; the rest as :func:`_sdpa_perhead`."""
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


def fused_sdpa_plain(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of B6: ``[B, N, 3C]`` or ``[B, N, 3, C]`` →
    ``[B, N, C]``."""
    qkv = _packed(qkv)
    if qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(f"C={qkv.shape[-1] // 3} not divisible by num_heads={num_heads}")
    return _sdpa_perhead(qkv, num_heads, scale, qkv.dtype)


def fused_sdpa(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Fused SDPA on packed QKV: ``[B, N, 3C]`` (or ``[B, N, 3, C]``) →
    ``[B, N, C]``."""
    if qkv.device.type == "cpu":
        return fused_sdpa_plain(qkv, num_heads, scale)
    qkv = _packed(qkv)
    check_cuda(torch.bfloat16, qkv=qkv)
    B, N, three_c = qkv.shape
    C = three_c // 3
    D = C // num_heads
    if three_c % 3 or C % num_heads or D not in HEAD_DIMS:
        raise ValueError(
            f"fused_sdpa needs head_dim 64 or 80; got C={C}, heads={num_heads}"
        )
    if not 1 <= N <= sdpa_max_n(D):
        raise ValueError(f"fused_sdpa supports 1 <= N <= {sdpa_max_n(D)} at head_dim {D}, "
                         f"got N={N}")
    out = torch.empty(B, N, C, dtype=qkv.dtype, device=qkv.device)
    SDPA_KERNEL(ptr(qkv), None, ptr(out), None, 0, B, N, N, C, num_heads, float(scale), 0,
                stream())
    return out


def attention_route_plain(qkv: torch.Tensor, idx: torch.Tensor | None, num_heads: int,
                          scale: float, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`attention_route` and
    :func:`short_attention`: the blocks' attention on the tokens ``idx [B,
    n]`` of ``qkv [B, n_src, 3C]`` (all of them when None), its output in
    ``out_dtype`` (``qkv``'s by default): ``_mha``'s phased form
    (:func:`_sdpa_phased`) where :func:`mha_phased` says the kernels take it,
    else B6's per-head form."""
    qkv = _packed(qkv)
    if idx is not None:
        qkv = torch.take_along_dim(qkv, idx.long()[..., None], dim=1)
    if qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(f"C={qkv.shape[-1] // 3} not divisible by num_heads={num_heads}")
    form = _sdpa_phased if mha_phased(num_heads, qkv.shape[1], scale) else _sdpa_perhead
    return form(qkv, num_heads, scale, out_dtype or qkv.dtype)


# the longest sequence each of attention_route's kernels takes (head_dim 64)
ROUTES = {"body": SDPA_MAX_N, "short": ATTN_MAX_N}


def _check_route_shapes(name: str, qkv: torch.Tensor, idx: torch.Tensor | None, num_heads: int,
                        max_n: int) -> tuple[int, int, int, int]:
    """``(B, n_src, n, C)`` of a packed qkv and its kept indices; raises on what
    the kernels do not take (head_dim 64 or 80, 1 <= n <= max_n, n_src <=
    SDPA_MAX_N, at head_dim 80 n and n_src <= SDPA_MAX_N_D80 too, idx int32
    ``[B, n]``)."""
    B, n_src, three_c = qkv.shape
    C = three_c // 3
    D = C // num_heads
    if three_c % 3 or C % num_heads or D not in HEAD_DIMS:
        raise ValueError(f"{name} needs head_dim 64 or 80; got C={C}, heads={num_heads}")
    max_n = min(max_n, sdpa_max_n(D))
    if idx is not None and (idx.ndim != 2 or idx.shape[0] != B or idx.dtype != torch.int32):
        raise ValueError(f"{name}: idx must be int32 [{B}, n], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    n = n_src if idx is None else idx.shape[1]
    if not 1 <= n <= max_n or n_src > sdpa_max_n(D):
        raise ValueError(f"{name}: n={n} of n_src={n_src} out of range (n <= {max_n})")
    return B, n_src, n, C


def attention_route(qkv: torch.Tensor, idx: torch.Tensor | None, num_heads: int, scale: float,
                    route: str) -> torch.Tensor:
    """The attention by the kernel named: ``"body"``, B6's wgmma body (its
    entry point ``csrc/sdpa.cu:rajni_sdpa``); ``"short"``, the short-row
    kernel (:func:`short_attention`, n <= 256); on contiguous tokens or
    through ``idx`` (int32 ``[B, n]``), into bf16, in the form the blocks
    take (:func:`mha_phased`). No path calls it;
    ``chip_smoke.py`` times the routes with it for the routing of
    ``csrc/common.cuh:launch_attention_any``. Raises on an unknown route and
    on shapes the kernel does not take before it dispatches."""
    if route not in ROUTES:
        raise ValueError(f"attention_route: unknown route {route!r} (one of {sorted(ROUTES)})")
    qkv = _packed(qkv)
    _check_route_shapes("attention_route", qkv, idx, num_heads, ROUTES[route])
    if qkv.device.type == "cpu":
        return attention_route_plain(qkv, idx, num_heads, scale)
    kernel = SHORT_KERNEL if route == "short" else SDPA_KERNEL
    return _launch_attention(kernel, qkv, idx, num_heads, scale, torch.bfloat16, False)[0]


# its launches are counted in csrc/short_attn.cu wherever an entry point
# launches it (K1, K2, B5, B7, B8, B10, B11, B13-B16 run it inside theirs)
SHORT_KERNEL = CudaKernel("rajni_short_attn", [P, P, P, P, I, I, I, I, I, I, F, I, P],
                          counter="rajni_short_attn_launches")


def short_attention_plain(qkv: torch.Tensor, idx: torch.Tensor | None, num_heads: int,
                          scale: float, out_dtype: torch.dtype = torch.bfloat16,
                          amax: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of :func:`short_attention`: the output, and with
    ``amax`` each output row's absmax over its C columns (fp32 ``[B·n]``)."""
    out = attention_route_plain(qkv, idx, num_heads, scale, out_dtype)
    return out, (out.float().abs().amax(dim=-1).reshape(-1) if amax else None)


def short_attention(qkv: torch.Tensor, idx: torch.Tensor | None, num_heads: int, scale: float,
                    out_dtype: torch.dtype = torch.bfloat16,
                    amax: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The short-row attention (``csrc/short_attn.cu``) on its own: the
    blocks' attention (in the form :func:`mha_phased` picks, as they launch
    it) on ``n <= 256`` tokens of ``qkv [B, n_src, 3C]`` (through ``idx``
    int32 ``[B, n]``, or all ``n_src``), into ``out_dtype`` (bf16 or fp32);
    with ``amax``, each output row's absmax too, as the int8 tails take it
    (head_dim 64 or 80). Raises on shapes the kernel does not take before it
    dispatches."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"short_attention: out_dtype must be bf16 or fp32, got {out_dtype}")
    qkv = _packed(qkv)
    _check_route_shapes("short_attention", qkv, idx, num_heads, ATTN_MAX_N)
    if qkv.device.type == "cpu":
        return short_attention_plain(qkv, idx, num_heads, scale, out_dtype, amax)
    return _launch_attention(SHORT_KERNEL, qkv, idx, num_heads, scale, out_dtype, amax)


def body_attention(qkv: torch.Tensor, idx: torch.Tensor | None, num_heads: int, scale: float,
                   out_dtype: torch.dtype = torch.bfloat16,
                   amax: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """B6's body (``csrc/sdpa.cu``) on its own, as the blocks launch it past
    256 tokens: :func:`short_attention`'s function and arguments (its plain
    version :func:`short_attention_plain`) on ``n <= SDPA_MAX_N`` tokens (at
    head_dim 80 ``n <= SDPA_MAX_N_D80``, and with an fp32 output or the row
    absmax, the int8 tails', ``n > 256`` only). Raises on shapes the kernel
    does not take before it dispatches."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"body_attention: out_dtype must be bf16 or fp32, got {out_dtype}")
    qkv = _packed(qkv)
    _, _, n, C = _check_route_shapes("body_attention", qkv, idx, num_heads, SDPA_MAX_N)
    if (C // num_heads != HEAD_DIM and (amax or out_dtype == torch.float32)
            and n <= ATTN_MAX_N):
        raise ValueError(f"body_attention: at head_dim {C // num_heads} an fp32 output or the row "
                         f"absmax needs n > {ATTN_MAX_N}, got n={n}")
    if qkv.device.type == "cpu":
        return short_attention_plain(qkv, idx, num_heads, scale, out_dtype, amax)
    return _launch_attention(SDPA_KERNEL, qkv, idx, num_heads, scale, out_dtype, amax)


def _launch_attention(kernel: CudaKernel, qkv, idx, num_heads: int, scale: float, out_dtype,
                      amax: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One launch of the short-row kernel or B6's body (their entry points
    take the same arguments) in the form :func:`mha_phased` picks."""
    check_cuda(torch.bfloat16, qkv=qkv)
    check_cuda(torch.int32, idx=idx)
    B, n_src, three_c = qkv.shape
    C = three_c // 3
    n = n_src if idx is None else idx.shape[1]
    out = torch.empty(B, n, C, dtype=out_dtype, device=qkv.device)
    am = torch.zeros(B * n, dtype=torch.float32, device=qkv.device) if amax else None
    kernel(ptr(qkv), ptr(idx), ptr(out), ptr(am), int(out_dtype == torch.float32), B, n_src, n,
           C, num_heads, float(scale), int(mha_phased(num_heads, n, scale)), stream())
    return out, am
