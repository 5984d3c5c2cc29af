"""Scalar math shared by the kernels and their plain versions (PyTorch
counterpart of ``rajni_tpu/kernels/math.py``): the GELU forms, and the int8
activation quantizers with their static-scale folds.

The kernels use :func:`gelu_fast`; ``csrc/common.cuh`` and
``csrc/gemm_sm90.cuh`` carry the same coefficients and clamp.
``csrc/int8.cuh`` quantizes as :func:`quantize_rows` and
:func:`quantize_static` do: ``rint`` (round half to even, as ``jnp.round``),
then a clip to ±127.
"""

from __future__ import annotations

import torch


def quantize_rows(y32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: ``(int8 [..., W], scale f32
    [..., 1])`` with ``y ≈ int8 * scale``.

    Quantizes as ``y * (127 / absmax)`` (absmax floored at 1e-8), a per-row
    multiplier as the TPU kernels take it, not ``y / scale``: the two differ
    by one on exact ties. The multiplier is one division, as in
    ``rajni_tpu/kernels/math.py`` and ``csrc/int8.cuh``: PyTorch takes
    ``127.0 / tensor`` as ``127 · (1 / tensor)``, two roundings, so the
    dividend is a tensor here. Rounds half to even.
    """
    absmax = torch.clamp_min(y32.abs().amax(dim=-1, keepdim=True), 1e-8)
    mul = torch.full_like(absmax, 127.0) / absmax
    q = torch.clamp(torch.round(y32 * mul), -127, 127).to(torch.int8)
    return q, absmax * (1.0 / 127.0)


def quantize_static(y32: torch.Tensor, inv: float | None = None) -> torch.Tensor:
    """int8 quantization with a calibrated static scale ``a = 1 / inv``.
    ``inv=None``: the ``1/a`` multiply was folded upstream, so only the
    round (half to even) and the clip remain."""
    if inv is not None:
        y32 = y32 * inv
    return torch.clamp(torch.round(y32), -127, 127).to(torch.int8)


def fold_static_attn(lns, lnb, sqkv, sproj, bqkv, aq: float, ap: float):
    """Fold the static attention scales into vector operands: ``1/a_qkv``
    into the LN affine, ``a_qkv`` into the qkv weight scales, ``1/a_proj``
    into the V columns of BOTH the qkv weight scales and the qkv bias (the
    bias is added after the dequant, so it must carry the fold too; the
    attention is linear in V and arrives pre-scaled for the proj quantize),
    and ``a_proj`` into the proj weight scales. Rows are ``[out_w]``; the V
    third is the last ``out_w // 3``. Returns ``(lns, lnb, sqkv, sproj,
    bqkv)`` in fp32, computed as ``rajni_tpu/kernels/math.py`` does.
    """
    aq, ap = float(aq), float(ap)
    v0 = 2 * (sqkv.shape[-1] // 3)
    lns = lns.float() * (1.0 / aq)
    lnb = lnb.float() * (1.0 / aq)
    sqkv = sqkv.float() * aq
    sqkv[..., v0:] *= 1.0 / ap
    bqkv = bqkv.float().clone()
    bqkv[..., v0:] *= 1.0 / ap
    if sproj is not None:
        sproj = sproj.float() * ap
    return lns, lnb, sqkv, sproj, bqkv


def fold_static_mlp(lns, lnb, s1, s2, hidden: int, a1: float, a2: float):
    """MLP counterpart of :func:`fold_static_attn`: ``1/a_fc1`` into the LN
    affine, the dequant factors into ``s1``/``s2``, and ``1/a_fc2`` as a
    ``[hidden]`` row that multiplies the GELU output before its quantize.
    Returns ``(lns, lnb, s1, s2, sinv)``."""
    a1, a2 = float(a1), float(a2)
    lns = lns.float() * (1.0 / a1)
    lnb = lnb.float() * (1.0 / a1)
    sinv = torch.full((hidden,), 1.0 / a2, dtype=torch.float32, device=s1.device)
    return lns, lnb, s1.float() * a1, s2.float() * a2, sinv


def erf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 erf (max abs error 1.5e-7)."""
    a1, a2, a3, a4, a5 = (
        0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    )
    p = 0.3275911
    sign = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return sign * (1.0 - poly * torch.exp(-ax * ax))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Erf-form GELU ``0.5 x (1 + erf(x / sqrt 2))`` via :func:`erf`."""
    return 0.5 * x * (1.0 + erf(x * (2.0**-0.5)))


# Odd degree-9 minimax fit of the normal-CDF logit over |x| <= 6; max
# |x·sigmoid(P(x)) - gelu(x)| = 6.2e-6.
_GELU_P = (
    1.595741357441813,
    0.07277895825923464,
    -1.7197148127561505e-4,
    -7.415772250437636e-5,
    2.8973745195906267e-6,
)


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """GELU as ``x * sigmoid(P(clamp(x, -6, 6)))``."""
    t = torch.clamp(x, -6.0, 6.0)
    t2 = t * t
    p = _GELU_P
    logit = t * (p[0] + t2 * (p[1] + t2 * (p[2] + t2 * (p[3] + t2 * p[4]))))
    return x * torch.sigmoid(logit)
