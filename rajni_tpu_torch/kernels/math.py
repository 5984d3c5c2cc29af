"""Scalar math shared by the kernels and their plain versions (PyTorch
counterpart of the GELU part of ``rajni_tpu/kernels/math.py``).

The kernels use :func:`gelu_fast`; ``csrc/common.cuh`` carries the same
coefficients and clamp.
"""

from __future__ import annotations

import torch


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
