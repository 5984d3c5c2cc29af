"""Preprocessing on the device (port of ``rajni_tpu/data/device.py``): uint8
host-to-device copies, then the normalize, or the resize, crop and normalize,
as batched torch operations on the tensor's device.

  * :func:`normalize_images`: the host keeps the geometry (decode, resize,
    crop: :func:`.pipeline.preprocess_u8`) and ships the uint8 crop, four
    times fewer bytes than float32; scaling to [0, 1] and the ImageNet
    normalize run on the device, bit for bit the host pipeline's
    ``(x / 255 - mean) / std``.
  * :func:`preprocess_on_device`: each image arrives decoded on a fixed
    uint8 canvas with its true ``(h, w)``; PIL's antialiased bicubic resample
    becomes two weight matrices a image, built from those sizes, and resize
    plus crop are the products ``Wv · img · Whᵀ`` (``torch.einsum`` in fp32),
    with PIL's uint8 rounding between the passes: within ±1/255 a pass of
    the host pipeline.

Both divide by tensors on the device: on CUDA, PyTorch evaluates ``tensor /
python_float`` as a multiply by the float's reciprocal, which is not the
host's division. The fp32 products need true fp32 (no TF32), which is
PyTorch's default (``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import IMAGENET_MEAN, IMAGENET_STD


def _const(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def normalize_images(images_u8: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``uint8 [B, H, W, 3]`` → ``dtype``: scale to [0, 1] and normalize,
    in the host pipeline's fp32 operations."""
    d = images_u8.device
    x = images_u8.to(torch.float32) / _const(255.0, d)
    x = (x - _const(IMAGENET_MEAN, d)) / _const(IMAGENET_STD, d)
    return x.to(dtype)


def _bicubic(x: torch.Tensor) -> torch.Tensor:
    """PIL's bicubic kernel (a = -0.5)."""
    a = -0.5
    x = x.abs()
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))


def _resample_rows(in_size: torch.Tensor, out_size: torch.Tensor, offset: torch.Tensor,
                   crop: int, canvas: int) -> torch.Tensor:
    """``[B, crop, canvas]`` PIL antialiased-bicubic weights: row ``i`` of
    image ``b`` makes output pixel ``offset[b] + i`` of an ``in_size[b] →
    out_size[b]`` resize, over a source axis padded to ``canvas``. PIL's
    ``precompute_coeffs``: ``center = (i + 0.5) · scale``, the bounds
    truncated as C++ ``int()`` does and clamped to the image, the kernel at
    ``(x + 0.5 - center) / filterscale``, rows normalized to sum 1."""
    dev = in_size.device
    in_f = in_size.to(torch.float32)[:, None, None]
    scale = in_f / out_size.to(torch.float32)[:, None, None]
    filterscale = torch.maximum(scale, torch.ones_like(scale))
    support = 2.0 * filterscale
    out_idx = (torch.arange(crop, dtype=torch.float32, device=dev)[None, :, None]
               + offset.to(torch.float32)[:, None, None])
    src_idx = torch.arange(canvas, dtype=torch.float32, device=dev)[None, None, :]
    center = (out_idx + 0.5) * scale
    lo = torch.clamp(torch.trunc(center - support + 0.5), min=0.0)
    hi = torch.minimum(torch.trunc(center + support + 0.5), in_f)
    w = _bicubic((src_idx + 0.5 - center) / filterscale)
    w = torch.where((src_idx >= lo) & (src_idx < hi), w, torch.zeros_like(w))
    total = w.sum(dim=2, keepdim=True)
    return w / torch.where(total == 0.0, torch.ones_like(total), total)


def _round8(x: torch.Tensor) -> torch.Tensor:
    """PIL's 8-bit rounding between passes: ``floor(x + 0.5)`` clamped to
    [0, 255] (``preprocess.cpp``'s ``clamp8``)."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def preprocess_on_device(
    canvas_u8: torch.Tensor,
    sizes: torch.Tensor,
    crop: int = 224,
    resize: int = 256,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """The eval preprocessing on the tensor's device: ``uint8 [B, S, S, 3]``
    canvases (each image top-left, padding ignored) and their ``[B, 2]``
    int32 ``(h, w)`` sizes (each at most ``S``) → ``[B, crop, crop, 3]``
    normalized ``dtype``. The host pipeline's semantics: torchvision's
    truncated long side, round-half-even crop offsets, PIL's two bicubic
    passes with uint8 rounding between them."""
    S = canvas_u8.shape[1]
    dev = canvas_u8.device
    h, w = sizes[:, 0].to(torch.int64), sizes[:, 1].to(torch.int64)
    tall = w <= h
    r = torch.full_like(h, resize)
    nw = torch.where(tall, r, torch.clamp((w * resize) // h, min=1))
    nh = torch.where(tall, torch.clamp((h * resize) // w, min=1), r)
    # round-half-even offsets, as Python's round()
    left = torch.round((nw - crop).to(torch.float32) / 2.0).to(torch.int64)
    top = torch.round((nh - crop).to(torch.float32) / 2.0).to(torch.int64)

    wh = _resample_rows(w, nw, left, crop, S)  # [B, crop, S] columns
    wv = _resample_rows(h, nh, top, crop, S)   # [B, crop, S] rows
    x = canvas_u8.to(torch.float32)            # [B, S, S, 3]
    tmp = _round8(torch.einsum("bhwc,bow->bhoc", x, wh))    # [B, S, crop, 3]
    out = _round8(torch.einsum("bhoc,bkh->bkoc", tmp, wv))  # [B, crop, crop, 3]
    out = (out * (1.0 / 255.0) - _const(IMAGENET_MEAN, dev)) * _const(
        np.float32(1.0) / IMAGENET_STD, dev)
    return out.to(dtype)
