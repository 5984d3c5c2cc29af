"""Training augmentation on the device: RandomResizedCrop, flip, RandAugment,
normalize, RandomErasing (port of ``rajni_tpu/data/augment.py``).

Each image arrives decode-only on a fixed uint8 canvas with its true ``(h,
w)`` (``ImageFolder(output="canvas")``). Its crop box follows
``torchvision.transforms.RandomResizedCrop.get_params`` (ten candidates, the
first valid one, the clamped centre-crop fallback); crop and resize are two
weight matrices an image, PIL's antialiased bicubic weights clamped to the
crop box (torchvision resamples the materialized crop), applied as fp32
products with PIL's 8-bit rounding between the passes. The flip reverses the
rows of the horizontal weights. Then timm's order: RandAugment on the uint8
crop, the ImageNet normalize, RandomErasing (:mod:`.randaug`).

Every draw comes from the stream ``(seed, _AUGMENT_TAG, step)``
(:mod:`..utils.rng`): the crop, flip, RandAugment and erasing values from a
numpy generator on the host (:func:`draw_augment`), RandomErasing's
per-pixel fill from a ``torch.Generator`` on the device. A resumed run
replays the same augmented stream. The per-pixel fill depends on the
device as well as the stream: a CUDA and a CPU generator seeded alike draw
different normals, so ``pixel``-mode erasing differs between a run on the
card and one on the CPU (the other values do not). :func:`augment_apply`
takes the drawn values explicitly. Divisions are by tensors, as in
:mod:`.device`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.rng import device_generator, host_rng
from .device import _bicubic, _const, _round8
from .pipeline import IMAGENET_MEAN, IMAGENET_STD
from .randaug import (
    draw_rand_augment,
    draw_random_erasing,
    parse_rand_augment,
    rand_augment_apply,
    random_erasing_apply,
)

#: torchvision RandomResizedCrop defaults
DEFAULT_SCALE = (0.08, 1.0)
DEFAULT_RATIO = (3.0 / 4.0, 4.0 / 3.0)
_AUGMENT_TAG = 0x61756731  # "aug1": the augmentation stream


def _t(value, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _rrc_box(h: torch.Tensor, w: torch.Tensor, area_frac: torch.Tensor,
             log_ratio: torch.Tensor, u_top: torch.Tensor, u_left: torch.Tensor,
             ratio: tuple[float, float] = DEFAULT_RATIO):
    """RandomResizedCrop's box, ``(top, left, crop_h, crop_w)`` int64 ``[B]``,
    from the draws (JAX's ``_rrc_box``, ``augment.py:58``): ten candidates
    of area ``h·w·area_frac`` and aspect ``exp(log_ratio)`` (``[B, 10]``),
    rounded half to even; the first whose sides fit wins, placed at
    ``floor(u·(side − crop + 1))``; with none, the centre crop of the image
    with its aspect clamped into ``ratio``."""
    hf, wf = h.to(torch.float32), w.to(torch.float32)
    target = (hf * wf)[:, None] * area_frac
    aspect = torch.exp(log_ratio)
    cw = torch.round(torch.sqrt(target * aspect))
    ch = torch.round(torch.sqrt(target / aspect))
    valid = (cw > 0.0) & (cw <= wf[:, None]) & (ch > 0.0) & (ch <= hf[:, None])
    first = torch.argmax(valid.to(torch.uint8), dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    in_ratio = wf / hf
    lo, hi = _t(ratio[0], hf), _t(ratio[1], hf)
    cw_fb = torch.where(in_ratio < lo, wf, torch.where(in_ratio > hi, torch.round(hf * hi), wf))
    ch_fb = torch.where(in_ratio < lo, torch.round(wf / lo), hf)
    ch_sel = torch.where(any_valid, torch.gather(ch, 1, first)[:, 0], ch_fb)
    cw_sel = torch.where(any_valid, torch.gather(cw, 1, first)[:, 0], cw_fb)
    two = _t(2.0, hf)
    top = torch.where(any_valid, torch.floor(u_top * (hf - ch_sel + 1.0)),
                      torch.floor((hf - ch_fb) / two))
    left = torch.where(any_valid, torch.floor(u_left * (wf - cw_sel + 1.0)),
                       torch.floor((wf - cw_fb) / two))
    return top.to(torch.int64), left.to(torch.int64), ch_sel.to(torch.int64), cw_sel.to(
        torch.int64)


def _region_rows(src_off: torch.Tensor, src_size: torch.Tensor, out_size: int,
                 canvas: int) -> torch.Tensor:
    """``[B, out_size, canvas]`` bicubic weights resizing each image's span
    ``[src_off, src_off + src_size)`` to ``out_size`` pixels (JAX's
    ``_region_rows``, ``augment.py:123``): PIL's ``precompute_coeffs`` (a =
    −0.5, the support widened by the shrink ratio, truncated bounds, rows
    normalized), the window clamped to the crop box."""
    dev = src_size.device
    src_f = src_size.to(torch.float32)[:, None, None]
    off_f = src_off.to(torch.float32)[:, None, None]
    scale = src_f / _t(float(out_size), src_f)
    filterscale = torch.maximum(scale, torch.ones_like(scale))
    support = 2.0 * filterscale
    out_idx = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    src_idx = torch.arange(canvas, dtype=torch.float32, device=dev)[None, None, :]
    center = off_f + (out_idx + 0.5) * scale
    lo = torch.maximum(torch.trunc(center - support + 0.5), off_f)
    hi = torch.minimum(torch.trunc(center + support + 0.5), off_f + src_f)
    wgt = _bicubic((src_idx + 0.5 - center) / filterscale)
    wgt = torch.where((src_idx >= lo) & (src_idx < hi), wgt, torch.zeros_like(wgt))
    total = wgt.sum(dim=2, keepdim=True)
    return wgt / torch.where(total == 0.0, torch.ones_like(total), total)


def draw_augment(rng: np.random.Generator, batch: int, *, scale=DEFAULT_SCALE,
                 ratio=DEFAULT_RATIO, hflip: bool = True, rand_augment: str | None = None,
                 erase: tuple[float, str, int] | None = None, crop: int = 224,
                 noise_generator: torch.Generator | None = None) -> dict:
    """The draw half: per image ten area fractions in ``scale`` and ten log
    aspects in ``log(ratio)``, the top and left coins, the flip coin; the
    RandAugment draws (:func:`.randaug.draw_rand_augment`, for the policy
    string ``rand_augment``) and the RandomErasing ones (``erase``: ``(prob,
    mode, count)``; the per-pixel fill of ``[crop, crop, 3]`` on
    ``noise_generator``'s device)."""
    f32 = np.float32
    draws = {
        "area": rng.uniform(scale[0], scale[1], (batch, 10)).astype(f32),
        "log_ratio": rng.uniform(math.log(ratio[0]), math.log(ratio[1]),
                                 (batch, 10)).astype(f32),
        "u_top": rng.random(batch).astype(f32), "u_left": rng.random(batch).astype(f32),
        "flip": (rng.random(batch) < 0.5) if hflip else np.zeros(batch, bool),
        "ratio": ratio, "rand_augment": None, "erase": None,
    }
    if rand_augment:
        ra = parse_rand_augment(rand_augment)
        draws["rand_augment"] = (draw_rand_augment(rng, batch, **ra), ra["increasing"])
    if erase is not None and erase[0] > 0.0:
        prob, mode, count = erase
        draws["erase"] = draw_random_erasing(rng, batch, prob=prob, mode=mode, count=count,
                                             noise_shape=(crop, crop, 3),
                                             noise_generator=noise_generator)
    return draws


def crop_and_flip(canvas_u8: torch.Tensor, sizes: torch.Tensor, draws: dict,
                  crop: int = 224) -> torch.Tensor:
    """RandomResizedCrop and the flip from the drawn values: ``uint8 [B, S,
    S, 3]`` canvases and ``[B, 2]`` ``(h, w)`` → ``[B, crop, crop, 3]`` fp32
    integers in [0, 255], PIL's two bicubic passes with the 8-bit rounding
    between them."""
    S, dev = canvas_u8.shape[1], canvas_u8.device

    def t(k):
        return torch.as_tensor(np.asarray(draws[k])).to(dev)

    top, left, ch, cw = _rrc_box(sizes[:, 0], sizes[:, 1], t("area"), t("log_ratio"),
                                 t("u_top"), t("u_left"), draws["ratio"])
    wh = _region_rows(left, cw, crop, S)  # [B, crop, S] columns
    wv = _region_rows(top, ch, crop, S)   # [B, crop, S] rows
    wh = torch.where(t("flip")[:, None, None], wh.flip(1), wh)
    x = canvas_u8.to(torch.float32)
    tmp = _round8(torch.einsum("bhwc,bow->bhoc", x, wh))    # [B, S, crop, 3]
    return _round8(torch.einsum("bhoc,bkh->bkoc", tmp, wv))  # [B, crop, crop, 3]


def normalize_and_erase(x: torch.Tensor, draws: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """The ImageNet normalize of the uint8-valued ``x``, then RandomErasing
    where drawn, in ``dtype``."""
    dev = x.device
    out = (x * (1.0 / 255.0) - _const(IMAGENET_MEAN, dev)) * _const(
        np.float32(1.0) / IMAGENET_STD, dev)
    if draws["erase"] is not None:
        out = random_erasing_apply(out, draws["erase"])
    return out.to(dtype)


def augment_apply(canvas_u8: torch.Tensor, sizes: torch.Tensor, draws: dict, crop: int = 224,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """The apply half on ``canvas_u8``'s device, from the drawn values
    (:func:`draw_augment`): :func:`crop_and_flip`, RandAugment, then
    :func:`normalize_and_erase` → ``[B, crop, crop, 3]`` in ``dtype``."""
    out = crop_and_flip(canvas_u8, sizes, draws, crop)
    if draws["rand_augment"] is not None:
        ra, increasing = draws["rand_augment"]
        out = rand_augment_apply(out, ra, increasing)
    return normalize_and_erase(out, draws, dtype)


def augment_on_device(canvas_u8: torch.Tensor, sizes: torch.Tensor, seed: int, step: int,
                      crop: int = 224, scale=DEFAULT_SCALE, ratio=DEFAULT_RATIO,
                      hflip: bool = True, dtype=torch.bfloat16, rand_augment: str | None = None,
                      erase: tuple[float, str, int] | None = None) -> torch.Tensor:
    """Train-mode augmentation of a batch of canvases (JAX's
    ``augment_on_device``, ``augment.py:159``), its draws from the stream
    ``(seed, _AUGMENT_TAG, step)``: host values from a numpy generator, the
    erasing's per-pixel fill from a ``torch.Generator`` on the canvases'
    device."""
    draws = draw_augment(host_rng(seed, _AUGMENT_TAG, step), canvas_u8.shape[0], scale=scale,
                         ratio=ratio, hflip=hflip, rand_augment=rand_augment, erase=erase,
                         crop=crop, noise_generator=device_generator(
                             seed, _AUGMENT_TAG, step, device=canvas_u8.device))
    return augment_apply(canvas_u8, sizes, draws, crop, dtype)
