"""RandAugment and RandomErasing, batched on the tensor's device (port of
``rajni_tpu/data/randaug.py``).

The policy is timm's (``auto_augment.py``): per layer one of 15 ops drawn
uniformly, gated at ``prob``, its magnitude ``N(m, mstd)`` (``U[0, m]`` when
``mstd >= 100``) clamped to ``[0, mmax]``, the ``inc1`` increasing level
maps. The pixels are PIL's, as the JAX package transcribes them: the LUT ops
(invert, posterize, solarize, solarize-add, autocontrast, equalize) and the
enhance ops (color, contrast, brightness, sharpness, PIL's truncating
``_blend``) exactly; the geometric ops (rotate, shear, translate) by PIL's
half-pixel inverse-affine sampling with Pillow's transform cubic.
RandomErasing is timm's (``random_erasing.py``): a per-image gate, ten
candidate boxes of ``U(0.02, 1/3)·area/count`` and log-uniform aspect, the
first that fits, filled per pixel (``pixel``), per box (``rand``) or with
zeros (``const``).

Each random function is split in two: ``draw_*`` draws its values from a
numpy generator on the host (a pure function of the train step's key,
:mod:`..utils.rng`), and ``*_apply`` takes them explicitly, so a test can
feed it the JAX package's draws. Images are ``[B, H, W, 3]`` float32 holding
integers in [0, 255] (RandAugment) or normalized values (RandomErasing).
Where JAX's ``lax.switch`` under ``vmap`` evaluates every op, the port
groups the images by their drawn op and runs each op once on its group.
Divisions are by tensors (on CUDA PyTorch takes ``tensor / python_number``
as a multiply by the reciprocal).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from .pipeline import IMAGENET_MEAN

#: timm's level scale: magnitudes live in [0, 10]
_MAX_LEVEL = 10.0

#: DeiT's geometric fill colour, ``round(255·mean)`` over the ImageNet mean
DEFAULT_FILL = tuple(min(255, round(255.0 * float(m))) for m in IMAGENET_MEAN)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` as a true division, ``b`` a number or a tensor."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return a / b


def _col(v: torch.Tensor) -> torch.Tensor:
    """A per-image value ``[n]`` broadcast over ``[n, H, W, 3]``."""
    return v.reshape(-1, 1, 1, 1)


def _clip8(x: torch.Tensor) -> torch.Tensor:
    """Round half up and clamp to the uint8 range (PIL's store)."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


# ---------------------------------------------------------------------------
# Pixel ops: x [n, H, W, 3] float32 integers in [0, 255], per-image arguments [n]
# ---------------------------------------------------------------------------


def invert(x):
    """``ImageOps.invert``."""
    return 255.0 - x


def posterize(x, bits):
    """``ImageOps.posterize``: keep the ``bits`` high bits, ``floor(v /
    2^(8−bits)) · 2^(8−bits)``."""
    s = _col(torch.exp2((8 - bits).to(torch.float32)))
    return torch.floor(x / s) * s


def solarize(x, threshold):
    """``ImageOps.solarize``: invert the pixels at or above ``threshold``."""
    return torch.where(x >= _col(threshold.to(torch.float32)), 255.0 - x, x)


def solarize_add(x, add, threshold: float = 128.0):
    """timm ``solarize_add``: pixels below 128 gain ``add``, saturating."""
    return torch.where(x < threshold, torch.clamp(x + _col(add.to(torch.float32)), max=255.0), x)


def autocontrast(x):
    """``ImageOps.autocontrast`` (cutoff 0): each channel stretched from its
    min and max, ``clip(trunc((v − lo)·255/(hi − lo)))``."""
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    scale = torch.full_like(span, 255.0) / span
    out = torch.clamp(torch.trunc((x - lo) * scale), 0.0, 255.0)
    return torch.where(hi > lo, out, x)


def equalize(x):
    """``ImageOps.equalize``: each channel through PIL's LUT, the last
    nonzero bin left out of the count, ``step = rest // 255``, identity
    where a channel has one value or ``step`` is 0, else ``lut[i] = (step//2
    + Σ_{j<i} h[j]) // step`` clamped to 255."""
    n, H, W, _ = x.shape
    idx = x.to(torch.int64).permute(0, 3, 1, 2).reshape(n, 3, H * W)
    h = torch.zeros(n, 3, 256, dtype=torch.int64, device=x.device)
    h.scatter_add_(2, idx, torch.ones_like(idx))
    nz = h > 0
    last = 255 - torch.argmax(nz.flip(-1).to(torch.uint8), dim=-1, keepdim=True)
    step = (H * W - torch.gather(h, 2, last)) // 255
    csum = torch.cumsum(h, dim=-1) - h
    lut = torch.clamp((step // 2 + csum) // torch.clamp(step, min=1), 0, 255)
    ident = torch.arange(256, device=x.device).expand_as(lut)
    lut = torch.where((nz.sum(-1, keepdim=True) <= 1) | (step == 0), ident, lut)
    out = torch.gather(lut, 2, idx).to(torch.float32)
    return out.reshape(n, 3, H, W).permute(0, 2, 3, 1)


def _gray(x):
    """PIL ``convert('L')``: ``(19595·R + 38470·G + 7471·B + 0x8000) >> 16``."""
    xi = x.to(torch.int32)
    return ((19595 * xi[..., 0] + 38470 * xi[..., 1] + 7471 * xi[..., 2] + 32768) >> 16).to(
        torch.float32)


def _blend(degenerate, x, factor):
    """``Image.blend(degenerate, img, factor)``: ``deg + f·(img − deg)``,
    stored through a C ``(int)`` cast, then clipped."""
    return torch.clamp(torch.trunc(degenerate + _col(factor) * (x - degenerate)), 0.0, 255.0)


def color(x, factor):
    """``ImageEnhance.Color``: blend with the grayscale image."""
    return _blend(_gray(x)[..., None], x, factor)


def contrast(x, factor):
    """``ImageEnhance.Contrast``: blend with the mean luma, rounded half up."""
    g = _gray(x)
    mean = torch.floor(_div(g.sum(dim=(1, 2)), float(g.shape[1] * g.shape[2])) + 0.5)
    return _blend(_col(mean), x, factor)


def brightness(x, factor):
    """``ImageEnhance.Brightness``: blend with black."""
    return _blend(torch.zeros_like(x), x, factor)


def sharpness(x, factor):
    """``ImageEnhance.Sharpness``: blend with ``ImageFilter.SMOOTH`` (the
    3×3 kernel [[1,1,1],[1,5,1],[1,1,1]]/13), the one-pixel border left
    unfiltered as PIL leaves it."""
    n, H, W, _ = x.shape
    pad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros_like(x)
    weights = ((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0))
    for dy in range(3):
        for dx in range(3):
            acc = acc + weights[dy][dx] * pad[:, dy:dy + H, dx:dx + W]
    smooth = _clip8(_div(acc, 13.0))
    rows = torch.arange(H, device=x.device)[:, None]
    cols = torch.arange(W, device=x.device)[None, :]
    interior = (rows >= 1) & (rows < H - 1) & (cols >= 1) & (cols < W - 1)
    smooth = torch.where(interior[None, :, :, None], smooth, x)
    return _blend(smooth, x, factor)


def _transform_cubic_weights(d):
    """Pillow's transform BICUBIC weights at phase ``d``: taps at floor−1 …
    floor+2, ``(−d+2d²−d³, 1−2d²+d³, d+d²−d³, −d²+d³)``."""
    d2 = d * d
    d3 = d2 * d
    return (-d + 2.0 * d2 - d3, 1.0 - 2.0 * d2 + d3, d + d2 - d3, -d2 + d3)


def _affine_bicubic(x, mat, fill):
    """PIL ``Image.transform(size, AFFINE, mat, BICUBIC, fillcolor)``, one
    matrix an image (``mat``: six ``[n]`` tensors): output pixel (col, row)
    samples ``(a·(col+½) + b·(row+½) + c − ½, d·(col+½) + e·(row+½) + f −
    ½)`` over its 4×4 neighbourhood, edge-clamped; a sample whose centre
    falls outside the image takes ``fill``."""
    n, H, W, _ = x.shape
    a, b, c, d, e, f = (m.reshape(-1, 1, 1) for m in mat)
    row = torch.arange(H, dtype=torch.float32, device=x.device)[None, :, None] + 0.5
    col = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :] + 0.5
    xin = a * col + b * row + c - 0.5
    yin = d * col + e * row + f - 0.5
    x0, y0 = torch.floor(xin), torch.floor(yin)
    wxs, wys = _transform_cubic_weights(xin - x0), _transform_cubic_weights(yin - y0)
    flat = x.reshape(n, H * W, 3)
    out = torch.zeros_like(x)
    for ty in range(-1, 3):
        yc = torch.clamp(y0.to(torch.int64) + ty, 0, H - 1)
        for tx in range(-1, 3):
            xc = torch.clamp(x0.to(torch.int64) + tx, 0, W - 1)
            taps = torch.gather(flat, 1, (yc * W + xc).reshape(n, H * W, 1).expand(-1, -1, 3))
            out = out + (wys[ty + 1] * wxs[tx + 1])[..., None] * taps.reshape(n, H, W, 3)
    valid = (xin >= -0.5) & (xin < W - 0.5) & (yin >= -0.5) & (yin < H - 0.5)
    fill_rgb = torch.tensor(fill, dtype=torch.float32, device=x.device)
    return torch.where(valid[..., None], _clip8(out), fill_rgb)


def _affine(x, *entries, fill):
    """:func:`_affine_bicubic` with each matrix entry a number or an ``[n]``
    tensor."""
    n = x.shape[0]
    mat = [e if isinstance(e, torch.Tensor) else torch.full((n,), float(e), device=x.device)
           for e in entries]
    return _affine_bicubic(x, mat, fill)


def shear_x(x, factor, fill=DEFAULT_FILL):
    """timm ``shear_x``: AFFINE (1, factor, 0, 0, 1, 0)."""
    return _affine(x, 1.0, factor, 0.0, 0.0, 1.0, 0.0, fill=fill)


def shear_y(x, factor, fill=DEFAULT_FILL):
    """timm ``shear_y``: AFFINE (1, 0, 0, factor, 1, 0)."""
    return _affine(x, 1.0, 0.0, 0.0, factor, 1.0, 0.0, fill=fill)


def translate_x_rel(x, pct, fill=DEFAULT_FILL):
    """timm ``translate_x_rel``: a shift of ``pct·width`` pixels."""
    return _affine(x, 1.0, 0.0, pct * x.shape[2], 0.0, 1.0, 0.0, fill=fill)


def translate_y_rel(x, pct, fill=DEFAULT_FILL):
    """timm ``translate_y_rel``: a shift of ``pct·height`` pixels."""
    return _affine(x, 1.0, 0.0, 0.0, 0.0, 1.0, pct * x.shape[1], fill=fill)


def rotate(x, degrees, fill=DEFAULT_FILL):
    """``Image.rotate(degrees, BICUBIC, fillcolor)`` about the centre: with
    θ = −radians(degrees), AFFINE [cos θ, sin θ, c, −sin θ, cos θ, f], (c, f)
    re-centring on (w/2, h/2)."""
    H, W = x.shape[1], x.shape[2]
    theta = -degrees * (math.pi / 180.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    cx, cy = W / 2.0, H / 2.0
    c = cos * (-cx) + sin * (-cy) + cx
    f = -sin * (-cx) + cos * (-cy) + cy
    return _affine(x, cos, sin, c, -sin, cos, f, fill=fill)


# ---------------------------------------------------------------------------
# The RandAugment policy
# ---------------------------------------------------------------------------


def _neg(v, neg):
    """timm ``_randomly_negate`` with its coin ``neg`` drawn."""
    return torch.where(neg, -v, v)


def _lvl(level, scale: float):
    """``level / 10 · scale``, in fp32 as JAX computes it."""
    return _div(level, _MAX_LEVEL) * scale


def _enhance_factor(level, neg, increasing: bool):
    if increasing:
        return 1.0 + _neg(_lvl(level, 0.9), neg)
    return _lvl(level, 1.8) + 0.1


def _op_table(fill, increasing: bool):
    """The 15 ops in timm's order (AutoContrast, Equalize, Invert, Rotate,
    Posterize, Solarize, SolarizeAdd, Color, Contrast, Brightness,
    Sharpness, ShearX, ShearY, TranslateXRel, TranslateYRel), each ``fn(x,
    level, neg)`` with per-image ``level`` and sign coin ``neg``."""

    def lvl_int(level, scale):
        return torch.trunc(_lvl(level, scale)).to(torch.int32)

    return [
        lambda x, level, neg: autocontrast(x),
        lambda x, level, neg: equalize(x),
        lambda x, level, neg: invert(x),
        lambda x, level, neg: rotate(x, _neg(_lvl(level, 30.0), neg), fill),
        lambda x, level, neg: posterize(
            x, (4 - lvl_int(level, 4.0)) if increasing else lvl_int(level, 4.0)),
        lambda x, level, neg: solarize(
            x, (256 - lvl_int(level, 256.0)) if increasing else lvl_int(level, 256.0)),
        lambda x, level, neg: solarize_add(x, lvl_int(level, 110.0)),
        lambda x, level, neg: color(x, _enhance_factor(level, neg, increasing)),
        lambda x, level, neg: contrast(x, _enhance_factor(level, neg, increasing)),
        lambda x, level, neg: brightness(x, _enhance_factor(level, neg, increasing)),
        lambda x, level, neg: sharpness(x, _enhance_factor(level, neg, increasing)),
        lambda x, level, neg: shear_x(x, _neg(_lvl(level, 0.3), neg), fill),
        lambda x, level, neg: shear_y(x, _neg(_lvl(level, 0.3), neg), fill),
        lambda x, level, neg: translate_x_rel(x, _neg(_lvl(level, 0.45), neg), fill),
        lambda x, level, neg: translate_y_rel(x, _neg(_lvl(level, 0.45), neg), fill),
    ]


NUM_OPS = 15


def parse_rand_augment(config: str) -> dict:
    """A timm RandAugment config string as policy kwargs:
    ``rand-m9-mstd0.5-inc1`` → 2 layers, magnitude 9, mstd 0.5, increasing.
    Keys: ``m``, ``n`` (layers, default 2), ``p`` (per-op probability,
    default 0.5), ``mstd`` (≥ 100: uniform [0, m]), ``mmax`` (default 10),
    ``inc``; ``w`` (weighted choice) is not supported."""
    parts = config.split("-")
    if not parts or parts[0] != "rand":
        raise ValueError(f"RandAugment config must start with 'rand': {config!r}")
    kwargs = dict(num_layers=2, magnitude=9.0, mstd=0.0, mmax=_MAX_LEVEL, prob=0.5,
                  increasing=False)
    for part in parts[1:]:
        m = re.match(r"([a-z]+)([\d.]+)", part)
        if not m:
            raise ValueError(f"bad RandAugment token {part!r} in {config!r}")
        key, val = m.group(1), m.group(2)
        if key == "m":
            kwargs["magnitude"] = float(val)
        elif key == "n":
            kwargs["num_layers"] = int(val)
        elif key == "p":
            kwargs["prob"] = float(val)
        elif key == "mstd":
            kwargs["mstd"] = float(val)
        elif key == "mmax":
            kwargs["mmax"] = float(val)
        elif key == "inc":
            kwargs["increasing"] = bool(int(val))
        else:
            raise ValueError(f"unsupported RandAugment token {part!r} in {config!r}")
    return kwargs


def draw_rand_augment(rng: np.random.Generator, batch: int, *, num_layers: int = 2,
                      magnitude: float = 9.0, mstd: float = 0.5, mmax: float = _MAX_LEVEL,
                      prob: float = 0.5, increasing: bool = True) -> dict:
    """Per image and layer: the op index, its gate, its level (``N(m,
    mstd)``, or ``U[0, m]`` when ``mstd >= 100``, clamped to ``[0, mmax]``)
    and its sign coin; ``[batch, num_layers]`` arrays."""
    shape = (batch, num_layers)
    op = rng.integers(0, NUM_OPS, shape)
    gate = rng.random(shape) < prob
    if mstd >= 100.0:
        level = rng.random(shape).astype(np.float32) * np.float32(magnitude)
    elif mstd > 0.0:
        level = np.float32(magnitude) + np.float32(mstd) * rng.standard_normal(shape).astype(
            np.float32)
    else:
        level = np.full(shape, magnitude, np.float32)
    neg = rng.random(shape) < 0.5
    return {"op": op, "gate": gate, "level": np.clip(level, 0.0, mmax).astype(np.float32),
            "neg": neg}


def rand_augment_apply(x: torch.Tensor, draws: dict, increasing: bool = True,
                       fill=DEFAULT_FILL) -> torch.Tensor:
    """The RandAugment layers on ``x`` ``[B, H, W, 3]`` (integers in [0,
    255], fp32) with the drawn ``op``, ``gate``, ``level`` and ``neg``
    (:func:`draw_rand_augment`): each layer groups the gated images by op and
    runs each op on its group."""
    ops = _op_table(fill, increasing)
    op, gate, neg = (torch.as_tensor(np.asarray(draws[k])) for k in ("op", "gate", "neg"))
    level = torch.as_tensor(np.asarray(draws["level"], np.float32)).to(x.device)
    neg = neg.to(x.device)
    for layer in range(op.shape[1]):
        y = x.clone()
        for k in sorted(set(op[gate[:, layer], layer].tolist())):
            rows = torch.nonzero((op[:, layer] == k) & gate[:, layer])[:, 0].to(x.device)
            y[rows] = ops[k](x[rows], level[rows, layer], neg[rows, layer])
        x = y
    return x


# ---------------------------------------------------------------------------
# RandomErasing (timm), on the normalized tensor
# ---------------------------------------------------------------------------


def draw_random_erasing(rng: np.random.Generator, batch: int, *, prob: float = 0.25,
                        mode: str = "pixel", count: int = 1, min_area: float = 0.02,
                        max_area: float = 1.0 / 3.0, min_aspect: float = 0.3,
                        max_aspect: float | None = None, noise_shape=None,
                        noise_generator: torch.Generator | None = None) -> dict:
    """Per image: the gate; per erase: ten area fractions in ``[min_area,
    max_area)``, ten log aspects, the top and left coins, and the fill (a
    normal scalar for ``rand``); for ``pixel`` the per-pixel normals
    ``[batch, count, *noise_shape]``, drawn on ``noise_generator``'s
    device."""
    if mode not in ("pixel", "rand", "const"):
        raise ValueError(f"unknown RandomErasing mode {mode!r}")
    max_aspect = max_aspect or 1.0 / min_aspect
    f32 = np.float32
    draws = {
        "mode": mode, "gate": rng.random(batch) < prob,
        "area": rng.uniform(min_area, max_area, (batch, count, 10)).astype(f32),
        "log_aspect": rng.uniform(math.log(min_aspect), math.log(max_aspect),
                                  (batch, count, 10)).astype(f32),
        "u_top": rng.random((batch, count)).astype(f32),
        "u_left": rng.random((batch, count)).astype(f32),
        "fill": rng.standard_normal((batch, count)).astype(f32),
    }
    if mode == "pixel":
        dev = noise_generator.device
        draws["noise"] = torch.randn((batch, count, *noise_shape), generator=noise_generator,
                                     device=dev)
    return draws


def _erase_box(area, log_aspect, u_top, u_left, H: int, W: int, count: int):
    """The first of ten candidate boxes that fits (none: an empty box), and
    its top-left from the coins: ``(top, left, h, w)``, each ``[B]``."""
    target = _div(area * float(H * W), float(count))
    ar = torch.exp(log_aspect)
    h = torch.round(torch.sqrt(target * ar)).to(torch.int64)
    w = torch.round(torch.sqrt(_div(target, ar))).to(torch.int64)
    valid = (h > 0) & (h < H) & (w > 0) & (w < W)
    first = torch.argmax(valid.to(torch.uint8), dim=-1, keepdim=True)
    any_valid = valid.any(dim=-1)
    zero = torch.zeros_like(any_valid, dtype=torch.int64)
    h_sel = torch.where(any_valid, torch.gather(h, -1, first)[..., 0], zero)
    w_sel = torch.where(any_valid, torch.gather(w, -1, first)[..., 0], zero)
    top = torch.floor(u_top * (H - h_sel).to(torch.float32)).to(torch.int64)
    left = torch.floor(u_left * (W - w_sel).to(torch.float32)).to(torch.int64)
    return top, left, h_sel, w_sel, any_valid


def random_erasing_apply(x: torch.Tensor, draws: dict) -> torch.Tensor:
    """timm's RandomErasing on ``x`` ``[B, H, W, C]`` with the drawn values
    (:func:`draw_random_erasing`), the erases applied in order."""
    B, H, W, _ = x.shape
    dev = x.device

    def t(k):
        return torch.as_tensor(np.asarray(draws[k])).to(dev)

    gate = t("gate")
    count = draws["area"].shape[1]
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    out = x
    for e in range(count):
        top, left, h, w, ok = _erase_box(t("area")[:, e], t("log_aspect")[:, e],
                                         t("u_top")[:, e], t("u_left")[:, e], H, W, count)
        mask = ((rows >= top[:, None, None]) & (rows < (top + h)[:, None, None])
                & (cols >= left[:, None, None]) & (cols < (left + w)[:, None, None])
                & (gate & ok)[:, None, None])
        if draws["mode"] == "pixel":
            fill = draws["noise"][:, e].to(dev, out.dtype)
        elif draws["mode"] == "rand":
            fill = _col(t("fill")[:, e]).to(out.dtype).expand_as(out)
        else:
            fill = torch.zeros_like(out)
        out = torch.where(mask[..., None], fill, out)
    return out
