"""Int8 weight quantization and calibrated static activation scales (port of
``rajni_tpu/quant.py``).

* **Weights**: symmetric per-output-channel int8, quantized once offline.
  The port's record is ``{"int8": int8 [out, in], "scale": f32 [out]}`` in
  torch layout (``nn.Linear``'s ``[out, in]``), with ``w ≈ int8 * scale[:,
  None]``; it takes the place of a linear's ``weight`` (the JAX record is
  ``{"int8": [in, out], "scale": [1, out]}`` under ``kernel``).
* **Activations**: symmetric per-row int8 computed on the fly by the
  kernels (:func:`..kernels.math.quantize_rows`), or static per-tensor
  scales from :func:`calibrate_act_scales`, folded into the LayerNorm
  affines and the weight-scale rows before the launch: for the int8
  attention kernels once, when :func:`attach_act_scales` attaches them to
  the params (``RAJNIViT`` does, dynamic scales too).
* Accumulation in int32, dequantized as ``acc · a_row · w_col`` before the
  bias.

:func:`quantize_params` is a params-level transform: ``impl="cuda"`` then
routes each block through the whole-block int8 kernels (B14, B15) and the
head through an int8 product; ``impl="torch"`` dequantizes the weights.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

import torch
import torch.nn.functional as F

from .kernels.block import attach_attn_operands
from .ops.attention import _linear, _qkv_projection, _sdpa
from .ops.importance import compute_importance
from .ops.pruning import gather_tokens, keep_count, select_tokens
from .utils.schedule import normalize_schedule

Params = dict[str, Any]


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8 quantization of ``weight [out,
    in]``: ``{"int8": int8 [out, in], "scale": f32 [out]}``. Divides the
    absmax by 127 and the weights by the scale (``w / scale``), as
    ``rajni_tpu.quant.quantize_weight`` does: tensor by tensor, since on CUDA
    PyTorch takes ``tensor / 127.0`` as a multiply by ``fl(1 / 127)``, two
    roundings."""
    w32 = w.float()
    absmax = torch.clamp_min(w32.abs().amax(dim=1, keepdim=True), 1e-8)
    scale = absmax / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"int8": q.contiguous(), "scale": scale[:, 0].contiguous()}


def dequantize_weight(q: dict, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_weight` (for the ops path and tests)."""
    return (q["int8"].float() * q["scale"][:, None]).to(dtype)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "int8" in leaf


def quantize_params(params: Params, attn: bool = True, head: bool = True) -> Params:
    """Quantize every block's fc1/fc2 weights to int8, with ``attn=True``
    also qkv and proj, with ``head=True`` also the classifier head.
    Embeddings, norms, biases and layer scales keep their dtype."""
    if params["blocks"] and is_quantized(params["blocks"][0]["mlp"]["fc1"]["weight"]):
        raise ValueError("params are already quantized")

    def q(layer):
        return {**layer, "weight": quantize_weight(layer["weight"])}

    out = dict(params)
    blocks = []
    for block in params["blocks"]:
        b = dict(block)
        b["mlp"] = {name: q(block["mlp"][name]) for name in ("fc1", "fc2")}
        if attn:
            b["attn"] = {**block["attn"], "qkv": q(block["attn"]["qkv"]),
                         "proj": q(block["attn"]["proj"])}
        blocks.append(b)
    out["blocks"] = blocks
    if head:
        out["head"] = q(params["head"])
        if "head_dist" in params:  # DeiT's distillation head, as the CLS head
            out["head_dist"] = q(params["head_dist"])
    return out


@dataclasses.dataclass(frozen=True)
class ActScales:
    """Calibrated static int8 activation scales, plain Python floats.

    ``blocks[i] = (a_qkv, a_proj, a_fc1, a_fc2)``: the scales of block i's
    four quantize sites (post-LN1 qkv input, attention output, post-LN2 fc1
    input, post-GELU fc2 input); ``head`` is the classifier input's. Each is
    ``absmax · margin / 127`` with ``y ≈ int8 · a``. The JSON file format
    is the JAX package's.
    """

    blocks: tuple[tuple[float, float, float, float], ...]
    head: float

    def block(self, i: int) -> tuple[float, float, float, float]:
        return self.blocks[i]

    def to_dict(self) -> dict:
        """The JSON object of the file format."""
        return {"blocks": [list(row) for row in self.blocks], "head": self.head}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "ActScales":
        with open(path) as f:
            return cls.from_dict(json.load(f), path)

    @classmethod
    def from_dict(cls, d: dict, path: str = "scales") -> "ActScales":
        """Scales from the format's JSON object, checked (``path`` names
        its source in the errors)."""
        blocks = tuple(tuple(float(v) for v in row) for row in d["blocks"])
        head = float(d["head"])
        for i, row in enumerate(blocks):
            if len(row) != 4:
                raise ValueError(
                    f"{path}: block {i} has {len(row)} scales, expected 4 "
                    "(a_qkv, a_proj, a_fc1, a_fc2)"
                )
        flat = [v for row in blocks for v in row] + [head]
        if any(not math.isfinite(v) or v <= 0.0 for v in flat):
            raise ValueError(f"{path}: activation scales must be finite and positive")
        return cls(blocks=blocks, head=head)


@torch.no_grad()
def _calibration_forward(params: Params, images: torch.Tensor, config, schedule):
    """The ops-path forward (exact GELU) that also returns the absmax of
    each quantize site: ``(block_amax [depth × 4], head_amax, logits)``.
    Mirrors ``vit_forward(impl="torch")``; the logits let tests pin it to
    that forward."""
    # models.vit imports this module, so it is imported here
    from .models.vit import _layer_scale, _patch_mean, embed_tokens, layer_norm

    schedule = normalize_schedule(schedule, config.depth)
    eps = config.layer_norm_eps
    x = embed_tokens(params, images, config)

    def amax(v):
        return v.float().abs().amax()

    scores = None
    block_amax = []
    for spec, block in zip(schedule, params["blocks"]):
        y = layer_norm(x, block["norm1"], eps)
        a_qkv = amax(y)
        qkv = _qkv_projection(y, block["attn"])
        if spec is not None:
            keep = keep_count(spec.keep_ratio, x.shape[1])
            if spec.update or scores is None:
                scores = compute_importance(qkv, config.num_heads)
            keep_idx = select_tokens(scores, keep)
            qkv = gather_tokens(qkv, keep_idx)
            x = gather_tokens(x, keep_idx)  # compaction before the residual add
            scores = torch.take_along_dim(scores, keep_idx, dim=1)
        else:
            scores = None
        attn = _sdpa(qkv, config.num_heads, config.attn_scale)
        a_proj = amax(attn)
        x = x + _layer_scale(_linear(attn, block["attn"]["proj"]), block, "ls1")

        y2 = layer_norm(x, block["norm2"], eps)
        a_fc1 = amax(y2)
        h = F.gelu(_linear(y2, block["mlp"]["fc1"]), approximate="none")
        a_fc2 = amax(h)
        x = x + _layer_scale(_linear(h, block["mlp"]["fc2"]), block, "ls2")
        block_amax.append((a_qkv, a_proj, a_fc1, a_fc2))

    if config.fc_norm_resolved:  # the pooled heads, as classifier_head
        pooled = _patch_mean(x, 1) if config.global_pool == "avg" else x[:, 0]
        feat = layer_norm(pooled, params["fc_norm"], eps)
    elif config.global_pool == "avg":
        feat = _patch_mean(layer_norm(x, params["norm"], eps), 1)
    else:
        feat = layer_norm(x[:, 0:1], params["norm"], eps)[:, 0]
    head_amax = amax(feat)
    logits = _linear(feat, params["head"])
    return block_amax, head_amax, logits


def calibrate_act_scales(params: Params, batches, config, schedule=None,
                         margin: float = 1.0) -> ActScales:
    """Static int8 activation scales from calibration batches run through
    the UNQUANTIZED forward (calibrate first, then :func:`quantize_params`).

    ``batches`` is one ``[B, H, W, 3]`` tensor or an iterable of them;
    calibrate with the schedule that will serve (token mixes differ).
    ``margin`` multiplies the observed absmax.
    """
    if is_quantized(params["blocks"][0]["mlp"]["fc1"]["weight"]):
        raise ValueError("calibrate on unquantized params (before quantize_params)")
    if not config.kernel_path_supported:
        raise ValueError("static activation scales feed the int8 kernels, which this config "
                         "(registers, distillation token or qk-norm) runs without: use "
                         "dynamic int8 (quantize_params without calibration)")
    if isinstance(batches, torch.Tensor):
        batches = [batches]
    block_amax = head_amax = None
    for images in batches:
        b_amax, h_amax, _ = _calibration_forward(params, images, config, schedule)
        if block_amax is None:
            block_amax, head_amax = b_amax, h_amax
        else:
            block_amax = [tuple(torch.maximum(a, b) for a, b in zip(row, prev))
                          for row, prev in zip(b_amax, block_amax)]
            head_amax = torch.maximum(h_amax, head_amax)
    if block_amax is None:
        raise ValueError("calibrate_act_scales received no batches")

    def scale(m):
        return float(torch.clamp_min(m, 1e-8) * (margin / 127.0))

    return ActScales(blocks=tuple(tuple(scale(m) for m in row) for row in block_amax),
                     head=scale(head_amax))


def attach_act_scales(params: Params, act_scales: ActScales | None) -> Params:
    """``params`` with the scales attached: each int8 attention's kernel
    operands made once, here (:func:`.kernels.block.attach_attn_operands`),
    for its static ``(a_qkv, a_proj)`` folded in, or for dynamic scales
    (``act_scales`` None), so the kernels read them on every call instead of
    making them again. A new tree sharing the tensors (``params`` is
    unchanged); attaching other scales makes them again, and so must a
    change of the weights in place."""
    if act_scales is not None and len(act_scales.blocks) != len(params["blocks"]):
        raise ValueError(f"scales for {len(act_scales.blocks)} blocks, params with "
                         f"{len(params['blocks'])}")
    rows = [None] * len(params["blocks"]) if act_scales is None else act_scales.blocks
    blocks = [{**b, "attn": attach_attn_operands(b["norm1"], b["attn"],
                                                 None if row is None else row[:2])}
              if is_quantized(b["attn"]["qkv"]["weight"]) else b
              for b, row in zip(params["blocks"], rows)]
    return {**params, "blocks": blocks}
