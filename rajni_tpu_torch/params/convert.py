"""timm checkpoint → parameter converter (port of
``rajni_tpu/params/convert.py``).

A timm ``VisionTransformer`` ``state_dict`` becomes the JAX package's numpy
parameter tree (:func:`convert_timm_state_dict`), which
:func:`.from_jax.params_from_numpy` carries into the port's layout and
:func:`.io.save_params` writes as the msgpack both packages read:

  * ``patch_embed.proj.weight [C, 3, P, P]`` (conv OIHW) →
    ``patch_embed.kernel [P·P·3, C]`` flattened in ``(ph, pw, c)`` order,
    the patch extraction's order;
  * every ``nn.Linear`` weight ``[out, in]`` → ``kernel [in, out]``
    (``attn.qkv`` packed q|k|v, ``attn.proj``, ``mlp.fc1``, ``mlp.fc2``,
    ``head``);
  * ``norm*.weight/bias`` → ``scale``/``bias``; LayerScale's
    ``ls1.gamma``/``ls2.gamma`` → per-block ``ls1``/``ls2``;
  * ``cls_token`` and ``pos_embed`` pass through; a pos-embed of another
    grid is resampled as timm does (:func:`resample_pos_embed`).

The extended variants (qk-norm, registers, pooled heads, distillation, a
patch-only pos-embed) convert when the config declares them
(:func:`adapt_config` reads the flags from the keys), and the port's forward
runs them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from ..models.vit import ViTConfig


def _to_numpy(t: Any) -> np.ndarray:
    """torch.Tensor / np.ndarray → np.ndarray (bf16 through fp32, exactly)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu()
        if str(getattr(t, "dtype", "")) == "torch.bfloat16":
            t = t.float()
        t = t.numpy()
    return np.asarray(t)


def _dense(sd: Mapping[str, Any], prefix: str) -> dict:
    """``{prefix}.weight [out,in]`` + ``.bias`` → ``{kernel [in,out], bias}``."""
    w = _to_numpy(sd[f"{prefix}.weight"])
    out = {"kernel": np.ascontiguousarray(w.T)}
    bias_key = f"{prefix}.bias"
    out["bias"] = (
        _to_numpy(sd[bias_key]) if bias_key in sd else np.zeros((w.shape[0],), w.dtype)
    )
    return out


def _norm(sd: Mapping[str, Any], prefix: str) -> dict:
    return {"scale": _to_numpy(sd[f"{prefix}.weight"]), "bias": _to_numpy(sd[f"{prefix}.bias"])}


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """Dense 1-D matrix ``W [n_out, n_in]`` of
    ``F.interpolate(mode="bicubic", align_corners=False, antialias=True)``,
    the resampler of timm's ``resample_abs_pos_embed``: Keys kernel with
    ``a = -0.5``, support scaled by ``max(n_in / n_out, 1)``, PIL-style
    spans, each row normalized."""
    a = -0.5

    def kernel(t: np.ndarray) -> np.ndarray:
        at = np.abs(t)
        return np.where(
            at <= 1.0,
            (a + 2.0) * at**3 - (a + 3.0) * at**2 + 1.0,
            np.where(at < 2.0, a * at**3 - 5.0 * a * at**2 + 8.0 * a * at - 4.0 * a, 0.0),
        )

    W = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 2.0 * fs
    for i in range(n_out):
        center = (i + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(n_in, int(center + support + 0.5))
        w = kernel((np.arange(xmin, xmax) + 0.5 - center) / fs)
        total = w.sum()
        if total != 0.0:
            w = w / total
        W[i, xmin:xmax] = w
    return W


def resample_pos_embed(pos_embed: np.ndarray, new_tokens: int, num_prefix: int = 1) -> np.ndarray:
    """Bicubic-resample a ``[1, N, C]`` absolute pos-embed to a new square
    grid, the ``num_prefix`` leading rows unchanged (timm's
    ``resample_abs_pos_embed``: rows, then columns, in fp32)."""
    pe = np.asarray(pos_embed, np.float32)
    prefix, grid = pe[:, :num_prefix], pe[:, num_prefix:]
    n_old = grid.shape[1]
    n_new = new_tokens - num_prefix
    g_old = int(round(n_old**0.5))
    g_new = int(round(n_new**0.5))
    if g_old * g_old != n_old or g_new * g_new != n_new:
        raise ValueError(f"pos_embed grids must be square: {n_old} -> {n_new} patches")
    C = grid.shape[-1]
    grid = grid.reshape(g_old, g_old, C)
    W = _cubic_weights(g_old, g_new).astype(np.float32)
    grid = np.einsum("oh,hwc->owc", W, grid)
    grid = np.einsum("ow,hwc->hoc", W, grid)
    return np.concatenate([prefix, grid.reshape(1, n_new, C)], axis=1)


def _check_variant(sd: Mapping[str, Any], config: ViTConfig) -> None:
    """The extended-variant keys must match the config's flags: their
    presence, not their values, decides the forward's semantics."""
    has_qk = any(".q_norm." in k or ".k_norm." in k for k in sd)
    if has_qk and not config.qk_norm:
        raise ValueError(
            "checkpoint carries attn.q_norm/k_norm weights but the config "
            "has qk_norm=False — convert with adapt_config(config, sd) so "
            "the per-head norms are modeled (timm applies the "
            "normalization regardless of affine values)"
        )
    if config.qk_norm and not has_qk:
        raise ValueError("config has qk_norm=True but the checkpoint has no "
                         "attn.q_norm/k_norm weights")
    has_fc_norm = any(k.startswith("fc_norm.") for k in sd)
    if has_fc_norm != config.fc_norm_resolved:
        raise ValueError(
            "fc_norm presence mismatch: checkpoint "
            f"{'has' if has_fc_norm else 'lacks'} fc_norm.* but the config "
            f"resolves use_fc_norm={config.fc_norm_resolved} — pooled-head "
            "checkpoints need global_pool='avg' (use adapt_config)"
        )
    has_reg = "reg_token" in sd
    if has_reg != bool(config.reg_tokens):
        raise ValueError(
            f"register-token mismatch: checkpoint {'has' if has_reg else 'lacks'} reg_token "
            f"but config reg_tokens={config.reg_tokens} (use adapt_config)"
        )
    has_dist = "dist_token" in sd or "head_dist.weight" in sd
    if has_dist != config.distilled:
        raise ValueError(
            f"distillation mismatch: checkpoint {'has' if has_dist else 'lacks'} "
            f"dist_token/head_dist but config distilled={config.distilled} (use adapt_config)"
        )


def _consumed(config: ViTConfig) -> set[str]:
    keys = {"patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token", "pos_embed",
            "head.weight", "head.bias"}
    keys |= ({"fc_norm.weight", "fc_norm.bias"} if config.fc_norm_resolved
             else {"norm.weight", "norm.bias"})
    if config.reg_tokens:
        keys.add("reg_token")
    if config.distilled:
        keys |= {"dist_token", "head_dist.weight", "head_dist.bias"}
    leaves = ["norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"]
    if config.qk_norm:
        leaves += ["attn.q_norm", "attn.k_norm"]
    for i in range(config.depth):
        keys |= {f"blocks.{i}.{leaf}.{wb}" for leaf in leaves for wb in ("weight", "bias")}
        keys |= {f"blocks.{i}.ls1.gamma", f"blocks.{i}.ls2.gamma"}
    return keys


def convert_timm_state_dict(state_dict: Mapping[str, Any], config: ViTConfig,
                            dtype: Any = np.float32) -> dict:
    """A timm ``VisionTransformer`` state_dict (torch tensors or numpy
    arrays, timm's names) → the JAX package's numpy tree of ``dtype``,
    shapes checked against ``config``. Every key must be consumed: a weight
    this converter does not model raises rather than being dropped."""
    sd = dict(state_dict)
    C, P = config.embed_dim, config.patch_size
    _check_variant(sd, config)

    conv_w = _to_numpy(sd["patch_embed.proj.weight"])  # [C, 3, P, P]
    if conv_w.shape != (C, config.in_chans, P, P):
        raise ValueError(f"patch_embed.proj.weight shape {conv_w.shape} does not match "
                         f"config {(C, config.in_chans, P, P)}")
    kernel = conv_w.transpose(2, 3, 1, 0).reshape(P * P * config.in_chans, C)

    pos_embed = _to_numpy(sd["pos_embed"])
    if pos_embed.shape[-1] != C or pos_embed.ndim != 3:
        raise ValueError(f"pos_embed shape {pos_embed.shape} incompatible with C={C}")
    if pos_embed.shape[1] != config.pos_embed_len:  # a checkpoint of another resolution
        pos_embed = resample_pos_embed(
            pos_embed, config.pos_embed_len,
            num_prefix=0 if config.no_embed_class else config.num_prefix_tokens,
        )

    params: dict = {
        "patch_embed": {"kernel": kernel, "bias": _to_numpy(sd["patch_embed.proj.bias"])},
        "cls_token": _to_numpy(sd["cls_token"]),
        "pos_embed": pos_embed,
        "blocks": [],
        "head": _dense(sd, "head"),
    }
    if config.fc_norm_resolved:
        params["fc_norm"] = _norm(sd, "fc_norm")
    else:
        params["norm"] = _norm(sd, "norm")
    if config.distilled:
        params["dist_token"] = _to_numpy(sd["dist_token"])
        params["head_dist"] = _dense(sd, "head_dist")
    if config.reg_tokens:
        reg = _to_numpy(sd["reg_token"])
        if reg.shape != (1, config.reg_tokens, C):
            raise ValueError(f"reg_token shape {reg.shape} != {(1, config.reg_tokens, C)}")
        params["reg_token"] = reg

    for i in range(config.depth):
        p = f"blocks.{i}"
        if f"{p}.norm1.weight" not in sd:
            raise KeyError(f"missing {p}.norm1.weight: checkpoint depth < {config.depth}")
        block = {
            "norm1": _norm(sd, f"{p}.norm1"),
            "attn": {"qkv": _dense(sd, f"{p}.attn.qkv"), "proj": _dense(sd, f"{p}.attn.proj")},
            "norm2": _norm(sd, f"{p}.norm2"),
            "mlp": {"fc1": _dense(sd, f"{p}.mlp.fc1"), "fc2": _dense(sd, f"{p}.mlp.fc2")},
        }
        if config.qk_norm:
            block["attn"]["q_norm"] = _norm(sd, f"{p}.attn.q_norm")
            block["attn"]["k_norm"] = _norm(sd, f"{p}.attn.k_norm")
        if f"{p}.ls1.gamma" in sd:
            block["ls1"] = _to_numpy(sd[f"{p}.ls1.gamma"])
            block["ls2"] = _to_numpy(sd[f"{p}.ls2.gamma"])
        params["blocks"].append(block)

    if f"blocks.{config.depth}.norm1.weight" in sd:
        raise ValueError(f"checkpoint has more than {config.depth} blocks — config mismatch")
    consumed = _consumed(config)
    leftover = sorted(k for k in sd if k not in consumed)
    if leftover:
        raise ValueError(
            "checkpoint contains weights this converter does not model "
            f"(would be silently dropped): {leftover[:8]}{' ...' if len(leftover) > 8 else ''}"
        )
    return _cast(params, dtype)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return np.asarray(tree, dtype=dtype)


def adapt_config(config: ViTConfig, state_dict: Mapping[str, Any]) -> ViTConfig:
    """The extended-variant flags read from a checkpoint's keys:
    ``attn.q_norm.*`` → ``qk_norm``; ``fc_norm.*`` → ``global_pool="avg"``,
    ``use_fc_norm``; ``reg_token`` → ``reg_tokens`` from its shape, with a
    patch-only pos-embed; ``dist_token``/``head_dist`` → ``distilled``.
    Without registers, the pos-embed's row count tells a patch-only table
    (a square) from a CLS-inclusive one (a square + 1)."""
    kw: dict[str, Any] = {}
    if any(".q_norm." in k for k in state_dict):
        kw["qk_norm"] = True
    if any(k.startswith("fc_norm.") for k in state_dict):
        kw["global_pool"] = "avg"
        kw["use_fc_norm"] = True
    if "reg_token" in state_dict:
        kw["reg_tokens"] = int(_to_numpy(state_dict["reg_token"]).shape[1])
        kw["no_embed_class"] = True
    if "dist_token" in state_dict or "head_dist.weight" in state_dict:
        kw["distilled"] = True
    cfg = dataclasses.replace(config, **kw) if kw else config

    if "pos_embed" in state_dict and not cfg.reg_tokens:
        rows = int(_to_numpy(state_dict["pos_embed"]).shape[1])

        def _square(v: int) -> bool:
            r = int(round(v**0.5))
            return r * r == v

        if _square(rows) and not _square(rows - 1):
            cfg = dataclasses.replace(cfg, no_embed_class=True)
        elif _square(rows - 1):
            cfg = dataclasses.replace(cfg, no_embed_class=False)
    return cfg


def load_torch_checkpoint(path: str) -> dict:
    """A ``.pth`` checkpoint as a flat numpy state_dict: a raw state_dict or
    one under ``"model"``, ``"state_dict"`` or ``"model_state_dict"``, a
    ``module.`` prefix stripped."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in ("model", "state_dict", "model_state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    sd = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        sd[k] = _to_numpy(v)
    return sd


def main(argv=None) -> None:
    """CLI: ``python -m rajni_tpu_torch.params.convert in.pth out.msgpack
    --model vit_base_patch16_224``; the msgpack loads in both packages."""
    import argparse

    from ..models.vit import get_config
    from .from_jax import params_from_numpy
    from .io import save_params

    p = argparse.ArgumentParser("timm checkpoint → rajni msgpack converter")
    p.add_argument("input", help="torch .pth checkpoint (timm state_dict)")
    p.add_argument("output", help="output .msgpack path")
    p.add_argument("--model", default="vit_base_patch16_224")
    args = p.parse_args(argv)

    sd = load_torch_checkpoint(args.input)
    tree = convert_timm_state_dict(sd, adapt_config(get_config(args.model), sd))
    save_params(args.output, params_from_numpy(tree))
    n = sum(a.size for a in _leaves(tree))
    print(f"converted {args.model}: {n / 1e6:.1f}M params -> {args.output}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
