"""Vision Transformer with RAJNI token pruning, in PyTorch.

Port of ``rajni_tpu/models/vit.py``. The model is a function over a plain
parameter dictionary (the counterpart of the JAX pytree); the schedule is a
per-block tuple, so every per-block token count is known before the
forward runs.

Parameter layout: linear weights are ``weight [out, in]`` as in
``nn.Linear`` (the JAX tree stores ``kernel [in, out]``);
``patch_embed.weight`` is ``[C, P·P·3]`` in ``(ph, pw, c)`` order; images
are NHWC ``[B, H, W, 3]``; packed QKV lanes are in ``(qkv, head, dim)``
order.

``impl`` selects the backend: ``"torch"`` is the plain ops path (the
counterpart of JAX's ``"xla"``); ``"cuda"`` routes every block through the
hand-written kernels (the counterpart of ``"pallas"``), whose wrappers fall
to their plain versions only for CPU tensors; ``"auto"`` is ``"cuda"`` on a
CUDA tensor and ``"torch"`` elsewhere. On the card, ``"cuda"`` demotes to
``"torch"`` where the kernels do not take the config or dtype
(:func:`cuda_kernels_take`), as JAX demotes ``"pallas"`` to ``"xla"``.

Int8 params (:func:`..quant.quantize_params`) run the int8 kernels on
``impl="cuda"`` (the whole-block B14/B15 where the JAX plans fit, else the
split kernels B9-B13), with calibrated static scales when
``act_scales`` is given, and an int8 head; ``impl="torch"`` dequantizes the
weights, as JAX's ``"xla"`` route does.

The extended timm variants run as in JAX: register and distillation
tokens (an always-kept prefix that is never ranked), a patch-only
position embedding (``no_embed_class``), qk-norm (in the attention and in
the scores' CLS row) and the pooled and distilled heads. The kernels take
those with one prefix token and no qk-norm (DeiT-3, pooled heads), since
the embedding and the head are outside them on every route
(:attr:`ViTConfig.kernel_path_supported`, JAX's rule); registers, the
distillation token and qk-norm run on ``"torch"``, as JAX demotes them to
XLA.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..kernels.block import (
    ATTN_MAX_N,
    C_MAX,
    C_MAX_BF16,
    fused_attn_block,
    fused_attn_block_int8,
    fused_gather_sdpa_proj_residual,
    fused_gather_sdpa_proj_residual_int8,
    fused_ln_qkv,
    fused_ln_qkv_int8,
    fused_pruned_attn_block,
    fused_pruned_attn_block_int8,
    int8_width_ok,
    select_kept,
)
from ..kernels.attention import HEAD_DIM, HEAD_DIMS, sdpa_max_n
from ..kernels.math import quantize_rows, quantize_static
from ..kernels.mlp import (
    _int8_mm,
    _layer_norm_f32,
    fused_ln_mlp_residual,
    fused_ln_mlp_residual_int8,
)
from ..kernels.wholeblock import (
    _attn_mlp_block_fits,
    _bf16_full_plan,
    _block_full_int8_plan,
    _gather_fits_fast,
    _pruned_block_fits,
    _pruned_full_int8_plan,
    fused_attn_mlp_block,
    fused_block_full_int8,
    fused_pruned_block_full,
    fused_pruned_block_full_int8,
    hopper_block_shape_ok,
)
from ..quant import ActScales, dequantize_weight, is_quantized
from ..ops.attention import attention, pruned_attention
from ..ops.pruning import gather_tokens, keep_count
from ..utils.schedule import Schedule, normalize_schedule, token_count_trace

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Static architecture config (same fields as the JAX package's)."""

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    use_layer_scale: bool = False
    layer_scale_init: float = 1e-5
    # extended timm variants: registers, DeiT's distillation token, a
    # patch-only pos-embed, qk-norm, pooled heads (JAX's fields and rules)
    reg_tokens: int = 0
    distilled: bool = False
    no_embed_class: bool = False
    qk_norm: bool = False
    global_pool: str = "token"
    use_fc_norm: bool | None = None

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_prefix_tokens(self) -> int:
        return 1 + int(self.distilled) + self.reg_tokens

    @property
    def num_tokens(self) -> int:
        return self.num_patches + self.num_prefix_tokens

    @property
    def pos_embed_len(self) -> int:
        return self.num_patches if self.no_embed_class else self.num_tokens

    @property
    def fc_norm_resolved(self) -> bool:
        if self.use_fc_norm is None:
            return self.global_pool == "avg"
        return self.use_fc_norm

    @property
    def kernel_path_supported(self) -> bool:
        """Whether the block kernels implement this config: one prefix token
        (CLS) and no qk-norm, JAX's rule. Pooled heads and a patch-only
        pos-embed are fine: the embedding and the head run outside the
        kernels on every route."""
        return self.num_prefix_tokens == 1 and not self.qk_norm

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def attn_scale(self) -> float:
        return self.head_dim**-0.5

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


VARIANTS: dict[str, ViTConfig] = {
    "vit_tiny_patch16_224": ViTConfig(embed_dim=192, depth=12, num_heads=3),
    "vit_small_patch16_224": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "deit_small_patch16_224": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "vit_base_patch16_224": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vit_base_patch16_384": ViTConfig(
        img_size=384, embed_dim=768, depth=12, num_heads=12
    ),
    "vit_large_patch16_224": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
    "vit_huge_patch14_224": ViTConfig(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16
    ),
    "vit_small_patch14_reg4_dinov2": ViTConfig(
        img_size=518, patch_size=14, embed_dim=384, depth=12, num_heads=6,
        reg_tokens=4, no_embed_class=True, use_layer_scale=True,
    ),
    "vit_base_patch14_reg4_dinov2": ViTConfig(
        img_size=518, patch_size=14, embed_dim=768, depth=12, num_heads=12,
        reg_tokens=4, no_embed_class=True, use_layer_scale=True,
    ),
    "vit_large_patch14_reg4_dinov2": ViTConfig(
        img_size=518, patch_size=14, embed_dim=1024, depth=24, num_heads=16,
        reg_tokens=4, no_embed_class=True, use_layer_scale=True,
    ),
}

# timm size word -> (embed_dim, depth, num_heads, mlp_ratio)
_SIZE_WORDS: dict[str, tuple[int, int, int, float]] = {
    "tiny": (192, 12, 3, 4.0),
    "small": (384, 12, 6, 4.0),
    "medium": (512, 12, 8, 4.0),
    "base": (768, 12, 12, 4.0),
    "large": (1024, 24, 16, 4.0),
    "huge": (1280, 32, 16, 4.0),
    "giant": (1408, 40, 16, 48 / 11),
    "gigantic": (1664, 48, 16, 64 / 13),
}


def _parse_model_name(name: str) -> ViTConfig | None:
    """``{vit|deit|deit3}_{size}[_distilled]_patch{P}[_reg{R}]_{res}`` →
    config, for names not in :data:`VARIANTS`."""
    m = re.fullmatch(
        r"(vit|deit|deit3)_([a-z]+)(_distilled)?_patch(\d+)(?:_reg(\d+))?_(\d+)",
        name,
    )
    if m is None or m.group(2) not in _SIZE_WORDS:
        return None
    dim, depth, heads, mlp_ratio = _SIZE_WORDS[m.group(2)]
    patch, img = int(m.group(4)), int(m.group(6))
    if img % patch:
        return None
    reg = int(m.group(5)) if m.group(5) else 0
    return ViTConfig(
        img_size=img, patch_size=patch, embed_dim=dim, depth=depth,
        num_heads=heads, mlp_ratio=mlp_ratio, reg_tokens=reg,
        distilled=m.group(3) is not None, no_embed_class=reg > 0,
        use_layer_scale=m.group(1) == "deit3",
    )


def get_config(name: str) -> ViTConfig:
    """Resolve a timm model name: registry first, then the name grammar."""
    if name in VARIANTS:
        return VARIANTS[name]
    parsed = _parse_model_name(name)
    if parsed is not None:
        return parsed
    raise ValueError(
        f"unknown model {name!r}; known: {sorted(VARIANTS)} or any "
        "'{vit|deit|deit3}_{size}_patch{P}[_reg{R}]_{res}' timm name"
    )


def adapt_config_to_params(config: ViTConfig, params: Params) -> ViTConfig:
    """The extended-variant flags read from a parameter tree's leaves (port
    of ``rajni_tpu/models/vit.py:adapt_config_to_params``): ``q_norm`` →
    ``qk_norm``; ``fc_norm`` without ``norm`` → ``global_pool="avg"``,
    ``use_fc_norm``; ``dist_token`` → ``distilled``; ``reg_token`` →
    ``reg_tokens`` with a patch-only pos-embed; without registers, a
    pos-embed of ``num_patches`` rows → ``no_embed_class``."""
    kw: dict[str, Any] = {}
    if params["blocks"] and "q_norm" in params["blocks"][0]["attn"]:
        kw["qk_norm"] = True
    if "fc_norm" in params and "norm" not in params:
        kw["global_pool"] = "avg"
        kw["use_fc_norm"] = True
    if "dist_token" in params:
        kw["distilled"] = True
    if "reg_token" in params:
        kw["reg_tokens"] = int(params["reg_token"].shape[1])
        kw["no_embed_class"] = True
    cfg = dataclasses.replace(config, **kw) if kw else config
    rows = int(params["pos_embed"].shape[1])
    if not cfg.reg_tokens and rows == cfg.num_patches != cfg.pos_embed_len:
        cfg = dataclasses.replace(cfg, no_embed_class=True)
    return cfg


# --------------------------------------------------------------------------
# Parameter init
# --------------------------------------------------------------------------


def init_params(
    generator: torch.Generator, config: ViTConfig, dtype=torch.float32,
    device="cpu",
) -> Params:
    """Random parameters (uniform ±1/sqrt(fan_in) linears, zero biases,
    N(0, 0.02) position embedding), drawn on the CPU from ``generator`` and
    moved to ``device``. The numbers differ from the JAX package's. The
    extended variants carry JAX's leaves: ``fc_norm`` in place of ``norm``
    for pooled heads, ``dist_token`` and ``head_dist``, ``reg_token``, and
    each block's ``q_norm``/``k_norm`` (over the head dim)."""
    C, Hd, P = config.embed_dim, config.mlp_hidden, config.patch_size

    def dense(fan_in, fan_out):
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.rand(fan_out, fan_in, generator=generator) * (2 * bound) - bound
        return {"weight": w, "bias": torch.zeros(fan_out)}

    def norm(n=C):
        return {"scale": torch.ones(n), "bias": torch.zeros(n)}

    params: Params = {
        "patch_embed": dense(P * P * config.in_chans, C),
        "cls_token": torch.zeros(1, 1, C),
        "pos_embed": torch.randn(1, config.pos_embed_len, C, generator=generator) * 0.02,
        "blocks": [],
        "head": dense(C, config.num_classes),
    }
    params["fc_norm" if config.fc_norm_resolved else "norm"] = norm()
    if config.distilled:
        params["dist_token"] = torch.zeros(1, 1, C)
        params["head_dist"] = dense(C, config.num_classes)
    if config.reg_tokens:
        params["reg_token"] = torch.zeros(1, config.reg_tokens, C)
    for _ in range(config.depth):
        block = {
            "norm1": norm(),
            "attn": {"qkv": dense(C, 3 * C), "proj": dense(C, C)},
            "norm2": norm(),
            "mlp": {"fc1": dense(C, Hd), "fc2": dense(Hd, C)},
        }
        if config.qk_norm:
            block["attn"]["q_norm"] = norm(config.head_dim)
            block["attn"]["k_norm"] = norm(config.head_dim)
        if config.use_layer_scale:
            block["ls1"] = torch.full((C,), config.layer_scale_init)
            block["ls2"] = torch.full((C,), config.layer_scale_init)
        params["blocks"].append(block)
    return tree_to(params, dtype=dtype, device=device)


def tree_to(tree, **kw):
    """Apply ``Tensor.to(**kw)`` to every tensor of a parameter tree
    (the result is contiguous, as the kernels require). An int8 record
    (:mod:`..quant`) only changes device: it stays int8 with fp32 scales."""
    if is_quantized(tree):
        kw = {k: v for k, v in kw.items() if k != "dtype"}
        return {k: v.to(**kw).contiguous() for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: tree_to(v, **kw) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, **kw) for v in tree]
    return tree.to(**kw).contiguous()


# --------------------------------------------------------------------------
# Building blocks
# --------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, params: Params, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics (biased variance, eps inside the
    sqrt), output in the input dtype."""
    y = _layer_norm_f32(x.float(), params["scale"], params["bias"], eps)
    return y.to(x.dtype)


def patch_embed(x: torch.Tensor, params: Params, config: ViTConfig) -> torch.Tensor:
    """Non-overlapping P×P patches + one matmul: NHWC ``[B, H, W, 3]`` →
    ``[B, N, C]`` in row-major (gh, gw) order."""
    B = x.shape[0]
    P, G = config.patch_size, config.grid_size
    x = x.reshape(B, G, P, G, P, config.in_chans).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, config.num_patches, P * P * config.in_chans)
    return x @ params["weight"].t() + params["bias"]


def mlp(x: torch.Tensor, params: Params) -> torch.Tensor:
    """Linear → exact (erf) GELU → Linear."""
    h = x @ params["fc1"]["weight"].t() + params["fc1"]["bias"]
    h = F.gelu(h, approximate="none")
    return h @ params["fc2"]["weight"].t() + params["fc2"]["bias"]


def _layer_scale(out: torch.Tensor, block: Params, name: str) -> torch.Tensor:
    return out * block[name] if name in block else out


def _mlp_branch(x: torch.Tensor, block: Params, config: ViTConfig, impl: str,
                act_scales: tuple[float, float] | None = None):
    """``x + ls2 * mlp(norm2(x))``; under ``impl="cuda"`` K3, or B9 with int8
    fc1/fc2 (``act_scales``: the static ``(a_fc1, a_fc2)``)."""
    eps = config.layer_norm_eps
    if impl == "cuda" and is_quantized(block["mlp"]["fc1"]["weight"]):
        return fused_ln_mlp_residual_int8(x, block["norm2"], block["mlp"], block.get("ls2"), eps,
                                          act_scales=act_scales)
    if impl == "cuda":
        return fused_ln_mlp_residual(x, block["norm2"], block["mlp"], block.get("ls2"), eps)
    out = mlp(layer_norm(x, block["norm2"], eps), block["mlp"])
    return x + _layer_scale(out, block, "ls2")


def stock_block(x: torch.Tensor, block: Params, config: ViTConfig) -> torch.Tensor:
    """Standard pre-norm block on the ops path (qk-norm where the block
    carries it)."""
    out = attention(
        layer_norm(x, block["norm1"], config.layer_norm_eps),
        block["attn"], config.num_heads, config.attn_scale,
        norm_eps=config.layer_norm_eps,
    )
    x = x + _layer_scale(out, block, "ls1")
    return _mlp_branch(x, block, config, "torch")


def embed_tokens(params: Params, images: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    """Patchify + prefix tokens (CLS, then the distillation token, then the
    registers) + position embedding → ``[B, N, C]``. Under
    ``no_embed_class`` the pos-embed covers the patches only and is added
    before the prefix is concatenated (timm's rule)."""
    B = images.shape[0]
    dtype = params["cls_token"].dtype
    x = patch_embed(images.to(dtype), params["patch_embed"], config)
    if config.no_embed_class:
        x = x + params["pos_embed"][:, : x.shape[1]]
    prefix = [params["cls_token"].expand(B, 1, config.embed_dim)]
    if config.distilled:
        prefix.append(params["dist_token"].expand(B, 1, config.embed_dim))
    if config.reg_tokens:
        prefix.append(params["reg_token"].expand(B, config.reg_tokens, config.embed_dim))
    x = torch.cat(prefix + [x], dim=1)
    if not config.no_embed_class:
        x = x + params["pos_embed"][:, : x.shape[1]]
    return x


# --------------------------------------------------------------------------
# Full forward
# --------------------------------------------------------------------------


def _dequantized(block: Params, dtype) -> Params:
    """The block with its int8 records dequantized to ``dtype`` (the ops
    path's weights, as JAX's ``_dequant_attn`` and ``_mlp_branch``)."""
    def lin(layer):
        w = layer["weight"]
        return {**layer, "weight": dequantize_weight(w, dtype)} if is_quantized(w) else layer

    return {**block, "attn": {k: lin(v) if k in ("qkv", "proj") else v
                              for k, v in block["attn"].items()},
            "mlp": {k: lin(v) for k, v in block["mlp"].items()}}


def cuda_kernels_take(config: ViTConfig, dtype: torch.dtype, quantized: bool = False,
                      training: bool = False) -> tuple[bool, str]:
    """Whether the CUDA kernels take this (config, activation dtype), for
    int8 params (``quantized``) or the training path (``training``): ``(ok,
    reason)``, the reason naming the first constraint that fails.

    The port's counterpart of ``rajni_tpu/models/vit.py:pallas_compilable``
    (with ``kernel_path_supported``): the kernels are written for bf16
    activations, C a multiple of 128 (hidden a multiple of 128), and for the
    classic configurations. The bf16 kernels take C <= 1280, head_dim 64 up
    to ``SDPA_MAX_N`` tokens and head_dim 80 (ViT-H/14) up to
    ``SDPA_MAX_N_D80`` (the score kernel takes both head_dims up to C =
    1280); the int8 kernels
    head_dim 64 with C <= 1024 or head_dim 80 at C = 1280 (ViT-H/14,
    :func:`..kernels.block.int8_width_ok`).
    The training kernels (B16 on K2's launches, B17, B18) take every width the
    bf16 inference kernels take, so ``training`` narrows nothing: JAX's
    training rules are VMEM fits (``train_kernels_supported``), which the
    port's kernels do not have. As JAX's rule holds only on the TPU, this one
    holds only on the card: the plain versions that the wrappers run on CPU
    tensors take any shape and dtype.
    """
    C, H = config.embed_dim, config.num_heads
    D = C / H
    if not config.kernel_path_supported:
        return False, "an extended timm variant"
    if dtype != torch.bfloat16:
        return False, f"{str(dtype).removeprefix('torch.')} activations (the kernels take bfloat16)"
    if C % 128:
        return False, f"C={C} is not a multiple of 128"
    if C > C_MAX_BF16:
        return False, f"C={C} > {C_MAX_BF16}"
    if D not in HEAD_DIMS:
        return False, f"head_dim {D:g} is not 64 or 80"
    if config.mlp_hidden % 128:
        return False, f"MLP hidden {config.mlp_hidden} is not a multiple of 128"
    if config.num_tokens > sdpa_max_n(int(D)):
        return False, f"{config.num_tokens} tokens > {sdpa_max_n(int(D))} at head_dim {D:g}"
    if quantized and not int8_width_ok(C, int(D)):
        return False, (f"int8 weights at C={C}, head_dim {D:g}: its kernels take head_dim "
                       f"{HEAD_DIM} with C <= {C_MAX} or head_dim 80 with C = {C_MAX_BF16}")
    return True, ""


def params_quantized(params: Params) -> bool:
    """Whether any block of ``params`` carries int8 weights
    (:func:`..quant.quantize_params`)."""
    return any(is_quantized(b[group][layer]["weight"]) for b in params["blocks"]
               for group, layer in (("attn", "qkv"), ("mlp", "fc1")))


def resolve_route(impl: str, config: ViTConfig, dtype: torch.dtype, device,
                  quantized: bool = False, training: bool = False) -> tuple[str, str]:
    """``(impl, reason)``: ``"auto"`` → ``"cuda"`` on a CUDA device,
    ``"torch"`` otherwise; then ``"cuda"`` on a CUDA device demotes to
    ``"torch"`` where :func:`cuda_kernels_take` fails for int8 params
    (``quantized``) or the training path (``training``), before any launch
    (the run stays on the same device, as JAX demotes to XLA,
    ``vit.py:684-692``). An extended variant the kernels do not implement
    demotes on every device, as JAX's does on every backend (the plain
    versions on the CPU implement the kernels' semantics, one prefix token
    and no qk-norm). ``device`` may be the target platform's name
    (``"cuda"``, ``"cpu"``): no card is needed to resolve a route.
    ``reason`` says why a demoted route was taken ("" otherwise)."""
    if impl not in ("torch", "cuda", "auto"):
        raise ValueError(f"unknown impl {impl!r}; use 'torch', 'cuda' or 'auto'")
    on_card = torch.device(device).type == "cuda"
    if impl == "auto":
        impl = "cuda" if on_card else "torch"
    if impl == "cuda" and not config.kernel_path_supported:
        return "torch", "an extended timm variant"
    if impl == "cuda" and on_card:
        ok, why = cuda_kernels_take(config, dtype, quantized, training)
        if not ok:
            return "torch", why
    return impl, ""


def route_line(impl: str, reason: str) -> str:
    """The route as the entry points print it: ``route: torch (C=192 is not
    a multiple of 128)``."""
    return f"route: {impl}" + (f" ({reason})" if reason else "")


def vit_forward(
    params: Params,
    images: torch.Tensor,
    config: ViTConfig,
    schedule: Schedule | None = None,
    impl: str = "torch",
    act_scales: ActScales | None = None,
    _sel_tap: Callable[[int, torch.Tensor], None] | None = None,
) -> torch.Tensor:
    """Pruned ViT forward: ``[B, H, W, 3] -> [B, num_classes]`` logits.

    Not under ``torch.no_grad()``: on ``impl="torch"`` with params that
    require grad it is the differentiable reference of the training path
    (the inference entry points, ``RAJNIViT`` and the CLIs, disable
    autograd themselves). ``impl`` goes through :func:`resolve_route`.

    On ``impl="cuda"`` the blocks are routed where ``rajni_tpu/models/
    vit.py:749-1046`` routes them, by the JAX fit rules (copied in
    ``kernels/wholeblock.py`` and ``kernels/mlp.py``). A pruned block
    rescores iff ``spec.update or scores is None``.

    * Int8 attention and MLP: a pruned block runs B14
      ``fused_pruned_block_full_int8`` where ``_pruned_full_int8_plan`` has a
      plan, a stock block B15 ``fused_block_full_int8`` where
      ``_block_full_int8_plan`` has one (ViT-B/224 and DeiT-S: every block;
      ViT-B/384: blocks 8-11, at 356 tokens).
    * Otherwise, int8 attention: a stock block runs B10
      ``fused_attn_block_int8``. A pruned block where ``_pruned_block_fits``
      holds takes JAX's one-kernel route, B11
      ``fused_pruned_attn_block_int8`` (ViT-L/16 224 blocks 4, 8, 12 and 16
      under ``VIT_L_AGGRESSIVE``; DeiT-S/16 384 block 3), given the static
      ``(a_qkv, a_proj)`` unconditionally since its own proj undoes the
      V-column fold (``vit.py:810-831``). Elsewhere it
      runs B12 ``fused_ln_qkv_int8``, the selection (``select_kept``: on the
      card ``csrc/select.cu``, exact) and a tail chosen before B12 runs (``vit.py:863-870``): B13
      ``fused_gather_sdpa_proj_residual_int8`` where ``_gather_fits_fast``
      holds, with B12 given the static ``(a_qkv, a_proj)`` (the V-column
      fold); else the bf16 B5 on the proj weight dequantized to bf16, with
      B12 given no scales, since B5 does not undo the fold (ViT-B/384
      blocks 3-5 take B5, 6-7 B13; ViT-H/14 under ``VIT_H_PROBE``: B10 in
      the 28 stock blocks, B12 + selection + B13 in the 4 pruned ones, no
      whole-block plan fitting at C = 1280).
    * bf16 attention and MLP: B7 ``fused_pruned_block_full`` / B8
      ``fused_attn_mlp_block`` where ``_bf16_full_plan`` fits (DeiT-S
      class) and the CUDA kernels take the shape (C % 128 == 0, head_dim
      64: narrower test widths keep the split kernels, which compute the
      same function).
    * Otherwise bf16 attention (MLP-only int8 too): a pruned block through
      K1 up to ``ATTN_MAX_N`` tokens, and past that through the two-kernel
      route of ``vit.py:867-928`` (B4 ``fused_ln_qkv``, ``select_kept``, B5
      ``fused_gather_sdpa_proj_residual``); a
      stock block through K2.
    * Every split MLP half: K3, or B9 ``fused_ln_mlp_residual_int8`` with
      int8 fc1/fc2 (the static ``(a_fc1, a_fc2)``).

    The residual stream is compacted before the residual add, and a stock
    block resets the threaded scores. ``act_scales`` (calibrated static
    int8 scales, :func:`..quant.calibrate_act_scales`) applies to int8
    params on ``impl="cuda"`` only; ``impl="torch"`` dequantizes the
    weights and quantizes the head dynamically, as JAX's ``"xla"`` route.
    The int8 attention kernels read their operands made for those scales
    (or dynamic ones) where ``params`` carry them attached
    (:func:`..quant.attach_act_scales`, which ``RAJNIViT`` runs), and make
    them on each call where not.

    ``_sel_tap(block_idx, keep_idx)`` receives each pruned block's kept
    token indices (a capture hook for tests and debugging).
    """
    schedule = normalize_schedule(schedule, config.depth)
    impl, _ = resolve_route(impl, config, params["cls_token"].dtype, images.device,
                            params_quantized(params))
    eps = config.layer_norm_eps
    C, H, scale = config.embed_dim, config.num_heads, config.attn_scale
    n_prefix = config.num_prefix_tokens  # 1 on "cuda" (kernel_path_supported)
    x = embed_tokens(params, images, config)

    scores: torch.Tensor | None = None
    for blk_i, (spec, block) in enumerate(zip(schedule, params["blocks"])):
        attn_q = is_quantized(block["attn"]["qkv"]["weight"])
        mlp_q = is_quantized(block["mlp"]["fc1"]["weight"])
        if impl == "torch" and (attn_q or mlp_q):
            block = _dequantized(block, x.dtype)
        n, itemsize, hidden = x.shape[1], x.element_size(), _hidden(block)
        blk_as = None if act_scales is None else act_scales.block(blk_i)
        mlp_as = None if blk_as is None else blk_as[2:4]
        cuda = impl == "cuda"
        if spec is not None:
            keep = keep_count(spec.keep_ratio, n, n_prefix)
            K = keep + n_prefix
            with_scores = spec.update or scores is None
            if cuda and attn_q and mlp_q and _pruned_full_int8_plan(n, K, C, hidden, itemsize):
                x, scores, keep_idx = fused_pruned_block_full_int8(
                    x, block, scores, H, keep, scale, eps, with_scores, blk_as)
            elif (cuda and not (attn_q or mlp_q) and _bf16_full_plan(n, K, C, hidden, itemsize)
                  and hopper_block_shape_ok(n, C, H, hidden, pruned=True)):
                x, scores, keep_idx = fused_pruned_block_full(
                    x, block, scores, H, keep, scale, eps, with_scores)
            else:
                x, scores, keep_idx = _pruned_halves(
                    x, block, config, impl, spec, keep, scores, with_scores, blk_as)
            if _sel_tap is not None:
                _sel_tap(blk_i, keep_idx)
            continue
        scores = None
        if cuda and attn_q and mlp_q and _block_full_int8_plan(n, C, hidden, itemsize):
            x = fused_block_full_int8(x, block, H, scale, eps, blk_as)
        elif (cuda and not (attn_q or mlp_q) and _attn_mlp_block_fits(n, C, hidden, itemsize)
              and hopper_block_shape_ok(n, C, H, hidden, pruned=False)):
            x = fused_attn_mlp_block(x, block, H, scale, eps)
        elif cuda:
            if attn_q:
                x = fused_attn_block_int8(x, block["norm1"], block["attn"], block.get("ls1"), H,
                                          scale, eps, None if blk_as is None else blk_as[:2])
            else:
                x = fused_attn_block(x, block["norm1"], block["attn"], block.get("ls1"), H,
                                     scale, eps)
            x = _mlp_branch(x, block, config, impl, mlp_as)
        else:
            x = stock_block(x, block, config)
    return classifier_head(x, params, config, act_scales, impl)


def _pruned_halves(x, block: Params, config: ViTConfig, impl: str, spec, keep: int,
                   scores, with_scores: bool, blk_as):
    """A pruned block as its attention half, then its MLP half (the routes
    of :func:`vit_forward` without a whole-block kernel). Returns ``(x,
    next_scores, keep_idx)``."""
    eps, H, scale = config.layer_norm_eps, config.num_heads, config.attn_scale
    C, n, K, itemsize = config.embed_dim, x.shape[1], keep + 1, x.element_size()
    attn_as, mlp_as = (None, None) if blk_as is None else (blk_as[:2], blk_as[2:4])
    if impl == "cuda" and is_quantized(block["attn"]["qkv"]["weight"]):
        if _pruned_block_fits(n, K, C, itemsize):
            x, scores, keep_idx = fused_pruned_attn_block_int8(
                x, block["norm1"], block["attn"], block.get("ls1"), scores, H, keep, scale, eps,
                with_scores, attn_as,
            )
            return _mlp_branch(x, block, config, impl, mlp_as), scores, keep_idx
        # the V-column fold is undone only by the int8 tail: decide the tail
        # before B12 runs (rajni_tpu/models/vit.py:863-870)
        int8_tail = _gather_fits_fast(n, K, C, itemsize)
        qkv, new_scores = fused_ln_qkv_int8(
            x, block["norm1"], block["attn"]["qkv"], H, eps, with_scores,
            attn_as if int8_tail else None,
        )
    elif impl == "cuda" and n > ATTN_MAX_N:
        qkv, new_scores = fused_ln_qkv(x, block["norm1"], block["attn"]["qkv"], H, eps,
                                       with_scores)
        int8_tail = None
    elif impl == "cuda":
        x, scores, keep_idx = fused_pruned_attn_block(
            x, block["norm1"], block["attn"], block.get("ls1"), scores, H, keep, scale, eps,
            with_scores,
        )
        qkv = None
    else:
        out, keep_idx, scores = pruned_attention(
            layer_norm(x, block["norm1"], eps), block["attn"], H, scale, keep, spec.update,
            scores, num_prefix=config.num_prefix_tokens, norm_eps=eps,
        )
        # residual-stream compaction BEFORE the residual add
        x = gather_tokens(x, keep_idx) + _layer_scale(out, block, "ls1")
        qkv = None
    if qkv is not None:  # the two-kernel route: B4 or B12, selection, tail
        if with_scores:
            scores = new_scores
        keep_idx, scores = select_kept(scores, keep)
        if int8_tail:
            x = fused_gather_sdpa_proj_residual_int8(
                qkv, keep_idx, x, block["attn"]["proj"], block.get("ls1"), H, scale,
                None if blk_as is None else blk_as[1],
            )
        else:
            proj = block["attn"]["proj"]
            if int8_tail is not None:  # int8 weights, bf16 tail
                proj = {**proj, "weight": dequantize_weight(proj["weight"], x.dtype)}
            x = fused_gather_sdpa_proj_residual(qkv, keep_idx, x, proj, block.get("ls1"), H,
                                                scale)
    return _mlp_branch(x, block, config, impl, mlp_as), scores, keep_idx


def _hidden(block: Params) -> int:
    w = block["mlp"]["fc1"]["weight"]
    return (w["int8"] if is_quantized(w) else w).shape[0]


def classifier_head(x: torch.Tensor, params: Params, config: ViTConfig,
                    act_scales: ActScales | None = None, impl: str = "torch") -> torch.Tensor:
    """Final norm, pooling and head (``rajni_tpu/models/vit.py:
    classifier_head``; plain torch on every route, as JAX's is plain XLA).

    * ``token`` (the classic head): ``norm`` on the CLS row, then its head.
    * distilled (DeiT): ``norm`` on the CLS and distillation rows, the mean
      of their two heads, ``(cls + dist) · 0.5`` in the logits' dtype.
    * ``avg`` with ``fc_norm``: the mean of the kept patch tokens (prefix
      excluded) in fp32, cast back, then ``fc_norm``; ``avg`` without it:
      ``norm`` over the sequence, then the patch mean. The mean divides the
      fp32 sum by the count as a tensor, as JAX divides (on CUDA ``tensor /
      python_float`` is a reciprocal multiply).
    """
    eps = config.layer_norm_eps
    n_prefix = config.num_prefix_tokens
    if config.distilled:
        y = layer_norm(x[:, 0:2], params["norm"], eps)
        cls_logits = _head_matmul(y[:, 0], params["head"], act_scales, impl)
        # the static head scale is the CLS feature's: the dist head stays dynamic
        dist_logits = _head_matmul(y[:, 1], params["head_dist"], None, impl)
        return ((cls_logits + dist_logits) * 0.5).to(cls_logits.dtype)
    if config.fc_norm_resolved:
        pooled = _patch_mean(x, n_prefix) if config.global_pool == "avg" else x[:, 0]
        feat = layer_norm(pooled, params["fc_norm"], eps)
    elif config.global_pool == "avg":
        feat = _patch_mean(layer_norm(x, params["norm"], eps), n_prefix)
    else:
        feat = layer_norm(x[:, 0:1], params["norm"], eps)[:, 0]
    return _head_matmul(feat, params["head"], act_scales, impl)


def _patch_mean(x: torch.Tensor, n_prefix: int) -> torch.Tensor:
    """The fp32 mean over the patch tokens ``x[:, n_prefix:]``, cast back
    to ``x``'s dtype (JAX's ``jnp.mean(..., dtype=float32)``)."""
    s = x[:, n_prefix:].float().sum(dim=1)
    return (s / torch.full_like(s[:, :1], x.shape[1] - n_prefix)).to(x.dtype)


def _head_matmul(feat: torch.Tensor, head: Params, act_scales: ActScales | None = None,
                 impl: str = "torch") -> torch.Tensor:
    """``[B, C]`` features through one head. An int8 head
    (``rajni_tpu/models/vit.py:_head_matmul``) is the feature quantized per
    row (or, with ``act_scales`` on ``impl="cuda"`` only, with the static
    head scale), an exact int8 product (float64), dequantized as ``acc · a ·
    w_scale + bias``."""
    if not is_quantized(head["weight"]):
        return feat @ head["weight"].t() + head["bias"]
    f32 = feat.float()
    if act_scales is not None and impl == "cuda":
        a = act_scales.head
        y_q = quantize_static(f32, 1.0 / a)
    else:
        y_q, a = quantize_rows(f32)
    logits = _int8_mm(y_q, head["weight"]["int8"]) * a * head["weight"]["scale"]
    return (logits + head["bias"].float()).to(feat.dtype)


def model_stats(config: ViTConfig, schedule: Schedule | None = None) -> dict:
    """Per-block entry token counts (the reference's ``get_last_stats``)."""
    schedule = normalize_schedule(schedule, config.depth)
    return {
        "token_counts": token_count_trace(
            config.num_tokens, schedule, config.num_prefix_tokens
        )
    }
