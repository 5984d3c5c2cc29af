"""Data and Megatron tensor parallelism over ``torch.distributed`` (port of
``rajni_tpu/parallel/mesh.py``).

JAX drives every device from one process and names a ``(data, model)``
device mesh; here each device slot is a process (a rank) and :class:`Mesh`
is this rank's place in the same grid, ``("data", "model")``, with one
process group per axis line. Rank ``r`` sits at ``(r // model, r % model)``,
as JAX reshapes its device list.

* **Data parallelism**: a forward takes the global batch on every rank (JAX's
  ``apply`` takes the global batch too), zero-pads it to a multiple of the
  data axis, runs this rank's rows, and gathers the logits over ``data``.
* **Tensor parallelism** (Megatron): each rank of a ``model`` line holds its
  slice of every block (:func:`shard_params`: QKV head-aligned and fc1 by
  output rows, proj and fc2 by input columns, int8 records with their
  per-channel scales), so each block is one column-parallel product, local
  attention and GELU, and one row-parallel product whose partial sums are
  all-reduced over ``model``. :func:`tp_forward` runs JAX's
  ``tp_pallas_forward`` sequence on the hand-written kernels' shard forms
  (``impl="cuda"``; on CPU tensors their plain versions) and the plain-ops
  decomposition of :func:`_tp_block` on ``impl="torch"`` (JAX's XLA route).

Collectives: ``all_reduce`` runs on the device (NCCL, or gloo, whose CUDA
support is ``broadcast`` and ``all_reduce``); gathers and point-to-point
copies go through host tensors where the backend is gloo.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.attention import fused_sdpa
from ..kernels.block import (
    fused_gather_sdpa_proj_residual,
    fused_gather_sdpa_proj_residual_int8,
    fused_ln_qkv,
    fused_ln_qkv_int8,
    select_kept,
)
from ..kernels.gemm import I8_PARTIAL, gemm_s8
from ..kernels.math import quantize_rows, quantize_static
from ..kernels.mlp import _mm, fused_ln_mlp_residual, fused_ln_mlp_residual_int8
from ..kernels.wholeblock import _gather_fits_fast
from ..models.vit import (
    ViTConfig,
    _dequantized,
    _layer_scale,
    classifier_head,
    embed_tokens,
    layer_norm,
    params_quantized,
    resolve_route,
    tree_to,
    vit_forward,
)
from ..ops.attention import _sdpa
from ..ops.importance import importance_from_partials, importance_partials
from ..ops.pruning import gather_tokens, keep_count, select_tokens
from ..quant import ActScales, attach_act_scales, dequantize_weight, is_quantized
from ..utils.schedule import Schedule, normalize_schedule

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# The rank grid
# ---------------------------------------------------------------------------


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a grid of ranks: ``shape`` (axis → size, in the
    grid's order), ``coords`` (axis → this rank's index), ``ranks`` (axis →
    the global ranks of the line through this rank along the axis),
    ``groups`` (axis → that line's process group, None for a line of one
    rank) and ``device``, this rank's device."""

    shape: dict
    coords: dict
    ranks: dict
    groups: dict
    device: torch.device

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)


def grid_mesh(names: tuple[str, ...], sizes: tuple[int, ...], device) -> Mesh:
    """The mesh of this process group's ranks as a grid ``sizes`` named
    ``names`` (row-major: the last axis varies fastest). Every rank creates
    every line's group, in the same order, as ``dist.new_group`` requires."""
    n, r = world_size(), world_rank()
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} != {n} ranks")
    grid = np.arange(n).reshape(sizes)
    coords = {a: int(c) for a, c in zip(names, np.unravel_index(r, sizes))}
    ranks, groups = {}, {}
    for i, name in enumerate(names):
        for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            line = [int(v) for v in line]
            group = dist.new_group(line) if n > 1 and sizes[i] > 1 else None
            if r in line:
                ranks[name], groups[name] = line, group
    return Mesh(dict(zip(names, sizes)), coords, ranks, groups, torch.device(device))


def default_device() -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` (the
    entry points run on the card unless the caller passes a CPU device)."""
    from .launch import rank_device

    return rank_device("cuda")


def make_mesh(data: int | None = None, model: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh over every rank of the process group (one
    rank when none is initialized); ``data`` defaults to the ranks left by
    ``model``."""
    n = world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return grid_mesh(("data", "model"), (data, model),
                     default_device() if device is None else device)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over the ``axis`` line (in place; ``t`` itself on a
    line of one rank)."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in the
    ``axis`` line's order, on ``t``'s device; through host tensors on gloo."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    src = t.detach().contiguous()
    if src.is_cuda and _gloo(group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str, index: int) -> torch.Tensor:
    """``t`` of the rank at ``index`` on the ``axis`` line, on every rank of
    the line (in place)."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    t = t.contiguous()
    dist.broadcast(t, src=mesh.ranks[axis][index], group=group)
    return t


# ---------------------------------------------------------------------------
# Parameters: the head-aligned QKV layout and each model rank's slice
# ---------------------------------------------------------------------------


def _record(w) -> dict:
    """An int8 record's payload and scale (attached kernel operands are
    made for one layout and dropped)."""
    return {"int8": w["int8"], "scale": w["scale"]}


def repack_qkv_heads(params: Params) -> Params:
    """Head-aligned TP layout of the packed QKV weights
    (``rajni_tpu/parallel/mesh.py:repack_qkv_heads``): ``weight [3C, C]`` →
    ``[3, C, C]`` (the ``(q|k|v, out, in)`` order), ``bias [3C]`` → ``[3,
    C]``, int8 records likewise (``scale [3C]`` → ``[3, C]``), so that a
    slice of the output axis is whole heads of q, k and v. A reshape: element
    order is unchanged."""

    def repack(block):
        qkv = dict(block["attn"]["qkv"])
        w = qkv["weight"]
        if is_quantized(w):
            if w["int8"].dim() == 2:
                C = w["int8"].shape[1]
                qkv["weight"] = {"int8": w["int8"].reshape(3, -1, C),
                                 "scale": w["scale"].reshape(3, -1)}
        elif w.dim() == 2:
            qkv["weight"] = w.reshape(3, -1, w.shape[1])
        if qkv["bias"].dim() == 1:
            qkv["bias"] = qkv["bias"].reshape(3, -1)
        return {**block, "attn": {**block["attn"], "qkv": qkv}}

    return {**params, "blocks": [repack(b) for b in params["blocks"]]}


def unrepack_qkv_heads(params: Params) -> Params:
    """Inverse of :func:`repack_qkv_heads`: back to ``[3C, C]`` / ``[3C]``."""

    def unrepack(block):
        qkv = dict(block["attn"]["qkv"])
        w = qkv["weight"]
        if is_quantized(w):
            if w["int8"].dim() == 3:
                qkv["weight"] = {"int8": w["int8"].reshape(-1, w["int8"].shape[-1]),
                                 "scale": w["scale"].reshape(-1)}
        elif w.dim() == 3:
            qkv["weight"] = w.reshape(-1, w.shape[-1])
        if qkv["bias"].dim() == 2:
            qkv["bias"] = qkv["bias"].reshape(-1)
        return {**block, "attn": {**block["attn"], "qkv": qkv}}

    return {**params, "blocks": [unrepack(b) for b in params["blocks"]]}


def _maybe_quantized_spec(weight, spec: tuple, out_sharded: bool):
    """``spec`` (an axis name or None per dim) for a plain weight; for an
    int8 record, the payload's ``spec`` and a scale that follows the output
    axis: sharded with it (its last dim), else replicated."""
    if not is_quantized(weight):
        return spec
    nd = weight["scale"].dim()
    return {"int8": spec, "scale": (None,) * (nd - 1) + ("model",) if out_sharded else ()}


def param_pspecs(params: Params) -> Params:
    """The tree of ``params`` with, for each tensor, its partition spec in
    the port's ``[out, in]`` layout (JAX's ``param_pspecs``): a tuple naming
    ``"model"`` on the sharded dim, ``()`` where replicated. QKV
    (head-aligned ``[3, C, C]`` when repacked) and fc1 shard their output
    rows with their biases; proj and fc2 their input columns, biases
    replicated; norms, embeddings, the head and the variants' leaves are
    replicated."""
    rep = lambda t: ()  # noqa: E731

    def block_spec(block):
        qkv_w = block["attn"]["qkv"]["weight"]
        nd = (qkv_w["int8"] if is_quantized(qkv_w) else qkv_w).dim()
        attn = {
            "qkv": {"weight": _maybe_quantized_spec(
                        qkv_w, (None, "model", None) if nd == 3 else ("model", None), True),
                    "bias": (None, "model") if block["attn"]["qkv"]["bias"].dim() == 2
                    else ("model",)},
            "proj": {"weight": _maybe_quantized_spec(block["attn"]["proj"]["weight"],
                                                     (None, "model"), False),
                     "bias": ()},
        }
        for key in ("q_norm", "k_norm"):  # per-head-dim norms: every shard applies them
            if key in block["attn"]:
                attn[key] = {"scale": (), "bias": ()}
        spec = {
            "norm1": {"scale": (), "bias": ()},
            "norm2": {"scale": (), "bias": ()},
            "attn": attn,
            "mlp": {
                "fc1": {"weight": _maybe_quantized_spec(block["mlp"]["fc1"]["weight"],
                                                        ("model", None), True),
                        "bias": ("model",)},
                "fc2": {"weight": _maybe_quantized_spec(block["mlp"]["fc2"]["weight"],
                                                        (None, "model"), False),
                        "bias": ()},
            },
        }
        for key in ("ls1", "ls2"):
            if key in block:
                spec[key] = ()
        return spec

    out = {k: _tree_map(rep, params[k]) for k in params if k != "blocks"}
    out["blocks"] = [block_spec(b) for b in params["blocks"]]
    return out


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (dicts and lists), with the
    matching leaves of the trees ``rest`` (which may hold tuples as
    leaves: the specs)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def shard_leaf(t: torch.Tensor, spec: tuple, index: int, parts: int) -> torch.Tensor:
    """Rank ``index``'s contiguous slice of ``t`` on each dim ``spec`` names
    ``"model"`` (of ``parts`` equal slices)."""
    for dim, axis in enumerate(spec):
        if axis == "model":
            n = t.shape[dim]
            if n % parts:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} not divisible by model={parts}")
            t = t.narrow(dim, index * (n // parts), n // parts)
    return t.contiguous()


def _strip_attached(tree):
    """``tree`` without the int8 records' attached kernel operands (made for
    the full width; a shard's are made on each call)."""
    if isinstance(tree, dict):
        if is_quantized(tree):
            return _record(tree)
        return {k: _strip_attached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_strip_attached(v) for v in tree]
    return tree


def shard_params(params: Params, mesh: Mesh) -> Params:
    """This rank's slice of every leaf of ``params`` for the ``model`` axis
    (JAX's ``shard_params``, written as one rank's slice): with ``model >
    1`` the QKV weights are repacked head-aligned first
    (:func:`repack_qkv_heads`), so the local QKV is ``[3, C/tp, C]``."""
    tp = mesh.size("model")
    params = _strip_attached(params)
    if tp == 1:
        return params
    params = repack_qkv_heads(params)
    idx = mesh.coord("model")
    return _tree_map(lambda t, s: shard_leaf(t, s, idx, tp), params, param_pspecs(params))


def local_qkv(qkv: Params) -> Params:
    """A shard's repacked QKV layer as the kernels take it: weight ``[3, C_l,
    C]`` → ``[3C_l, C]`` (the local ``(q|k|v, head, dim)`` packing), bias
    ``[3C_l]``."""
    w = qkv["weight"]
    if is_quantized(w):
        w = {"int8": w["int8"].reshape(-1, w["int8"].shape[-1]), "scale": w["scale"].reshape(-1)}
    else:
        w = w.reshape(-1, w.shape[-1])
    return {"weight": w, "bias": qkv["bias"].reshape(-1)}


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def _pad_batch(images, n_data: int):
    """Zero-pad the batch to a multiple of the data axis: ``(padded,
    real_batch)``; a tuple batch (the canvas tier) pads every leaf. numpy
    arrays or tensors (a tensor stays on its device)."""
    if isinstance(images, tuple):
        b = images[0].shape[0]
        return tuple(_pad_batch(e, n_data)[0] for e in images), b
    b = images.shape[0]
    pad = (-b) % n_data
    if pad == 0:
        return images, b
    if isinstance(images, torch.Tensor):
        zeros = images.new_zeros((pad,) + tuple(images.shape[1:]))
        return torch.cat([images, zeros]), b
    images = np.asarray(images)
    return np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)]), b


def data_rows(images, mesh: Mesh):
    """This rank's rows of a (padded) global batch: the ``data``
    coordinate's contiguous slice (every leaf of a tuple batch)."""
    if isinstance(images, tuple):
        return tuple(data_rows(e, mesh) for e in images)
    n = mesh.size("data")
    b = images.shape[0] // n
    return images[mesh.coord("data") * b:(mesh.coord("data") + 1) * b]


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def tp_width_reason(config: ViTConfig, tp: int) -> str:
    """Why the kernels' shard forms do not take ``config`` at ``tp`` ranks
    (``""`` when they do): a shard is ``C/tp`` columns of whole heads and
    ``hidden/tp`` hidden rows, each a multiple of 128 (the wgmma GEMM's and
    the int8 GEMM's tiles, the attention's widths)."""
    C, hidden = config.embed_dim, config.mlp_hidden
    if (C // tp) % 128:
        return f"C/tp = {C}/{tp} = {C // tp} is not a multiple of 128"
    if (hidden // tp) % 128:
        return f"MLP hidden/tp = {hidden}/{tp} = {hidden // tp} is not a multiple of 128"
    return ""


def check_tp(config: ViTConfig, tp: int) -> None:
    """JAX's refusals: ``tp`` must divide the heads and the MLP hidden."""
    if config.num_heads % tp:
        raise ValueError(f"model axis {tp} must divide num_heads={config.num_heads}")
    if config.mlp_hidden % tp:
        raise ValueError(f"model axis {tp} must divide mlp_hidden={config.mlp_hidden}")


def resolve_tp_route(impl: str, config: ViTConfig, dtype: torch.dtype, device, tp: int,
                     quantized: bool = False) -> tuple[str, str]:
    """``(impl, reason)`` of a forward over ``tp`` model ranks:
    :func:`..models.vit.resolve_route`, then on the card, where the kernels'
    shard forms do not take the widths (:func:`tp_width_reason`),
    ``"auto"`` demotes to ``"torch"`` with the reason and ``"cuda"`` raises
    ``ValueError``."""
    if tp > 1:
        check_tp(config, tp)
    asked = impl
    impl, reason = resolve_route(impl, config, dtype, device, quantized)
    if impl == "cuda" and tp > 1 and torch.device(device).type == "cuda":
        why = tp_width_reason(config, tp)
        if why:
            if asked == "cuda":
                raise ValueError(f"the CUDA kernels do not take tensor_parallel={tp}: {why}")
            return "torch", f"tensor_parallel={tp}: {why}"
    return impl, reason


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


def _tp_block(x, scores, block, spec, config: ViTConfig, mesh: Mesh, dpm=None):
    """One block with Megatron TP over ``model`` on the plain ops
    (``rajni_tpu/parallel/pipeline.py:_tp_block``; the torch route of
    :func:`tp_forward` and the pipeline's TP stages): head-aligned
    column-parallel QKV, the scores from all-reduced local-head partials,
    the replicated selection (the prefix kept), local-head SDPA (qk-norm
    where the block carries it), row-parallel proj all-reduced in fp32, the
    same for the MLP. ``block`` is this rank's shard (:func:`shard_params`).
    ``dpm``: drop-path masks scaling each branch."""
    tp = mesh.size("model")
    H_l, eps, dtype = config.num_heads // tp, config.layer_norm_eps, x.dtype
    attn = block["attn"]
    qk = (attn, eps) if "q_norm" in attn else None
    qkv = local_qkv(attn["qkv"])
    qkv_l = layer_norm(x, block["norm1"], eps) @ qkv["weight"].t() + qkv["bias"]
    if spec is not None:
        if spec.update or scores is None:
            a_s, v_s = importance_partials(qkv_l, H_l, qk_norm=qk)
            scores = importance_from_partials(all_reduce(a_s, mesh, "model"),
                                              all_reduce(v_s, mesh, "model"), config.num_heads)
        n_prefix = config.num_prefix_tokens
        keep_idx = select_tokens(scores, keep_count(spec.keep_ratio, x.shape[1], n_prefix),
                                 n_prefix)
        qkv_l = gather_tokens(qkv_l, keep_idx)
        x = gather_tokens(x, keep_idx)  # compaction before the residual add
        scores = torch.take_along_dim(scores, keep_idx, dim=1)
    else:
        scores = None  # a stock block resets the scores
    out_l = _sdpa(qkv_l, H_l, config.attn_scale, qk)
    out = all_reduce(_mm(out_l, attn["proj"]["weight"]), mesh, "model") + attn["proj"]["bias"]
    out = _layer_scale(out, block, "ls1")
    if dpm is not None:
        out = out * dpm[0]
    x = (x.float() + out).to(dtype)
    m = block["mlp"]
    h = layer_norm(x, block["norm2"], eps) @ m["fc1"]["weight"].t() + m["fc1"]["bias"]
    h = torch.nn.functional.gelu(h, approximate="none")
    out = all_reduce(_mm(h, m["fc2"]["weight"]), mesh, "model") + m["fc2"]["bias"]
    out = _layer_scale(out, block, "ls2")
    if dpm is not None:
        out = out * dpm[1]
    return (x.float() + out).to(dtype), scores


def tp_int8_tail(quantized: bool, spec, n_in: int, C_l: int, C: int, itemsize: int) -> bool:
    """Whether a TP block's int8 attention takes the int8 tail (B13) or, on
    a pruned block whose int8 gather tail does not fit, the dequantized bf16
    tail (B5), decided before its QKV producer runs (B12 folds ``1/a_proj``
    into V only for B13): ``rajni_tpu/parallel/mesh.py:505-520``, JAX's fit
    rule copied (``kernels/wholeblock.py:_gather_fits_fast``)."""
    return quantized and (spec is None or _gather_fits_fast(
        n_in, keep_count(spec.keep_ratio, n_in) + 1, max(C_l, C), itemsize))


def _tp_kernel_block(x, scores, blk_i, block, spec, config: ViTConfig, mesh: Mesh,
                     act_scales: ActScales | None, sel_tap=None):
    """One block of :func:`tp_forward` on the kernels (JAX's
    ``tp_pallas_forward`` body, ``mesh.py:491-632``)."""
    tp = mesh.size("model")
    C, H_l, eps, dtype = config.embed_dim, config.num_heads // tp, config.layer_norm_eps, x.dtype
    C_l, scale = C // tp, config.attn_scale
    qkv = local_qkv(block["attn"]["qkv"])
    quantized = is_quantized(qkv["weight"])
    aq = ap = a1 = a2 = None
    if act_scales is not None:  # MLP-only int8 consumes a_fc1/a_fc2 too
        aq, ap, a1, a2 = act_scales.block(blk_i)
    wproj, bproj = block["attn"]["proj"]["weight"], block["attn"]["proj"]["bias"]
    ls1, ls2 = block.get("ls1"), block.get("ls2")
    b1term = bproj if ls1 is None else bproj * ls1
    int8_tail = tp_int8_tail(quantized, spec, x.shape[1], C_l, C, x.element_size())
    if quantized:
        qkv_l, _ = fused_ln_qkv_int8(x, block["norm1"], qkv, H_l, eps, False,
                                     act_scales=None if aq is None or not int8_tail else (aq, ap))
    else:
        qkv_l, _ = fused_ln_qkv(x, block["norm1"], qkv, H_l, eps, False)
    if spec is None:
        attn_l = fused_sdpa(qkv_l, H_l, scale)  # [B, N, C_l]
        if quantized:
            # the row-parallel int8 product: each row quantized over this
            # shard's C_l columns (dynamic), or only rounded (static: B12
            # folded 1/a_proj into V), dequantized in fp32
            a32 = attn_l.float().reshape(-1, C_l)
            if ap is not None:
                q8, a_s = quantize_static(a32), torch.full_like(a32[:, :1], float(ap))
            else:
                q8, a_s = quantize_rows(a32)
            part = gemm_s8(q8, wproj["int8"], wproj["scale"].float(),
                           torch.zeros(C, dtype=torch.float32, device=x.device), I8_PARTIAL,
                           a=a_s).reshape(x.shape)
        else:
            part = _mm(attn_l, wproj)  # fp32 from the rounded operands
        out = all_reduce(part, mesh, "model")
        if ls1 is not None:
            out = out * ls1
        x = (x.float() + out + b1term).to(dtype)
        scores = None
    else:
        keep = keep_count(spec.keep_ratio, x.shape[1])
        if spec.update or scores is None:
            a_s, v_s = importance_partials(qkv_l, H_l)
            scores = importance_from_partials(all_reduce(a_s, mesh, "model"),
                                              all_reduce(v_s, mesh, "model"), config.num_heads)
        idx, next_scores = select_kept(scores, keep)
        if sel_tap is not None:
            sel_tap(blk_i, idx)
        x_g = gather_tokens(x, idx)
        zero_res = torch.zeros_like(x)
        zero_proj = {"bias": torch.zeros_like(bproj)}
        if int8_tail:
            part = fused_gather_sdpa_proj_residual_int8(
                qkv_l, idx, zero_res, {**zero_proj, "weight": wproj}, ls1, H_l, scale,
                act_scale=ap)
        else:  # the bf16 tail, the proj shard dequantized where int8
            wp = dequantize_weight(wproj, dtype) if quantized else wproj
            part = fused_gather_sdpa_proj_residual(qkv_l, idx, zero_res,
                                                   {**zero_proj, "weight": wp}, ls1, H_l, scale)
        out = all_reduce(part.float(), mesh, "model")
        x = (x_g.float() + out + b1term).to(dtype)
        scores = next_scores
    mlp = block["mlp"]
    b2 = mlp["fc2"]["bias"]
    b2term = b2 if ls2 is None else b2 * ls2
    mlp_zero = {"fc1": mlp["fc1"], "fc2": {"weight": mlp["fc2"]["weight"],
                                           "bias": torch.zeros_like(b2)}}
    if is_quantized(mlp["fc1"]["weight"]):
        part = fused_ln_mlp_residual_int8(x, block["norm2"], mlp_zero, ls2, eps,
                                          add_residual=False,
                                          act_scales=None if a1 is None else (a1, a2))
    else:
        part = fused_ln_mlp_residual(x, block["norm2"], mlp_zero, ls2, eps, add_residual=False)
    out = all_reduce(part.float(), mesh, "model")
    return (x.float() + out + b2term).to(dtype), scores


def tp_forward(params: Params, config: ViTConfig, schedule: Schedule | None, mesh: Mesh,
               impl: str = "cuda", stage=None, act_scales: ActScales | None = None,
               _sel_tap=None):
    """The DP + Megatron TP forward (``rajni_tpu/parallel/mesh.py:
    tp_pallas_forward``): ``images -> logits`` on this rank's data rows,
    through this rank's shard of ``params`` (full params in; sliced here).

    ``impl="cuda"`` runs JAX's per-block sequence on the kernels: B4 (or
    B12, int8) on the head shard without scores; a stock block B6, then the
    row-parallel proj product (bf16: fp32 from the rounded operands; int8:
    ``quantize_rows`` or the static rounding and :func:`..kernels.gemm.
    gemm_s8`'s fp32 ``I8_PARTIAL``); a pruned block the scores from the
    all-reduced partials, the replicated selection (:func:`select_kept`),
    B5 or B13 on a zero residual and zero bias (the shard's partial sum;
    the int8 tail where :func:`tp_int8_tail` holds, else B5 on the
    dequantized proj shard); the MLP through K3 or B9 with
    ``add_residual=False`` and a zero fc2 bias; one all-reduce after proj and
    one after fc2, then the residual and ``ls · bias`` added once. On CPU
    tensors the kernels' plain versions run the same sequence.
    ``impl="torch"`` runs :func:`_tp_block` (the plain ops; int8 weights
    dequantized, as the single-device torch route). The head is
    :func:`..models.vit.classifier_head` on the replicated stream.
    ``_sel_tap(block_idx, keep_idx)`` receives each pruned block's kept
    indices on the kernel route (a capture hook, as ``vit_forward``'s)."""
    schedule = normalize_schedule(schedule, config.depth)
    check_tp(config, mesh.size("model"))
    local = tree_to(shard_params(params, mesh), device=mesh.device)

    @torch.no_grad()
    def forward(images):
        if stage is not None:
            images = stage(images)
        x = embed_tokens(local, images, config)
        scores = None
        for blk_i, (spec, block) in enumerate(zip(schedule, local["blocks"])):
            if impl == "cuda":
                x, scores = _tp_kernel_block(x, scores, blk_i, block, spec, config, mesh,
                                             act_scales, _sel_tap)
            else:
                if is_quantized(block["attn"]["qkv"]["weight"]) or is_quantized(
                        block["mlp"]["fc1"]["weight"]):
                    block = _dequantized(block, x.dtype)
                x, scores = _tp_block(x, scores, block, spec, config, mesh)
        return classifier_head(x, local, config, act_scales, impl)

    return forward


def local_forward(params: Params, config: ViTConfig, schedule: Schedule | None, mesh: Mesh,
                  impl: str = "torch", stage=None, act_scales: ActScales | None = None,
                  _sel_tap=None):
    """``images -> logits`` on this rank's data rows: the single-device
    forward (``model = 1``, each data rank its own batch shard) or
    :func:`tp_forward`; ``impl`` through :func:`resolve_tp_route`."""
    tp = mesh.size("model")
    impl, _ = resolve_tp_route(impl, config, params["cls_token"].dtype, mesh.device, tp,
                               params_quantized(params))
    if tp > 1:
        return tp_forward(params, config, schedule, mesh, impl, stage, act_scales, _sel_tap)
    if impl == "cuda" and params_quantized(params):
        params = attach_act_scales(params, act_scales)  # the operands made once

    @torch.no_grad()
    def forward(images):
        if stage is not None:
            images = stage(images)
        return vit_forward(params, images, config, schedule, impl, act_scales, _sel_tap)

    return forward


def _rows_to_device(images, device):
    if isinstance(images, tuple):
        return tuple(_rows_to_device(e, device) for e in images)
    if isinstance(images, torch.Tensor):
        return images.to(device)
    return torch.from_numpy(np.ascontiguousarray(images)).to(device)


def sharded_forward(params: Params, config: ViTConfig, schedule: Schedule | None, mesh: Mesh,
                    impl: str = "torch", stage=None, act_scales: ActScales | None = None,
                    _sel_tap=None):
    """``images -> logits`` with the batch over ``data`` and the params over
    ``model`` (JAX's ``sharded_forward``): the returned callable takes the
    global batch ``[B, H, W, 3]`` (or a canvas tuple) on every rank, pads it
    to a multiple of the data axis, runs this rank's rows
    (:func:`local_forward`) and returns the global logits on every rank.
    ``impl``: ``"auto"`` → ``"cuda"`` on the card, ``"torch"`` elsewhere
    (:func:`resolve_tp_route`)."""
    fwd = local_forward(params, config, schedule, mesh, impl, stage, act_scales, _sel_tap)
    n_data = mesh.size("data")

    def apply(images):
        images, b = _pad_batch(images, n_data)
        logits = fwd(_rows_to_device(data_rows(images, mesh), mesh.device))
        return all_gather_rows(logits, mesh, "data")[:b]

    apply.route = resolve_tp_route(impl, config, params["cls_token"].dtype, mesh.device,
                                   mesh.size("model"), params_quantized(params))
    return apply


def data_parallel_forward(params: Params, config: ViTConfig, schedule: Schedule | None,
                          mesh: Mesh | None = None, impl: str = "torch", stage=None,
                          act_scales: ActScales | None = None):
    """:func:`sharded_forward` over every rank as the ``data`` axis by
    default."""
    if mesh is None:
        mesh = make_mesh()
    return sharded_forward(params, config, schedule, mesh, impl, stage, act_scales)


def eval_step_fn(config: ViTConfig, schedule: Schedule | None, mesh: Mesh, impl: str = "torch"):
    """``(params, images, labels) -> (correct, total)``: the global batch
    (divisible by the data axis) on every rank, this rank's data rows
    forwarded, the counters summed over ``data`` (JAX's ``eval_step_fn``,
    whose XLA psum this all-reduce is)."""
    cache: dict = {}

    def step(params, images, labels):
        if images.shape[0] % mesh.size("data"):
            raise ValueError(f"batch {images.shape[0]} not divisible by data={mesh.size('data')}")
        if cache.get("params") is not params:
            cache["params"] = params
            cache["fwd"] = local_forward(params, config, schedule, mesh, impl)
        logits = cache["fwd"](_rows_to_device(data_rows(images, mesh), mesh.device))
        rows = data_rows(torch.as_tensor(np.asarray(labels), dtype=torch.int64), mesh)
        correct = int((logits.argmax(dim=-1).cpu() == rows).sum())
        counts = torch.tensor([correct, rows.shape[0]], dtype=torch.int64, device=mesh.device)
        counts = all_reduce(counts, mesh, "data")
        return int(counts[0]), int(counts[1])

    return step
