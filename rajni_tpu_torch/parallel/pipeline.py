"""GPipe pipeline parallelism over ``pipe`` ranks, the forward (port of
``rajni_tpu/parallel/pipeline.py``).

A ``(data, pipe)`` mesh, or ``(data, pipe, model)`` with Megatron TP inside
each stage (:func:`..parallel.mesh._tp_block`). Each rank holds only its
stage's blocks (and, with ``model``, only its shard of them). A forward cuts
the global batch into ``M`` microbatches (``--microbatch``, default ``2 ·
pipe``), each sharded over ``data``; stage 0 embeds them, every stage runs
its blocks on microbatch after microbatch and sends the activations and the
threaded scores to the next stage point-to-point, padded to the entry count
``N0`` (the per-block counts are fixed by the schedule, so each stage slices
its true count back: :func:`_entry_counts`). The last stage banks each
microbatch's CLS row, runs the head once on all of them and broadcasts the
logits over ``pipe``; the logits are then gathered over ``data``. Scores
enter a stage only where the previous stage's last block was pruned.

JAX's stage programs are XLA ops only (``pipeline.py:476-481`` refuses
``impl != "xla"``): here the stages run the plain ops (``impl="torch"``,
the single-device torch route's block functions, so a pipelined forward
equals the single-device one) and ``"cuda"`` is refused. Point-to-point
copies go through host tensors on gloo (its CUDA support is ``broadcast``
and ``all_reduce``). Int8 params and the extended timm variants are refused,
as in JAX. The training step (``make_pipeline_train_step``) is not ported.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..models.vit import (
    ViTConfig,
    _pruned_halves,
    classifier_head,
    embed_tokens,
    stock_block,
    tree_to,
)
from ..ops.pruning import keep_count
from ..quant import is_quantized
from ..utils.schedule import Schedule, normalize_schedule, token_count_trace
from .mesh import (
    Mesh,
    _gloo,
    _pad_batch,
    _rows_to_device,
    _tp_block,
    all_gather_rows,
    broadcast,
    check_tp,
    default_device,
    grid_mesh,
    param_pspecs,
    repack_qkv_heads,
    shard_leaf,
    world_size,
)


def make_pipe_mesh(pipe: int = 1, data: int | None = None, model: int = 1,
                   device=None) -> Mesh:
    """A ``(data, pipe)`` mesh, or ``(data, pipe, model)`` when ``model >
    1``, over every rank; ``data`` defaults to the ranks left."""
    n = world_size()
    if data is None:
        if n % (pipe * model):
            raise ValueError(f"{n} ranks not divisible by pipe={pipe} * model={model}")
        data = n // (pipe * model)
    if data * pipe * model != n:
        raise ValueError(f"mesh {data}x{pipe}x{model} != {n} ranks")
    device = default_device() if device is None else device
    if model == 1:
        return grid_mesh(("data", "pipe"), (data, pipe), device)
    return grid_mesh(("data", "pipe", "model"), (data, pipe, model), device)


def _check_plain(params: Any) -> None:
    leaves = [params["blocks"][0]["attn"]["qkv"]["weight"], params["head"]["weight"]]
    if any(is_quantized(w) for w in leaves):
        raise NotImplementedError(
            "pipeline parallelism supports plain (bf16/f32) params; int8 records are not "
            "wired — PP targets models whose bf16 weights exceed a card, use quantization "
            "to *avoid* PP instead")


def stack_params(params: Any, n_stages: int, tp: int = 1) -> Any:
    """``{"embed": {...}, "blocks": stacked, "head": {"norm", "head"}}``
    with every block leaf stacked on a leading ``depth`` axis (the
    contiguous slice of it a stage's blocks); with ``tp > 1`` the QKV
    weights repacked head-aligned first (:func:`.mesh.repack_qkv_heads`).
    Requires ``depth % n_stages == 0``."""
    _check_plain(params)
    if tp > 1:
        params = repack_qkv_heads(params)
    depth = len(params["blocks"])
    if depth % n_stages:
        raise ValueError(f"depth={depth} must be divisible by pipe={n_stages} stages")

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs)

    return {
        "embed": {"patch_embed": params["patch_embed"], "cls_token": params["cls_token"],
                  "pos_embed": params["pos_embed"]},
        "blocks": stack(*params["blocks"]),
        "head": {"norm": params["norm"], "head": params["head"]},
    }


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_params(ptree: Any) -> Any:
    """Inverse of :func:`stack_params` (checkpoint interchange)."""
    depth = ptree["blocks"]["norm1"]["scale"].shape[0]
    return {
        "patch_embed": ptree["embed"]["patch_embed"],
        "cls_token": ptree["embed"]["cls_token"],
        "pos_embed": ptree["embed"]["pos_embed"],
        "blocks": [_index(ptree["blocks"], i) for i in range(depth)],
        "norm": ptree["head"]["norm"],
        "head": ptree["head"]["head"],
    }


def _entry_counts(config: ViTConfig, schedule) -> list[int]:
    """Token count entering each block (a stage slices its padded input
    back to its first block's count)."""
    return token_count_trace(config.num_tokens, schedule)


def _stage_blocks(ptree: Any, mesh: Mesh, n_local: int) -> list:
    """This rank's blocks: its stage's slice of the stacked tree and, with
    a ``model`` axis, its shard of each (:func:`.mesh.shard_leaf` by
    :func:`.mesh.param_pspecs` of one unstacked block)."""
    g0 = mesh.coord("pipe") * n_local
    blocks = [_index(ptree["blocks"], g0 + j) for j in range(n_local)]
    tp = mesh.size("model")
    if tp == 1:
        return blocks
    specs = param_pspecs({"blocks": blocks})["blocks"]
    idx = mesh.coord("model")

    def shard(tree, spec):
        if isinstance(tree, dict):
            return {k: shard(v, spec[k]) for k, v in tree.items()}
        return shard_leaf(tree, spec, idx, tp)

    return [shard(b, s) for b, s in zip(blocks, specs)]


def _stage_branch(stage: int, n_local: int, config: ViTConfig, schedule, entry: list[int],
                  scores_valid_in: bool, mesh: Mesh):
    """Stage ``stage``'s program: slice the padded input to its entry
    count, run its blocks (the single-device torch route's block functions,
    or :func:`.mesh._tp_block` over ``model``), pad back to ``N0``."""
    n0, g0, tp = config.num_tokens, stage * n_local, mesh.size("model")

    def branch(blocks, x_pad, scores_pad):
        x = x_pad[:, :entry[g0]]
        scores = scores_pad[:, :entry[g0]] if scores_valid_in else None
        for j, block in enumerate(blocks):
            spec = schedule[g0 + j]
            if tp > 1:
                x, scores = _tp_block(x, scores, block, spec, config, mesh)
            elif spec is not None:
                keep = keep_count(spec.keep_ratio, x.shape[1])
                x, scores, _ = _pruned_halves(x, block, config, "torch", spec, keep, scores,
                                              spec.update or scores is None, None)
            else:
                x = stock_block(x, block, config)
                scores = None
        x_out = torch.nn.functional.pad(x, (0, 0, 0, n0 - x.shape[1]))
        s_out = torch.zeros_like(scores_pad) if scores is None else torch.nn.functional.pad(
            scores.to(scores_pad.dtype), (0, n0 - scores.shape[1]))
        return x_out, s_out

    return branch


def _send(t: torch.Tensor, dst: int, group) -> list:
    src = t.cpu() if t.is_cuda and _gloo(group) else t.contiguous()
    return [dist.isend(src, dst, group=group), src]


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    host = like.is_cuda and _gloo(group)
    buf = torch.empty_like(like, device="cpu") if host else torch.empty_like(like)
    dist.recv(buf, src, group=group)
    return buf.to(like.device)


def _check_classic(config: ViTConfig) -> None:
    """The stage programs take the classic block and head semantics (one
    prefix token, no qk-norm, the CLS head); the extended variants are
    refused, as JAX refuses them."""
    if (config.num_prefix_tokens != 1 or config.qk_norm or config.global_pool != "token"
            or config.fc_norm_resolved):
        raise ValueError(
            "pipeline parallelism supports classic ViT configs only (no registers / "
            "distillation token / qk-norm / pooled heads) — use data or tensor parallelism "
            "for extended variants")


def _pipeline_logits_fn(config: ViTConfig, schedule, mesh: Mesh, n_micro: int, impl: str,
                        ptree: Any, stage=None):
    """``images [M, b_micro, H, W, 3]`` (this rank's data rows of each
    microbatch) → ``logits [M, b_micro, classes]`` fp32 on every stage."""
    n_stages = mesh.size("pipe")
    depth = config.depth
    if depth % n_stages:
        raise ValueError(f"depth={depth} % pipe={n_stages} != 0")
    if impl != "torch":
        raise NotImplementedError(
            "the pipeline's stage programs run the plain ops (as JAX's are XLA-ops only, "
            "rajni_tpu/parallel/pipeline.py:476); pass impl='torch'")
    tp = mesh.size("model")
    if tp > 1:
        check_tp(config, tp)
    n_local = depth // n_stages
    entry = _entry_counts(config, schedule)
    s = mesh.coord("pipe")
    valid_in = s > 0 and schedule[s * n_local - 1] is not None
    branch = _stage_branch(s, n_local, config, schedule, entry, valid_in, mesh)
    blocks = tree_to(_stage_blocks(ptree, mesh, n_local), device=mesh.device)
    embed = tree_to(ptree["embed"], device=mesh.device)
    head = tree_to(ptree["head"], device=mesh.device)
    group = mesh.groups.get("pipe")
    prev = mesh.ranks["pipe"][s - 1] if s > 0 else None
    nxt = mesh.ranks["pipe"][s + 1] if s < n_stages - 1 else None

    @torch.no_grad()
    def run(images):
        dtype, C = embed["cls_token"].dtype, config.embed_dim
        b_micro = images.shape[1]
        x_like = torch.zeros(b_micro, config.num_tokens, C, dtype=dtype, device=mesh.device)
        s_like = torch.zeros(b_micro, config.num_tokens, dtype=torch.float32,
                             device=mesh.device)
        banked, pending = [], []
        for m in range(n_micro):  # GPipe: microbatch m enters stage s at tick m + s
            if prev is None:
                img = images[m] if stage is None else stage(images[m])
                x_in, s_in = embed_tokens(embed, img, config), s_like
            else:
                x_in, s_in = _recv(x_like, prev, group), _recv(s_like, prev, group)
            x_out, s_out = branch(blocks, x_in, s_in)
            if nxt is not None:
                pending += _send(x_out, nxt, group) + _send(s_out, nxt, group)
            else:
                banked.append(x_out[:, 0:1])  # the head reads the CLS row only
        for work in pending[::2]:
            work.wait()
        if nxt is None:
            logits = classifier_head(torch.cat(banked), head, config, None, "torch").float()
        else:
            logits = torch.empty(n_micro * b_micro, config.num_classes, dtype=torch.float32,
                                 device=mesh.device)
        logits = broadcast(logits, mesh, "pipe", n_stages - 1)
        return logits.reshape(n_micro, b_micro, -1)

    return run


def pipeline_forward(params: Any, config: ViTConfig, schedule: Schedule | None, mesh: Mesh,
                     microbatch: int | None = None, impl: str = "torch", stage=None):
    """Pipelined ``images -> logits`` over a ``(data, pipe[, model])`` mesh
    (JAX's ``pipeline_forward``): ``params`` the standard tree (stacked
    here) or one from :func:`stack_params`; the callable takes the global
    ``[B, H, W, 3]`` on every rank (padded to ``microbatch · data`` and sliced
    back) and returns ``[B, num_classes]`` fp32 logits on every rank, the
    single-device torch forward's. ``microbatch``: the microbatches ``M``
    (default ``2 · pipe``; GPipe's utilization is ``M / (M + pipe - 1)``).
    ``stage``: an on-device per-image preprocessing callable (array batches
    only)."""
    _check_classic(config)
    schedule = normalize_schedule(schedule, config.depth)
    n_stages, tp = mesh.size("pipe"), mesh.size("model")
    n_micro = microbatch or 2 * n_stages
    if isinstance(params.get("blocks"), list):
        params = stack_params(params, n_stages, tp)
    elif tp > 1 and params["blocks"]["attn"]["qkv"]["weight"].dim() != 4:
        raise ValueError("a 3-D (model) mesh needs the head-aligned stacked layout — "
                         "re-stack with stack_params(params, n_stages, tp)")
    run = _pipeline_logits_fn(config, schedule, mesh, n_micro, impl, params, stage)
    n_data = mesh.size("data")
    group = n_micro * n_data

    def apply(images):
        if isinstance(images, tuple):
            raise ValueError("pipeline_forward takes array batches (not the canvas tier)")
        images, b = _pad_batch(images, group)
        images = _rows_to_device(images, mesh.device)
        mb = images.reshape((n_micro, n_data, -1) + tuple(images.shape[1:]))
        out = run(mb[:, mesh.coord("data")])  # [M, b_micro, classes]
        out = all_gather_rows(out.transpose(0, 1).contiguous(), mesh, "data")  # [D·b, M, cls]
        out = out.reshape(n_data, -1, n_micro, out.shape[-1]).permute(2, 0, 1, 3)
        return out.reshape(-1, out.shape[-1])[:b]

    apply.n_micro = n_micro
    return apply
