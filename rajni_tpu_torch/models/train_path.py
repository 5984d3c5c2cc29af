"""The training forward on the hand-written kernels: kernel forward, and a
backward fed by the forward's saved boundaries.

Port of ``rajni_tpu/models/train_path.py``. Each block is a
``torch.autograd.Function`` whose forward runs the residual-emitting kernels
and saves ``(x, qkv, x1, h)``:

  * a stock block runs B16 ``train_attn_block`` (``x1, qkv``) and B17
    ``train_ln_mlp`` (``y, h``);
  * a pruned block runs B4 ``fused_ln_qkv`` (qkv and RAJNI scores), the
    dense selection, B5 ``fused_gather_sdpa_proj_residual`` and B17; it also
    saves the kept indices.

The backward recomputes only elementwise work (the two LayerNorms, the GELU)
and the SDPA: the SDPA in B18 ``train_sdpa_bwd``, the proj, qkv, fc1 and fc2
gradients as plain matrix products around it, which JAX leaves to
XLA (``train_path.py:92-107``, 156-226). The forward's QKV, proj, fc1 and
fc2 products are not recomputed.

Gradient semantics are JAX's, term by term:
  * the MLP backward differentiates the EXACT (erf) GELU at the saved h
    (``_seg_fc2``), although the forward ran ``gelu_fast``;
  * scores carry no gradient (the reference's ``no_grad``): a pruned block
    returns a zero cotangent for the scores it was given;
  * a gather's transpose writes each kept row's cotangent back to its token
    (one term a row, so a scatter gives the same bits as JAX's ``selᵀ @``).

Where JAX's TPU fit rules (``_train_attn_fits``, ``train_mlp_fits``,
``train_sdpa_bwd_fits``) fall back to XLA, the port runs its kernels: they
are VMEM facts. The counterpart of ``train_kernels_supported`` is
:func:`.vit.cuda_kernels_take`: on the card, :func:`vit_forward_train`
demotes a (config, dtype) the kernels do not take to the differentiable
plain forward, before any launch, so every kept count the kernel route meets
is one B18 takes (at most ``sdpa_max_n`` of the head_dim: 848 tokens at 64,
384 at 80). The kernel route takes head_dim 64 and 80 (ViT-H/14) alike: B4
and B5 at their bf16 widths, B16 at K2's, B17 at C <= 1280, and B18's
head_dim-80 form, which keeps JAX's per-head numerics (the scale on the fp32
logits) where the forward kernels take ``_mha``'s phased form, as JAX's
training path does.

Drop-path (JAX ``train_path.py:295-465``): the per-block masks are drawn
outside the ops and blended around the mask-free kernels as ``x + m·(y −
x)``; the backward gives the branch ``m·g`` and the identity path the rest,
``(1 − m)·g`` (scattered back to the kept tokens in a pruned block, whose
blend is against the gathered residual). Remat wraps each block op in a
non-reentrant ``torch.utils.checkpoint`` with the masks as inputs: the
recompute re-runs the kernels and draws nothing. DeiT-3's patch-only
pos-embed and the pooled heads train on the kernels (the embedding and the
head are outside them); registers, the distillation token and qk-norm run
the differentiable plain forward, as JAX's ``train_kernels_supported``
sends them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.block import fused_gather_sdpa_proj_residual, fused_ln_qkv
from ..kernels.train import train_attn_block, train_ln_mlp, train_sdpa_bwd
from ..ops.pruning import gather_tokens, keep_count, select_tokens_dense
from ..utils.schedule import Schedule, normalize_schedule
from .vit import (
    Params,
    ViTConfig,
    classifier_head,
    embed_tokens,
    layer_norm,
    remat_call,
    resolve_route,
    vit_forward,
)

# A block's leaves in the order the block ops take and return them.
_LEAVES = (
    ("norm1", "scale"), ("norm1", "bias"), ("attn", "qkv", "weight"), ("attn", "qkv", "bias"),
    ("attn", "proj", "weight"), ("attn", "proj", "bias"), ("norm2", "scale"), ("norm2", "bias"),
    ("mlp", "fc1", "weight"), ("mlp", "fc1", "bias"), ("mlp", "fc2", "weight"),
    ("mlp", "fc2", "bias"),
)


def _paths(block: Params) -> tuple:
    return _LEAVES + tuple((n,) for n in ("ls1", "ls2") if n in block)


def _flatten(tree: Params, paths) -> list:
    out = []
    for path in paths:
        t = tree
        for k in path:
            t = t[k]
        out.append(t)
    return out


def _unflatten(leaves, paths) -> Params:
    tree: Params = {}
    for path, leaf in zip(paths, leaves):
        t = tree
        for k in path[:-1]:
            t = t.setdefault(k, {})
        t[path[-1]] = leaf
    return tree


# ---------------------------------------------------------------------------
# Backward segments between the saved boundaries
# ---------------------------------------------------------------------------


def _wgrad(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``a @ Wᵀ`` (``W [out, in]``) for cotangent ``g``."""
    return g.reshape(-1, g.shape[-1]).t() @ a.reshape(-1, a.shape[-1])


def _bgrad(g: torch.Tensor) -> torch.Tensor:
    return g.float().sum(dim=tuple(range(g.ndim - 1))).to(g.dtype)


def _ln_linear_vjp(x, ln, lin, g, eps: float):
    """VJP of ``layer_norm(x, ln) @ Wᵀ + b`` (the ln1 + qkv and ln2 + fc1
    segments, JAX's ``_seg_qkv`` and ``_seg_fc1``) for cotangent ``g``:
    ``(d_ln, d_lin, d_x)``. Only the LayerNorm is recomputed."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        s = ln["scale"].detach().requires_grad_()
        b = ln["bias"].detach().requires_grad_()
        a = layer_norm(xx, {"scale": s, "bias": b}, eps)
    d_lin = {"weight": _wgrad(g, a.detach()), "bias": _bgrad(g)}
    d_x, d_s, d_b = torch.autograd.grad(a, (xx, s, b), g @ lin["weight"])
    return {"scale": d_s, "bias": d_b}, d_lin, d_x


def _mlp_bwd(block: Params, x1, h, g_y, eps: float):
    """Backward through the MLP half from the saved ``(x1, h)``: the exact
    GELU's VJP at h (``_seg_fc2``), then the ln2 + fc1 segment. Returns
    ``(d_x1, (d_ln2, d_fc1, d_fc2, d_ls2))``."""
    fc2, ls2 = block["mlp"]["fc2"], block.get("ls2")
    with torch.enable_grad():
        hh = h.detach().requires_grad_()
        hg = F.gelu(hh, approximate="none")
    d_out = g_y if ls2 is None else g_y * ls2
    d_ls2 = None
    if ls2 is not None:
        out = hg.detach() @ fc2["weight"].t() + fc2["bias"]
        d_ls2 = (out.float() * g_y.float()).sum(dim=(0, 1)).to(ls2.dtype)
    d_fc2 = {"weight": _wgrad(d_out, hg.detach()), "bias": _bgrad(d_out)}
    (d_h,) = torch.autograd.grad(hg, hh, d_out @ fc2["weight"])
    d_ln2, d_fc1, d_x1 = _ln_linear_vjp(x1, block["norm2"], block["mlp"]["fc1"], d_h, eps)
    return g_y + d_x1, (d_ln2, d_fc1, d_fc2, d_ls2)


def _scatter(src: torch.Tensor, keep_idx: torch.Tensor, n: int) -> torch.Tensor:
    """The transpose of the token gather: row k of ``src`` to token
    ``keep_idx[b, k]`` of an ``[B, n, W]`` zero tensor."""
    out = src.new_zeros(src.shape[0], n, src.shape[-1])
    return out.scatter_(1, keep_idx[..., None].expand(-1, -1, src.shape[-1]), src)


def _attn_bwd(block: Params, x, qkv, keep_idx, d_x1, num_heads: int, scale: float, eps: float):
    """Backward through the attention half from the saved ``(x, qkv)``:
    ``(d_x, (d_ln1, d_qkv_params, d_proj, d_ls1))``, the SDPA backward in
    B18 (JAX's ``_attn_bwd_pallas``)."""
    proj, ls1 = block["attn"]["proj"], block.get("ls1")
    qkv_g = qkv if keep_idx is None else gather_tokens(qkv, keep_idx)
    d_t = d_x1 if ls1 is None else d_x1 * ls1
    ao, d_qkv = train_sdpa_bwd(qkv_g.contiguous(), (d_t @ proj["weight"]).contiguous(),
                               num_heads, scale)
    d_proj = {"weight": _wgrad(d_t, ao), "bias": _bgrad(d_t)}
    d_ls1 = None
    if ls1 is not None:
        out = ao @ proj["weight"].t() + proj["bias"]
        d_ls1 = (out.float() * d_x1.float()).sum(dim=(0, 1)).to(ls1.dtype)
    d_x = d_x1
    if keep_idx is not None:
        d_qkv = _scatter(d_qkv, keep_idx, x.shape[1])
        d_x = _scatter(d_x1, keep_idx, x.shape[1])
    d_ln1, d_qkvp, d_xb = _ln_linear_vjp(x, block["norm1"], block["attn"]["qkv"], d_qkv, eps)
    return d_x + d_xb, (d_ln1, d_qkvp, d_proj, d_ls1)


def _block_grads(block: Params, paths, attn_pieces, mlp_pieces) -> list:
    """The cotangents in the order of ``paths``."""
    d_ln1, d_qkvp, d_proj, d_ls1 = attn_pieces
    d_ln2, d_fc1, d_fc2, d_ls2 = mlp_pieces
    g = {"norm1": d_ln1, "attn": {"qkv": d_qkvp, "proj": d_proj}, "norm2": d_ln2,
         "mlp": {"fc1": d_fc1, "fc2": d_fc2}, "ls1": d_ls1, "ls2": d_ls2}
    return _flatten(g, paths)


# ---------------------------------------------------------------------------
# Block ops
# ---------------------------------------------------------------------------


def _dp_rest(m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The identity path's share of a drop-path blend's cotangent: ``x + m·(y
    − x)`` passes ``(1 − m)·g`` to ``x`` besides the branch's ``m·g``."""
    return (1.0 - m) * g


def _mask_grads(ctx, first: int, masks) -> list:
    """Zero cotangents for the drop-path masks (inputs ``first``, ``first +
    1``), ``None`` where a mask is absent or takes no gradient."""
    return [torch.zeros_like(m) if m is not None and ctx.needs_input_grad[first + i] else None
            for i, m in enumerate(masks)]


class _StockBlock(torch.autograd.Function):
    """A stock block: B16 then B17 forward, residual-fed backward, with the
    drop-path masks ``m1``, ``m2`` (``[B, 1, 1]`` or ``None``) blended around
    the kernels."""

    @staticmethod
    def forward(ctx, static, x, m1, m2, *leaves):
        num_heads, scale, eps, paths = static
        block = _unflatten(leaves, paths)
        x1, qkv = train_attn_block(x, block["norm1"], block["attn"], block.get("ls1"), num_heads,
                                   scale, eps)
        if m1 is not None:
            x1 = x + m1 * (x1 - x)
        y, h = train_ln_mlp(x1, block["norm2"], block["mlp"], block.get("ls2"), eps)
        if m2 is not None:
            y = x1 + m2 * (y - x1)
        ctx.static = static
        ctx.save_for_backward(x, qkv, x1, h, m1, m2, *leaves)
        return y

    @staticmethod
    def backward(ctx, g_y):
        num_heads, scale, eps, paths = ctx.static
        x, qkv, x1, h, m1, m2, *leaves = ctx.saved_tensors
        block = _unflatten(leaves, paths)
        g_y = g_y.contiguous()
        d_x1, mlp_pieces = _mlp_bwd(block, x1, h, g_y if m2 is None else m2 * g_y, eps)
        if m2 is not None:
            d_x1 = d_x1 + _dp_rest(m2, g_y)
        d_x, attn_pieces = _attn_bwd(block, x, qkv, None, d_x1 if m1 is None else m1 * d_x1,
                                     num_heads, scale, eps)
        if m1 is not None:
            d_x = d_x + _dp_rest(m1, d_x1)
        return (None, d_x, *_mask_grads(ctx, 2, (m1, m2)),
                *_block_grads(block, paths, attn_pieces, mlp_pieces))


class _PrunedBlock(torch.autograd.Function):
    """A pruned block: B4, selection, B5, B17 forward, residual-fed
    backward. Returns ``(y, next_scores, keep_idx)``; the scores and indices
    carry no gradient. The attention branch's drop-path blend is against the
    residual gathered to the kept tokens."""

    @staticmethod
    def forward(ctx, static, x, scores, m1, m2, *leaves):
        num_heads, scale, eps, keep, with_scores, paths = static
        block = _unflatten(leaves, paths)
        qkv, new_scores = fused_ln_qkv(x, block["norm1"], block["attn"]["qkv"], num_heads, eps,
                                       with_scores)
        scores_used = new_scores if with_scores else scores
        keep_idx, _ = select_tokens_dense(scores_used, keep, torch.bool)
        x1 = fused_gather_sdpa_proj_residual(qkv, keep_idx, x, block["attn"]["proj"],
                                             block.get("ls1"), num_heads, scale)
        if m1 is not None:
            x_g = gather_tokens(x, keep_idx)
            x1 = x_g + m1 * (x1 - x_g)
        next_scores = torch.take_along_dim(scores_used, keep_idx, dim=1)
        y, h = train_ln_mlp(x1, block["norm2"], block["mlp"], block.get("ls2"), eps)
        if m2 is not None:
            y = x1 + m2 * (y - x1)
        ctx.static = static
        ctx.scores_like = None if scores is None else (scores.shape, scores.dtype)
        ctx.mark_non_differentiable(next_scores, keep_idx)
        ctx.save_for_backward(x, qkv, keep_idx, x1, h, m1, m2, *leaves)
        return y, next_scores, keep_idx

    @staticmethod
    def backward(ctx, g_y, _g_scores, _g_idx):
        num_heads, scale, eps, _, _, paths = ctx.static
        x, qkv, keep_idx, x1, h, m1, m2, *leaves = ctx.saved_tensors
        block = _unflatten(leaves, paths)
        g_y = g_y.contiguous()
        d_x1, mlp_pieces = _mlp_bwd(block, x1, h, g_y if m2 is None else m2 * g_y, eps)
        if m2 is not None:
            d_x1 = d_x1 + _dp_rest(m2, g_y)
        d_x, attn_pieces = _attn_bwd(block, x, qkv, keep_idx,
                                     d_x1 if m1 is None else m1 * d_x1, num_heads, scale, eps)
        if m1 is not None:  # the gathered residual's identity path, scattered back
            d_x = d_x + _scatter(_dp_rest(m1, d_x1), keep_idx, x.shape[1])
        d_scores = None
        if ctx.scores_like is not None:  # scores carry no gradient (reference no_grad)
            shape, dtype = ctx.scores_like
            d_scores = torch.zeros(shape, dtype=dtype, device=x.device)
        return (None, d_x, d_scores, *_mask_grads(ctx, 3, (m1, m2)),
                *_block_grads(block, paths, attn_pieces, mlp_pieces))


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def vit_forward_train(
    params: Params,
    images: torch.Tensor,
    config: ViTConfig,
    schedule: Schedule | None = None,
    remat: bool = False,
    _sel_tap=None,
    *,
    dp_masks: list | None = None,
    return_dist: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Training forward on the kernels: ``[B, H, W, 3] -> logits`` (or
    ``(cls_logits, dist_logits)`` under ``return_dist``), differentiable
    through the block ops above (a drop-in for ``vit_forward(..., "torch")``
    under autograd, the same selections and compaction, tolerance-level
    numerics).

    Every block takes its kernel op (the kernels take every token count the
    config allows; JAX's "both fit VMEM" rule is a TPU fact). A (config,
    dtype) that the kernels do not take runs the plain forward
    (:func:`.vit.resolve_route`: on the card, and for the extended variants
    on every device), with the same drop-path masks and remat.
    ``dp_masks`` gives each block's drop-path masks ``(m_attn, m_mlp)`` or
    ``None`` (JAX's key schedule, one stream a block, is the caller's:
    :func:`..train.step_drop_path_masks`).
    ``remat`` runs each block op under :func:`.vit.remat_call`: the backward
    re-runs the op's forward, the kernels, from its inputs, masks included.
    ``_sel_tap(block_idx, keep_idx)`` receives each pruned block's kept
    indices.
    """
    dtype = params["cls_token"].dtype
    dps = dp_masks if dp_masks is not None else [None] * config.depth
    if resolve_route("cuda", config, dtype, images.device, training=True)[0] == "torch":
        return vit_forward(params, images, config, schedule, "torch", _sel_tap=_sel_tap,
                           remat=remat, dp_masks=dp_masks, return_dist=return_dist)
    schedule = normalize_schedule(schedule, config.depth)
    H, scale, eps = config.num_heads, config.attn_scale, config.layer_norm_eps
    x = embed_tokens(params, images, config)
    scores = None
    for blk_i, (spec, block) in enumerate(zip(schedule, params["blocks"])):
        paths = _paths(block)
        leaves = _flatten(block, paths)
        m1, m2 = dps[blk_i] if dps[blk_i] is not None else (None, None)
        if spec is not None:
            keep = keep_count(spec.keep_ratio, x.shape[1], 1)
            with_scores = spec.update or scores is None
            static = (H, scale, eps, keep, with_scores, paths)
            args = (static, x, scores, m1, m2, *leaves)
            x, scores, keep_idx = (remat_call(_PrunedBlock.apply, *args) if remat
                                   else _PrunedBlock.apply(*args))
            if _sel_tap is not None:
                _sel_tap(blk_i, keep_idx)
            continue
        scores = None  # a stock block resets the threaded scores
        args = ((H, scale, eps, paths), x, m1, m2, *leaves)
        x = remat_call(_StockBlock.apply, *args) if remat else _StockBlock.apply(*args)
    return classifier_head(x, params, config, return_dist=return_dist)
