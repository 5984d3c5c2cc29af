"""Training step and fine-tuning CLI (port of ``rajni_tpu/train.py``)::

    python -m rajni_tpu_torch.train --data_path train/ --model vit_base_patch16_224 \\
        --schedule schedule.json --steps 300 --batch_size 128 --dtype bfloat16 \\
        --kernels cuda --augment --rand_augment rand-m9-mstd0.5-inc1 --reprob 0.25 \\
        --mixup 0.8 --cutmix 1.0 --drop_path 0.1 --layer_decay 0.75 --ema 0.9999 \\
        --save_state_every 100 --output out.msgpack

Trains a ViT through its pruning schedule and saves a msgpack checkpoint
that both packages load (:mod:`.params.io`). ``--kernels cuda`` runs the
kernel training path (:func:`.models.train_path.vit_forward_train`),
``torch`` the plain forward under autograd; ``auto`` takes the kernels on a
card and the plain forward elsewhere, and a config or dtype the kernels do
not take runs the plain forward (the ``route:`` line says why). The
optimizer is optax's chain: clipping, ``adamw`` with its schedule, layer
decay, EMA, inside ``MultiSteps`` under gradient accumulation
(:func:`build_optimizer`); the parameters are updated in place.

Every random stream (drop-path masks, mixup and CutMix, augmentation) is a
pure function of ``(--seed, tag, step)`` (:mod:`.utils.rng`), with JAX's
tags, so ``--resume`` replays the uninterrupted run's data stream, masks,
λ and augmentations; the train state file carries the rest
(:func:`save_train_state`). The parallel flags (``--data_parallel``,
``--tensor_parallel``, ``--pipeline_parallel``, ``--distributed``) and the
Orbax state backend are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import math
import os
from typing import Callable

import numpy as np
import torch

from .models.train_path import vit_forward_train
from .models.vit import (
    Params,
    ViTConfig,
    adapt_config_to_params,
    drop_path_masks,
    get_config,
    init_params,
    resolve_route,
    route_line,
    vit_forward,
)
from .params.io import load_checkpoint_auto, load_tree, save_params, save_tree
from .utils.rng import device_generator, host_rng
from .utils.schedule import Schedule, load_schedule
from .utils.timing import profiled, require_device

# JAX's stream tags (rajni_tpu/train.py:420-423): each folded into its
# stream's key so no two streams share one
_MIXUP_TAG = 0x6D697875  # "mixu"
_CUTMIX_TAG = 0x63757478  # "cutx"
_SWITCH_TAG = 0x73776368  # "swch"
_DROPPATH_TAG = 0x64707468  # "dpth"


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross entropy in fp32; ``label_smoothing`` mixes the one-hot
    target with the uniform distribution, ``(1−s)·onehot + s/K``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, labels[:, None].long(), dim=-1)[:, 0]
    if label_smoothing:
        s = float(label_smoothing)
        nll = (1.0 - s) * nll - s * logp.mean(dim=-1)
    return nll.mean()


def param_leaves(params: Params) -> list:
    """The parameter tensors in a fixed order (dictionary order, blocks in
    sequence)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    if isinstance(params, list):
        return [t for v in params for t in param_leaves(v)]
    return [params]


def tree_with_leaves(tree: Params, leaves) -> Params:
    """``tree``'s structure with :func:`param_leaves`'s leaves replaced, in
    order, by ``leaves``."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        if isinstance(t, list):
            return [rebuild(v) for v in t]
        return next(it)

    return rebuild(tree)


# ---------------------------------------------------------------------------
# Optimizer: optax semantics
# ---------------------------------------------------------------------------


def _schedule_ticks(total_steps: int, warmup_steps: int, grad_accum: int) -> tuple[int, int]:
    """Micro-step horizons as optimizer-update ticks (the unit the LR
    schedule counts under gradient accumulation)."""
    if grad_accum <= 1:
        return total_steps, warmup_steps
    decay = max(1, total_steps // grad_accum)
    warm = max(1, warmup_steps // grad_accum) if warmup_steps > 0 else 0
    return decay, warm


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _constants(value: float):
    """``t -> value`` as a 0-dim tensor of ``t``'s dtype on its device, made
    once per (dtype, device): an operand cast to the leaf's dtype, as optax
    casts its traced scalars, and a true division where it divides (on CUDA
    PyTorch takes ``tensor / python_number`` as a multiply by the
    reciprocal)."""
    made: dict = {}

    def of(t: torch.Tensor) -> torch.Tensor:
        key = (t.dtype, t.device)
        if key not in made:
            made[key] = torch.full((), value, dtype=t.dtype, device=t.device)
        return made[key]

    return of


def _cosine(init: float, steps: int) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` to 0."""
    return lambda count: init * 0.5 * (1 + math.cos(math.pi * min(count, steps) / steps))


def layer_decay_factors(params: Params, decay: float) -> Params:
    """Per-leaf update multipliers for layer-wise LR decay (timm's
    ``layer_decay``; ``rajni_tpu/train.py:140``): the head and the norms at
    1, block ``i`` at ``decay^(depth − i)``, the embedding leaves
    (patch-embed, CLS, register and distillation tokens, pos-embed) at
    ``decay^(depth + 1)``. A tree of floats with the params' structure."""
    depth = len(params["blocks"])
    top = depth + 1
    embed = {"patch_embed", "cls_token", "pos_embed", "reg_token", "dist_token"}

    def fill(tree, f):
        return tree_with_leaves(tree, itertools.repeat(f))

    factors = {}
    for k, v in params.items():
        if k == "blocks":
            factors[k] = [fill(b, decay ** (top - (i + 1))) for i, b in enumerate(v)]
        else:
            factors[k] = fill(v, decay ** top if k in embed else 1.0)
    return factors


@dataclasses.dataclass
class OptState:
    count: int  # inner updates taken (the Adam and schedule count)
    mu: list
    nu: list
    mini_step: int = 0  # micro-steps accumulated since the last update
    acc: list | None = None  # the running mean of the micro-gradients
    ema: list | None = None  # the fp32 EMA of the params (``ema > 0``)


class AdamW:
    """optax's chain: ``clip_by_global_norm`` when ``grad_clip > 0``, then
    ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on every leaf),
    then layer decay (``factors``, per leaf), then the EMA tracker (``ema``
    decay), wrapped in ``MultiSteps`` when ``grad_accum > 1``, applied in
    place.

    What optax does and ``torch.optim`` does not: the learning rate is read
    at the update count BEFORE it is incremented (a warmup's first update has
    lr 0); the clip scales by ``max_norm / ‖g‖`` only when ``‖g‖ ≥ max_norm``,
    with no ``+1e-6``; the moments keep the parameters' dtype; accumulation
    keeps the running mean ``acc + (g − acc)/(n + 1)`` and updates once per
    ``grad_accum`` micro-steps, the schedule, layer decay and EMA counting
    updates; a layer-decay factor is cast to the update's dtype; the EMA is
    an fp32 copy, ``ema·d + (1 − d)·p`` from the params after the update.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: Callable[[int], float], weight_decay: float, grad_clip: float = 0.0,
                 grad_accum: int = 1, factors: list | None = None, ema: float = 0.0):
        self.lr, self.weight_decay = lr, weight_decay
        self.grad_clip, self.grad_accum = grad_clip, grad_accum
        self.factors = None if factors is None else [_constants(f) for f in factors]
        self.ema = ema

    def init(self, params: list) -> OptState:
        zeros = [torch.zeros_like(p, requires_grad=False) for p in params]
        return OptState(
            0, zeros, [torch.zeros_like(z) for z in zeros],
            acc=[torch.zeros_like(z) for z in zeros] if self.grad_accum > 1 else None,
            ema=[p.detach().float().clone() for p in params] if self.ema > 0.0 else None)

    @torch.no_grad()
    def update(self, grads, state: OptState, params: list) -> None:
        """One micro-step: accumulate, and every ``grad_accum`` micro-steps
        move ``params`` in place."""
        if self.grad_accum > 1:
            n = state.mini_step
            count = _constants(n + 1)
            for a, g in zip(state.acc, grads):
                a.add_((g.to(a.dtype) - a) / count(a))
            state.mini_step = (n + 1) % self.grad_accum
            if state.mini_step:
                return
            grads = state.acc
        if self.grad_clip > 0.0:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            if norm >= self.grad_clip:
                grads = [(g / norm.to(g.dtype)) * self.grad_clip for g in grads]
        lr = self.lr(state.count)
        state.count += 1
        c1, c2 = _constants(1 - self.b1**state.count), _constants(1 - self.b2**state.count)
        for i, (p, g, m, v) in enumerate(zip(params, grads, state.mu, state.nu)):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (m / c1(m)) / (torch.sqrt(v / c2(v)) + self.eps)
            upd = -lr * (u + self.weight_decay * p)
            if self.factors is not None:
                upd = upd * self.factors[i](upd)
            p.add_(upd)
        if state.ema is not None:
            d = torch.tensor(self.ema, dtype=torch.float32, device=params[0].device)
            for e, p in zip(state.ema, params):
                e.copy_(d * e + (1.0 - d) * p.float())
        if self.grad_accum > 1:
            for a in state.acc:
                a.zero_()


def build_optimizer(learning_rate: float, total_steps: int, weight_decay: float = 0.05,
                    lr_schedule: str = "constant", warmup_steps: int = 0, grad_accum: int = 1,
                    grad_clip: float = 0.0, ema: float = 0.0, layer_decay: float = 0.0,
                    params: Params | None = None) -> AdamW:
    """AdamW with the JAX package's fine-tuning knobs (``train.py:230``):
    ``"cosine"`` is a linear warmup from 0 then a cosine decay to 0 at
    ``total_steps``; ``"constant"`` an optional linear warmup from 0, then
    flat. The horizons count micro-steps and are converted to update ticks
    under ``grad_accum``. ``layer_decay`` in (0, 1] scales each leaf's
    update by :func:`layer_decay_factors` of ``params`` (needed then);
    ``ema > 0`` tracks an EMA of the params (:func:`get_ema_params`)."""
    decay_ticks, warm_ticks = _schedule_ticks(total_steps, warmup_steps, grad_accum)
    if lr_schedule == "cosine":
        warm = _linear(0.0, learning_rate, warm_ticks)
        cos = _cosine(learning_rate, max(decay_ticks, warm_ticks + 1) - warm_ticks)

        def lr(count):
            return warm(count) if count < warm_ticks else cos(count - warm_ticks)
    elif lr_schedule == "constant":
        lr = _linear(0.0, learning_rate, warm_ticks) if warm_ticks > 0 else (
            lambda count: learning_rate)
    else:
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}; use 'constant' or 'cosine'")
    factors = None
    if layer_decay > 0.0:
        if params is None:
            raise ValueError("layer_decay requires the params tree")
        factors = param_leaves(layer_decay_factors(params, layer_decay))
    return AdamW(lr, weight_decay, grad_clip, grad_accum, factors, ema)


def get_ema_params(opt_state: OptState, like: Params | None = None):
    """The EMA of the params (``None`` without ``ema``): the fp32 leaves, or
    with ``like`` (the live params) a tree of ``like``'s structure and
    dtypes, the form to evaluate or save."""
    if opt_state.ema is None or like is None:
        return opt_state.ema
    return tree_with_leaves(like, [e.to(p.dtype) for e, p in
                                   zip(opt_state.ema, param_leaves(like))])


# ---------------------------------------------------------------------------
# Batch mixing and distillation
# ---------------------------------------------------------------------------


def mixup_lam(seed: int, step: int, alpha: float) -> np.float32:
    """The step's mixup coefficient, ``λ ~ Beta(α, α)``, from the stream
    ``(seed, _MIXUP_TAG, step)``."""
    return np.float32(host_rng(seed, _MIXUP_TAG, step).beta(alpha, alpha))


def cutmix_box(lam_raw, cy: int, cx: int, height: int, width: int) -> tuple:
    """timm's ``rand_bbox`` with ``correct_lam`` (JAX's
    ``cutmix_mask_and_lam``, ``train.py:439``): a box of side ``int(dim ·
    sqrt(1 − λ_raw))`` centred at ``(cy, cx)``, its edges ``c ± cut // 2``
    clipped to the image, and the area-corrected ``λ = 1 − area / (H·W)``,
    in fp32. Returns ``(yl, yh, xl, xh, λ)``."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam_raw))
    cut_h = int(np.floor(np.float32(height) * ratio))
    cut_w = int(np.floor(np.float32(width) * ratio))
    yl, yh = min(max(cy - cut_h // 2, 0), height), min(max(cy + cut_h // 2, 0), height)
    xl, xh = min(max(cx - cut_w // 2, 0), width), min(max(cx + cut_w // 2, 0), width)
    lam = np.float32(1.0) - np.float32((yh - yl) * (xh - xl)) / np.float32(height * width)
    return yl, yh, xl, xh, lam


def draw_batch_mix(seed: int, step: int, height: int, width: int, mixup_alpha: float = 0.0,
                   cutmix_alpha: float = 0.0, switch_prob: float = 0.5) -> dict:
    """The draw half of :func:`apply_batch_mix`: ``{"mode": "mixup" |
    "cutmix" | None, "lam", "box"}``, each value a pure function of ``(seed,
    step)`` under its stream's tag (mixup's λ; CutMix's raw λ, then its
    centre row and column; the per-step switch at ``switch_prob`` when both
    alphas are set, timm's batch mode)."""
    mix: dict = {"mode": None, "lam": np.float32(1.0), "box": None}
    use_cut = cutmix_alpha > 0.0
    if mixup_alpha > 0.0 and cutmix_alpha > 0.0:
        use_cut = bool(host_rng(seed, _SWITCH_TAG, step).random() < switch_prob)
    if use_cut:
        rng = host_rng(seed, _CUTMIX_TAG, step)
        lam_raw = rng.beta(cutmix_alpha, cutmix_alpha)
        cy, cx = int(rng.integers(0, height)), int(rng.integers(0, width))
        *box, lam = cutmix_box(lam_raw, cy, cx, height, width)
        mix.update(mode="cutmix", lam=lam, box=tuple(box))
    elif mixup_alpha > 0.0:
        mix.update(mode="mixup", lam=mixup_lam(seed, step, mixup_alpha))
    return mix


def mix_images(images: torch.Tensor, lam) -> torch.Tensor:
    """Mixup's blend, ``λ·x + (1−λ)·reverse(x)`` (timm pairs the batch with
    its own reverse), λ in the images' dtype."""
    lam = torch.tensor(float(lam), dtype=torch.float32).to(images.device, images.dtype)
    return lam * images + (1.0 - lam) * images.flip(0)


def apply_batch_mix(images: torch.Tensor, mix: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The apply half (JAX's ``apply_batch_mix``, ``train.py:479``): NHWC
    ``images`` mixed as ``mix`` says (:func:`draw_batch_mix`), and λ as an
    fp32 0-dim tensor on their device; CutMix pastes the box from the
    reversed batch."""
    lam = torch.tensor(float(mix["lam"]), dtype=torch.float32, device=images.device)
    if mix["mode"] == "mixup":
        return mix_images(images, mix["lam"]), lam
    if mix["mode"] == "cutmix":
        yl, yh, xl, xh = mix["box"]
        out = images.clone()
        out[:, yl:yh, xl:xh] = images.flip(0)[:, yl:yh, xl:xh]
        return out, lam
    return images, lam


def mixed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, lam,
                        label_smoothing: float = 0.0) -> torch.Tensor:
    """Mixup's loss: the λ-weighted cross entropy against the labels and the
    reversed labels."""
    return lam * cross_entropy(logits, labels, label_smoothing) + (1.0 - lam) * cross_entropy(
        logits, labels.flip(0), label_smoothing)


def distillation_loss(dist_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      kind: str = "hard", tau: float = 1.0) -> torch.Tensor:
    """DeiT's distillation term (``rajni_tpu/train.py:550``). ``hard``: cross
    entropy of the dist head against the teacher's argmax; ``soft``: ``τ² ·
    KL(softmax(teacher/τ) ‖ softmax(student/τ))`` summed and divided by the
    logits' size (the DeiT repository's normalization)."""
    if kind == "hard":
        return cross_entropy(dist_logits, teacher_logits.argmax(-1))
    t_div = torch.full((), tau, dtype=torch.float32, device=dist_logits.device)
    t = torch.log_softmax(teacher_logits.float() / t_div, dim=-1)
    s = torch.log_softmax(dist_logits.float() / t_div, dim=-1)
    kl_sum = (t.exp() * (t - s)).sum()
    return (tau * tau) * kl_sum / dist_logits.numel()


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: OptState
    step: int = 0


def create_train_state(params: Params, tx: AdamW) -> TrainState:
    """Make the parameters autograd leaves and initialize the optimizer."""
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return TrainState(params, tx.init(leaves))


def step_drop_path_masks(seed: int, step: int, rate: float, depth: int, batch: int,
                         dtype: torch.dtype, device) -> list:
    """A train step's drop-path masks: per block ``(m_attn, m_mlp)`` from the
    stream ``(seed, _DROPPATH_TAG, step, block)`` on ``device``, JAX's key
    schedule (one fold per block, split into the two branches)."""
    return drop_path_masks(rate, depth, batch, dtype,
                           lambda b: device_generator(seed, _DROPPATH_TAG, step, b, device=device))


def make_train_step(config: ViTConfig, schedule: Schedule | None, tx: AdamW,
                    label_smoothing: float = 0.0, impl: str = "torch", mixup_alpha: float = 0.0,
                    cutmix_alpha: float = 0.0, switch_prob: float = 0.5, seed: int = 0,
                    remat: bool = False, drop_path: float = 0.0, distill: tuple | None = None,
                    teacher_params: Params | None = None, teacher_impl: str | None = None):
    """``train_step(state, images, labels) -> {"loss", "accuracy"}``: the
    forward through the pruning schedule, the loss, the gradients and one
    optimizer micro-step, the parameters updated in place
    (``rajni_tpu/train.py:574-746``). ``impl="cuda"`` runs
    :func:`.models.train_path.vit_forward_train`, ``"torch"`` the plain
    forward under autograd; both take ``remat`` and ``drop_path``.

    Mixing (``mixup_alpha``, ``cutmix_alpha``, ``switch_prob``) happens
    outside autograd, drawn from ``(seed, state.step)``; the loss is then the
    λ-weighted cross entropy against both label sets, the accuracy against
    the unmixed labels. The drop-path masks come from ``(seed, state.step,
    block)`` (:func:`step_drop_path_masks`). ``distill`` — ``(kind, alpha,
    tau, teacher_config)`` with ``teacher_params`` — adds DeiT's
    distillation: the student's dist head (a single-head student's head
    twice, JAX's "usual distillation") against the teacher's unpruned
    inference forward under ``no_grad`` on ``teacher_impl`` (``impl`` when
    ``None``; the CLI resolves it from the teacher's own config, so a
    student demoted to ``"torch"`` keeps its teacher on the kernels),
    ``(1 − α)·base + α·distill``."""
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown impl {impl!r}; use 'cuda' or 'torch'")
    mixing = mixup_alpha > 0.0 or cutmix_alpha > 0.0
    teacher_impl = teacher_impl or impl

    def forward(params, images, dps, return_dist=False):
        if impl == "cuda":
            return vit_forward_train(params, images, config, schedule, remat=remat,
                                     dp_masks=dps, return_dist=return_dist)
        return vit_forward(params, images, config, schedule, "torch", remat=remat, dp_masks=dps,
                           return_dist=return_dist)

    def base_loss(logits, labels, lam):
        if mixing:
            return mixed_cross_entropy(logits, labels, lam, label_smoothing)
        return cross_entropy(logits, labels, label_smoothing)

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> dict:
        lam = None
        if mixing:
            with torch.no_grad():
                mix = draw_batch_mix(seed, state.step, images.shape[1], images.shape[2],
                                     mixup_alpha, cutmix_alpha, switch_prob)
                images, lam = apply_batch_mix(images, mix)
        leaves = param_leaves(state.params)
        dps = None
        if drop_path > 0.0:
            dps = step_drop_path_masks(seed, state.step, drop_path, config.depth,
                                       images.shape[0], leaves[0].dtype, images.device)
        with torch.enable_grad():
            if distill is not None:
                kind, alpha, tau, teacher_config = distill
                logits, dist_logits = forward(state.params, images, dps, return_dist=True)
                with torch.no_grad():
                    teacher = vit_forward(teacher_params, images, teacher_config, None,
                                          teacher_impl)
                loss = (1.0 - alpha) * base_loss(logits, labels, lam) + alpha * distillation_loss(
                    dist_logits, teacher, kind, tau)
            else:
                logits = forward(state.params, images, dps)
                loss = base_loss(logits, labels, lam)
            grads = torch.autograd.grad(loss, leaves)
        tx.update(grads, state.opt_state, leaves)
        state.step += 1
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return train_step


# ---------------------------------------------------------------------------
# Saving and resuming
# ---------------------------------------------------------------------------


def save_train_state(path: str, state: TrainState, backend: str = "msgpack") -> None:
    """Persist the whole train state: params, Adam's ``mu`` and ``nu``, the
    update count, ``grad_accum``'s ``mini_step`` and running mean, the EMA
    and ``step`` (JAX's ``save_train_state``, ``train.py:307``), in the
    port's msgpack codec, written atomically (:func:`.params.io.save_tree`).
    The leaves are lists in :func:`param_leaves`' order."""
    if backend == "orbax":
        raise ValueError("--state_backend orbax is not ported: it needs the orbax package, "
                         "which the port does not use; use msgpack")
    if backend != "msgpack":
        raise ValueError(f"unknown train-state backend {backend!r}")
    o = state.opt_state
    save_tree(path, {"params": param_leaves(state.params), "count": o.count, "mu": o.mu,
                     "nu": o.nu, "mini_step": o.mini_step, "acc": o.acc, "ema": o.ema,
                     "step": state.step})


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Restore a train state saved by :func:`save_train_state` into
    ``template`` (a fresh state of the same model and optimizer flags), in
    place: each leaf copied into the template's tensor, of its dtype and on
    its device. A leaf count or shape that disagrees raises."""
    saved = load_tree(path)

    def restore(name, dst: list | None, src: list | None):
        if (dst is None) != (src is None) or (dst is not None and len(dst) != len(src)):
            raise ValueError(f"train state {path!r}: {name} does not match this run's optimizer "
                             "and model flags")
        for d, s in zip(dst or (), src or ()):
            s = s if isinstance(s, torch.Tensor) else torch.from_numpy(s)
            if tuple(s.shape) != tuple(d.shape):
                raise ValueError(f"train-state leaf shape {tuple(s.shape)} does not match the "
                                 f"template's {tuple(d.shape)}: was the state saved with other "
                                 "--model/--schedule flags?")
            with torch.no_grad():
                d.copy_(s.to(d.dtype))

    o = template.opt_state
    restore("params", param_leaves(template.params), saved["params"])
    for name in ("mu", "nu", "acc", "ema"):
        restore(name, getattr(o, name), saved[name])
    o.count, o.mini_step = int(saved["count"]), int(saved["mini_step"])
    template.step = int(saved["step"])
    return template


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def synthetic_batch(seed: int, batch: int, img_size: int,
                    num_classes: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX CLI's synthetic batch (``rajni_tpu/train.py:1411-1417``):
    ``default_rng(seed)``'s standard normals as fp32 NHWC images, then its
    int32 labels."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, img_size, img_size, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, batch).astype(np.int32)
    return images, labels


def _eval_top1(fwd, params, loader, batch_size: int, device, max_batches: int | None = None):
    """Top-1 accuracy over a validation loader (JAX's ``_eval_top1``,
    ``train.py:749``): the ragged last batch padded to ``batch_size`` (one
    shape for the kernels), the pad rows dropped before counting."""
    correct = total = 0
    for i, (im, lb) in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        b = int(im.shape[0])
        if b == 0:
            continue
        if b < batch_size:
            im = np.concatenate([im, np.zeros((batch_size - b,) + im.shape[1:], im.dtype)])
        logits = fwd(params, torch.from_numpy(im).to(device))[:b]
        correct += int((logits.argmax(-1).cpu().numpy() == np.asarray(lb)[:b]).sum())
        total += b
    return 100.0 * correct / max(total, 1)


def get_args(argv=None):
    p = argparse.ArgumentParser("RAJNI PyTorch/CUDA fine-tuning")
    p.add_argument("--data_path", type=str, default=None, help="ImageFolder training root")
    p.add_argument("--synthetic", action="store_true",
                   help="Train on one synthetic batch drawn from --seed (the JAX CLI's)")
    p.add_argument("--shuffle", action="store_true",
                   help="Reshuffle the training set each pass, in the order "
                        "np.random.default_rng([seed, pass]).permutation (--resume replays it)")
    p.add_argument("--augment", action="store_true",
                   help="RandomResizedCrop + horizontal flip on the device from decode-only "
                        "uint8 canvases (rajni_tpu_torch.data.augment); requires --data_path")
    p.add_argument("--canvas", type=int, default=512,
                   help="With --augment: the decode canvas side; larger images are "
                        "downscaled to fit")
    p.add_argument("--repeated_aug", type=int, default=0, metavar="N",
                   help="Repeated augmentation: each step reads ceil(batch/N) images and "
                        "repeats each N times; requires --augment")
    p.add_argument("--rand_augment", type=str, default=None, metavar="CFG",
                   help="With --augment: a timm RandAugment config (e.g. "
                        "'rand-m9-mstd0.5-inc1') on the uint8 crop after the flip")
    p.add_argument("--reprob", type=float, default=0.0, metavar="P",
                   help="With --augment: timm RandomErasing probability after normalizing")
    p.add_argument("--remode", type=str, default="pixel", choices=("pixel", "rand", "const"),
                   help="RandomErasing fill mode (timm remode)")
    p.add_argument("--recount", type=int, default=1,
                   help="RandomErasing rectangles per image (timm recount)")
    p.add_argument("--label_smoothing", type=float, default=0.0, metavar="S")
    p.add_argument("--mixup", type=float, default=0.0, metavar="ALPHA",
                   help="Mixup with lam ~ Beta(ALPHA, ALPHA) a step (0 = off)")
    p.add_argument("--cutmix", type=float, default=0.0, metavar="ALPHA",
                   help="CutMix with lam ~ Beta(ALPHA, ALPHA) a step, area-corrected (0 = off)")
    p.add_argument("--mixup_switch_prob", type=float, default=0.5, metavar="P",
                   help="With --mixup and --cutmix: the probability of CutMix a step")
    p.add_argument("--model", type=str, default="vit_base_patch16_224")
    p.add_argument("--schedule", type=str, default=None,
                   help="Pruning schedule JSON to train through")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Initial params: msgpack of either package, or a timm .pth/.pt/.bin; "
                        "random if absent")
    p.add_argument("--output", type=str, default="rajni_finetuned.msgpack")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_schedule", type=str, default="constant", choices=["constant", "cosine"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--grad_accum", type=int, default=1, metavar="K",
                   help="Average K micro-batch gradients per optimizer update; --steps "
                        "counts micro-steps")
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--layer_decay", type=float, default=0.0, metavar="D",
                   help="Layer-wise LR decay: block i at lr*D^(depth-i), the embeddings at "
                        "lr*D^(depth+1), the head at lr (0 = off)")
    p.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                   help="Track an fp32 EMA of the params per update, saved as <output>.ema "
                        "(0 = off)")
    p.add_argument("--grad_clip", type=float, default=0.0, metavar="NORM",
                   help="Clip the gradient to this global L2 norm before AdamW (0 = off)")
    p.add_argument("--kernels", type=str, default="auto", choices=["auto", "cuda", "torch"],
                   help="The CUDA kernel training path, or the plain forward under autograd "
                        "(auto: the kernels on a card)")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="Param dtype (fp32 default, as the JAX CLI's)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--eval_data", type=str, default=None,
                   help="Validation ImageFolder: top-1 every --eval_every steps and after the "
                        "last; the best params are saved to <output>.best")
    p.add_argument("--eval_every", type=int, default=0, metavar="N")
    p.add_argument("--eval_batches", type=int, default=None, metavar="M")
    p.add_argument("--eval_batch_size", type=int, default=None)
    p.add_argument("--save_state_every", type=int, default=0, metavar="N",
                   help="Every N steps (and at the last), save the whole train state "
                        "atomically; 0 = off")
    p.add_argument("--state_path", type=str, default=None,
                   help="Train-state file (default <output>.state)")
    p.add_argument("--state_backend", type=str, default="msgpack", choices=["msgpack", "orbax"],
                   help="msgpack only: orbax is not ported")
    p.add_argument("--resume", type=str, default=None, metavar="STATE",
                   help="Resume from a saved train state; --steps is the total budget")
    p.add_argument("--remat", action="store_true",
                   help="Recompute each block's forward in the backward (the kernels on "
                        "--kernels cuda)")
    p.add_argument("--drop_path", type=float, default=0.0, metavar="RATE",
                   help="Stochastic depth at rates linspace(0, RATE, depth)")
    p.add_argument("--distill_teacher", type=str, default=None, metavar="CKPT",
                   help="Distill from this frozen teacher checkpoint (msgpack or timm .pth)")
    p.add_argument("--distill_model", type=str, default=None, metavar="NAME",
                   help="The teacher's architecture (required with --distill_teacher)")
    p.add_argument("--distill_type", choices=["hard", "soft"], default="hard")
    p.add_argument("--distill_alpha", type=float, default=0.5,
                   help="loss = (1-alpha)*CE(labels) + alpha*distill")
    p.add_argument("--distill_tau", type=float, default=1.0,
                   help="Soft-distillation temperature")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="Write a torch.profiler Chrome trace of the training loop")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    _validate(args)
    return args


def _validate(args) -> None:
    """The JAX CLI's checks (``rajni_tpu/train.py:1040-1110``) that apply to
    one device."""
    if args.eval_every and not args.eval_data:
        raise ValueError("--eval_every requires --eval_data")
    if not 0.0 <= args.drop_path < 1.0:
        raise ValueError("--drop_path must be in [0, 1)")
    if args.distill_teacher and not args.distill_model:
        raise ValueError("--distill_teacher requires --distill_model (the teacher architecture "
                         "name)")
    if args.distill_teacher and not 0.0 <= args.distill_alpha <= 1.0:
        raise ValueError("--distill_alpha must be in [0, 1]")
    if args.distill_teacher and args.distill_tau <= 0.0:
        raise ValueError("--distill_tau must be > 0")
    if args.augment and (args.synthetic or not args.data_path):
        raise ValueError("--augment requires a real --data_path dataset (crops are sampled "
                         "from decode-only uint8 canvases)")
    if (args.rand_augment or args.reprob) and not args.augment:
        raise ValueError("--rand_augment/--reprob extend the augmentation: they require "
                         "--augment")
    if args.repeated_aug < 0 or args.repeated_aug == 1:
        raise ValueError("--repeated_aug must be 0 (off) or >= 2 repeats")
    if args.repeated_aug > 1 and not args.augment:
        raise ValueError("--repeated_aug requires --augment: without augmentation the N copies "
                         "of each image are identical")
    if args.rand_augment:
        from .data.randaug import parse_rand_augment

        parse_rand_augment(args.rand_augment)
    if not 0.0 <= args.reprob <= 1.0:
        raise ValueError("--reprob must be in [0, 1]")
    if args.recount < 1:
        raise ValueError("--recount must be >= 1")
    if not 0.0 <= args.label_smoothing < 1.0:
        raise ValueError("--label_smoothing must be in [0, 1)")
    if args.mixup < 0.0:
        raise ValueError("--mixup alpha must be >= 0")
    if args.cutmix < 0.0:
        raise ValueError("--cutmix alpha must be >= 0")
    if not 0.0 <= args.mixup_switch_prob <= 1.0:
        raise ValueError("--mixup_switch_prob must be in [0, 1]")
    if args.grad_clip < 0.0:
        raise ValueError("--grad_clip must be >= 0 (0 disables)")
    if not 0.0 <= args.ema < 1.0:
        raise ValueError("--ema decay must be in [0, 1) (0 disables)")
    if not 0.0 <= args.layer_decay <= 1.0:
        raise ValueError("--layer_decay must be in [0, 1] (0 disables)")
    if args.state_backend == "orbax":
        raise ValueError("--state_backend orbax is not ported (it needs the orbax package); "
                         "use msgpack")
    if args.data_path is None and not args.synthetic:
        raise ValueError("provide --data_path or --synthetic")


def _train_batches(args, config: ViTConfig, start_step: int):
    """The training data stream, ``(images, labels)`` numpy batches (canvas
    tuples with ``--augment``), as the JAX CLI reads it
    (``rajni_tpu/train.py:1404-1515``): full batches only, each pass in
    dataset order or, with ``--shuffle``, in ``default_rng([seed,
    pass]).permutation``; repeated augmentation repeats each image N times
    and truncates; a resumed run fast-forwards ``start_step % bpe`` batches
    of its pass."""
    from .data.pipeline import DataLoader, ImageFolder

    if args.augment:
        dataset = ImageFolder(args.data_path, img_size=config.img_size, output="canvas",
                              canvas=args.canvas)
    else:
        dataset = ImageFolder(args.data_path, img_size=config.img_size)
    batch = sub_batch = args.batch_size
    if args.repeated_aug > 1:
        sub_batch = -(-batch // args.repeated_aug)
    if len(dataset) < sub_batch:
        raise ValueError(f"dataset ({len(dataset)} images) smaller than the batch ({sub_batch}) "
                         "— no full batch can ever be formed")
    loader = DataLoader(dataset, batch_size=sub_batch)
    print(f"training on {len(dataset)} images, {len(dataset.classes)} classes"
          + (f", {args.repeated_aug}x repeated augmentation ({sub_batch} unique/step)"
             if args.repeated_aug > 1 else ""))
    base = list(dataset.samples)
    bpe = max(len(dataset) // sub_batch, 1)  # full batches per pass

    def batches(pass_idx):
        while True:
            if args.shuffle:
                perm = np.random.default_rng([args.seed, pass_idx]).permutation(len(base))
                dataset.samples = [base[j] for j in perm]
            for im, lb in loader:
                lead = im[0] if isinstance(im, tuple) else im
                if lead.shape[0] != sub_batch:
                    continue
                if args.repeated_aug > 1:
                    def rep(a):
                        return np.repeat(np.asarray(a), args.repeated_aug, axis=0)[:batch]

                    im = tuple(rep(a) for a in im) if isinstance(im, tuple) else rep(im)
                    lb = rep(lb)
                yield im, lb.astype(np.int32)
            pass_idx += 1

    it = batches(start_step // bpe if args.shuffle else 0)
    skip = start_step % bpe
    if skip:
        print(f"resume: fast-forwarding the data stream {skip} batches (decode only)")
        for _ in range(skip):
            next(it)
    return it


def main(argv=None) -> TrainState:
    args = get_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        print(f"Device: {torch.cuda.get_device_name(device)}")
    config = get_config(args.model)
    schedule = load_schedule(args.schedule, config.depth) if args.schedule else None
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    if args.checkpoint:
        params = load_checkpoint_auto(args.checkpoint, args.model, dtype=dtype, device=device)
        config = adapt_config_to_params(config, params)
    else:
        params = init_params(torch.Generator().manual_seed(args.seed), config, dtype, device)
    distill, teacher_params = None, None
    if args.distill_teacher:
        teacher_params = load_checkpoint_auto(args.distill_teacher, args.distill_model,
                                              dtype=dtype, device=device)
        teacher_cfg = adapt_config_to_params(get_config(args.distill_model), teacher_params)
        if teacher_cfg.img_size != config.img_size:
            raise ValueError(f"teacher resolution {teacher_cfg.img_size} != student "
                             f"{config.img_size}: both forwards share one batch")
        distill = (args.distill_type, args.distill_alpha, args.distill_tau, teacher_cfg)
        print(f"distilling from {args.distill_model} ({args.distill_type}, "
              f"alpha={args.distill_alpha})")
    impl, why = resolve_route(args.kernels, config, dtype, device, training=True)
    print(route_line(impl, why))
    teacher_impl = None
    if distill is not None:  # the teacher's own route: a demoted student leaves it on the kernels
        teacher_impl, why = resolve_route(args.kernels, distill[3], dtype, device)
        print(f"teacher {route_line(teacher_impl, why)}")

    tx = build_optimizer(args.lr, args.steps, args.weight_decay, args.lr_schedule,
                         args.warmup_steps, args.grad_accum, args.grad_clip, args.ema,
                         args.layer_decay, params)
    state = create_train_state(params, tx)
    step_fn = make_train_step(config, schedule, tx, args.label_smoothing, impl, args.mixup,
                              args.cutmix, args.mixup_switch_prob, args.seed, args.remat,
                              args.drop_path, distill, teacher_params, teacher_impl)
    if args.resume:
        state = load_train_state(args.resume, state)
        print(f"resumed train state from {args.resume} at step {state.step}")
    start_step = state.step

    if args.data_path is None:
        images, labels = synthetic_batch(args.seed, args.batch_size, config.img_size,
                                         config.num_classes)
        batch_iter = itertools.repeat((torch.from_numpy(images).to(device),
                                       torch.from_numpy(labels).to(device)))
    else:
        batch_iter = _train_batches(args, config, start_step)

    run_eval = None
    if args.eval_data:
        from .data.pipeline import DataLoader, ImageFolder

        eb = args.eval_batch_size or args.batch_size
        eval_loader = DataLoader(ImageFolder(args.eval_data, img_size=config.img_size),
                                 batch_size=eb)

        @torch.no_grad()
        def eval_fwd(p, x):
            return vit_forward(p, x, config, schedule, impl)

        best_acc = -1.0
        if args.resume and os.path.exists(f"{args.output}.best"):
            from .params.io import load_params

            best_acc = _eval_top1(eval_fwd, load_params(f"{args.output}.best", dtype=dtype,
                                                        device=device),
                                  eval_loader, eb, device, args.eval_batches)
            print(f"seeded best val_top1 {best_acc:.2f}% from existing {args.output}.best")

        def run_eval(at_step):
            nonlocal best_acc
            candidates = [("", state.params)]
            if args.ema > 0.0:
                candidates.append((" (ema)", get_ema_params(state.opt_state, like=state.params)))
            for tag, tree in candidates:
                acc = _eval_top1(eval_fwd, tree, eval_loader, eb, device, args.eval_batches)
                print(f"step {at_step:6d}  val_top1{tag} {acc:.2f}%")
                if acc > best_acc:
                    best_acc = acc
                    save_params(f"{args.output}.best", tree)
                    print(f"new best ({acc:.2f}%{tag}) -> {args.output}.best")

    state_path = args.state_path or f"{args.output}.state"
    erase = (args.reprob, args.remode, args.recount) if args.reprob > 0.0 else None
    last_eval = None
    with profiled(args.profile, device):
        for step in range(start_step + 1, args.steps + 1):
            im, lb = next(batch_iter)
            if args.augment:
                from .data.augment import augment_on_device

                im = augment_on_device(torch.from_numpy(im[0]).to(device),
                                       torch.from_numpy(im[1]).to(device), args.seed, step,
                                       crop=config.img_size, dtype=dtype,
                                       rand_augment=args.rand_augment, erase=erase)
            elif isinstance(im, np.ndarray):
                im = torch.from_numpy(im).to(device)
            if isinstance(lb, np.ndarray):
                lb = torch.from_numpy(lb).to(device)
            metrics = step_fn(state, im, lb)
            if step % args.log_every == 0 or step == args.steps:
                print(f"step {step:6d}  loss {float(metrics['loss']):.4f}  "
                      f"acc {float(metrics['accuracy']):.3f}")
            if args.save_state_every and (step % args.save_state_every == 0
                                          or step == args.steps):
                save_train_state(state_path, state, args.state_backend)
            if run_eval is not None and args.eval_every and step % args.eval_every == 0:
                run_eval(step)
                last_eval = step
    if run_eval is not None and last_eval != args.steps:
        run_eval(args.steps)
    save_params(args.output, state.params)
    print(f"saved fine-tuned params -> {args.output}")
    if args.ema > 0.0:
        save_params(f"{args.output}.ema", get_ema_params(state.opt_state, like=state.params))
        print(f"saved EMA params -> {args.output}.ema")
    return state


if __name__ == "__main__":
    main()
