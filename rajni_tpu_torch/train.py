"""Training step and fine-tuning CLI (port of ``rajni_tpu/train.py``)::

    python -m rajni_tpu_torch.train --synthetic --model vit_base_patch16_224 \\
        --schedule schedule.json --steps 4 --batch_size 32 --dtype bfloat16 \\
        --kernels cuda --output out.msgpack

Trains a ViT through its pruning schedule and saves a msgpack checkpoint
that both packages load (:mod:`.params.io`). ``--kernels cuda`` runs the
kernel training path (:func:`.models.train_path.vit_forward_train`),
``torch`` the plain forward under autograd; ``auto`` takes the kernels on a
card and the plain forward elsewhere, and the card demotes a config or dtype
the kernels do not take to the plain forward (the ``route:`` line says
which). The optimizer is optax's ``adamw`` with its schedule, clipping and
gradient accumulation semantics (:func:`build_optimizer`); the parameters are
updated in place. Not ported yet (ROADMAP A3): layer decay, EMA, drop-path,
remat, mixup and cutmix, distillation, augmentation, train-state resume,
ImageFolder data, and the parallel flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Callable

import torch

from .models.train_path import vit_forward_train
from .models.vit import (
    Params,
    ViTConfig,
    get_config,
    init_params,
    resolve_route,
    route_line,
    vit_forward,
)
from .params.io import load_params, save_params
from .utils.schedule import Schedule, load_schedule
from .utils.timing import require_device


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


def param_leaves(params: Params) -> list[torch.Tensor]:
    """The parameter tensors in a fixed order (dictionary order, blocks in
    sequence)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    if isinstance(params, list):
        return [t for v in params for t in param_leaves(v)]
    return [params]


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


def _divisors(value: float):
    """``t -> value`` as a 0-dim tensor of ``t``'s dtype on its device, made
    once per (dtype, device): dividing by it is a true division, as optax
    divides by its traced scalars cast to the leaf's dtype (on CUDA PyTorch
    takes ``tensor / python_number`` as a multiply by the reciprocal)."""
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


@dataclasses.dataclass
class OptState:
    count: int  # inner updates taken (the Adam and schedule count)
    mu: list
    nu: list
    mini_step: int = 0  # micro-steps accumulated since the last update
    acc: list | None = None  # the running mean of the micro-gradients


class AdamW:
    """optax ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on every
    leaf), preceded by ``clip_by_global_norm`` when ``grad_clip > 0`` and
    wrapped in ``MultiSteps`` when ``grad_accum > 1``, applied in place.

    What optax does and ``torch.optim`` does not: the learning rate is read
    at the update count BEFORE it is incremented (a warmup's first update has
    lr 0); the clip scales by ``max_norm / ‖g‖`` only when ``‖g‖ ≥ max_norm``,
    with no ``+1e-6``; the moments keep the parameters' dtype; accumulation
    keeps the running mean ``acc + (g − acc)/(n + 1)`` and updates once per
    ``grad_accum`` micro-steps, the schedule counting updates.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: Callable[[int], float], weight_decay: float, grad_clip: float = 0.0,
                 grad_accum: int = 1):
        self.lr, self.weight_decay = lr, weight_decay
        self.grad_clip, self.grad_accum = grad_clip, grad_accum

    def init(self, params: list[torch.Tensor]) -> OptState:
        zeros = [torch.zeros_like(p, requires_grad=False) for p in params]
        return OptState(0, zeros, [torch.zeros_like(z) for z in zeros],
                        acc=[torch.zeros_like(z) for z in zeros] if self.grad_accum > 1 else None)

    @torch.no_grad()
    def update(self, grads, state: OptState, params: list[torch.Tensor]) -> None:
        """One micro-step: accumulate, and every ``grad_accum`` micro-steps
        move ``params`` in place."""
        if self.grad_accum > 1:
            n = state.mini_step
            count = _divisors(n + 1)
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
        c1, c2 = _divisors(1 - self.b1**state.count), _divisors(1 - self.b2**state.count)
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (m / c1(m)) / (torch.sqrt(v / c2(v)) + self.eps)
            p.add_(-lr * (u + self.weight_decay * p))
        if self.grad_accum > 1:
            for a in state.acc:
                a.zero_()


def build_optimizer(learning_rate: float, total_steps: int, weight_decay: float = 0.05,
                    lr_schedule: str = "constant", warmup_steps: int = 0, grad_accum: int = 1,
                    grad_clip: float = 0.0) -> AdamW:
    """AdamW with the JAX package's fine-tuning knobs (``train.py:230``):
    ``"cosine"`` is a linear warmup from 0 then a cosine decay to 0 at
    ``total_steps``; ``"constant"`` an optional linear warmup from 0, then
    flat. The horizons count micro-steps and are converted to update ticks
    under ``grad_accum``. Layer decay and EMA are not ported yet."""
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
    return AdamW(lr, weight_decay, grad_clip, grad_accum)


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


def make_train_step(config: ViTConfig, schedule: Schedule | None, tx: AdamW,
                    label_smoothing: float = 0.0, impl: str = "torch"):
    """``train_step(state, images, labels) -> {"loss", "accuracy"}``: the
    forward through the pruning schedule, the loss, the gradients and one
    optimizer micro-step, the parameters updated in place. ``impl="cuda"``
    runs :func:`.models.train_path.vit_forward_train`, ``"torch"`` the plain
    forward under autograd."""
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown impl {impl!r}; use 'cuda' or 'torch'")

    def forward(params, images):
        if impl == "cuda":
            return vit_forward_train(params, images, config, schedule)
        return vit_forward(params, images, config, schedule, "torch")

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> dict:
        leaves = param_leaves(state.params)
        with torch.enable_grad():
            logits = forward(state.params, images)
            loss = cross_entropy(logits, labels, label_smoothing)
            grads = torch.autograd.grad(loss, leaves)
        tx.update(grads, state.opt_state, leaves)
        state.step += 1
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return train_step


def get_args(argv=None):
    p = argparse.ArgumentParser("RAJNI PyTorch/CUDA fine-tuning")
    p.add_argument("--synthetic", action="store_true", required=True,
                   help="Train on one synthetic batch drawn from --seed (the only data "
                        "source ported so far)")
    p.add_argument("--model", type=str, default="vit_base_patch16_224")
    p.add_argument("--schedule", type=str, default=None,
                   help="Pruning schedule JSON to train through")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Initial params (msgpack of either package); random if absent")
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
    p.add_argument("--grad_clip", type=float, default=0.0, metavar="NORM",
                   help="Clip the gradient to this global L2 norm before AdamW (0 = off)")
    p.add_argument("--label_smoothing", type=float, default=0.0, metavar="S")
    p.add_argument("--kernels", type=str, default="auto", choices=["auto", "cuda", "torch"],
                   help="The CUDA kernel training path, or the plain forward under autograd "
                        "(auto: the kernels on a card)")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="Param dtype (fp32 default, as the JAX CLI's)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> TrainState:
    args = get_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        print(f"Device: {torch.cuda.get_device_name(device)}")
    config = get_config(args.model)
    schedule = load_schedule(args.schedule, config.depth) if args.schedule else None
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    gen = torch.Generator().manual_seed(args.seed)
    if args.checkpoint:
        params = load_params(args.checkpoint, dtype=dtype, device=device)
    else:
        params = init_params(gen, config, dtype, device)
    impl, why = resolve_route(args.kernels, config, dtype, device, training=True)
    print(route_line(impl, why))

    tx = build_optimizer(args.lr, args.steps, args.weight_decay, args.lr_schedule,
                         args.warmup_steps, args.grad_accum, args.grad_clip)
    state = create_train_state(params, tx)
    step_fn = make_train_step(config, schedule, tx, args.label_smoothing, impl)
    images = torch.randn(args.batch_size, config.img_size, config.img_size, 3,
                         generator=gen).to(device)
    labels = torch.randint(0, config.num_classes, (args.batch_size,), generator=gen).to(device)
    for step in range(1, args.steps + 1):
        metrics = step_fn(state, images, labels)
        if step % args.log_every == 0 or step == args.steps:
            print(f"step {step:6d}  loss {float(metrics['loss']):.4f}  "
                  f"acc {float(metrics['accuracy']):.3f}")
    save_params(args.output, state.params)
    print(f"saved fine-tuned params -> {args.output}")
    return state


if __name__ == "__main__":
    main()
