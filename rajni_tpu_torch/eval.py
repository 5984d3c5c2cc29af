"""Single-device evaluation harness (port of ``rajni_tpu/eval.py``).

Accounting kept from the reference:
  * ``warmup`` untimed batches, restarting the iterator when it runs out;
  * the host→device copy happens, and is fenced, outside the timed region;
  * the timed region is the forward only, fenced on the card;
  * ``acc = 100 * correct / max(total, 1)``;
  * ``throughput = total / max(time, 1e-6)`` images per second.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

import numpy as np
import torch

from .utils.timing import fence, require_device


def _to_device(images, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(images)).to(device)


def evaluate_model(
    model: Callable[[torch.Tensor], torch.Tensor],
    dataloader: Iterable,
    device="cuda",
    max_batches: int | None = None,
    warmup: int = 5,
) -> tuple[float, float]:
    """Evaluate ``model`` (images ``[B, H, W, 3]`` on ``device`` → logits)
    over ``(images, labels)`` numpy batches; return ``(top1 %, img/s)``."""
    device = require_device(device)
    if warmup > 0:
        print(f"Warming up {warmup} batches")
        it = iter(dataloader)
        for _ in range(warmup):
            try:
                x, _ = next(it)
            except StopIteration:
                it = iter(dataloader)
                try:
                    x, _ = next(it)
                except StopIteration:
                    raise ValueError("dataloader yielded no batches") from None
            model(_to_device(x, device))
            fence(device)

    correct = total = 0
    total_time = 0.0
    for i, (images, labels) in enumerate(dataloader):
        if max_batches is not None and i >= max_batches:
            break
        x = _to_device(images, device)
        fence(device)  # the copy stays outside the timed region

        start = time.perf_counter()
        logits = model(x)
        fence(device)
        total_time += time.perf_counter() - start

        preds = logits.argmax(dim=1).cpu().numpy()
        correct += int((preds == np.asarray(labels)).sum())
        total += int(len(labels))

    acc = 100.0 * correct / max(total, 1)
    return acc, total / max(total_time, 1e-6)
