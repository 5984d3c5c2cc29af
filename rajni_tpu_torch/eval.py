"""Single-device evaluation harness (port of ``rajni_tpu/eval.py``).

Accounting kept from the reference:
  * ``warmup`` untimed batches, restarting the iterator when it runs out
    (each padded to the first batch's size, as JAX's ``_pad_to``);
  * the host→device copy happens, and is fenced, outside the timed region;
  * the timed region is the forward only (with an on-device preprocessing
    stage, the stage too), fenced on the card;
  * ``acc = 100 * correct / max(total, 1)``;
  * ``throughput = total / max(time, 1e-6)`` images per second.

The copies run ``prefetch`` batches ahead of the forward, from pinned host
memory on a stream of their own (``non_blocking``), so they overlap the
forward of the batch before; each batch's copy is waited for before its
timer starts. A batch is an array or, for the canvas tier
(:func:`.data.device.preprocess_on_device`), the tuple ``(canvas, sizes)``.
The timed loop runs a partial last batch as it is: an eager forward has no
program to compile for a new batch size.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Iterable

import numpy as np
import torch

from .utils.timing import fence, require_device

try:  # a soft dependency
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None


def _host_batch(images):
    """A host batch as numpy: an array, or a tuple of arrays (canvas tier)."""
    if isinstance(images, tuple):
        return tuple(np.asarray(e) for e in images)
    return np.asarray(images)


def _batch_dim(images) -> int:
    return (images[0] if isinstance(images, tuple) else images).shape[0]


def _pad_to(images, b: int):
    """Zero-pad a partial batch up to ``b`` rows."""
    if isinstance(images, tuple):
        return tuple(_pad_to(e, b) for e in images)
    pad = b - images.shape[0]
    if pad <= 0:
        return images
    return np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)], axis=0)


def _to_device(images, device: torch.device, stream=None):
    """A host batch on ``device`` (a tensor, or a tuple of them); with a
    ``stream``, through pinned memory and ``non_blocking`` on it."""
    if isinstance(images, tuple):
        return tuple(_to_device(e, device, stream) for e in images)
    t = torch.from_numpy(np.ascontiguousarray(images))
    if stream is None:
        return t.to(device)
    with torch.cuda.stream(stream):
        return t.pin_memory().to(device, non_blocking=True)


def _prefetch_to_device(iterator, device: torch.device, depth: int = 2):
    """Yield ``(images on device, labels)`` with the copies of the next
    ``depth`` batches issued before a batch is handed out. On the card they
    run on a side stream, and each batch comes with the event that its copy
    has finished (None on the CPU)."""
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    buf = collections.deque()
    for images, labels in iterator:
        x = _to_device(_host_batch(images), device, stream)
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
        buf.append((x, np.asarray(labels), event))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def _ready(x, event) -> None:
    """The fence before the timer: the copy of ``x`` has finished, and the
    current stream may use its memory."""
    if event is None:
        return
    event.synchronize()
    current = torch.cuda.current_stream()
    current.wait_event(event)
    for t in x if isinstance(x, tuple) else (x,):
        t.record_stream(current)


def evaluate_model(
    model: Callable,
    dataloader: Iterable,
    device="cuda",
    max_batches: int | None = None,
    warmup: int = 5,
    progress: bool = True,
    prefetch: int = 2,
) -> tuple[float, float]:
    """Evaluate ``model`` (a device batch → logits ``[B, classes]``) over
    ``(images, labels)`` numpy batches; return ``(top1 %, img/s)``.

    ``prefetch`` batches' copies are issued ahead of the forward (0: none);
    ``progress`` shows a tqdm bar (where tqdm is installed) with the running
    accuracy and img/s."""
    device = require_device(device)
    if warmup > 0:
        print(f"Warming up {warmup} batches")
        it = iter(dataloader)
        warm_b = None
        for _ in range(warmup):
            try:
                x, _ = next(it)
            except StopIteration:
                it = iter(dataloader)
                try:
                    x, _ = next(it)
                except StopIteration:
                    raise ValueError("dataloader yielded no batches") from None
            x = _host_batch(x)
            if warm_b is None:
                warm_b = _batch_dim(x)
            model(_to_device(_pad_to(x, warm_b), device))
            fence(device)

    correct = total = 0
    total_time = 0.0
    iterator = _prefetch_to_device(iter(dataloader), device, max(prefetch, 0))
    pbar = None
    if progress and tqdm is not None:
        try:
            n = len(dataloader)  # type: ignore[arg-type]
        except TypeError:
            n = None
        pbar = tqdm(iterator, desc="Evaluating",
                    total=max_batches if max_batches is not None else n, leave=False)
        iterator = pbar

    for i, (x, labels, event) in enumerate(iterator):
        if max_batches is not None and i >= max_batches:
            break
        _ready(x, event)  # the copy stays outside the timed region

        start = time.perf_counter()
        logits = model(x)
        fence(device)
        total_time += time.perf_counter() - start

        preds = logits.argmax(dim=1).cpu().numpy()
        correct += int((preds == labels).sum())
        total += int(len(labels))
        if pbar is not None and total > 0:
            pbar.set_postfix(acc=f"{100.0 * correct / total:.2f}%",
                             imgs_per_s=f"{total / max(total_time, 1e-6):.1f}")
    if pbar is not None:
        pbar.close()

    acc = 100.0 * correct / max(total, 1)
    return acc, total / max(total_time, 1e-6)
