"""Device selection and the fence for wall-clock timing.

CUDA launches return before the card finishes, so a timed region ends in
``torch.cuda.synchronize()`` (:func:`fence`).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def require_device(device) -> torch.device:
    """Resolve ``device``; raise when it names CUDA and no card is present
    (there is no silent move to the CPU: pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    return dev


def fence(device: torch.device) -> None:
    """Block the host until all work queued on ``device`` has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_throughput(fn, *args, batch: int, device: torch.device,
                       iters: int = 20, warmup: int = 3,
                       repeats: int = 3) -> float:
    """Best-of-``repeats`` throughput of ``fn(*args)`` in items/s:
    ``warmup`` fenced calls, then loops of ``iters`` back-to-back calls
    fenced once at the end."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    for _ in range(warmup):
        fn(*args)
        fence(device)
    best = 0.0
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        fence(device)
        best = max(best, iters * batch / max(time.perf_counter() - t0, 1e-9))
    return best


@contextlib.contextmanager
def profiled(directory: str | None, device: torch.device):
    """A ``torch.profiler`` trace of the ``with`` block, written as
    ``DIR/trace.json`` (Chrome's trace format), or nothing."""
    if directory is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    print(f"Profiling to {directory}")
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Wrote the trace {path}")
