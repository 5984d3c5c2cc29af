"""Random streams keyed on ``(seed, tag, step[, more])``.

The JAX package derives every training stream in-graph as
``fold_in(fold_in(key(seed), tag), step)`` (``rajni_tpu/train.py:420-423``),
so a resumed run replays the same draws with no RNG state to checkpoint.
The port keeps that key schedule, not threefry's bits: each stream's seed is
a pure function of the same integers, through numpy's ``SeedSequence``, and
seeds a numpy generator (scalars drawn on the host) or a ``torch.Generator``
on the device that draws.
"""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(*key: int) -> int:
    """A 64-bit seed from non-negative integers ``(seed, tag, step, ...)``."""
    return int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])


def host_rng(*key: int) -> np.random.Generator:
    """A numpy generator for the stream ``key``."""
    return np.random.default_rng(stream_seed(*key))


def device_generator(*key: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for the stream ``key``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(stream_seed(*key))
    return gen
