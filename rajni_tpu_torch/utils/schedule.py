"""Pruning-schedule parsing, normalization and static token-count traces.

PyTorch-side copy of ``rajni_tpu/utils/schedule.py`` (the port imports
nothing of the JAX package). Schedule format::

    {"3": {"keep_ratio": 0.95, "update": false}, ...}

  * key: transformer block index (int, or str as JSON gives it);
  * ``keep_ratio``: fraction of *patch* tokens kept (CLS always survives);
  * ``update``: recompute importance; defaults True when absent.

Internally a schedule is a per-block tuple of length ``depth`` whose
entries are ``None`` (stock block) or :class:`PruneSpec`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Sequence

from ..ops.pruning import keep_count


@dataclasses.dataclass(frozen=True)
class PruneSpec:
    """Per-block pruning config."""

    keep_ratio: float
    update: bool = True


# Per-block entries: None = stock block, PruneSpec = pruned block.
Schedule = tuple  # tuple[PruneSpec | None, ...]


def _check_ratio(ratio: float, block: int) -> None:
    if not 0.0 < ratio <= 1.0:
        raise ValueError(
            f"keep_ratio must be in (0, 1], got {ratio} for block {block}"
        )


def normalize_schedule(
    schedule: Mapping | Sequence | None,
    depth: int,
) -> Schedule:
    """Normalize any accepted schedule form to a per-block tuple.

    Accepts ``None`` (identity), a mapping ``{block: {"keep_ratio": r,
    "update": b}}`` with int or string keys, a mapping whose values are
    :class:`PruneSpec`, or an already-normalized sequence of length
    ``depth``.
    """
    if schedule is None:
        return (None,) * depth

    if isinstance(schedule, Mapping):
        out: list[PruneSpec | None] = [None] * depth
        for key, cfg in schedule.items():
            i = int(key)
            if not 0 <= i < depth:
                raise ValueError(
                    f"schedule block index {i} out of range for depth {depth}"
                )
            if isinstance(cfg, PruneSpec):
                spec = cfg
            else:
                spec = PruneSpec(
                    keep_ratio=float(cfg["keep_ratio"]),
                    update=bool(cfg.get("update", True)),
                )
            _check_ratio(spec.keep_ratio, i)
            out[i] = spec
        return tuple(out)

    seq = tuple(schedule)
    if len(seq) != depth:
        raise ValueError(f"schedule length {len(seq)} != depth {depth}")
    for i, entry in enumerate(seq):
        if entry is None:
            continue
        if not isinstance(entry, PruneSpec):
            raise TypeError(f"bad schedule entry: {entry!r}")
        _check_ratio(entry.keep_ratio, i)
    return seq


def load_schedule(path: str, depth: int) -> Schedule:
    """Load a schedule JSON file (string keys coerced to block indices)."""
    with open(path) as f:
        raw = json.load(f)
    return normalize_schedule(raw, depth)


def schedule_to_dict(schedule: Schedule) -> dict[int, dict]:
    """Inverse of :func:`normalize_schedule`, for printing/serialization."""
    return {
        i: {"keep_ratio": s.keep_ratio, "update": s.update}
        for i, s in enumerate(schedule)
        if s is not None
    }


def token_count_trace(
    num_tokens: int, schedule: Schedule, num_prefix: int = 1
) -> list[int]:
    """Token count at the *entry* of each block.

    ``keep`` depends only on the schedule and the incoming count, so the
    trace needs no forward pass.
    """
    counts = []
    n = num_tokens
    for spec in schedule:
        counts.append(n)
        if spec is not None:
            n = keep_count(spec.keep_ratio, n, num_prefix) + num_prefix
    return counts


# The shipped reference schedule: the flagship benchmark configuration.
REFERENCE_SCHEDULE = {
    3: {"keep_ratio": 0.95, "update": False},
    4: {"keep_ratio": 0.95, "update": True},
    5: {"keep_ratio": 0.85, "update": True},
    6: {"keep_ratio": 0.85, "update": True},
    7: {"keep_ratio": 0.95, "update": True},
}
