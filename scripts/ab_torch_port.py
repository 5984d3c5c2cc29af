#!/usr/bin/env python3
"""img/s of the port's paths for several checkouts in turn, on one card.

    python3 scripts/ab_torch_port.py PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT

Each root is a checkout of this repository (for example a parent commit
unpacked with ``git archive`` into an ignored directory). For each root in
the order given, a fresh process imports that root's ``rajni_tpu_torch``
(which builds its kernels into its own ``_build``) and measures the
throughput of ViT-B/16 224 bf16 (batch 256), ViT-B/16 384 bf16 (batch 128),
ViT-B/16 224 int8 (batch 256) and ViT-B/16 384 int8 (batch 128), pruned
(``REFERENCE_SCHEDULE``) and with the identity schedule, as chip_smoke.py
measures them. Prints the card's name and power limit, then one JSON line per
run; a path that a checkout does not route yet (``NotImplementedError``)
reads null. Compare two versions only within one call, in turns. Needs a
CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (model, image side, batch, int8)
PATHS = (("vit_base_patch16_224", 224, 256, False), ("vit_base_patch16_384", 384, 128, False),
         ("vit_base_patch16_224", 224, 256, True), ("vit_base_patch16_384", 384, 128, True))


def measure(root: str) -> dict:
    """The img/s of every path for the checkout at ``root`` (run in a process
    of its own, with ``root`` first on ``sys.path``)."""
    sys.path.insert(0, root)
    import torch

    import rajni_tpu_torch
    from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT
    from rajni_tpu_torch.quant import quantize_params
    from rajni_tpu_torch.utils.timing import measure_throughput

    if not rajni_tpu_torch.__file__.startswith(str(Path(root).resolve())):
        raise RuntimeError(f"imported {rajni_tpu_torch.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"root": root}
    for model, side, batch, int8 in PATHS:
        raw = RAJNIViT(model, REFERENCE_SCHEDULE, kernels="cuda", seed=0, device=dev)
        params = quantize_params(raw.params) if int8 else raw.params
        gen = torch.Generator().manual_seed(1)
        images = torch.randn(batch, side, side, 3, generator=gen).to(dev)
        for name, sched in (("pruned", REFERENCE_SCHEDULE), ("identity", None)):
            key = f"{model}{' int8' if int8 else ''} {name}"
            m = RAJNIViT(model, sched, params=params, kernels="cuda", device=dev)
            try:
                ips = measure_throughput(m, images, batch=batch, device=dev, iters=10, warmup=2,
                                         repeats=3)
            except NotImplementedError:  # a tree that does not route this path yet
                out[key] = None
                continue
            out[key] = round(ips, 1)
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(str(Path(argv[1]).resolve()))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for root in argv:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
