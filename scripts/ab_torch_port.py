#!/usr/bin/env python3
"""img/s of the port's paths for several checkouts in turn, on one card.

    python3 scripts/ab_torch_port.py PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT

Each root is a checkout of this repository (for example a parent commit
unpacked with ``git archive`` into an ignored directory). For each root in
the order given, a fresh process imports that root's ``rajni_tpu_torch``
(which builds its kernels into its own ``_build``) and measures the
throughput of ViT-B/16 224 bf16 (batch 256), ViT-B/16 384 bf16 (batch 128),
ViT-B/16 224 int8 (P3b, batch 256), ViT-B/16 384 int8 (P4a, batch 128),
DeiT-S/16 384 int8 (P5d, batch 128, ``DEIT_S_DYNAMIC``), ViT-L/16 224 bf16
(P5c, batch 256, ``VIT_L_AGGRESSIVE``), DeiT-S/16 224 bf16 (P3a, batch 256,
``DEIT_S_DYNAMIC``) and ViT-B/16 224 with MLP-only int8 (P4c, batch 256),
pruned and with the identity schedule, and the train img/s of ViT-B/16 224
bf16 through the kernels (T6, batch 128), as chip_smoke.py measures them. Prints the card's
name and power limit, then one JSON line per run; a path that a checkout
does not route yet (``NotImplementedError``) reads null. Compare two versions
only within one call, in turns. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# scripts/bench_suite.py:34 DEIT_S_DYNAMIC: blocks 3-10 keep 0.9, rescoring
DEIT_S_DYNAMIC = {i: {"keep_ratio": 0.9, "update": True} for i in range(3, 11)}
# scripts/bench_suite.py:37 VIT_L_AGGRESSIVE: keep 0.7 at blocks 4, 8, 12, 16
VIT_L_AGGRESSIVE = {i: {"keep_ratio": 0.7} for i in (4, 8, 12, 16)}
# (model, image side, batch, int8 mode, pruned schedule; None: REFERENCE_SCHEDULE).
# int8 mode: None (bf16), "dynamic" (every product) or "mlp" (the MLP only)
PATHS = (("vit_base_patch16_224", 224, 256, None, None),
         ("vit_base_patch16_384", 384, 128, None, None),
         ("vit_base_patch16_224", 224, 256, "dynamic", None),
         ("vit_base_patch16_384", 384, 128, "dynamic", None),
         ("deit_small_patch16_384", 384, 128, "dynamic", DEIT_S_DYNAMIC),
         ("vit_large_patch16_224", 224, 256, None, VIT_L_AGGRESSIVE),
         ("deit_small_patch16_224", 224, 256, None, DEIT_S_DYNAMIC),
         ("vit_base_patch16_224", 224, 256, "mlp", None))
TRAIN_MODEL, TRAIN_BATCH = "vit_base_patch16_224", 128


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
    for model, side, batch, int8, schedule in PATHS:
        schedule = schedule or REFERENCE_SCHEDULE
        raw = RAJNIViT(model, schedule, kernels="cuda", seed=0, device=dev)
        params = quantize_params(raw.params, attn=int8 != "mlp") if int8 else raw.params
        gen = torch.Generator().manual_seed(1)
        images = torch.randn(batch, side, side, 3, generator=gen).to(dev)
        for name, sched in (("pruned", schedule), ("identity", None)):
            key = f"{model}{f' int8 {int8}' if int8 else ''} {name}"
            m = RAJNIViT(model, sched, params=params, kernels="cuda", device=dev)
            try:
                ips = measure_throughput(m, images, batch=batch, device=dev, iters=10, warmup=2,
                                         repeats=3)
            except NotImplementedError:  # a tree that does not route this path yet
                out[key] = None
                continue
            out[key] = round(ips, 1)
        del raw, params, images

    from rajni_tpu_torch import train as tt
    from rajni_tpu_torch.models import vit as tvit

    config = tvit.get_config(TRAIN_MODEL)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(TRAIN_BATCH, config.img_size, config.img_size, 3, generator=gen).to(dev)
    labels = torch.randint(0, config.num_classes, (TRAIN_BATCH,), generator=gen).to(dev)
    for name, sched in (("pruned", REFERENCE_SCHEDULE), ("identity", None)):
        tx = tt.build_optimizer(1e-4, 100, 0.05)
        params = tvit.init_params(torch.Generator().manual_seed(0), config, torch.bfloat16, dev)
        state = tt.create_train_state(params, tx)
        step = tt.make_train_step(config, sched, tx, impl="cuda")
        ips = measure_throughput(step, state, images, labels, batch=TRAIN_BATCH, device=dev,
                                 iters=10, warmup=2, repeats=3)
        out[f"{TRAIN_MODEL} train {name}"] = round(ips, 1)
        del state, step
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
