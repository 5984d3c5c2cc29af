#!/usr/bin/env python3
"""Sound readings of chip_smoke.py's first-step training checks, over seeds.

    python3 scripts/train_first_step_readings.py [--seeds 4] [--out FILE]

For T6 (ViT-B/16 224, batch 128, bf16, ``REFERENCE_SCHEDULE``), T6 with
drop-path 0.1, DeiT-3 (``deit3_base_patch16_224``) and a ViT-B/16 with the
pooled ``fc_norm`` head, runs ``chip_smoke.first_step`` with params seeded
0 .. seeds-1 (the images, labels and drop-path masks from the same seed):
the kernel route against the kernels' plain versions and against the
torch-autograd route, on the kernel route's kept sets. Prints the card's
name and power limit and one JSON line per (config, seed) with the loss
difference and the worst leaf's gradient relative L2 against each, the
largest score discrepancy of a selection against the plain versions
(relative to the largest score) and the share of images whose selection by
the torch route differs; then the largest reading of each over the seeds.
These are the readings that chip_smoke's gates are set from. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--out", type=str, default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from rajni_tpu_torch.kernels import build
    from rajni_tpu_torch.models import vit as tvit

    if not torch.cuda.is_available():
        print("train_first_step_readings: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    build.build()
    device = torch.device("cuda", 0)
    base = tvit.get_config(cs.PATH224)
    configs = {"T6": (None, 0.0), f"T6 drop-path {cs.DROP_PATH}": (None, cs.DROP_PATH),
               "deit3_base_patch16_224": (dataclasses.replace(
                   tvit.get_config("deit3_base_patch16_224"), no_embed_class=True), 0.0),
               "ViT-B/16 avg-pool fc_norm": (dataclasses.replace(
                   base, global_pool="avg", use_fc_norm=True), 0.0)}
    lines, worst = [], {}
    for name, (cfg, rate) in configs.items():
        for seed in range(args.seeds):
            r = cs.first_step(device, cs.TRAIN, tag=f"{name} seed {seed}", config=cfg,
                              drop_path=rate, seed=seed, printed=False)
            row = {"config": name, "seed": seed,
                   "plain_loss": r["plain"]["loss"], "plain_grad": r["plain"]["worst"],
                   "torch_loss": r["torch"]["loss"], "torch_grad": r["torch"]["worst"],
                   "score_rel": max(g["delta_rel"] for g in r["plain"]["sel"].values()),
                   "torch_sel_share": max(g["images"] for g in r["torch"]["sel"].values())
                   / cs.B_TRAIN}
            print(json.dumps(row))
            lines.append(row)
            w = worst.setdefault(name, {})
            for k, v in row.items():
                if k not in ("config", "seed"):
                    w[k] = max(w.get(k, 0.0), v)
            torch.cuda.empty_cache()
    print(json.dumps({"largest over the seeds": worst}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(l) + "\n" for l in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
