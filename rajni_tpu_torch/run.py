"""Evaluation CLI (port of ``rajni_tpu/run.py``, single device, synthetic
data)::

    python -m rajni_tpu_torch.run --synthetic 3 --batch_size 64 \\
        --schedule schedule.json [--compare_base] [--kernels cuda] [--device cuda]

Parameters are random (drawn from ``--seed``): throughput is meaningful,
accuracy is not. The dataset path, checkpoints, quantization, parallelism,
preprocessing modes, artifacts and profiling are not ported yet.
"""

from __future__ import annotations

import argparse

import torch

from .data.pipeline import SyntheticLoader
from .eval import evaluate_model
from .models.wrapper import RAJNIViT
from .utils.schedule import load_schedule, schedule_to_dict
from .utils.timing import require_device


def get_args(argv=None):
    p = argparse.ArgumentParser("RAJNI PyTorch/CUDA evaluation")
    p.add_argument("--model", type=str, default="vit_base_patch16_224")
    p.add_argument("--schedule", type=str, default=None,
                   help="Path to JSON pruning schedule")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--synthetic", type=int, required=True, metavar="N",
                   help="Evaluate N synthetic batches")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--kernels", type=str, default="auto",
                   choices=["auto", "torch", "cuda"],
                   help="Block backend: the hand-written CUDA kernels "
                        "(auto on a card) or the plain PyTorch ops path")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compare_base", action="store_true",
                   help="Also evaluate the unpruned model and print the speedup")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    print("\nArgs:")
    for k, v in vars(args).items():
        print(f"  {k}: {v}")
    device = require_device(args.device)
    if device.type == "cuda":
        print(f"Device: {torch.cuda.get_device_name(device)}")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    base = RAJNIViT(args.model, None, dtype=dtype, kernels=args.kernels,
                    seed=args.seed, device=device)
    config = base.config
    loader = SyntheticLoader(
        num_batches=args.synthetic, batch_size=args.batch_size,
        img_size=config.img_size, num_classes=config.num_classes, seed=args.seed,
    )
    print(f"\nUsing {args.synthetic} synthetic batches of {args.batch_size} "
          "(random params: accuracy not meaningful)")

    def run_eval(model):
        return evaluate_model(model, loader, device=device,
                              max_batches=args.max_batches, warmup=args.warmup)

    result = {}
    if args.compare_base:
        print("\nEvaluating BASE model")
        result["base"] = run_eval(base)
        print(f"Base  - Accuracy: {result['base'][0]:.2f}%, "
              f"Throughput: {result['base'][1]:.1f} img/s")

    if args.schedule is None:
        raise ValueError("You must provide --schedule for RAJNI evaluation")
    schedule = load_schedule(args.schedule, config.depth)
    model = RAJNIViT(config, schedule, params=base.params, dtype=dtype,
                     kernels=args.kernels, device=device)
    print("\nLoaded RAJNI schedule:")
    for k, v in schedule_to_dict(schedule).items():
        print(f"  Layer {k}: {v}")
    print(f"Token counts per block: {model.get_last_stats()['token_counts']}")
    print("\nEvaluating RAJNI model")
    result["rajni"] = run_eval(model)
    acc, tput = result["rajni"]
    print(f"RAJNI - Accuracy: {acc:.2f}%, Throughput: {tput:.1f} img/s")
    if args.compare_base:
        speedup = tput / result["base"][1]
        drop = result["base"][0] - acc
        print(f"\nSpeedup: {speedup:.2f}x | Accuracy drop: {drop:.2f}%")
    return result


if __name__ == "__main__":
    main()
