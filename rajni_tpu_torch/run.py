"""Evaluation CLI (port of ``rajni_tpu/run.py``, single device, synthetic
data)::

    python -m rajni_tpu_torch.run --synthetic 3 --batch_size 64 \\
        --schedule schedule.json [--compare_base] [--kernels cuda] [--device cuda] \\
        [--quantize [--calibrate N [--save_scales f.json] | --load_scales f.json]] \\
        [--checkpoint params.msgpack]

Parameters are random (drawn from ``--seed``) unless ``--checkpoint`` names a
msgpack checkpoint of either package (:mod:`.params.io`): throughput is
meaningful, accuracy on synthetic data is not. ``--quantize`` runs int8 weights (dynamic per-row
activation scales); ``--calibrate N`` calibrates static scales on the first
N batches before quantizing, ``--load_scales`` reads scales that
``--save_scales`` wrote. The ``route:`` line says whether the kernels run or
the config or dtype was demoted to the plain path. The dataset path, parallelism,
preprocessing modes, artifacts and profiling are not ported yet.
"""

from __future__ import annotations

import argparse

import torch

from .data.pipeline import SyntheticLoader
from .eval import evaluate_model
from .models.vit import params_quantized, resolve_route, route_line
from .models.wrapper import RAJNIViT
from .params.io import load_params
from .quant import ActScales, calibrate_act_scales, quantize_params
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
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Params (msgpack of either package); random if absent")
    p.add_argument("--compare_base", action="store_true",
                   help="Also evaluate the unpruned model and print the speedup")
    p.add_argument("--quantize", action="store_true",
                   help="Int8 qkv, proj, fc1, fc2 and head weights (dynamic "
                        "per-row activation scales)")
    p.add_argument("--calibrate", type=int, default=0, metavar="N",
                   help="With --quantize: calibrate static int8 activation "
                        "scales on the first N batches")
    p.add_argument("--save_scales", default=None, metavar="FILE",
                   help="With --calibrate: also write the calibrated scales "
                        "(pruned forward) to a JSON file")
    p.add_argument("--load_scales", default=None, metavar="FILE",
                   help="With --quantize: static scales written by "
                        "--save_scales, instead of calibrating")
    return p.parse_args(argv)


def _check_quant_args(args) -> None:
    """The JAX CLI's rules, checked before any work."""
    if args.calibrate and not args.quantize:
        raise ValueError("--calibrate requires --quantize")
    if args.save_scales and not (args.quantize and args.calibrate):
        raise ValueError("--save_scales requires --quantize --calibrate N")
    if args.load_scales:
        if not args.quantize:
            raise ValueError("--load_scales requires --quantize")
        if args.calibrate:
            raise ValueError("--load_scales and --calibrate are mutually exclusive "
                             "(loading replaces calibration)")


def main(argv=None):
    args = get_args(argv)
    _check_quant_args(args)
    print("\nArgs:")
    for k, v in vars(args).items():
        print(f"  {k}: {v}")
    device = require_device(args.device)
    if device.type == "cuda":
        print(f"Device: {torch.cuda.get_device_name(device)}")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.schedule is None:
        raise ValueError("You must provide --schedule for RAJNI evaluation")

    params = load_params(args.checkpoint) if args.checkpoint else None
    base = RAJNIViT(args.model, None, params=params, dtype=dtype, kernels=args.kernels,
                    seed=args.seed, device=device)
    config = base.config
    loader = SyntheticLoader(
        num_batches=args.synthetic, batch_size=args.batch_size,
        img_size=config.img_size, num_classes=config.num_classes, seed=args.seed,
    )
    print(f"\nUsing {args.synthetic} synthetic batches of {args.batch_size} "
          "(random params: accuracy not meaningful)")
    schedule = load_schedule(args.schedule, config.depth)

    raw_params, params = base.params, base.params
    calib = []
    if args.calibrate:  # captured before quantization: calibration runs the raw weights
        for i, (images, _) in enumerate(loader):
            if i >= args.calibrate:
                break
            calib.append(torch.from_numpy(images).to(device))
        print(f"Captured {len(calib)} calibration batches")
    if args.quantize:
        params = quantize_params(raw_params)
        print("Quantized qkv, proj, fc1, fc2 and head weights to int8")
    # the route of the params evaluated (int8 ones demote where the int8 kernels do not go)
    print(route_line(*resolve_route(args.kernels, config, dtype, device, params_quantized(params))))
    loaded = None
    if args.load_scales:
        loaded = ActScales.load(args.load_scales)
        if len(loaded.blocks) != config.depth:
            raise ValueError(f"{args.load_scales} holds scales for {len(loaded.blocks)} "
                             f"blocks but {args.model} has {config.depth}")
        print(f"Loaded static int8 activation scales from {args.load_scales}")

    def scales_for(sched):
        """Static scales for one forward: the loaded (pruned-forward) ones,
        or calibrated with that forward's schedule; None: dynamic."""
        if loaded is not None:
            return loaded if sched is not None else None
        if not calib:
            return None
        scales = calibrate_act_scales(raw_params, calib, config, sched)
        print(f"Calibrated static int8 activation scales ({'pruned' if sched else 'base'} forward)")
        return scales

    def run_eval(model):
        return evaluate_model(model, loader, device=device,
                              max_batches=args.max_batches, warmup=args.warmup)

    result = {}
    if args.compare_base:
        print("\nEvaluating BASE model")
        result["base"] = run_eval(RAJNIViT(config, None, params=params, dtype=dtype,
                                           kernels=args.kernels, device=device,
                                           act_scales=scales_for(None)))
        print(f"Base  - Accuracy: {result['base'][0]:.2f}%, "
              f"Throughput: {result['base'][1]:.1f} img/s")

    act_scales = scales_for(schedule)
    if args.save_scales:
        act_scales.save(args.save_scales)
        print(f"Saved static int8 activation scales to {args.save_scales}")
    model = RAJNIViT(config, schedule, params=params, dtype=dtype,
                     kernels=args.kernels, device=device, act_scales=act_scales)
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
