"""Evaluation CLI (port of ``rajni_tpu/run.py``, single device)::

    python -m rajni_tpu_torch.run --data_path /path/to/val \\
        --schedule schedule.json [--checkpoint vit_b16.pth | params.msgpack] \\
        [--preprocess host|device|device-full [--canvas 512]] [--num_workers 8] \\
        [--compare_base] [--kernels cuda] [--device cuda] [--profile DIR] [--no-progress] \\
        [--quantize [--calibrate N [--save_scales f.json] | --load_scales f.json]]
    python -m rajni_tpu_torch.run --synthetic 3 --batch_size 64 --schedule schedule.json

``--data_path`` is an ImageNet-style folder (a subdirectory a class);
``--synthetic N`` evaluates N batches of random images instead. Parameters
are random (drawn from ``--seed``) unless ``--checkpoint`` names a msgpack
checkpoint of either package or a timm ``.pth``/``.pt``/``.bin`` state_dict,
converted on loading (:func:`.params.io.load_checkpoint_auto`).

``--preprocess`` says where the eval transform runs (:mod:`.data.device`):
``host`` ships normalized float32 (the reference protocol; the C++ library
where it builds, else PIL), ``device`` ships the host's uint8 crop and
normalizes on the device, ``device-full`` ships the decoded image on a uint8
canvas and resizes, crops and normalizes on the device. The device stage
runs inside the timed forward. The ``preprocess:`` line names the tier that
ran (``host (native)``, ``host (PIL)``, ``device``, ``device-full``) and the
``route:`` line whether the kernels run or the config or dtype was demoted
to the plain path. ``--quantize`` runs int8 weights (dynamic per-row
activation scales); ``--calibrate N`` calibrates static scales on the first
N batches, through the same preprocessing stage, before quantizing;
``--load_scales`` reads scales that ``--save_scales`` wrote. ``--profile
DIR`` writes a ``torch.profiler`` Chrome trace of the RAJNI evaluation.
``--artifact FILE`` evaluates an artifact of :mod:`.export` (its weights,
schedule, route and dtype baked in) with the same accounting. The parallel
flags are not ported yet.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import torch

from .data.pipeline import DataLoader, ImageFolder, SyntheticLoader
from .eval import _to_device, evaluate_model
from .models.vit import (
    adapt_config_to_params,
    get_config,
    model_stats,
    params_quantized,
    resolve_route,
    route_line,
)
from .models.wrapper import RAJNIViT
from .params.io import load_checkpoint_auto
from .quant import ActScales, calibrate_act_scales, quantize_params
from .utils.schedule import load_schedule, schedule_to_dict
from .utils.timing import require_device

TIERS = {"host": "float32", "device": "uint8", "device-full": "canvas"}


def get_args(argv=None):
    p = argparse.ArgumentParser("RAJNI PyTorch/CUDA evaluation")
    p.add_argument("--data_path", type=str, default=None,
                   help="ImageNet-style dataset root (a subdirectory a class)")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--num_workers", type=int, default=8,
                   help="Decode threads of the image loader")
    p.add_argument("--pin_mem", action="store_true", default=True,
                   help="Accepted for the JAX CLI's flags: batches always reach the "
                        "card from pinned host memory")
    p.add_argument("--model", type=str, default="vit_base_patch16_224")
    p.add_argument("--schedule", type=str, default=None,
                   help="Path to JSON pruning schedule")
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="Evaluate N synthetic batches instead of --data_path")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--kernels", type=str, default="auto",
                   choices=["auto", "torch", "cuda"],
                   help="Block backend: the hand-written CUDA kernels "
                        "(auto on a card) or the plain PyTorch ops path")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--artifact", type=str, default=None, metavar="FILE",
                   help="Evaluate an exported serving artifact (rajni_tpu_torch.export) "
                        "with the same accounting; its weights, schedule, kernels and "
                        "dtype are baked in, so --checkpoint/--schedule/--quantize/"
                        "--kernels are rejected; fixed artifacts set the batch and pad "
                        "the ragged last one")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Params: msgpack of either package, or a timm .pth/.pt/.bin "
                        "state_dict (converted on loading); random if absent")
    p.add_argument("--compare_base", action="store_true",
                   help="Also evaluate the unpruned model and print the speedup")
    p.add_argument("--preprocess", type=str, default="host", choices=list(TIERS),
                   help="Where the eval transform runs: 'host' (normalized float32 "
                        "copies), 'device' (the host's uint8 crop, normalized on the "
                        "device, bit for bit the host's), 'device-full' (decoded images on "
                        "a uint8 canvas; resize, crop and normalize on the device)")
    p.add_argument("--canvas", type=int, default=512,
                   help="Side of the uint8 canvas of --preprocess device-full")
    p.add_argument("--progress", action=argparse.BooleanOptionalAction, default=True,
                   help="Show a progress bar (where tqdm is installed)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="Write a torch.profiler Chrome trace of the RAJNI evaluation "
                        "into DIR")
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


def make_preprocess_stage(preprocess: str, config, dtype=torch.bfloat16):
    """The on-device stage of a ``--preprocess`` tier (None for ``host``):
    the device batch of the loader's output mode → normalized ``dtype``
    images, run inside the timed forward."""
    if preprocess == "device":
        from .data.device import normalize_images

        return lambda images: normalize_images(images, dtype)
    if preprocess == "device-full":
        from .data.device import preprocess_on_device

        def stage(images):
            canvas, sizes = images
            return preprocess_on_device(canvas, sizes, crop=config.img_size,
                                        resize=int(config.img_size * 256 / 224), dtype=dtype)

        return stage
    return None


def _with_stage(model, stage):
    if stage is None:
        return model
    return lambda images: model(stage(images))


def _data(args, config):
    """The loader and the ``preprocess:`` line's tier."""
    if args.synthetic is not None:
        if args.preprocess != "host":
            print("WARNING: --synthetic yields preprocessed float batches; "
                  "forcing --preprocess host")
            args.preprocess = "host"
        loader = SyntheticLoader(num_batches=args.synthetic, batch_size=args.batch_size,
                                 img_size=config.img_size, num_classes=config.num_classes,
                                 seed=args.seed)
        print(f"\nUsing {args.synthetic} synthetic batches of {args.batch_size} "
              "(accuracy not meaningful)")
        return loader, "none (synthetic batches)"
    if args.data_path is None:
        raise ValueError("provide --data_path or --synthetic N")
    dataset = ImageFolder(args.data_path, img_size=config.img_size,
                          output=TIERS[args.preprocess], canvas=args.canvas)
    loader = DataLoader(dataset, batch_size=args.batch_size, num_workers=args.num_workers)
    print(f"\nLoaded validation set: {len(dataset)} images, {len(dataset.classes)} classes")
    tier = args.preprocess
    if tier == "host":
        tier = f"host ({dataset.host_tier()})"
        from .data import native

        if native.error():
            print(f"NOTE: the C++ preprocessing did not build; PIL runs: {native.error()}")
    return loader, tier


def _eval_artifact(args, device):
    """Evaluate an exported artifact (``rajni_tpu/run.py:_eval_artifact``):
    the program a server loads gets the live model's accounting. A fixed
    artifact drives the loader at its batch and pads the ragged last batch
    with zero images (logits sliced back); bucket and dynamic artifacts take
    ``--batch_size``."""
    from .export import load_exported

    rejected = {
        "--checkpoint": args.checkpoint,
        "--schedule": args.schedule,
        "--quantize": args.quantize,
        "--calibrate": args.calibrate,
        "--load_scales": args.load_scales,
        "--save_scales": args.save_scales,
        "--compare_base": args.compare_base,
        "--kernels": args.kernels != "auto",
    }
    bad = [k for k, v in rejected.items() if v]
    if bad:
        raise ValueError(f"--artifact evaluates a baked program; {', '.join(bad)} cannot "
                         "apply — set them at export time (rajni_tpu_torch.export)")
    if args.preprocess != "host":
        raise ValueError("--artifact expects normalized float inputs (the exported "
                         "program starts at the model); use --preprocess host")
    serve = load_exported(args.artifact, device)
    config = serve.config
    img_size, in_dtype = config.img_size, serve.input_spec.dtype
    fixed = not serve.dynamic_batch and not serve.buckets
    batch = int(serve.input_spec.shape[0]) if fixed else args.batch_size
    kind = "fixed" if fixed else f"buckets {serve.buckets}" if serve.buckets else "dynamic"
    print(f"\nArtifact {args.artifact}: {img_size}px, batch {kind}, "
          f"{str(in_dtype).removeprefix('torch.')}")
    print(serve.route)
    if fixed and batch != args.batch_size:
        print(f"NOTE: loader batch follows the artifact ({batch}), not --batch_size "
              f"({args.batch_size})")
    args.batch_size = batch
    loader, tier = _data(args, config)
    print(f"preprocess: {tier}")
    print(f"Token counts per block: {model_stats(config, serve.schedule)['token_counts']}")

    with _profiled(args.profile, device):
        acc, throughput = evaluate_model(serve.any_batch, loader, device=device, max_batches=args.max_batches,
                                         warmup=args.warmup, progress=args.progress)
    print(f"\nArtifact model: top-1 {acc:.3f}% | {throughput:.1f} img/s")
    return acc, throughput


def main(argv=None):
    args = get_args(argv)
    _check_quant_args(args)
    print("\nArgs:")
    for k, v in vars(args).items():
        print(f"  {k}: {v}")
    device = require_device(args.device)
    if device.type == "cuda":
        print(f"Device: {torch.cuda.get_device_name(device)}")
    if args.artifact:
        return _eval_artifact(args, device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    config = get_config(args.model)
    loader, tier = _data(args, config)

    if args.checkpoint:
        params = load_checkpoint_auto(args.checkpoint, args.model)
        print(f"Loaded params from {args.checkpoint}")
        # extended-variant checkpoints carry their semantics in the tree, not the name
        adapted = adapt_config_to_params(config, params)
        if adapted != config:
            config = adapted
            print("Adapted config to checkpoint variant: "
                  f"qk_norm={config.qk_norm} global_pool={config.global_pool} "
                  f"reg_tokens={config.reg_tokens} distilled={config.distilled} "
                  f"no_embed_class={config.no_embed_class}")
    else:
        params = None
        print("WARNING: no --checkpoint given; using randomly initialized "
              "params (throughput valid, accuracy meaningless)")
    base = RAJNIViT(config, None, params=params, dtype=dtype, kernels=args.kernels,
                    seed=args.seed, device=device)
    stage = make_preprocess_stage(args.preprocess, config, dtype)

    raw_params, params = base.params, base.params
    calib = []
    if args.calibrate:  # captured before quantization: calibration runs the raw weights
        for i, (images, _) in enumerate(loader):
            if i >= args.calibrate:
                break
            x = _to_device(images, device)
            calib.append(x if stage is None else stage(x))
        print(f"Captured {len(calib)} calibration batches")
        if not calib:
            raise ValueError("--calibrate captured 0 batches (empty dataset/loader?)")
    if args.quantize:
        params = quantize_params(raw_params)
        print("Quantized qkv, proj, fc1, fc2 and head weights to int8")
    # the route of the params evaluated (int8 ones demote where the int8 kernels do not go)
    print(route_line(*resolve_route(args.kernels, config, dtype, device, params_quantized(params))))
    print(f"preprocess: {tier}")
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
        return evaluate_model(_with_stage(model, stage), loader, device=device,
                              max_batches=args.max_batches, warmup=args.warmup,
                              progress=args.progress)

    result = {}
    base_scales = scales_for(None) if args.compare_base else None
    if args.schedule is None:
        raise ValueError("You must provide --schedule for RAJNI evaluation")
    schedule = load_schedule(args.schedule, config.depth)
    act_scales = scales_for(schedule)
    calib.clear()
    if args.compare_base:
        print("\nEvaluating BASE model")
        result["base"] = run_eval(RAJNIViT(config, None, params=params, dtype=dtype,
                                           kernels=args.kernels, device=device,
                                           act_scales=base_scales))
        print(f"Base  - Accuracy: {result['base'][0]:.2f}%, "
              f"Throughput: {result['base'][1]:.1f} img/s")

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
    with _profiled(args.profile, device):
        result["rajni"] = run_eval(model)
    acc, tput = result["rajni"]
    print(f"RAJNI - Accuracy: {acc:.2f}%, Throughput: {tput:.1f} img/s")
    if args.compare_base:
        speedup = tput / result["base"][1]
        drop = result["base"][0] - acc
        print(f"\nSpeedup: {speedup:.2f}x | Accuracy drop: {drop:.2f}%")
    return result


@contextlib.contextmanager
def _profiled(directory: str | None, device: torch.device):
    """A ``torch.profiler`` trace of the block, written as
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


if __name__ == "__main__":
    main()
