#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's forward spends its time on the card.

    python3 scripts/profile_torch_port.py [--model vit_base_patch16_224] [--batch 256] [--iters 3]
    python3 scripts/profile_torch_port.py --model vit_base_patch16_384 --batch 128
    python3 scripts/profile_torch_port.py --model vit_huge_patch14_224 --batch 128 --schedule h.json
    python3 scripts/profile_torch_port.py --quantize [--calibrate]
    python3 scripts/profile_torch_port.py --model vit_base_patch16_384 --batch 128 --quantize [--calibrate]
    python3 scripts/profile_torch_port.py --model vit_large_patch16_224 --schedule s.json --quantize
    python3 scripts/profile_torch_port.py --train cuda --batch 128

Runs the model in bf16 through ``RAJNIViT(kernels="cuda")`` with
``REFERENCE_SCHEDULE`` (or the schedule JSON file ``--schedule``, in the eval
CLI's format: ViT-H/14's ``VIT_H_PROBE``, ``scripts/bench_suite.py:46-49``, is
``{"5": {"keep_ratio": 0.7}, "10": ..., "15": ..., "20": ...}``) and with the
identity schedule, under
``torch.profiler``, and prints for each: the device time per forward by
kernel name and summed by kind (:func:`kind_of`), the wall time per forward
and the device's busy share.
``--quantize`` runs int8 weights (dynamic scales); with ``--calibrate``,
static scales calibrated on the profiled batch before quantization (at 384
tokens that is the split int8 route: B9, B10, B12, B13, B5 and B15). The
two-kernel route's selection (past 256 tokens) is the port's selection
kernel (``csrc/select.cu``), in the profile with the rest.
``--train cuda`` (or ``torch``) profiles a training step instead (forward,
backward and AdamW on bf16 params, ``rajni_tpu_torch.train.make_train_step``
on the kernel route, or the plain forward under autograd), per step.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def kind_of(name: str) -> str:
    """A device kernel's kind, by its name: the port's own kernels (the
    wgmma GEMM, ``gemm_sm90_kernel``, bf16 (K1-K3, B4, B5, B17) or int8 (its
    ``S8Epi`` instantiations, B9-B15), the int8 row-band GEMM
    (``band_s8_kernel``: B10's and B11's proj); the row quantizer,
    ``quant_rows_kernel``; B18; the forward attention, the short-row kernel
    or B6's body; other), library GEMMs, and PyTorch's elementwise, copy and
    reduction kernels."""
    if "rajni" in name:
        if "gemm_sm90" in name:
            return "port GEMM int8 wgmma" if "S8Epi" in name else "port GEMM wgmma"
        if "band_s8" in name:
            return "port band GEMM int8"
        if "quant_rows" in name:
            return "port row quantizer"
        if "sdpa_bwd" in name:
            return "port B18"
        if "short_attn" in name or "sdpa_wgmma" in name:
            return "port attention"
        return "port other"
    if any(k in name for k in ("nvjet", "cutlass", "gemm", "splitKreduce")):
        return "library GEMM"
    if "copy" in name or "Memcpy" in name:
        return "copy/cast"
    if "reduce_kernel" in name:
        return "reduction"
    if "elementwise" in name or "Memset" in name:
        return "elementwise"
    return "other"


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="vit_base_patch16_224")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--schedule", default=None,
                   help="schedule JSON file (default: REFERENCE_SCHEDULE)")
    p.add_argument("--quantize", action="store_true", help="int8 weights, dynamic scales")
    p.add_argument("--calibrate", action="store_true",
                   help="with --quantize: static scales calibrated on the batch")
    p.add_argument("--train", choices=("cuda", "torch"), default=None,
                   help="profile a training step on this route instead of a forward")
    args = p.parse_args(argv)
    if args.calibrate and not args.quantize:
        p.error("--calibrate requires --quantize")
    if args.train and args.quantize:
        p.error("--train trains bf16 params; --quantize does not apply")
    if not torch.cuda.is_available():
        print("profile_torch_port: CUDA is not available", file=sys.stderr)
        return 2

    from rajni_tpu_torch import REFERENCE_SCHEDULE, RAJNIViT, calibrate_act_scales, quantize_params
    from rajni_tpu_torch.models.vit import get_config
    from rajni_tpu_torch.utils.schedule import load_schedule

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    schedule = (REFERENCE_SCHEDULE if args.schedule is None
                else load_schedule(args.schedule, get_config(args.model).depth))
    pruned = RAJNIViT(args.model, schedule, kernels="cuda", device=device)
    side = pruned.config.img_size
    images = torch.randn(args.batch, side, side, 3, generator=gen).to(device)
    base = RAJNIViT(args.model, None, params=pruned.params, kernels="cuda", device=device)
    if args.quantize:
        raw, cfg = pruned.params, pruned.config
        scales = {k: calibrate_act_scales(raw, images, cfg, s) if args.calibrate else None
                  for k, s in (("pruned", schedule), ("identity", None))}
        q = quantize_params(raw)
        pruned = RAJNIViT(args.model, schedule, params=q, kernels="cuda",
                          device=device, act_scales=scales["pruned"])
        base = RAJNIViT(args.model, None, params=q, kernels="cuda", device=device,
                        act_scales=scales["identity"])
    mode = ("int8 static" if args.calibrate else "int8 dynamic") if args.quantize else "bf16"
    if args.train:
        mode = f"bf16 training step, kernels={args.train}"
    print(f"model {args.model} ({mode}), batch {args.batch}, token counts "
          f"{pruned.get_last_stats()['token_counts']}")
    runs = {"pruned": lambda: pruned(images), "identity": lambda: base(images)}
    if args.train:
        from rajni_tpu_torch import train as tt

        labels = torch.randint(0, pruned.config.num_classes, (args.batch,), generator=gen)
        labels = labels.to(device)
        for label, model in (("pruned", pruned), ("identity", base)):
            tx = tt.build_optimizer(1e-4, 100, 0.05)
            state = tt.create_train_state(RAJNIViT(args.model, device=device).params, tx)
            step = tt.make_train_step(model.config, model.schedule, tx, impl=args.train)
            runs[label] = lambda step=step, state=state: step(state, images, labels)
    unit = "step" if args.train else "forward"

    for label, run in runs.items():
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
        rows = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:  # device kernels only
                continue
            dev_us = e.self_device_time_total
            if dev_us > 0:
                rows[e.key] = rows.get(e.key, 0.0) + dev_us / 1e3 / args.iters
        busy = sum(rows.values())
        print(f"\n{label}: batch {args.batch}, wall {wall_ms:.3f} ms/{unit}, device busy "
              f"{busy:.3f} ms/{unit} ({100 * busy / wall_ms:.1f}% of wall)")
        for name, ms in sorted(rows.items(), key=lambda kv: -kv[1]):
            print(f"  {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:110]}")
        by_kind: dict[str, float] = {}
        for name, ms in rows.items():
            by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms
        print("  by kind: " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                        sorted(by_kind.items(), key=lambda kv: -kv[1])))

    return 0


if __name__ == "__main__":
    sys.exit(main())
