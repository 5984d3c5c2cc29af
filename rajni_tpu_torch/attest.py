"""Accuracy attestation: captured-logits fixtures and drift reports (port of
``rajni_tpu/attest.py``).

* **Fixtures**: one ``.npz`` of preprocessed images (NHWC fp32), the logits a
  reference gave on them, the model name and the pruning schedule. The
  fields are the JAX package's, so each package reads the other's files
  (``tests/fixtures/`` holds one captured from the reference program).
* **Checker**: :func:`check_fixture` runs this package's forward on the
  fixture's images and reports top-1 agreement and the logits' deviation.
* **CLI**: ``python -m rajni_tpu_torch.attest fixture.npz --checkpoint
  p.msgpack`` prints the report and exits non-zero below
  ``--min_agreement``.

``impl`` takes the port's names (``"torch"``, ``"cuda"``, ``"auto"``); the
JAX default ``"xla"`` is ``"torch"`` here. Entry points run on the card
unless ``device="cpu"``.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

import numpy as np
import torch

FIXTURE_VERSION = 1


def save_fixture(
    path: str,
    images: np.ndarray,
    logits: np.ndarray,
    model: str,
    schedule: Mapping[int, Any] | None = None,
    source: str = "",
) -> None:
    """Write a captured-logits fixture: ``images [n, H, W, 3]`` preprocessed
    (normalized) fp32, ``logits [n, classes]``, the timm ``model`` name, the
    pruning ``schedule`` (None: unpruned) and a free-text ``source``."""
    images = np.asarray(images, np.float32)
    logits = np.asarray(logits, np.float32)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [n, H, W, 3] NHWC, got {images.shape}")
    if logits.shape[0] != images.shape[0]:
        raise ValueError("images/logits length mismatch")
    from .utils.schedule import schedule_to_dict

    sched_json = (
        json.dumps({int(k): dict(v) for k, v in schedule_to_dict(
            schedule if isinstance(schedule, (list, tuple)) else _normalized(schedule, model)
        ).items()})
        if schedule is not None else "null"
    )
    np.savez_compressed(
        path,
        version=FIXTURE_VERSION,
        images=images,
        logits=logits,
        model=np.str_(model),
        schedule=np.str_(sched_json),
        source=np.str_(source),
    )


def _normalized(schedule, model: str):
    from .models.vit import get_config
    from .utils.schedule import normalize_schedule

    return normalize_schedule(schedule, get_config(model).depth)


def load_fixture(path: str) -> dict:
    """A fixture of :func:`save_fixture` (either package's) → ``images``,
    ``logits``, ``model``, ``schedule`` (a dict or None), ``source``."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["version"])
        if version > FIXTURE_VERSION:
            raise ValueError(f"fixture version {version} > {FIXTURE_VERSION}")
        sched = json.loads(str(z["schedule"]))
        return {
            "images": z["images"],
            "logits": z["logits"],
            "model": str(z["model"]),
            "schedule": {int(k): v for k, v in sched.items()} if sched else None,
            "source": str(z["source"]),
        }


def _impl(impl: str) -> str:
    """The port's name for a backend (JAX's ``xla``/``pallas`` accepted)."""
    return {"xla": "torch", "pallas": "cuda"}.get(impl, impl)


def check_fixture(
    fixture: str | dict,
    params,
    dtype: torch.dtype | None = None,
    impl: str = "torch",
    batch: int | None = None,
    act_scales=None,
    device="cuda",
) -> dict:
    """Replay a fixture through this package and report the deviation:
    ``{"n", "top1_agreement", "max_abs_diff", "mean_abs_diff", "model",
    "source"}``, ``top1_agreement`` the share of images whose argmax is the
    captured one.

    ``params`` is the port's dictionary (int8 records allowed; ``dtype``
    casts the rest, the records keep theirs); the config is the fixture
    model's, with the extended-variant flags the params carry. Images go in
    chunks of ``batch``, the last padded with zero images. ``act_scales``
    (an :class:`..quant.ActScales` or a ``--save_scales`` JSON path)
    attests the static-scale int8 configuration that serves."""
    from .models.vit import adapt_config_to_params, get_config
    from .models.wrapper import RAJNIViT
    from .quant import ActScales

    fix = load_fixture(fixture) if isinstance(fixture, str) else fixture
    config = adapt_config_to_params(get_config(fix["model"]), params)
    images = np.asarray(fix["images"], np.float32)
    ref = np.asarray(fix["logits"], np.float32)
    n = images.shape[0]
    batch = batch or n
    if isinstance(act_scales, str):
        act_scales = ActScales.load(act_scales)
    model = RAJNIViT(config, fix["schedule"], params=params,
                     dtype=dtype or params["cls_token"].dtype, kernels=_impl(impl),
                     device=device, act_scales=act_scales)
    outs = []
    for i in range(0, n, batch):
        chunk = images[i:i + batch]
        pad = batch - chunk.shape[0]
        if pad > 0:  # every chunk one batch size, as JAX keeps one program
            chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        out = model(torch.from_numpy(chunk)).float().cpu().numpy()
        outs.append(out[:out.shape[0] - pad])
    got = np.concatenate(outs)[:n]
    diff = np.abs(got - ref)
    return {
        "n": int(n),
        "top1_agreement": float((got.argmax(1) == ref.argmax(1)).mean()),
        "max_abs_diff": float(diff.max()),
        "mean_abs_diff": float(diff.mean()),
        "model": fix["model"],
        "source": fix["source"],
    }


def capture_self_fixture(
    path: str,
    params,
    model: str,
    schedule=None,
    n: int = 32,
    seed: int = 0,
    impl: str = "torch",
    device="cuda",
) -> dict:
    """Capture this package's logits (in ``params``' dtype, stored fp32) on
    ``n`` standard-normal images drawn by numpy from ``seed`` (the JAX
    package's images for the same seed) as a fixture: a pin against later
    drift."""
    from .models.vit import adapt_config_to_params, get_config
    from .models.wrapper import RAJNIViT

    config = adapt_config_to_params(get_config(model), params)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, config.img_size, config.img_size, 3)).astype(np.float32)
    dtype = params["cls_token"].dtype
    net = RAJNIViT(config, schedule, params=params, dtype=dtype, kernels=_impl(impl),
                   device=device)
    logits = net(torch.from_numpy(images)).float().cpu().numpy()
    save_fixture(path, images, logits, model, schedule,
                 source=f"rajni-tpu-torch self {str(dtype).removeprefix('torch.')} "
                        f"{_impl(impl)}")
    return {"n": n, "path": path}


def main(argv=None) -> None:
    """CLI: replay a fixture against a checkpoint and gate on agreement."""
    import argparse

    p = argparse.ArgumentParser("rajni-tpu-torch accuracy attestation")
    p.add_argument("fixture", help="captured-logits .npz fixture (either package's)")
    p.add_argument("--checkpoint", required=True,
                   help="params: msgpack of either package, or a timm .pth/.pt/.bin")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the dtype attested (bfloat16: the serving configuration)")
    p.add_argument("--kernels", default="torch", choices=["torch", "cuda", "auto"])
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--min_agreement", type=float, default=0.995,
                   help="exit non-zero below this top-1 agreement (0.995: the <=0.5%% "
                        "drop north star)")
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize the checkpoint before attesting")
    p.add_argument("--act_scales", default=None, metavar="FILE",
                   help="with --quantize: calibrated static scales JSON (--save_scales "
                        "output), the static-scale int8 configuration that serves")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.act_scales and not args.quantize:
        raise ValueError("--act_scales requires --quantize")
    from .params.io import load_checkpoint_auto

    fix = load_fixture(args.fixture)
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    params = load_checkpoint_auto(args.checkpoint, fix["model"], dtype=dtype)
    if args.quantize:
        from .quant import quantize_params

        params = quantize_params(params)
    report = check_fixture(fix, params, impl=args.kernels, batch=args.batch,
                           act_scales=args.act_scales, device=args.device)
    report["dtype"] = args.dtype
    print(json.dumps(report))
    if report["top1_agreement"] < args.min_agreement:
        raise SystemExit(f"top-1 agreement {report['top1_agreement']:.4f} < "
                         f"{args.min_agreement}")


if __name__ == "__main__":
    main()
